/* The JPEG 2000 Part 1 decoder's shared types (j2k.c: markers, tiles and
 * the image; j2k_t2.c: packets; j2k_t1.c: code-blocks; j2k_dwt.c: the
 * inverse transforms), and the tier-1 tables and sample states the
 * encoder (j2k_enc.c) shares with it. The arithmetic follows OpenJPEG
 * 2.5, the library OpenCV reads and writes JPEG 2000 through, so that
 * the samples and bytes are the ones cv2 sees. Not part of native.h's
 * interface. */
#ifndef YOLO_TPU_TORCH_J2K_H
#define YOLO_TPU_TORCH_J2K_H

#include <setjmp.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#define J2K_MAXRES 33
#define J2K_MAXBANDS (3 * J2K_MAXRES - 2)

/* code-block styles (COD / COC SPcod); PTERM (0x10) changes only how
 * the encoder ends a segment */
#define J2K_LAZY 0x01
#define J2K_RESET 0x02
#define J2K_TERMALL 0x04
#define J2K_VSC 0x08
#define J2K_SEGSYM 0x20

/* progression orders */
enum { J2K_LRCP, J2K_RLCP, J2K_RPCL, J2K_PCRL, J2K_CPRL };

/* one decode: every allocation is recorded and freed at the end, so an
 * error can longjmp out of any depth; the list is doubly linked so that a
 * realloc or a free finds its block's neighbours at once */
typedef struct j2k_block {
    struct j2k_block *next, *prev;
    max_align_t pad[];
} j2k_block;

typedef struct {
    jmp_buf jmp;
    char *err;
    size_t errlen;
    j2k_block *blocks;
} j2k_ctx;

void *j2k_alloc(j2k_ctx *c, size_t n);           /* zeroed */
void *j2k_realloc(j2k_ctx *c, void *p, size_t n);
void j2k_free(j2k_ctx *c, void *p);
/* frees what was allocated since mark (a realloc keeps a block's place
 * in the list, so those blocks are the ones ahead of it) */
void j2k_release(j2k_ctx *c, j2k_block *mark);
void j2k_fail(j2k_ctx *c, const char *fmt, ...)
#if defined(__GNUC__)
    __attribute__((noreturn, format(printf, 2, 3)))
#endif
    ;

typedef struct { int expn, mant; } j2k_step;

/* a tile-component's coding parameters (COD / COC, QCD / QCC, RGN) */
typedef struct {
    int prt;            /* precinct sizes given (Scod / Scoc bit 0) */
    int numres;         /* decomposition levels + 1 */
    int cblkw, cblkh;   /* code-block size exponents */
    int cblksty;
    int qmfbid;         /* 1: reversible 5/3, 0: irreversible 9/7 */
    int prcw[J2K_MAXRES], prch[J2K_MAXRES];
    int qntsty, numgbits;
    j2k_step steps[J2K_MAXBANDS];
    int roishift;
} j2k_tccp;

typedef struct {
    int resno0, compno0, layno1, resno1, compno1, prg;
} j2k_poc;

typedef struct {
    uint8_t *data;
    size_t len, cap;
} j2k_buf;

/* a tile's coding parameters and its data */
typedef struct {
    int csty;           /* Scod: SOP (2), EPH (4) */
    int prg, numlayers, mct;
    j2k_tccp *tccps;
    j2k_poc *pocs;
    int npocs;
    j2k_buf data;       /* the tile-parts' bodies, in order */
    j2k_buf ppt[256];   /* PPT bodies by Zppt */
    int has_ppt, cur_part, nparts, seen, decoded;
} j2k_tcp;

typedef struct {
    int prec, sgnd, dx, dy;
} j2k_siz_comp;

/* the codestream's main-header state */
typedef struct {
    int x0, y0, x1, y1;          /* image area on the reference grid */
    int tx0, ty0, tdx, tdy;      /* tile grid */
    int tw, th;
    int ncomp;
    j2k_siz_comp *comps;
    j2k_tcp deflt;               /* the main header's parameters */
    j2k_tcp *tcps;
    j2k_buf ppm[256];            /* PPM bodies by Zppm */
    int has_ppm;
    const uint8_t *ppm_data;     /* the merged Ippm, read across tiles */
    size_t ppm_len;
} j2k_cp;

/* --- the tile's decomposition (OpenJPEG's tcd) --------------------- */

typedef struct {
    size_t len;                 /* bytes */
    int numpasses, maxpasses, newlen, numnewpasses;
} j2k_seg;

typedef struct {
    int x0, y0, x1, y1;
    int numbps, numlenbits, numsegs, numnewpasses;
    j2k_seg *segs;
    int segcap;
    j2k_buf data;               /* the segments' bytes, in order */
} j2k_cblk;

typedef struct {
    int *value, *low, *parent;  /* nodes: leaves first */
    int nnodes;
} j2k_tgt;

typedef struct {
    int x0, y0, x1, y1, cw, ch;
    j2k_cblk *cblks;
    j2k_tgt incl, imsb;
} j2k_prec;

typedef struct {
    int x0, y0, x1, y1, bandno;
    int numbps;
    float stepsize;
    j2k_prec *precs;
} j2k_band;

typedef struct {
    int x0, y0, x1, y1;
    int pw, ph, pdx, pdy, numbands;
    j2k_band bands[3];
} j2k_res;

typedef union { int32_t i; float f; } j2k_sample;

typedef struct {
    int x0, y0, x1, y1;
    int numres;
    j2k_res res[J2K_MAXRES];
    j2k_sample *data;           /* (y1 - y0) rows of (x1 - x0) */
} j2k_tilec;

typedef struct {
    int x0, y0, x1, y1;         /* on the reference grid */
    j2k_tilec *comps;
} j2k_tile;

/* --- tier 1, shared by the decoder (j2k_t1.c) and the encoder
 * (j2k_enc.c) ------------------------------------------------------- */

typedef struct { uint16_t qe; uint8_t nmps, nlps, sw; } j2k_qe;
extern const j2k_qe J2K_QE[47];


/* contexts: 0-8 zero coding, 9-13 sign, 14-16 magnitude, run, uniform */
#define CX_SC 9
#define CX_MAG 14
#define CX_AGG 17
#define CX_UNI 18
#define NCX 19

/* sample state: the significance of the 8 neighbours, the signs of the
 * 4 direct ones, and the sample's own bits. A sample that becomes
 * significant sets its bits in its neighbours' states (as OpenJPEG's
 * opj_t1_update_flags): under VSC a stripe's first row does not tell the
 * row above it, so that a stripe's last row sees the next stripe as
 * insignificant in every context. */
#define N_N 0x0001
#define N_S 0x0002
#define N_W 0x0004
#define N_E 0x0008
#define N_NW 0x0010
#define N_NE 0x0020
#define N_SW 0x0040
#define N_SE 0x0080
#define NEG_N 0x0100
#define NEG_S 0x0200
#define NEG_W 0x0400
#define NEG_E 0x0800
#define F_SIG 0x1000
#define F_NEG 0x2000
#define F_VISIT 0x4000
#define F_REFINED 0x8000
#define N_ANY 0x00ff

/* a code-block's states: a border stripe above and below, a border
 * column each side; the state of sample (x, y) is at stripe y / 4 + 1,
 * column x + 1, row y % 4 (cols = w + 2) */
static inline uint16_t *j2k_t1_state(uint16_t *f, int cols, int x, int y) {
    return f + (((size_t)(y >> 2) + 1) * (size_t)cols + (size_t)x + 1) * 4 +
           (size_t)(y & 3);
}

/* the four states of a stripe column as one word */
static inline uint64_t j2k_t1_column(const uint16_t *f) {
    uint64_t v;
    memcpy(&v, f, sizeof v);
    return v;
}

#define J2K_X4(m) ((uint64_t)(m) * 0x0001000100010001ull)

/* the sign-coding table's index: the direct neighbours' significance
 * and signs */
static inline int j2k_t1_sc_index(uint16_t f) {
    return (f & 0xf) | ((f >> 4) & 0xf0);
}

/* sample f (row r of its stripe) becomes significant */
static inline void j2k_t1_set_sig(uint16_t *f, int r, int cols, int neg,
                                  int vsc) {
    ptrdiff_t col = 4, up = r ? -1 : -4 * (ptrdiff_t)cols + 3;
    ptrdiff_t down = r < 3 ? 1 : 4 * (ptrdiff_t)cols - 3;
    *f |= (uint16_t)(F_SIG | (neg ? F_NEG : 0));
    f[-col] |= (uint16_t)(N_E | (neg ? NEG_E : 0));
    f[col] |= (uint16_t)(N_W | (neg ? NEG_W : 0));
    if (!(vsc && r == 0)) {
        uint16_t *n = f + up;
        *n |= (uint16_t)(N_S | (neg ? NEG_S : 0));
        n[-col] |= N_SE;
        n[col] |= N_SW;
    }
    uint16_t *s = f + down;
    *s |= (uint16_t)(N_N | (neg ? NEG_N : 0));
    s[-col] |= N_NE;
    s[col] |= N_NW;
}

/* j2k_t2.c */
void j2k_t2_decode(j2k_ctx *c, j2k_cp *cp, j2k_tcp *tcp, j2k_tile *tile,
                   int ncomp);
void j2k_tgt_init(j2k_ctx *c, j2k_tgt *t, int w, int h);

/* j2k_t1.c: the context tables, filled once per decode; a code-block's
 * passes -> its w x h coefficients in OpenJPEG's doubled units */
typedef struct {
    uint8_t zc[4][256];     /* zero coding by orientation, neighbours */
    uint16_t sc[256];       /* sign coding | prediction << 8 */
} j2k_t1_tables;

void j2k_t1_luts(j2k_t1_tables *lut);
void j2k_t1_decode_cblk(j2k_ctx *c, const j2k_t1_tables *lut,
                        const j2k_cblk *cb, int orient, int roishift,
                        int cblksty, int32_t *out);

/* j2k_dwt.c */
void j2k_dwt_decode_53(j2k_ctx *c, j2k_tilec *tc);
void j2k_dwt_decode_97(j2k_ctx *c, j2k_tilec *tc);
void j2k_mct_decode(j2k_sample *c0, j2k_sample *c1, j2k_sample *c2,
                    size_t n);
void j2k_mct_decode_real(j2k_sample *c0, j2k_sample *c1, j2k_sample *c2,
                         size_t n);

static inline int j2k_ceildiv(int a, int b) {
    return (int)(((int64_t)a + b - 1) / b);
}
static inline int j2k_ceildivpow2(int a, int b) {
    return (int)(((int64_t)a + ((int64_t)1 << b) - 1) >> b);
}
static inline int j2k_floordivpow2(int a, int b) { return a >> b; }
static inline int j2k_imin(int a, int b) { return a < b ? a : b; }
static inline int j2k_imax(int a, int b) { return a > b ? a : b; }

#endif
