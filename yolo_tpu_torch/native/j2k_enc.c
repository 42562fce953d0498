/* JPEG 2000 Part 1 encoder: the codestream cv2.imwrite writes into a
 * .jp2 file, byte for byte. OpenCV 5 encodes through OpenJPEG 2.5 with
 * its defaults and one quality layer at a compression ratio of 4:
 *
 *   one tile, 8-bit unsigned components (R, G, B or gray) without a
 *   component transform, 5 decomposition levels of the reversible 5/3,
 *   64x64 code-blocks of style 0, default precincts, LRCP, no
 *   quantization and 2 guard bits, a COM naming the library.
 *
 * The pipeline is OpenJPEG's, with its arithmetic:
 *
 *   - the DC level shift, then per level the vertical lifting of every
 *     column, then the horizontal lifting of every row;
 *   - tier 1: every pass down to bit-plane 0 through the MQ coder, only
 *     the last one terminated (opj_mqc_flush). A pass's rate is the
 *     bytes written so far plus 3; the rates are then capped from the
 *     last pass down so that they never decrease, and a rate whose last
 *     byte is 0xFF is one less. A pass's distortion decrease is its
 *     nmsedec sum (opj_t1_getnmsedec_sig / _ref: 7-bit windows of the
 *     magnitudes with 6 fractional bits) times the square of the band's
 *     5/3 norm and 2^bit-plane, over 8192 (opj_t1_getwmsedec);
 *   - the rate allocation of opj_tcd_rateallocate: the byte budget is
 *     the rate's share of the raw size (24 or 8 bits a pixel / 4) less
 *     every byte written before the tile (JP2 boxes and main header),
 *     in single precision; at most 128 bisections of the slope threshold
 *     between the least and the largest pass slope, ended once the
 *     threshold moves by 0.5e-5 of itself or less; each trial lays out
 *     the layer (opj_tcd_makelayer: a pass joins where threshold - its
 *     slope from the last pass taken < DBL_EPSILON, or where it adds
 *     distortion for no bytes) and sizes every packet (tier 2) against
 *     the budget; the lowest threshold that fitted is the layer's;
 *   - tier 2: a packet per resolution and component, its header always
 *     starting with the non-empty bit, the inclusion and zero-bit-plane
 *     tag trees, the pass counts, Lblock from 3 by comma code.
 *
 * int yolo_j2k_encode(const uint8_t *pixels, int h, int w, int channels,
 *                     size_t before, uint8_t **out, size_t *out_len,
 *                     char *err, size_t errlen)
 *   pixels: (h, w, channels) uint8, RGB (3) or gray (1); before: the
 *   bytes the file holds ahead of the codestream (its JP2 boxes and the
 *   jp2c box header), which OpenJPEG takes from the budget. Returns 0
 *   and a malloc'ed codestream (free with yolo_native_free), or nonzero
 *   with a message in err: an image under 32 pixels a side has too few
 *   samples for 5 resolutions (OpenJPEG refuses it).
 *
 * Plain C11; the floating-point steps are ISO C's (no contraction), so
 * every host computes the same slopes and the same layer. */

#include <float.h>
#include <math.h>
#include <setjmp.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "j2k.h"

#define NUMRES 6                /* 5 decomposition levels */
#define CBLK 64
#define FRACBITS 6              /* T1_NMSEDEC_FRACBITS */
#define MAXPASSES (3 * 30)
#define RATE 4.0f               /* OpenCV's compression ratio */

static const char COMMENT[] = "Created by OpenJPEG version 2.5.3";

/* opj_dwt_norms: the 5/3 synthesis norms by orientation and level */
static const double NORMS[4][10] = {
    {1.000, 1.500, 2.750, 5.375, 10.68, 21.34, 42.67, 85.33, 170.7, 341.3},
    {1.038, 1.592, 2.919, 5.703, 11.33, 22.64, 45.25, 90.48, 180.9},
    {1.038, 1.592, 2.919, 5.703, 11.33, 22.64, 45.25, 90.48, 180.9},
    {.7186, .9218, 1.586, 3.043, 6.019, 12.01, 24.00, 47.97, 95.93},
};

/* --- the MQ encoder (opj_mqc_*) ------------------------------------- */

typedef struct {
    uint32_t a, c;
    int ct;
    uint8_t *buf;       /* buf[0]: the byte before the first, 0 */
    size_t bp, cap;     /* bp: the byte last written */
    uint8_t idx[NCX], mps[NCX];
    j2k_ctx *cx;
} mqe;

static void mqe_put(mqe *m, uint32_t v) {
    if (m->bp + 2 >= m->cap) {
        m->cap *= 2;
        m->buf = j2k_realloc(m->cx, m->buf, m->cap);
    }
    m->buf[++m->bp] = (uint8_t)v;
}

static void mqe_byteout(mqe *m) {
    if (m->buf[m->bp] == 0xff) {
        mqe_put(m, m->c >> 20);
        m->c &= 0xfffff;
        m->ct = 7;
    } else if ((m->c & 0x8000000) == 0) {
        mqe_put(m, m->c >> 19);
        m->c &= 0x7ffff;
        m->ct = 8;
    } else {
        m->buf[m->bp]++;
        if (m->buf[m->bp] == 0xff) {
            m->c &= 0x7ffffff;
            mqe_put(m, m->c >> 20);
            m->c &= 0xfffff;
            m->ct = 7;
        } else {
            mqe_put(m, m->c >> 19);
            m->c &= 0x7ffff;
            m->ct = 8;
        }
    }
}

static void mqe_start(mqe *m) {
    memset(m->idx, 0, sizeof m->idx);
    memset(m->mps, 0, sizeof m->mps);
    m->idx[CX_UNI] = 46;
    m->idx[CX_AGG] = 3;
    m->idx[0] = 4;
    m->a = 0x8000;
    m->c = 0;
    m->ct = 12;
    m->bp = 0;
    m->buf[0] = 0;
}

static void mqe_encode(mqe *m, int d, int cx) {
    int i = m->idx[cx];
    uint32_t qe = J2K_QE[i].qe;
    m->a -= qe;
    if (d == m->mps[cx]) {
        if (m->a & 0x8000) {
            m->c += qe;
            return;
        }
        if (m->a < qe)
            m->a = qe;
        else
            m->c += qe;
        m->idx[cx] = J2K_QE[i].nmps;
    } else {
        if (m->a < qe)
            m->c += qe;
        else
            m->a = qe;
        if (J2K_QE[i].sw) m->mps[cx] = (uint8_t)(1 - m->mps[cx]);
        m->idx[cx] = J2K_QE[i].nlps;
    }
    do {
        m->a <<= 1;
        m->c <<= 1;
        if (--m->ct == 0) mqe_byteout(m);
    } while ((m->a & 0x8000) == 0);
}

static void mqe_flush(mqe *m) {
    uint32_t tempc = m->c + m->a;
    m->c |= 0xffff;
    if (m->c >= tempc) m->c -= 0x8000;
    m->c <<= m->ct;
    mqe_byteout(m);
    m->c <<= m->ct;
    mqe_byteout(m);
    if (m->buf[m->bp] != 0xff) {
        mqe_put(m, 0);      /* the pointer moves past the last byte */
    }
}

/* opj_mqc_numbytes: the bytes before the one last written, as
 * OpenJPEG's unsigned difference (-1 before the first byte) */
static uint32_t mqe_numbytes(const mqe *m) { return (uint32_t)(m->bp - 1); }

/* --- the encoder's tile ---------------------------------------------- */

typedef struct {
    uint32_t rate;      /* bytes from the block's start */
    double dist;        /* cumulated distortion decrease */
} epass;

typedef struct {
    int x0, y0, w, h;   /* in the band */
    int numbps, npasses;
    epass pass[MAXPASSES];
    uint8_t *data;      /* the MQ bytes (the first pass's at data[0]) */
    int nlayer;         /* passes in the layer */
    uint32_t laylen;    /* their bytes */
} ecblk;

typedef struct {
    int value, low, known;
} tnode;

typedef struct {
    int *parent;
    tnode *n;
    int nnodes;
} etgt;

typedef struct {
    int bandno, w, h, offx, offy;   /* size; position in the tile array */
    int numbps;                     /* expn + guard bits - 1 */
    int cw, ch;
    ecblk *cblks;
    etgt incl, imsb;
} eband;

typedef struct {
    int nbands;
    eband bands[3];
} eres;

typedef struct {
    int w, h, nc;
    int32_t *comp[3];
    eres res[3][NUMRES];
    int16_t sig[128], sig0[128], ref[128], ref0[128];
    j2k_ctx *cx;
} enc;

static void tgt_init(j2k_ctx *c, etgt *t, int w, int h) {
    j2k_tgt g;
    j2k_tgt_init(c, &g, w, h);
    t->parent = g.parent;
    t->nnodes = g.nnodes;
    t->n = j2k_alloc(c, sizeof(tnode) * (size_t)t->nnodes);
}

static void tgt_reset(etgt *t) {
    for (int i = 0; i < t->nnodes; i++) {
        t->n[i].value = 999;
        t->n[i].low = 0;
        t->n[i].known = 0;
    }
}

static void tgt_setvalue(etgt *t, int leaf, int value) {
    int i = leaf;
    while (i >= 0 && t->n[i].value > value) {
        t->n[i].value = value;
        i = t->parent[i];
    }
}

/* --- tier 2's bit writer (opj_bio) ------------------------------------ */

typedef struct {
    uint8_t *out;       /* NULL: count only */
    size_t n;           /* bytes written */
    uint32_t buf;
    int ct;
} bio;

static void bio_byteout(bio *b) {
    b->buf = (b->buf << 8) & 0xffff;
    b->ct = b->buf == 0xff00 ? 7 : 8;
    if (b->out) b->out[b->n] = (uint8_t)(b->buf >> 8);
    b->n++;
}

static void bio_putbit(bio *b, int bit) {
    if (b->ct == 0) bio_byteout(b);
    b->ct--;
    b->buf |= (uint32_t)bit << b->ct;
}

static void bio_write(bio *b, uint32_t v, int n) {
    for (int i = n - 1; i >= 0; i--) bio_putbit(b, (v >> i) & 1);
}

static void bio_flush(bio *b) {
    bio_byteout(b);
    if (b->ct == 7) bio_byteout(b);
}

static void tgt_encode(bio *b, etgt *t, int leaf, int threshold) {
    int stk[32], sp = 0, i = leaf;
    while (t->parent[i] >= 0) {
        stk[sp++] = i;
        i = t->parent[i];
    }
    int low = 0;
    for (;;) {
        tnode *node = &t->n[i];
        if (low > node->low)
            node->low = low;
        else
            low = node->low;
        while (low < threshold) {
            if (low >= node->value) {
                if (!node->known) {
                    bio_putbit(b, 1);
                    node->known = 1;
                }
                break;
            }
            bio_putbit(b, 0);
            low++;
        }
        node->low = low;
        if (sp == 0) break;
        i = stk[--sp];
    }
}

static int floorlog2(uint32_t a) {
    int l = 0;
    while (a > 1) {
        a >>= 1;
        l++;
    }
    return l;
}

/* --- the forward 5/3 (opj_dwt_encode_and_deinterleave_h_one_row for
 * a signal starting at an even index; the vertical pass is the same
 * lifting down a column) -------------------------------------------- */

static void fdwt53(int32_t *row, int32_t *tmp, int n) {
    if (n < 2) return;
    const int sn = (n + 1) >> 1, dn = n - sn;
    int i;
    for (i = 0; i < sn - 1; i++)
        tmp[sn + i] = row[2 * i + 1] - ((row[2 * i] + row[2 * i + 2]) >> 1);
    if (n % 2 == 0) tmp[sn + i] = row[2 * i + 1] - row[2 * i];
    row[0] += (tmp[sn] + tmp[sn] + 2) >> 2;
    for (i = 1; i < dn; i++)
        row[i] = row[2 * i] + ((tmp[sn + i - 1] + tmp[sn + i] + 2) >> 2);
    if (n % 2 == 1)
        row[i] = row[2 * i] + ((tmp[sn + i - 1] + tmp[sn + i - 1] + 2) >> 2);
    memcpy(row + sn, tmp + sn, (size_t)dn * sizeof(int32_t));
}

static void dwt_forward(j2k_ctx *c, int32_t *a, int w, int h) {
    int n = w > h ? w : h;
    int32_t *line = j2k_alloc(c, sizeof(int32_t) * (size_t)n);
    int32_t *tmp = j2k_alloc(c, sizeof(int32_t) * (size_t)n);
    for (int lev = 0; lev < NUMRES - 1; lev++) {
        int rw = j2k_ceildivpow2(w, lev), rh = j2k_ceildivpow2(h, lev);
        for (int x = 0; x < rw; x++) {
            for (int y = 0; y < rh; y++) line[y] = a[(size_t)y * w + x];
            fdwt53(line, tmp, rh);
            for (int y = 0; y < rh; y++) a[(size_t)y * w + x] = line[y];
        }
        for (int y = 0; y < rh; y++) fdwt53(a + (size_t)y * w, tmp, rw);
    }
    j2k_free(c, tmp);
    j2k_free(c, line);
}

/* --- tier 1 -------------------------------------------------------- */

/* t1_generate_luts.c's nmsedec tables */
static void nmsedec_luts(enc *e) {
    for (int i = 0; i < 128; i++) {
        double t = i / pow(2, FRACBITS);
        double u = t, v = t - 1.5;
        int k;
        k = (int)(floor((u * u - v * v) * pow(2, FRACBITS) + 0.5) /
                  pow(2, FRACBITS) * 8192.0);
        e->sig[i] = (int16_t)(k > 0 ? k : 0);
        k = (int)(floor((u * u) * pow(2, FRACBITS) + 0.5) /
                  pow(2, FRACBITS) * 8192.0);
        e->sig0[i] = (int16_t)(k > 0 ? k : 0);
        u = t - 1.0;
        v = (i & 64) ? t - 1.5 : t - 0.5;
        k = (int)(floor((u * u - v * v) * pow(2, FRACBITS) + 0.5) /
                  pow(2, FRACBITS) * 8192.0);
        e->ref[i] = (int16_t)(k > 0 ? k : 0);
        k = (int)(floor((u * u) * pow(2, FRACBITS) + 0.5) /
                  pow(2, FRACBITS) * 8192.0);
        e->ref0[i] = (int16_t)(k > 0 ? k : 0);
    }
}

typedef struct {
    int w, h, cols;
    uint16_t *f;
    uint32_t *mag;      /* |coefficient| << FRACBITS, row-major */
    const uint8_t *zc;
    const uint16_t *sc;
    const enc *e;
    mqe m;
} t1e;

static inline int nms_sig(const enc *e, uint32_t x, int bpno) {
    return bpno > 0 ? e->sig[(x >> bpno) & 127] : e->sig0[x & 127];
}

static inline int nms_ref(const enc *e, uint32_t x, int bpno) {
    return bpno > 0 ? e->ref[(x >> bpno) & 127] : e->ref0[x & 127];
}

static inline void code_sign(t1e *t, uint16_t *f, int y) {
    uint16_t cs = t->sc[j2k_t1_sc_index(*f)];
    int neg = (*f & F_NEG) != 0;
    mqe_encode(&t->m, neg ^ (cs >> 8), cs & 0xff);
    j2k_t1_set_sig(f, y & 3, t->cols, neg, 0);
}

static int enc_sigpass(t1e *t, int bpno) {
    uint32_t one = (uint32_t)1 << (bpno + FRACBITS);
    int nmsedec = 0;
    for (int k = 0; k < t->h; k += 4) {
        int stop = k + 4 < t->h ? k + 4 : t->h;
        for (int x = 0; x < t->w; x++) {
            uint16_t *f = j2k_t1_state(t->f, t->cols, x, k);
            if (!(j2k_t1_column(f) & J2K_X4(N_ANY))) continue;
            for (int y = k; y < stop; y++, f++) {
                if ((*f & (F_SIG | F_VISIT)) || !(*f & N_ANY)) continue;
                uint32_t mag = t->mag[(size_t)y * t->w + x];
                int v = (mag & one) != 0;
                mqe_encode(&t->m, v, t->zc[*f & N_ANY]);
                if (v) {
                    nmsedec += nms_sig(t->e, mag, bpno);
                    code_sign(t, f, y);
                }
                *f |= F_VISIT;
            }
        }
    }
    return nmsedec;
}

static int enc_refpass(t1e *t, int bpno) {
    uint32_t one = (uint32_t)1 << (bpno + FRACBITS);
    int nmsedec = 0;
    for (int k = 0; k < t->h; k += 4) {
        int stop = k + 4 < t->h ? k + 4 : t->h;
        for (int x = 0; x < t->w; x++) {
            uint16_t *f = j2k_t1_state(t->f, t->cols, x, k);
            if (!(j2k_t1_column(f) & J2K_X4(F_SIG))) continue;
            for (int y = k; y < stop; y++, f++) {
                if ((*f & (F_SIG | F_VISIT)) != F_SIG) continue;
                uint32_t mag = t->mag[(size_t)y * t->w + x];
                nmsedec += nms_ref(t->e, mag, bpno);
                int cx = (*f & F_REFINED) ? CX_MAG + 2
                         : (*f & N_ANY) ? CX_MAG + 1 : CX_MAG;
                mqe_encode(&t->m, (mag & one) != 0, cx);
                *f |= F_REFINED;
            }
        }
    }
    return nmsedec;
}

static int enc_clnpass(t1e *t, int bpno) {
    uint32_t one = (uint32_t)1 << (bpno + FRACBITS);
    int nmsedec = 0;
    for (int k = 0; k < t->h; k += 4) {
        int stop = k + 4 < t->h ? k + 4 : t->h;
        for (int x = 0; x < t->w; x++) {
            uint16_t *f = j2k_t1_state(t->f, t->cols, x, k);
            const uint32_t *mg = t->mag + (size_t)k * t->w + x;
            int y = k;
            if (stop - k == 4 &&
                !(j2k_t1_column(f) & J2K_X4(F_SIG | F_VISIT | N_ANY))) {
                int r = 0;
                while (r < 4 && !(mg[(size_t)r * t->w] & one)) r++;
                mqe_encode(&t->m, r != 4, CX_AGG);
                if (r == 4) continue;
                mqe_encode(&t->m, r >> 1, CX_UNI);
                mqe_encode(&t->m, r & 1, CX_UNI);
                nmsedec += nms_sig(t->e, mg[(size_t)r * t->w], bpno);
                code_sign(t, f + r, k + r);
                y = k + r + 1;
            }
            for (; y < stop; y++) {
                uint16_t *g = f + (y - k);
                if (*g & (F_SIG | F_VISIT)) continue;
                uint32_t mag = mg[(size_t)(y - k) * t->w];
                int v = (mag & one) != 0;
                mqe_encode(&t->m, v, t->zc[*g & N_ANY]);
                if (v) {
                    nmsedec += nms_sig(t->e, mag, bpno);
                    code_sign(t, g, y);
                }
            }
            for (int i = 0; i < 4; i++) f[i] &= (uint16_t)~F_VISIT;
        }
    }
    return nmsedec;
}

/* opj_t1_getwmsedec for the reversible path (no component weight, step
 * size 1), in its order of operations */
static double wmsedec(int nmsedec, int level, int orient, int bpno) {
    double w = NORMS[orient][level] * (double)(1 << bpno);
    w *= w * nmsedec / 8192.0;
    return w;
}

/* opj_t1_encode_cblk: src is the block's first sample in the tile */
static void t1_encode_cblk(t1e *t, ecblk *cb, const int32_t *src,
                           size_t stride, int orient, int level) {
    t->w = cb->w;
    t->h = cb->h;
    t->cols = cb->w + 2;
    uint32_t max = 0;
    uint16_t *fs = t->f;
    memset(fs, 0, sizeof(uint16_t) * 4 * (size_t)t->cols *
                      (size_t)((t->h + 3) / 4 + 2));
    for (int y = 0; y < t->h; y++)
        for (int x = 0; x < t->w; x++) {
            int32_t v = src[(size_t)y * stride + x];
            uint32_t mag = (uint32_t)(v < 0 ? -(int64_t)v : v) << FRACBITS;
            t->mag[(size_t)y * t->w + x] = mag;
            if (mag > max) max = mag;
            if (v < 0) *j2k_t1_state(fs, t->cols, x, y) |= F_NEG;
        }
    cb->numbps = max ? floorlog2(max) + 1 - FRACBITS : 0;
    cb->npasses = 0;
    if (cb->numbps == 0) return;
    if (3 * cb->numbps - 2 > MAXPASSES)
        j2k_fail(t->m.cx, "JPEG 2000 encode: %d bit-planes in a code-block",
                 cb->numbps);
    mqe_start(&t->m);
    double cum = 0.0;
    int bpno = cb->numbps - 1, passtype = 2, passno;
    for (passno = 0; bpno >= 0; passno++) {
        epass *p = &cb->pass[passno];
        int nmsedec = passtype == 0   ? enc_sigpass(t, bpno)
                      : passtype == 1 ? enc_refpass(t, bpno)
                                      : enc_clnpass(t, bpno);
        cum += wmsedec(nmsedec, level, orient, bpno);
        p->dist = cum;
        if (passtype == 2 && bpno == 0) {
            mqe_flush(&t->m);
            p->rate = mqe_numbytes(&t->m);
        } else {
            p->rate = mqe_numbytes(&t->m) + 3;
        }
        if (++passtype == 3) {
            passtype = 0;
            bpno--;
        }
    }
    cb->npasses = passno;
    /* rates never decrease */
    uint32_t last = mqe_numbytes(&t->m);
    for (int i = cb->npasses; i > 0;) {
        epass *p = &cb->pass[--i];
        if (p->rate > last)
            p->rate = last;
        else
            last = p->rate;
    }
    size_t n = mqe_numbytes(&t->m);
    cb->data = j2k_alloc(t->m.cx, n + 1);
    memcpy(cb->data, t->m.buf + 1, n);
    /* no pass ends on 0xFF (data[-1] would be the 0 before the first) */
    for (int i = 0; i < cb->npasses; i++) {
        epass *p = &cb->pass[i];
        if (p->rate && t->m.buf[p->rate] == 0xff) p->rate--;
    }
}

/* --- the layer and tier 2 ---------------------------------------------- */

#define FOR_BANDS(e, c, r, b)                                         \
    for (int c = 0; c < (e)->nc; c++)                                 \
        for (int r = 0; r < NUMRES; r++)                              \
            for (eband *b = (e)->res[c][r].bands;                     \
                 b < (e)->res[c][r].bands + (e)->res[c][r].nbands; b++)

/* opj_tcd_makelayer for the first layer */
static void makelayer(enc *e, double thresh) {
    FOR_BANDS(e, c, r, b) {
        for (int k = 0; k < b->cw * b->ch; k++) {
            ecblk *cb = &b->cblks[k];
            int n = 0;
            for (int p = 0; p < cb->npasses; p++) {
                const epass *ps = &cb->pass[p];
                uint32_t dr;
                double dd;
                if (n == 0) {
                    dr = ps->rate;
                    dd = ps->dist;
                } else {
                    dr = ps->rate - cb->pass[n - 1].rate;
                    dd = ps->dist - cb->pass[n - 1].dist;
                }
                if (!dr) {
                    if (dd != 0) n = p + 1;
                    continue;
                }
                if (thresh - (dd / dr) < DBL_EPSILON) n = p + 1;
            }
            cb->nlayer = n;
            cb->laylen = n ? cb->pass[n - 1].rate : 0;
        }
    }
}

static void putnumpasses(bio *b, int n) {
    if (n == 1)
        bio_putbit(b, 0);
    else if (n == 2)
        bio_write(b, 2, 2);
    else if (n <= 5)
        bio_write(b, 0xc | (uint32_t)(n - 3), 4);
    else if (n <= 36)
        bio_write(b, 0x1e0 | (uint32_t)(n - 6), 9);
    else
        bio_write(b, 0xff80 | (uint32_t)(n - 37), 16);
}

/* every packet of the layer (LRCP): the bytes they take, written to out
 * unless it is NULL; stops at more than maxlen and returns -1 */
static long t2_encode(enc *e, uint8_t *out, size_t maxlen) {
    size_t total = 0;
    for (int r = 0; r < NUMRES; r++)
        for (int c = 0; c < e->nc; c++) {
            eres *res = &e->res[c][r];
            for (int i = 0; i < res->nbands; i++) {
                eband *b = &res->bands[i];
                tgt_reset(&b->incl);
                tgt_reset(&b->imsb);
                for (int k = 0; k < b->cw * b->ch; k++) {
                    tgt_setvalue(&b->imsb, k,
                                 b->numbps - b->cblks[k].numbps);
                }
            }
            bio bb = {out ? out + total : NULL, 0, 0, 8};
            bio_putbit(&bb, 1);
            for (int i = 0; i < res->nbands; i++) {
                eband *b = &res->bands[i];
                int nb = b->cw * b->ch;
                for (int k = 0; k < nb; k++)
                    if (b->cblks[k].nlayer) tgt_setvalue(&b->incl, k, 0);
                for (int k = 0; k < nb; k++) {
                    ecblk *cb = &b->cblks[k];
                    tgt_encode(&bb, &b->incl, k, 1);
                    if (!cb->nlayer) continue;
                    tgt_encode(&bb, &b->imsb, k, 999);
                    putnumpasses(&bb, cb->nlayer);
                    /* one codeword segment: its length in Lblock (from
                     * 3, raised by comma code) + log2(passes) bits */
                    int passbits = floorlog2((uint32_t)cb->nlayer);
                    int inc = floorlog2(cb->laylen) + 1 - (3 + passbits);
                    if (inc < 0) inc = 0;
                    for (int j = 0; j < inc; j++) bio_putbit(&bb, 1);
                    bio_putbit(&bb, 0);
                    bio_write(&bb, cb->laylen, 3 + inc + passbits);
                }
            }
            bio_flush(&bb);
            if (total + bb.n > maxlen) return -1;
            total += bb.n;
            for (int i = 0; i < res->nbands; i++) {
                eband *b = &res->bands[i];
                for (int k = 0; k < b->cw * b->ch; k++) {
                    ecblk *cb = &b->cblks[k];
                    if (!cb->nlayer) continue;
                    if (cb->laylen > maxlen - total) return -1;
                    if (out) memcpy(out + total, cb->data, cb->laylen);
                    total += cb->laylen;
                }
            }
        }
    return (long)total;
}

/* opj_tcd_rateallocate for one layer of the given byte budget */
static void rate_allocate(enc *e, uint32_t maxlen) {
    double min = DBL_MAX, max = 0;
    FOR_BANDS(e, c, r, b) {
        for (int k = 0; k < b->cw * b->ch; k++) {
            const ecblk *cb = &b->cblks[k];
            for (int p = 0; p < cb->npasses; p++) {
                int32_t dr;
                double dd;
                if (p == 0) {
                    dr = (int32_t)cb->pass[0].rate;
                    dd = cb->pass[0].dist;
                } else {
                    dr = (int32_t)(cb->pass[p].rate - cb->pass[p - 1].rate);
                    dd = cb->pass[p].dist - cb->pass[p - 1].dist;
                }
                if (dr == 0) continue;
                double slope = dd / dr;
                if (slope < min) min = slope;
                if (slope > max) max = slope;
            }
        }
    }
    double lo = min, hi = max, thresh = 0, stable = 0;
    for (int i = 0; i < 128; i++) {
        double next = (lo + hi) / 2;
        /* OpenJPEG stops once the threshold has settled */
        if (fabs(next - thresh) <= 0.5 * 1e-5 * thresh) break;
        thresh = next;
        makelayer(e, thresh);
        if (t2_encode(e, NULL, maxlen) >= 0) {
            hi = thresh;
            stable = thresh;
        } else {
            lo = thresh;
        }
    }
    makelayer(e, stable == 0 ? thresh : stable);
}

/* --- the codestream ---------------------------------------------------- */

typedef struct {
    uint8_t *p;
    size_t n, cap;
    j2k_ctx *cx;
} wbuf;

/* n more bytes at the end of w: where they go */
static uint8_t *reserve(wbuf *w, size_t n) {
    if (w->n + n > w->cap) {
        while (w->n + n > w->cap) w->cap *= 2;
        w->p = j2k_realloc(w->cx, w->p, w->cap);
    }
    w->n += n;
    return w->p + w->n - n;
}

static void put(wbuf *w, const void *src, size_t n) {
    memcpy(reserve(w, n), src, n);
}

static void put8(wbuf *w, uint32_t v) {
    uint8_t b = (uint8_t)v;
    put(w, &b, 1);
}

static void put16(wbuf *w, uint32_t v) {
    uint8_t b[2] = {(uint8_t)(v >> 8), (uint8_t)v};
    put(w, b, 2);
}

static void put32(wbuf *w, uint32_t v) {
    uint8_t b[4] = {(uint8_t)(v >> 24), (uint8_t)(v >> 16), (uint8_t)(v >> 8),
                    (uint8_t)v};
    put(w, b, 4);
}

static void main_header(wbuf *w, int width, int height, int nc) {
    put16(w, 0xff4f);                       /* SOC */
    put16(w, 0xff51);                       /* SIZ */
    put16(w, 38 + 3 * (uint32_t)nc);
    put16(w, 0);
    put32(w, (uint32_t)width);
    put32(w, (uint32_t)height);
    put32(w, 0);
    put32(w, 0);
    put32(w, (uint32_t)width);
    put32(w, (uint32_t)height);
    put32(w, 0);
    put32(w, 0);
    put16(w, (uint32_t)nc);
    for (int c = 0; c < nc; c++) {
        put8(w, 7);
        put8(w, 1);
        put8(w, 1);
    }
    put16(w, 0xff52);                       /* COD */
    put16(w, 12);
    put8(w, 0);                             /* Scod */
    put8(w, J2K_LRCP);
    put16(w, 1);                            /* layers */
    put8(w, 0);                             /* no MCT */
    put8(w, NUMRES - 1);
    put8(w, 4);                             /* 64 x 64 */
    put8(w, 4);
    put8(w, 0);
    put8(w, 1);                             /* 5/3 */
    put16(w, 0xff5c);                       /* QCD */
    put16(w, 3 + 3 * (NUMRES - 1) + 1);
    put8(w, 2 << 5);                        /* 2 guard bits, none */
    put8(w, 8 << 3);
    for (int r = 1; r < NUMRES; r++) {
        put8(w, 9 << 3);
        put8(w, 9 << 3);
        put8(w, 10 << 3);
    }
    put16(w, 0xff64);                       /* COM */
    put16(w, 4 + (uint32_t)strlen(COMMENT));
    put16(w, 1);
    put(w, COMMENT, strlen(COMMENT));
}

/* the bands of each resolution, OpenJPEG's geometry for a tile at the
 * origin: the low band of level l is ceil(size / 2^l) wide; each band
 * one precinct of 64 x 64 code-blocks from its origin */
static void setup(enc *e) {
    for (int ci = 0; ci < e->nc; ci++)
        for (int r = 0; r < NUMRES; r++) {
            int lev = NUMRES - 1 - r;
            int rw = j2k_ceildivpow2(e->w, lev);
            int rh = j2k_ceildivpow2(e->h, lev);
            int lw = j2k_ceildivpow2(e->w, lev + 1);
            int lh = j2k_ceildivpow2(e->h, lev + 1);
            eres *res = &e->res[ci][r];
            res->nbands = r == 0 ? 1 : 3;
            for (int i = 0; i < res->nbands; i++) {
                eband *b = &res->bands[i];
                b->bandno = r == 0 ? 0 : i + 1;
                int hx = b->bandno & 1, hy = b->bandno >> 1;
                b->w = r == 0 ? rw : hx ? rw - lw : lw;
                b->h = r == 0 ? rh : hy ? rh - lh : lh;
                b->offx = hx ? lw : 0;
                b->offy = hy ? lh : 0;
                /* QCD's exponent (8 + the band's gain) + 2 guard bits - 1 */
                b->numbps = 8 + hx + hy + 2 - 1;
                b->cw = j2k_ceildiv(b->w, CBLK);
                b->ch = j2k_ceildiv(b->h, CBLK);
                b->cblks = j2k_alloc(e->cx, sizeof(ecblk) *
                                                (size_t)(b->cw * b->ch));
                for (int y = 0; y < b->ch; y++)
                    for (int x = 0; x < b->cw; x++) {
                        ecblk *cb = &b->cblks[y * b->cw + x];
                        cb->x0 = x * CBLK;
                        cb->y0 = y * CBLK;
                        cb->w = j2k_imin(b->w - cb->x0, CBLK);
                        cb->h = j2k_imin(b->h - cb->y0, CBLK);
                    }
                tgt_init(e->cx, &b->incl, b->cw, b->ch);
                tgt_init(e->cx, &b->imsb, b->cw, b->ch);
            }
        }
}

static void encode(j2k_ctx *c, const uint8_t *pixels, int h, int w, int nc,
                   size_t before, uint8_t **out, size_t *out_len) {
    enc *e = j2k_alloc(c, sizeof(enc));
    e->cx = c;
    e->w = w;
    e->h = h;
    e->nc = nc;
    nmsedec_luts(e);
    size_t n = (size_t)w * (size_t)h;
    for (int ci = 0; ci < nc; ci++) {
        int32_t *a = e->comp[ci] = j2k_alloc(c, sizeof(int32_t) * n);
        for (size_t i = 0; i < n; i++)
            a[i] = (int32_t)pixels[i * nc + ci] - 128;   /* DC shift */
        dwt_forward(c, a, w, h);
    }
    setup(e);

    j2k_t1_tables *lut = j2k_alloc(c, sizeof *lut);
    j2k_t1_luts(lut);
    t1e t;
    t.e = e;
    t.sc = lut->sc;
    t.f = j2k_alloc(c, sizeof(uint16_t) * 4 * (CBLK + 2) * (CBLK / 4 + 2));
    t.mag = j2k_alloc(c, sizeof(uint32_t) * CBLK * CBLK);
    t.m.cx = c;
    t.m.cap = 1 << 16;
    t.m.buf = j2k_alloc(c, t.m.cap);
    FOR_BANDS(e, ci, r, b) {
        int level = NUMRES - 1 - r;
        t.zc = lut->zc[b->bandno];
        for (int k = 0; k < b->cw * b->ch; k++) {
            ecblk *cb = &b->cblks[k];
            const int32_t *src = e->comp[ci] + (size_t)(b->offy + cb->y0) * w +
                                 (size_t)(b->offx + cb->x0);
            t1_encode_cblk(&t, cb, src, (size_t)w, b->bandno, level);
        }
    }

    wbuf cs = {j2k_alloc(c, 4096), 0, 4096, c};
    main_header(&cs, w, h, nc);
    /* opj_j2k_update_rates: the layer's bytes, in single precision */
    float rate = (float)(((double)(nc * 8) * (uint32_t)w * (uint32_t)h) /
                         (RATE * (float)8));
    rate -= (float)(before + cs.n) / (float)1;
    if (rate < 30.0f) rate = 30.0f;
    uint32_t maxlen = (uint32_t)ceil(rate);
    rate_allocate(e, maxlen);
    long body = t2_encode(e, NULL, (size_t)-1);
    put16(&cs, 0xff90);                     /* SOT */
    put16(&cs, 10);
    put16(&cs, 0);
    put32(&cs, (uint32_t)(12 + 2 + body));
    put8(&cs, 0);
    put8(&cs, 1);
    put16(&cs, 0xff93);                     /* SOD */
    t2_encode(e, reserve(&cs, (size_t)body), (size_t)body);
    put16(&cs, 0xffd9);                     /* EOC */
    *out = malloc(cs.n);
    if (!*out) j2k_fail(c, "JPEG 2000 encode: out of memory");
    memcpy(*out, cs.p, cs.n);
    *out_len = cs.n;
}

int yolo_j2k_encode(const uint8_t *pixels, int h, int w, int channels,
                    size_t before, uint8_t **out, size_t *out_len, char *err,
                    size_t errlen) {
    *out = NULL;
    *out_len = 0;
    if (channels != 1 && channels != 3) {
        snprintf(err, errlen, "JPEG 2000 encode: channels=%d (1 or 3)",
                 channels);
        return 1;
    }
    if (w < (1 << (NUMRES - 1)) || h < (1 << (NUMRES - 1))) {
        snprintf(err, errlen, "JPEG 2000 encode: a %dx%d image is too small "
                 "for %d resolutions (32 pixels a side at least)", w, h,
                 NUMRES);
        return 1;
    }
    if ((int64_t)w * h > (1 << 28)) {
        snprintf(err, errlen, "JPEG 2000 encode: a %dx%d image (at most 2^28 "
                 "pixels)", w, h);
        return 1;
    }
    j2k_ctx *c = calloc(1, sizeof *c);
    if (!c) {
        snprintf(err, errlen, "JPEG 2000 encode: out of memory");
        return 1;
    }
    c->err = err;
    c->errlen = errlen;
    int rc = 0;
    if (setjmp(c->jmp)) {
        free(*out);
        *out = NULL;
        rc = 1;
    } else {
        encode(c, pixels, h, w, channels, before, out, out_len);
    }
    j2k_release(c, NULL);
    free(c);
    return rc;
}
