/* JPEG 2000 tier 1: a code-block's coding passes -> its coefficients.
 *
 * The MQ decoder (Annex C, 47 states, the 0xFF 0xFF end marker that
 * OpenJPEG appends to each segment) and the raw decoder of BYPASS
 * passes; the significance propagation, magnitude refinement and
 * cleanup passes over stripes of four rows (Annex D), with every
 * code-block style: BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM.
 *
 * Coefficients are kept as OpenJPEG 2.5 keeps them, with one bit below
 * the least decoded bit-plane: a sample that becomes significant at
 * bit-plane p is 3 << p (the middle of its interval), and a refinement
 * at p adds or takes 1 << p from its magnitude. An ROI shift (RGN
 * maxshift) then divides the samples of magnitude 1 << roishift or more
 * (doubled units, as OpenJPEG compares them) by 1 << roishift.
 *
 * Plain C11, no state between calls. */

#include <stddef.h>
#include <stdlib.h>
#include <string.h>

#include "j2k.h"

/* T.800 Table C.2: Qe, NMPS, NLPS, SWITCH */
const j2k_qe J2K_QE[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0},
};

typedef struct {
    const uint8_t *bp;
    uint32_t c, a;
    int ct;
    uint8_t idx[NCX], mps[NCX];
} mqc;

static void mq_reset(mqc *m) {
    memset(m->idx, 0, sizeof m->idx);
    memset(m->mps, 0, sizeof m->mps);
    m->idx[CX_UNI] = 46;
    m->idx[CX_AGG] = 3;
    m->idx[0] = 4;
}

/* BYTEIN (C.3.4): bp is the byte last read; the segment is followed by
 * 0xFF 0xFF */
static inline void mq_bytein(mqc *m) {
    uint32_t next = m->bp[1];
    if (m->bp[0] == 0xff) {
        if (next > 0x8f) {
            m->c += 0xff00;
            m->ct = 8;
        } else {
            m->bp++;
            m->c += next << 9;
            m->ct = 7;
        }
    } else {
        m->bp++;
        m->c += next << 8;
        m->ct = 8;
    }
}

static void mq_init(mqc *m, const uint8_t *bp, size_t len) {
    m->bp = bp;
    m->c = (uint32_t)(len == 0 ? 0xff : bp[0]) << 16;
    mq_bytein(m);
    m->c <<= 7;
    m->ct -= 7;
    m->a = 0x8000;
}

#if defined(__GNUC__)
__attribute__((always_inline))
#endif
static inline int mq_decode(mqc *m, int cx) {
    int i = m->idx[cx], d;
    uint32_t qe = J2K_QE[i].qe;
    m->a -= qe;
    if ((m->c >> 16) < qe) {
        if (m->a < qe) {
            d = m->mps[cx];
            m->idx[cx] = J2K_QE[i].nmps;
        } else {
            d = 1 - m->mps[cx];
            if (J2K_QE[i].sw) m->mps[cx] = (uint8_t)(1 - m->mps[cx]);
            m->idx[cx] = J2K_QE[i].nlps;
        }
        m->a = qe;
    } else {
        m->c -= qe << 16;
        if (m->a & 0x8000) return m->mps[cx];
        if (m->a < qe) {
            d = 1 - m->mps[cx];
            if (J2K_QE[i].sw) m->mps[cx] = (uint8_t)(1 - m->mps[cx]);
            m->idx[cx] = J2K_QE[i].nlps;
        } else {
            d = m->mps[cx];
            m->idx[cx] = J2K_QE[i].nmps;
        }
    }
    do {
        if (m->ct == 0) mq_bytein(m);
        m->a <<= 1;
        m->c <<= 1;
        m->ct--;
    } while (m->a < 0x8000);
    return d;
}

static void raw_init(mqc *m, const uint8_t *bp) {
    m->bp = bp;
    m->c = 0;
    m->ct = 0;
}

static inline int raw_decode(mqc *m) {
    if (m->ct == 0) {
        if (m->c == 0xff) {
            if (*m->bp > 0x8f) {
                m->c = 0xff;
                m->ct = 8;
            } else {
                m->c = *m->bp++;
                m->ct = 7;
            }
        } else {
            m->c = *m->bp++;
            m->ct = 8;
        }
    }
    m->ct--;
    return (int)((m->c >> m->ct) & 1);
}

typedef struct {
    int w, h, cols, vsc;
    /* per stripe (one of border above and below) and column (one of
     * border each side), the 4 samples' states together */
    uint16_t *f;
    int32_t *d;         /* h x w */
    const uint8_t *zc;  /* the zero-coding contexts of this orientation */
    const uint16_t *sc; /* sign context | prediction << 8 */
    mqc m;
} t1;

/* zero coding (Table D.1) from the 8 neighbour bits; HL (orient 1) reads
 * vertical neighbours first */
static int zc_context(int nb, int orient) {
    int h = !!(nb & N_W) + !!(nb & N_E);
    int v = !!(nb & N_N) + !!(nb & N_S);
    int d = !!(nb & N_NW) + !!(nb & N_NE) + !!(nb & N_SW) + !!(nb & N_SE);
    if (orient == 3) {
        int hv = h + v;
        if (d == 0) return hv == 0 ? 0 : hv == 1 ? 1 : 2;
        if (d == 1) return hv == 0 ? 3 : hv == 1 ? 4 : 5;
        if (d == 2) return hv == 0 ? 6 : 7;
        return 8;
    }
    if (orient == 1) {
        int tmp = h;
        h = v;
        v = tmp;
    }
    if (h == 0) {
        if (v == 0) return d == 0 ? 0 : d == 1 ? 1 : 2;
        return v == 1 ? 3 : 4;
    }
    if (h == 1) return v == 0 ? (d == 0 ? 5 : 6) : 7;
    return 8;
}

/* sign coding (Table D.3) from the direct neighbours' significance and
 * signs (bits 0-3 and 8-11, packed to 8 bits) -> context | flip << 8 */
static uint16_t sc_context(int bits) {
    int sig = bits & 0xf, neg = bits >> 4;
    int c[4];   /* N, S, W, E */
    for (int i = 0; i < 4; i++)
        c[i] = (sig >> i & 1) ? ((neg >> i & 1) ? -1 : 1) : 0;
    int v = c[0] + c[1], h = c[2] + c[3];
    h = h < -1 ? -1 : h > 1 ? 1 : h;
    v = v < -1 ? -1 : v > 1 ? 1 : v;
    static const int cx[3][3] = {{13, 12, 11}, {10, 9, 10}, {11, 12, 13}};
    int flip = h < 0 || (h == 0 && v < 0);
    return (uint16_t)(cx[h + 1][v + 1] | (flip << 8));
}

static inline uint16_t *fl(const t1 *t, int x, int y) {
    return j2k_t1_state(t->f, t->cols, x, y);
}

static void set_sig(t1 *t, int x, int y, int neg, int32_t oneplushalf) {
    j2k_t1_set_sig(fl(t, x, y), y & 3, t->cols, neg, t->vsc);
    t->d[y * t->w + x] = neg ? -oneplushalf : oneplushalf;
}

static inline void decode_sign(t1 *t, uint16_t *f, int x, int y,
                               int32_t oneplushalf) {
    uint16_t cs = t->sc[j2k_t1_sc_index(*f)];
    int v = mq_decode(&t->m, cs & 0xff) ^ (cs >> 8);
    set_sig(t, x, y, v, oneplushalf);
}

static void sigpass(t1 *t, int bpno, int raw) {
    int32_t one = (int32_t)1 << bpno, oneplushalf = one | (one >> 1);
    for (int k = 0; k < t->h; k += 4) {
        int stop = k + 4 < t->h ? k + 4 : t->h;
        for (int x = 0; x < t->w; x++) {
            uint16_t *f = fl(t, x, k);
            if (!(j2k_t1_column(f) & J2K_X4(N_ANY))) continue;
            for (int y = k; y < stop; y++, f++) {
                if ((*f & (F_SIG | F_VISIT)) || !(*f & N_ANY)) continue;
                if (raw) {
                    if (raw_decode(&t->m))
                        set_sig(t, x, y, raw_decode(&t->m), oneplushalf);
                } else if (mq_decode(&t->m, t->zc[*f & N_ANY])) {
                    decode_sign(t, f, x, y, oneplushalf);
                }
                *f |= F_VISIT;
            }
        }
    }
}

static void refpass(t1 *t, int bpno, int raw) {
    int32_t poshalf = ((int32_t)1 << bpno) >> 1;
    for (int k = 0; k < t->h; k += 4) {
        int stop = k + 4 < t->h ? k + 4 : t->h;
        for (int x = 0; x < t->w; x++) {
            uint16_t *f = fl(t, x, k);
            if (!(j2k_t1_column(f) & J2K_X4(F_SIG))) continue;
            for (int y = k; y < stop; y++, f++) {
                if ((*f & (F_SIG | F_VISIT)) != F_SIG) continue;
                int v;
                if (raw) {
                    v = raw_decode(&t->m);
                } else {
                    int cx = (*f & F_REFINED) ? CX_MAG + 2
                             : (*f & N_ANY) ? CX_MAG + 1 : CX_MAG;
                    v = mq_decode(&t->m, cx);
                }
                int32_t *d = &t->d[y * t->w + x];
                *d += (v ^ (*d < 0)) ? poshalf : -poshalf;
                *f |= F_REFINED;
            }
        }
    }
}

static void clnpass(t1 *t, int bpno, int segsym) {
    int32_t one = (int32_t)1 << bpno, oneplushalf = one | (one >> 1);
    for (int k = 0; k < t->h; k += 4) {
        int stop = k + 4 < t->h ? k + 4 : t->h;
        for (int x = 0; x < t->w; x++) {
            uint16_t *f = fl(t, x, k);
            int y = k;
            /* the run mode: four samples, none significant or visited,
             * none with a significant neighbour */
            if (stop - k == 4 &&
                !(j2k_t1_column(f) & J2K_X4(F_SIG | F_VISIT | N_ANY))) {
                if (!mq_decode(&t->m, CX_AGG)) continue;
                int r = mq_decode(&t->m, CX_UNI) << 1;
                r |= mq_decode(&t->m, CX_UNI);
                y = k + r;
                decode_sign(t, f + r, x, y, oneplushalf);
                y++;
            }
            for (; y < stop; y++) {
                uint16_t *g = f + (y - k);
                if (*g & (F_SIG | F_VISIT)) continue;
                if (mq_decode(&t->m, t->zc[*g & N_ANY]))
                    decode_sign(t, g, x, y, oneplushalf);
            }
            for (int i = 0; i < 4; i++) f[i] &= (uint16_t)~F_VISIT;
        }
    }
    if (segsym) {
        for (int i = 0; i < 4; i++) mq_decode(&t->m, CX_UNI);
    }
}

void j2k_t1_luts(j2k_t1_tables *lut) {
    for (int o = 0; o < 4; o++)
        for (int nb = 0; nb < 256; nb++)
            lut->zc[o][nb] = (uint8_t)zc_context(nb, o);
    for (int b = 0; b < 256; b++) lut->sc[b] = sc_context(b);
}

void j2k_t1_decode_cblk(j2k_ctx *c, const j2k_t1_tables *lut,
                        const j2k_cblk *cb, int orient, int roishift,
                        int cblksty, int32_t *out) {
    t1 t;
    t.w = cb->x1 - cb->x0;
    t.h = cb->y1 - cb->y0;
    t.cols = t.w + 2;
    t.zc = lut->zc[orient];
    t.sc = lut->sc;
    t.vsc = (cblksty & J2K_VSC) != 0;
    t.d = out;
    memset(out, 0, sizeof(int32_t) * (size_t)t.w * (size_t)t.h);
    if (cb->numsegs == 0 || t.w <= 0 || t.h <= 0) return;
    t.f = j2k_alloc(c, sizeof(uint16_t) * 4 * (size_t)t.cols *
                           (size_t)((t.h + 3) / 4 + 2));
    int bpno_plus_one = roishift + cb->numbps;
    if (bpno_plus_one >= 31)
        j2k_fail(c, "JPEG 2000: a code-block of %d bit-planes (more than "
                 "30)", bpno_plus_one);
    /* a segment followed by the 0xFF 0xFF OpenJPEG appends */
    size_t maxlen = 0;
    for (int s = 0; s < cb->numsegs; s++)
        if (cb->segs[s].len > maxlen) maxlen = cb->segs[s].len;
    uint8_t *seg = j2k_alloc(c, maxlen + 2);
    mq_reset(&t.m);
    int passtype = 2;
    size_t off = 0;
    for (int s = 0; s < cb->numsegs; s++) {
        const j2k_seg *sg = &cb->segs[s];
        int raw = (cblksty & J2K_LAZY) && passtype < 2 &&
                  bpno_plus_one <= cb->numbps - 4;
        if (sg->len) memcpy(seg, cb->data.data + off, sg->len);
        seg[sg->len] = 0xff;
        seg[sg->len + 1] = 0xff;
        off += sg->len;
        if (raw)
            raw_init(&t.m, seg);
        else
            mq_init(&t.m, seg, sg->len);
        for (int p = 0; p < sg->numpasses && bpno_plus_one >= 1; p++) {
            if (passtype == 0)
                sigpass(&t, bpno_plus_one, raw);
            else if (passtype == 1)
                refpass(&t, bpno_plus_one, raw);
            else
                clnpass(&t, bpno_plus_one, (cblksty & J2K_SEGSYM) != 0);
            if ((cblksty & J2K_RESET) && !raw) mq_reset(&t.m);
            if (++passtype == 3) {
                passtype = 0;
                bpno_plus_one--;
            }
        }
    }
    j2k_free(c, seg);
    j2k_free(c, t.f);
    if (roishift) {
        size_t n = (size_t)t.w * (size_t)t.h;
        if (roishift >= 31) {
            memset(out, 0, n * sizeof(int32_t));
        } else {
            int32_t thresh = (int32_t)1 << roishift;
            for (size_t i = 0; i < n; i++) {
                int32_t v = out[i], mag = v < 0 ? -v : v;
                if (mag >= thresh) {
                    mag >>= roishift;
                    out[i] = v < 0 ? -mag : mag;
                }
            }
        }
    }
}
