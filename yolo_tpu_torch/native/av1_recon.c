/* AV1 intra reconstruction: dequantization (the DC / AC lookups at the
 * block's qindex, quantizer matrices on 2-D transforms, the 64-point
 * scale and clamps), the inverse transforms (DCT 4-64, ADST 4-16, their
 * flips and the identity, with libaom's intermediate rounding, shifts and
 * 16-bit clamps), intra prediction (DC, directional with angle deltas,
 * edge filter and upsampling, smooth, Paeth, filter intra, the edge rules
 * at frame and tile borders) and chroma from luma.
 * Plain C11. */

#include <stdlib.h>
#include <string.h>

#include "av1.h"
#include "av1_tables.h"

#define LO (-32768)
#define HI 32767

static inline int32_t clamp16(int64_t v) {
    return (int32_t)(v < LO ? LO : v > HI ? HI : v);
}

static inline int32_t rs(int64_t v, int bits) {
    return (int32_t)((v + ((int64_t)1 << (bits - 1))) >> bits);
}

static inline int32_t hb(int w0, int32_t x0, int w1, int32_t x1) {
    return rs((int64_t)w0 * x0 + (int64_t)w1 * x1, 12);
}

static inline int cosv(int a) {
    return a >= 0 ? av1_cospi[a] : -av1_cospi[-a];
}

/* the bits of x < 64 in reverse order */
static const uint8_t brev6[64] = {
    0, 32, 16, 48, 8, 40, 24, 56, 4, 36, 20, 52, 12, 44, 28, 60,
    2, 34, 18, 50, 10, 42, 26, 58, 6, 38, 22, 54, 14, 46, 30, 62,
    1, 33, 17, 49, 9, 41, 25, 57, 5, 37, 21, 53, 13, 45, 29, 61,
    3, 35, 19, 51, 11, 43, 27, 59, 7, 39, 23, 55, 15, 47, 31, 63 };

static inline int brev(int n, int x) { return brev6[x] >> (6 - n); }

/* --- inverse transforms -------------------------------------------------- */

/* libaom's inverse DCT of n (4-64) points: the even half is the DCT of
 * n / 2 points, the odd half a rotation stage, then butterfly and
 * rotation stages of growing span, then the final butterflies */
static void idct(int32_t *x, int n) {
    int32_t t[32], b[32], o[32];
    if (n == 4) {
        int32_t a0 = hb(av1_cospi[32], x[0], av1_cospi[32], x[2]);
        int32_t a1 = hb(av1_cospi[32], x[0], -av1_cospi[32], x[2]);
        int32_t a2 = hb(av1_cospi[48], x[1], -av1_cospi[16], x[3]);
        int32_t a3 = hb(av1_cospi[16], x[1], av1_cospi[48], x[3]);
        x[0] = clamp16((int64_t)a0 + a3);
        x[1] = clamp16((int64_t)a1 + a2);
        x[2] = clamp16((int64_t)a1 - a2);
        x[3] = clamp16((int64_t)a0 - a3);
        return;
    }
    int m = n / 2, lg = 0;
    while ((1 << lg) < n) lg++;
    for (int i = 0; i < m; i++) t[i] = x[2 * i];
    for (int i = 0; i < m; i++) b[i] = x[brev(lg, m + i)];
    idct(t, m);
    memcpy(o, b, sizeof(int32_t) * m);
    for (int i = 0; i < m / 2; i++) {
        int th = 64 * brev(lg, m + i) / n, j = m - 1 - i;
        o[i] = hb(cosv(64 - th), b[i], -cosv(th), b[j]);
        o[j] = hb(cosv(th), b[i], cosv(64 - th), b[j]);
    }
    memcpy(b, o, sizeof(int32_t) * m);
    for (int lv = 1; (1 << lv) < m; lv++) {
        int g = 1 << lv;
        for (int s = 0; s < m; s += g) {
            for (int k = 0; k < g / 2; k++) {
                int64_t a = b[s + k], e = b[s + g - 1 - k];
                if ((s / g) % 2 == 0) {
                    o[s + k] = clamp16(a + e);
                    o[s + g - 1 - k] = clamp16(a - e);
                } else {
                    o[s + k] = clamp16(e - a);
                    o[s + g - 1 - k] = clamp16(a + e);
                }
            }
        }
        memcpy(b, o, sizeof(int32_t) * m);
        int p = m / g, pl = 0;
        while ((1 << pl) < p) pl++;
        for (int s = 0; s < m / 2; s += 2 * g) {
            int th = p > 2 ? (64 / p) * brev(pl, p / 2 + s / (2 * g)) : 32;
            for (int i = s + g / 2; i < s + g; i++) {
                int j = m - 1 - i;
                o[i] = hb(-cosv(th), b[i], cosv(64 - th), b[j]);
                o[j] = hb(cosv(64 - th), b[i], cosv(th), b[j]);
            }
            for (int i = s + g; i < s + g + g / 2 && i < m / 2; i++) {
                int j = m - 1 - i;
                o[i] = hb(-cosv(64 - th), b[i], -cosv(th), b[j]);
                o[j] = hb(-cosv(th), b[i], cosv(64 - th), b[j]);
            }
        }
        memcpy(b, o, sizeof(int32_t) * m);
    }
    for (int i = 0; i < m; i++) {
        x[i] = clamp16((int64_t)t[i] + b[m - 1 - i]);
        x[n - 1 - i] = clamp16((int64_t)t[i] - b[m - 1 - i]);
    }
}

static void iadst4(int32_t *x) {
    int32_t x0 = x[0], x1 = x[1], x2 = x[2], x3 = x[3];
    if (!(x0 | x1 | x2 | x3)) return;
    const int32_t *sp = av1_sinpi;
    int64_t s0 = (int64_t)sp[1] * x0, s1 = (int64_t)sp[2] * x0;
    int64_t s2 = (int64_t)sp[3] * x1, s3 = (int64_t)sp[4] * x2;
    int64_t s4 = (int64_t)sp[1] * x2, s5 = (int64_t)sp[2] * x3;
    int64_t s6 = (int64_t)sp[4] * x3;
    int32_t s7 = x0 - x2 + x3;
    s0 = s0 + s3;
    s1 = s1 - s4;
    s3 = s2;
    s2 = (int64_t)sp[3] * s7;
    s0 = s0 + s5;
    s1 = s1 - s6;
    x[0] = rs(s0 + s3, 12);
    x[1] = rs(s1 + s3, 12);
    x[2] = rs(s2, 12);
    x[3] = rs(s0 + s1 - s3, 12);
}

/* libaom's 8- and 16-point inverse ADST */
static void iadst816(int32_t *x, int n) {
    int32_t b[16], o[16];
    for (int k = 0; k < n / 2; k++) {
        b[2 * k] = x[n - 1 - 2 * k];
        b[2 * k + 1] = x[2 * k];
    }
    for (int k = 0; k < n / 2; k++) {
        int a = (n == 16 ? 2 : 4) + (n == 16 ? 8 : 16) * k;
        o[2 * k] = hb(av1_cospi[a], b[2 * k], av1_cospi[64 - a], b[2 * k + 1]);
        o[2 * k + 1] =
            hb(av1_cospi[64 - a], b[2 * k], -av1_cospi[a], b[2 * k + 1]);
    }
    memcpy(b, o, sizeof(int32_t) * n);
    /* butterflies across halves of blocks of h * 2, then rotations on
     * the second halves: (8, 56) / (40, 24) at 16 points, (16, 48), (32) */
    for (int h = n / 2; h >= 2; h /= 2) {
        for (int s = 0; s < n; s += 2 * h) {
            for (int i = 0; i < h; i++) {
                o[s + i] = clamp16((int64_t)b[s + i] + b[s + i + h]);
                o[s + i + h] = clamp16((int64_t)b[s + i] - b[s + i + h]);
            }
        }
        memcpy(b, o, sizeof(int32_t) * n);
        for (int s = 0; s < n; s += 2 * h) {
            int q = s + h;              /* the rotated half */
            if (h == 1) break;
            if (h == 2) {
                o[q] = hb(av1_cospi[32], b[q], av1_cospi[32], b[q + 1]);
                o[q + 1] = hb(av1_cospi[32], b[q], -av1_cospi[32], b[q + 1]);
            } else if (h == 4) {
                o[q] = hb(av1_cospi[16], b[q], av1_cospi[48], b[q + 1]);
                o[q + 1] = hb(av1_cospi[48], b[q], -av1_cospi[16], b[q + 1]);
                o[q + 2] = hb(-av1_cospi[48], b[q + 2], av1_cospi[16], b[q + 3]);
                o[q + 3] = hb(av1_cospi[16], b[q + 2], av1_cospi[48], b[q + 3]);
            } else {                    /* h == 8, n == 16 */
                o[q] = hb(av1_cospi[8], b[q], av1_cospi[56], b[q + 1]);
                o[q + 1] = hb(av1_cospi[56], b[q], -av1_cospi[8], b[q + 1]);
                o[q + 2] = hb(av1_cospi[40], b[q + 2], av1_cospi[24], b[q + 3]);
                o[q + 3] = hb(av1_cospi[24], b[q + 2], -av1_cospi[40], b[q + 3]);
                o[q + 4] = hb(-av1_cospi[56], b[q + 4], av1_cospi[8], b[q + 5]);
                o[q + 5] = hb(av1_cospi[8], b[q + 4], av1_cospi[56], b[q + 5]);
                o[q + 6] = hb(-av1_cospi[24], b[q + 6], av1_cospi[40], b[q + 7]);
                o[q + 7] = hb(av1_cospi[40], b[q + 6], av1_cospi[24], b[q + 7]);
            }
        }
        memcpy(b, o, sizeof(int32_t) * n);
    }
    static const int8_t idx8[8] = { 0, 4, 6, 2, 3, 7, 5, 1 };
    static const int8_t idx16[16] = { 0, 8, 12, 4, 6, 14, 10, 2,
                                      3, 11, 15, 7, 5, 13, 9, 1 };
    const int8_t *idx = n == 8 ? idx8 : idx16;
    for (int i = 0; i < n; i++) x[i] = (i & 1) ? -b[idx[i]] : b[idx[i]];
}

static void iidentity(int32_t *x, int n) {
    for (int i = 0; i < n; i++) {
        if (n == 4) x[i] = rs((int64_t)5793 * x[i], 12);
        else if (n == 8) x[i] = x[i] * 2;
        else if (n == 16) x[i] = rs((int64_t)2 * 5793 * x[i], 12);
        else x[i] = x[i] * 4;
    }
}

/* 1-D types of av1_vtx_1d / av1_htx_1d: 0 DCT, 1 ADST, 2 identity */
static void tx1d(int32_t *x, int n, int type) {
    if (type == 2) iidentity(x, n);
    else if (type == 1) n == 4 ? iadst4(x) : iadst816(x, n);
    else idct(x, n);
}

static void inverse_transform(av1_dec *d, int plane, int x0, int y0, int t,
                              int type, const int32_t *in) {
    int lw = av1_tx_w_log2[t], lh = av1_tx_h_log2[t];
    int w = 1 << lw, h = 1 << lh;
    int rect = abs(lw - lh) == 1;
    int shift = av1_inv_row_shift[t];
    int vt = av1_vtx_1d[type], ht = av1_htx_1d[type];
    int ud = type == FLIPADST_DCT || type == FLIPADST_FLIPADST ||
             type == FLIPADST_ADST || type == V_FLIPADST;
    int lr = type == DCT_FLIPADST || type == FLIPADST_FLIPADST ||
             type == ADST_FLIPADST || type == H_FLIPADST;
    int32_t *buf = d->tbuf;
    int32_t tmp[64];
    int cw = w > 32 ? 32 : w;
    for (int r = 0; r < h; r++) {
        int nz = 0;
        for (int c = 0; c < w; c++) {
            int64_t v = (r < 32 && c < 32) ? in[r * cw + c] : 0;
            if (rect) v = rs(v * 2896, 12);
            tmp[c] = clamp16(v);
            nz |= tmp[c];
        }
        if (!nz) {                /* every 1-D transform maps 0 to 0 */
            memset(buf + r * w, 0, sizeof(int32_t) * (size_t)w);
            continue;
        }
        tx1d(tmp, w, ht);
        for (int c = 0; c < w; c++)
            buf[r * w + c] = shift ? rs(tmp[c], shift) : tmp[c];
    }
    uint8_t *dst = d->plane[plane] + (size_t)y0 * d->stride[plane] + x0;
    int stride = d->stride[plane];
    for (int c = 0; c < w; c++) {
        int cc = lr ? w - 1 - c : c;
        for (int r = 0; r < h; r++) tmp[r] = clamp16(buf[r * w + cc]);
        tx1d(tmp, h, vt);
        for (int r = 0; r < h; r++) {
            int v = rs(tmp[ud ? h - 1 - r : r], 4) + dst[r * stride + c];
            dst[r * stride + c] = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
        }
    }
}

void av1_reconstruct(av1_dec *d, int plane, int x, int y, int t, int type,
                     int eob) {
    (void)eob;
    int lw = av1_tx_w_log2[t], lh = av1_tx_h_log2[t];
    int w = 1 << lw, h = 1 << lh;
    int tw = w > 32 ? 32 : w, th = h > 32 ? 32 : h;
    int pels = w * h, dqshift = (pels > 256) + (pels > 1024);
    int q = d->cur_q, dc, ac;
    if (plane == 0) {
        dc = av1_dc_qlookup[av1_clip3(0, 255, q + d->dq_ydc)];
        ac = av1_ac_qlookup[q];
    } else if (plane == 1) {
        dc = av1_dc_qlookup[av1_clip3(0, 255, q + d->dq_udc)];
        ac = av1_ac_qlookup[av1_clip3(0, 255, q + d->dq_uac)];
    } else {
        dc = av1_dc_qlookup[av1_clip3(0, 255, q + d->dq_vdc)];
        ac = av1_ac_qlookup[av1_clip3(0, 255, q + d->dq_vac)];
    }
    const uint8_t *qm = NULL;
    if (d->using_qm && d->qm[plane] < 15 && type < IDTX)
        qm = av1_qm[d->qm[plane]][plane > 0] + av1_qm_offset[t];
    int32_t *deq = d->deq;
    for (int i = 0; i < tw * th; i++) {
        int32_t v = d->coef[i];
        if (!v) {
            deq[i] = 0;
            continue;
        }
        int dqv = i == 0 ? dc : ac;
        if (qm) dqv = (qm[i] * dqv + 16) >> 5;
        int64_t a = v < 0 ? -(int64_t)v : v;
        int64_t r = ((a * dqv) & 0xffffff) >> dqshift;
        if (v < 0) r = -r;
        deq[i] = clamp16(r);
    }
    inverse_transform(d, plane, x, y, t, type, deq);
}

/* --- intra prediction ---------------------------------------------------- */

static int is_smooth_mode(int m) {
    return m == AV1_SMOOTH || m == AV1_SMOOTH_V || m == AV1_SMOOTH_H;
}

static int filter_type(av1_dec *d, int plane) {
    int r = d->mi_row, c = d->mi_col, smooth = 0;
    if (plane == 0 ? d->avail_u : d->avail_uc) {
        int rr = r - 1, cc = c;
        if (plane) {
            if (d->ss_x && !(c & 1)) cc++;
            if (d->ss_y && (r & 1)) rr--;
        }
        av1_mi *m = &d->mi[(size_t)rr * d->mi_cols + cc];
        smooth |= is_smooth_mode(plane ? m->uvmode : m->ymode);
    }
    if (plane == 0 ? d->avail_l : d->avail_lc) {
        int rr = r, cc = c - 1;
        if (plane) {
            if (d->ss_x && (c & 1)) cc--;
            if (d->ss_y && !(r & 1)) rr++;
        }
        av1_mi *m = &d->mi[(size_t)rr * d->mi_cols + cc];
        smooth |= is_smooth_mode(plane ? m->uvmode : m->ymode);
    }
    return smooth;
}

static int edge_strength(int w, int h, int delta, int type) {
    int d = abs(delta), wh = w + h, s = 0;
    if (type == 0) {
        if (wh <= 8) {
            if (d >= 56) s = 1;
        } else if (wh <= 12) {
            if (d >= 40) s = 1;
        } else if (wh <= 16) {
            if (d >= 40) s = 1;
        } else if (wh <= 24) {
            if (d >= 8) s = 1;
            if (d >= 16) s = 2;
            if (d >= 32) s = 3;
        } else if (wh <= 32) {
            if (d >= 1) s = 1;
            if (d >= 4) s = 2;
            if (d >= 32) s = 3;
        } else {
            if (d >= 1) s = 3;
        }
    } else {
        if (wh <= 8) {
            if (d >= 40) s = 1;
            if (d >= 64) s = 2;
        } else if (wh <= 16) {
            if (d >= 20) s = 1;
            if (d >= 48) s = 2;
        } else if (wh <= 24) {
            if (d >= 4) s = 3;
        } else {
            if (d >= 1) s = 3;
        }
    }
    return s;
}

static int use_upsample(int w, int h, int delta, int type) {
    int d = abs(delta), wh = w + h;
    if (d <= 0 || d >= 40) return 0;
    return type ? wh <= 8 : wh <= 16;
}

/* p points at edge[0]; filters p[-1 .. sz - 2] */
static void filter_edge(int *p, int sz, int strength) {
    static const int k[3][5] = { { 0, 4, 8, 4, 0 }, { 0, 5, 6, 5, 0 },
                                 { 2, 4, 4, 4, 2 } };
    if (!strength) return;
    int e[160];
    for (int i = 0; i < sz; i++) e[i] = p[i - 1];
    for (int i = 1; i < sz; i++) {
        int s = 0;
        for (int j = 0; j < 5; j++) {
            int kk = av1_clip3(0, sz - 1, i - 2 + j);
            s += k[strength - 1][j] * e[kk];
        }
        p[i - 1] = (s + 8) >> 4;
    }
}

static void upsample_edge(int *p, int sz) {
    int in[72];
    in[0] = p[-1];
    in[1] = p[-1];
    for (int i = 0; i < sz; i++) in[i + 2] = p[i];
    in[sz + 2] = p[sz - 1];
    p[-2] = in[0];
    for (int i = 0; i < sz; i++) {
        int s = -in[i] + 9 * in[i + 1] + 9 * in[i + 2] - in[i + 3];
        s = (s + 8) >> 4;
        p[2 * i - 1] = s < 0 ? 0 : s > 255 ? 255 : s;
        p[2 * i] = in[i + 2];
    }
}

void av1_predict_intra(av1_dec *d, int plane, int x, int y, int have_left,
                       int have_above, int have_ar, int have_bl, int mode,
                       int lw, int lh) {
    int w = 1 << lw, h = 1 << lh;
    int sx = plane ? d->ss_x : 0, sy = plane ? d->ss_y : 0;
    int maxx = ((d->mi_cols * 4) >> sx) - 1, maxy = ((d->mi_rows * 4) >> sy) - 1;
    int stride = d->stride[plane];
    uint8_t *f = d->plane[plane];
    uint8_t *dst = f + (size_t)y * stride + x;
    int above_buf[160], left_buf[160];
    int *above = above_buf + 16, *left = left_buf + 16;
    int n = w + h;
    if (!have_above && have_left) {
        for (int i = -1; i < n; i++) above[i] = f[(size_t)y * stride + x - 1];
    } else if (!have_above && !have_left) {
        for (int i = -1; i < n; i++) above[i] = 127;
    } else {
        int lim = x + (have_ar ? 2 * w : w) - 1;
        if (lim > maxx) lim = maxx;
        for (int i = 0; i < n; i++) {
            int xx = x + i > lim ? lim : x + i;
            above[i] = f[(size_t)(y - 1) * stride + xx];
        }
    }
    if (!have_left && have_above) {
        for (int i = -1; i < n; i++) left[i] = f[(size_t)(y - 1) * stride + x];
    } else if (!have_left && !have_above) {
        for (int i = -1; i < n; i++) left[i] = 129;
    } else {
        int lim = y + (have_bl ? 2 * h : h) - 1;
        if (lim > maxy) lim = maxy;
        for (int i = 0; i < n; i++) {
            int yy = y + i > lim ? lim : y + i;
            left[i] = f[(size_t)yy * stride + x - 1];
        }
    }
    int corner;
    if (have_above && have_left) corner = f[(size_t)(y - 1) * stride + x - 1];
    else if (have_above) corner = f[(size_t)(y - 1) * stride + x];
    else if (have_left) corner = f[(size_t)y * stride + x - 1];
    else corner = 128;
    above[-1] = left[-1] = corner;

    if (plane == 0 && d->use_fi) {
        int (*pred)[64] = d->fipred;
        int taps_mode = d->fi_mode;
        for (int i2 = 0; i2 < h / 2; i2++) {
            for (int j4 = 0; j4 < w / 4; j4++) {
                int p[7];
                for (int i = 0; i < 7; i++) {
                    if (i < 5) {
                        if (i2 == 0)
                            p[i] = above[(j4 << 2) + i - 1];
                        else if (j4 == 0 && i == 0)
                            p[i] = left[(i2 << 1) - 1];
                        else
                            p[i] = pred[(i2 << 1) - 1][(j4 << 2) + i - 1];
                    } else {
                        if (j4 == 0)
                            p[i] = left[(i2 << 1) + i - 5];
                        else
                            p[i] = pred[(i2 << 1) + i - 5][(j4 << 2) - 1];
                    }
                }
                for (int i = 0; i < 8; i++) {
                    int pr = 0;
                    for (int j = 0; j < 7; j++)
                        pr += av1_filter_intra_taps[taps_mode][i][j] * p[j];
                    int v = pr >= 0 ? (pr + 8) >> 4 : -((-pr + 8) >> 4);
                    pred[(i2 << 1) + (i >> 2)][(j4 << 2) + (i & 3)] =
                        v < 0 ? 0 : v > 255 ? 255 : v;
                }
            }
        }
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++) dst[i * stride + j] = (uint8_t)pred[i][j];
        return;
    }
    if (mode >= AV1_V && mode <= AV1_D67) {
        int delta = plane ? d->angle_uv : d->angle_y;
        int pa = av1_mode_to_angle[mode] + delta * 3;
        int up_a = 0, up_l = 0;
        if (d->edge_filter) {
            int ft = filter_type(d, plane);
            if (pa != 90 && pa != 180) {
                if (pa > 90 && pa < 180 && w + h >= 24) {
                    int s = left[0] * 5 + above[-1] * 6 + above[0] * 5;
                    above[-1] = left[-1] = (s + 8) >> 4;
                }
                if (have_above) {
                    int st = edge_strength(w, h, pa - 90, ft);
                    int npx = (w < maxx - x + 1 ? w : maxx - x + 1) +
                              (pa < 90 ? h : 0) + 1;
                    filter_edge(above, npx, st);
                }
                if (have_left) {
                    int st = edge_strength(w, h, pa - 180, ft);
                    int npx = (h < maxy - y + 1 ? h : maxy - y + 1) +
                              (pa > 180 ? w : 0) + 1;
                    filter_edge(left, npx, st);
                }
            }
            up_a = use_upsample(w, h, pa - 90, ft);
            if (up_a) upsample_edge(above, w + (pa < 90 ? h : 0));
            up_l = use_upsample(w, h, pa - 180, ft);
            if (up_l) upsample_edge(left, h + (pa > 180 ? w : 0));
        }
        int dx = 0, dy = 0;
        if (pa < 90) dx = av1_dr_intra_derivative[pa];
        else if (pa > 90 && pa < 180) dx = av1_dr_intra_derivative[180 - pa];
        if (pa > 90 && pa < 180) dy = av1_dr_intra_derivative[pa - 90];
        else if (pa > 180) dy = av1_dr_intra_derivative[270 - pa];
        for (int i = 0; i < h; i++) {
            for (int j = 0; j < w; j++) {
                int v;
                if (pa < 90) {
                    int idx = (i + 1) * dx;
                    int base = (idx >> (6 - up_a)) + (j << up_a);
                    int sh = ((idx << up_a) >> 1) & 0x1f;
                    int maxb = (w + h - 1) << up_a;
                    if (base < maxb)
                        v = (above[base] * (32 - sh) + above[base + 1] * sh + 16) >> 5;
                    else
                        v = above[maxb];
                } else if (pa > 90 && pa < 180) {
                    int idx = (j << 6) - (i + 1) * dx;
                    int base = idx >> (6 - up_a);
                    if (base >= -(1 << up_a)) {
                        int sh = ((idx * (1 << up_a)) >> 1) & 0x1f;
                        v = (above[base] * (32 - sh) + above[base + 1] * sh + 16) >> 5;
                    } else {
                        idx = (i << 6) - (j + 1) * dy;
                        base = idx >> (6 - up_l);
                        int sh = ((idx * (1 << up_l)) >> 1) & 0x1f;
                        v = (left[base] * (32 - sh) + left[base + 1] * sh + 16) >> 5;
                    }
                } else if (pa > 180) {
                    int idx = (j + 1) * dy;
                    int base = (idx >> (6 - up_l)) + (i << up_l);
                    int sh = ((idx << up_l) >> 1) & 0x1f;
                    int maxb = (w + h - 1) << up_l;
                    if (base < maxb)
                        v = (left[base] * (32 - sh) + left[base + 1] * sh + 16) >> 5;
                    else
                        v = left[maxb];
                } else if (pa == 90) {
                    v = above[j];
                } else {
                    v = left[i];
                }
                dst[i * stride + j] = (uint8_t)v;
            }
        }
        return;
    }
    if (mode == AV1_SMOOTH || mode == AV1_SMOOTH_V || mode == AV1_SMOOTH_H) {
        const uint8_t *wx = av1_smooth_weights + w - 4;
        const uint8_t *wy = av1_smooth_weights + h - 4;
        for (int i = 0; i < h; i++) {
            for (int j = 0; j < w; j++) {
                int v;
                if (mode == AV1_SMOOTH)
                    v = (wy[i] * above[j] + (256 - wy[i]) * left[h - 1] +
                         wx[j] * left[i] + (256 - wx[j]) * above[w - 1] + 256) >> 9;
                else if (mode == AV1_SMOOTH_V)
                    v = (wy[i] * above[j] + (256 - wy[i]) * left[h - 1] + 128) >> 8;
                else
                    v = (wx[j] * left[i] + (256 - wx[j]) * above[w - 1] + 128) >> 8;
                dst[i * stride + j] = (uint8_t)v;
            }
        }
        return;
    }
    if (mode == AV1_PAETH) {
        for (int i = 0; i < h; i++) {
            for (int j = 0; j < w; j++) {
                int base = above[j] + left[i] - above[-1];
                int pl = abs(base - left[i]), pt = abs(base - above[j]);
                int ptl = abs(base - above[-1]);
                int v = (pl <= pt && pl <= ptl) ? left[i]
                        : pt <= ptl              ? above[j]
                                                 : above[-1];
                dst[i * stride + j] = (uint8_t)v;
            }
        }
        return;
    }
    /* DC */
    int avg;
    if (have_left && have_above) {
        int s = 0;
        for (int j = 0; j < w; j++) s += above[j];
        for (int i = 0; i < h; i++) s += left[i];
        avg = (s + ((w + h) >> 1)) / (w + h);
    } else if (have_left) {
        int s = 0;
        for (int i = 0; i < h; i++) s += left[i];
        avg = (s + (h >> 1)) >> lh;
    } else if (have_above) {
        int s = 0;
        for (int j = 0; j < w; j++) s += above[j];
        avg = (s + (w >> 1)) >> lw;
    } else {
        avg = 128;
    }
    for (int i = 0; i < h; i++) memset(dst + i * stride, avg, (size_t)w);
}

void av1_predict_palette(av1_dec *d, int plane, int x, int y, int bx,
                         int by, int t) {
    int w = 1 << av1_tx_w_log2[t], h = 1 << av1_tx_h_log2[t];
    const uint8_t (*m)[64] = (const uint8_t (*)[64])d->cmap[plane > 0];
    uint8_t *dst = d->plane[plane] + (size_t)y * d->stride[plane] + x;
    for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++)
            dst[i * d->stride[plane] + j] =
                d->pal[plane][m[by * 4 + i][bx * 4 + j]];
}

/* intra block copy: each plane's block from the frame decoded so far at
 * the DV (luma whole samples; 4:2:0 chroma at half samples averages two
 * or four, the bilinear filter's rounding); a 4-wide or 4-high block's
 * chroma covers its 8x8, as libaom predicts it */
void av1_predict_intrabc(av1_dec *d) {
    for (int p = 0; p < (d->has_chroma ? 3 : 1); p++) {
        int sx = p ? d->ss_x : 0, sy = p ? d->ss_y : 0;
        int w = (d->bw4 * 4) >> sx, h = (d->bh4 * 4) >> sy;
        if (w < 4) w = 4;
        if (h < 4) h = 4;
        int x0 = (d->mi_col >> sx) * 4, y0 = (d->mi_row >> sy) * 4;
        int fx = d->dv[1] * (p ? 1 : 2), fy = d->dv[0] * (p ? 1 : 2);
        int ix = x0 + (fx >> 4), iy = y0 + (fy >> 4);   /* 1/16 samples */
        int hx = (fx & 15) != 0, hy = (fy & 15) != 0;
        int pw = d->pw[p], ph = d->ph[p], st = d->stride[p];
        uint8_t *f = d->plane[p];
        if (ix < 0 || iy < 0 || ix + w + hx > pw || iy + h + hy > ph)
            av1_fail(d, "an intra block copy from outside the frame");
        uint8_t *dst = f + (size_t)y0 * st + x0;
        const uint8_t *src = f + (size_t)iy * st + ix;
        for (int i = 0; i < h; i++) {
            for (int j = 0; j < w; j++) {
                const uint8_t *q = src + (size_t)i * st + j;
                int v;
                if (hx && hy) v = (q[0] + q[1] + q[st] + q[st + 1] + 2) >> 2;
                else if (hx) v = (q[0] + q[1] + 1) >> 1;
                else if (hy) v = (q[0] + q[st] + 1) >> 1;
                else v = q[0];
                dst[(size_t)i * st + j] = (uint8_t)v;
            }
        }
    }
}

void av1_predict_cfl(av1_dec *d, int plane, int x, int y, int t) {
    int lw = av1_tx_w_log2[t], lh = av1_tx_h_log2[t];
    int w = 1 << lw, h = 1 << lh, sx = d->ss_x, sy = d->ss_y;
    int alpha = plane == 1 ? d->cfl_u : d->cfl_v;
    int L[32][32];
    int sum = 0;
    int vw = (d->max_luma_w - (x << sx)) >> sx;
    int vh = (d->max_luma_h - (y << sy)) >> sy;
    const uint8_t *luma = d->plane[0];
    int ls = d->stride[0];
    for (int i = 0; i < h; i++) {
        int ly = (y << sy) + ((i < vh ? i : vh - 1) << sy);
        for (int j = 0; j < w; j++) {
            int lx = (x << sx) + ((j < vw ? j : vw - 1) << sx);
            int s = 0;
            for (int dy = 0; dy <= sy; dy++)
                for (int dx = 0; dx <= sx; dx++)
                    s += luma[(size_t)(ly + dy) * ls + lx + dx];
            L[i][j] = s << (3 - sx - sy);
            sum += L[i][j];
        }
    }
    int avg = (sum + (1 << (lw + lh - 1))) >> (lw + lh);
    uint8_t *dst = d->plane[plane] + (size_t)y * d->stride[plane] + x;
    for (int i = 0; i < h; i++) {
        for (int j = 0; j < w; j++) {
            int sc = alpha * (L[i][j] - avg);
            sc = sc >= 0 ? (sc + 32) >> 6 : -((-sc + 32) >> 6);
            int v = dst[i * d->stride[plane] + j] + sc;
            dst[i * d->stride[plane] + j] = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
        }
    }
}
