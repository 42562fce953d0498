/* AV1's in-loop filters for the port's AVIF decoder, and the colour step:
 *
 *   * deblocking (the 4-, 6-, 8- and 14-tap filters of libaom's
 *     loopfilter.c at every transform edge, vertical edges of the frame
 *     first, the level of each plane and direction with the intra ref
 *     delta that loop_filter_delta_enabled adds, the sharpness limits);
 *   * CDEF (libaom's direction search, primary and secondary taps with
 *     damping, the variance-adjusted luma strength, skipped 8x8 blocks
 *     and 64x64 units left as they are, pixels outside the frame unused);
 *   * yolo_avif_yuv_to_rgb: 8-bit 4:2:0 to RGB as libavif 1.4.2 runs it
 *     through libyuv: bilinear chroma upsampling (ScaleRowUp2_Linear /
 *     _Bilinear with their edge columns and rows) and YuvPixel's 6-bit
 *     fixed point, BT.601 full range (kYuvJPEGConstants).
 * Plain C11. */

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "av1.h"
#include "av1_tables.h"
#include "native.h"

/* --- deblocking ---------------------------------------------------------- */

static inline int clamp_s8(int t) { return t < -128 ? -128 : t > 127 ? 127 : t; }

static void filter4(int mask, int thresh, uint8_t *op1, uint8_t *op0,
                    uint8_t *oq0, uint8_t *oq1) {
    int ps1 = *op1 - 128, ps0 = *op0 - 128, qs0 = *oq0 - 128, qs1 = *oq1 - 128;
    int hev = abs(*op1 - *op0) > thresh || abs(*oq1 - *oq0) > thresh;
    int f = hev ? clamp_s8(ps1 - qs1) : 0;
    f = mask ? clamp_s8(f + 3 * (qs0 - ps0)) : 0;
    int f1 = clamp_s8(f + 4) >> 3, f2 = clamp_s8(f + 3) >> 3;
    *oq0 = (uint8_t)(clamp_s8(qs0 - f1) + 128);
    *op0 = (uint8_t)(clamp_s8(ps0 + f2) + 128);
    f = hev ? 0 : (f1 + 1) >> 1;
    *oq1 = (uint8_t)(clamp_s8(qs1 - f) + 128);
    *op1 = (uint8_t)(clamp_s8(ps1 + f) + 128);
}

#define R3(v) (((v) + 4) >> 3)
#define R4(v) (((v) + 8) >> 4)

/* one line across an edge: s[0] is q0, s[-step] p0 */
static void lf_line(uint8_t *s, int step, int len, int lim, int blim,
                    int thr) {
    int p[7], q[7];
    int n = len == 14 ? 7 : len == 8 ? 4 : len == 6 ? 3 : 2;
    for (int i = 0; i < n; i++) {
        p[i] = s[-(i + 1) * step];
        q[i] = s[i * step];
    }
    int mask;
    if (len == 4) {
        mask = abs(p[1] - p[0]) <= lim && abs(q[1] - q[0]) <= lim &&
               abs(p[0] - q[0]) * 2 + abs(p[1] - q[1]) / 2 <= blim;
        filter4(mask, thr, s - 2 * step, s - step, s, s + step);
        return;
    }
    if (len == 6) {
        mask = abs(p[2] - p[1]) <= lim && abs(p[1] - p[0]) <= lim &&
               abs(q[1] - q[0]) <= lim && abs(q[2] - q[1]) <= lim &&
               abs(p[0] - q[0]) * 2 + abs(p[1] - q[1]) / 2 <= blim;
        int flat = abs(p[1] - p[0]) <= 1 && abs(q[1] - q[0]) <= 1 &&
                   abs(p[2] - p[0]) <= 1 && abs(q[2] - q[0]) <= 1;
        if (flat && mask) {
            s[-2 * step] = (uint8_t)R3(p[2] * 3 + p[1] * 2 + p[0] * 2 + q[0]);
            s[-step] = (uint8_t)R3(p[2] + p[1] * 2 + p[0] * 2 + q[0] * 2 + q[1]);
            s[0] = (uint8_t)R3(p[1] + p[0] * 2 + q[0] * 2 + q[1] * 2 + q[2]);
            s[step] = (uint8_t)R3(p[0] + q[0] * 2 + q[1] * 2 + q[2] * 3);
        } else {
            filter4(mask, thr, s - 2 * step, s - step, s, s + step);
        }
        return;
    }
    mask = abs(p[3] - p[2]) <= lim && abs(p[2] - p[1]) <= lim &&
           abs(p[1] - p[0]) <= lim && abs(q[1] - q[0]) <= lim &&
           abs(q[2] - q[1]) <= lim && abs(q[3] - q[2]) <= lim &&
           abs(p[0] - q[0]) * 2 + abs(p[1] - q[1]) / 2 <= blim;
    int flat = abs(p[1] - p[0]) <= 1 && abs(q[1] - q[0]) <= 1 &&
               abs(p[2] - p[0]) <= 1 && abs(q[2] - q[0]) <= 1 &&
               abs(p[3] - p[0]) <= 1 && abs(q[3] - q[0]) <= 1;
    int flat2 = 0;
    if (len == 14)
        flat2 = abs(p[6] - p[0]) <= 1 && abs(q[6] - q[0]) <= 1 &&
                abs(p[5] - p[0]) <= 1 && abs(q[5] - q[0]) <= 1 &&
                abs(p[4] - p[0]) <= 1 && abs(q[4] - q[0]) <= 1;
    if (len == 14 && flat2 && flat && mask) {
        int p6 = p[6], p5 = p[5], p4 = p[4], p3 = p[3], p2 = p[2], p1 = p[1];
        int p0 = p[0], q0 = q[0], q1 = q[1], q2 = q[2], q3 = q[3], q4 = q[4];
        int q5 = q[5], q6 = q[6];
        s[-6 * step] = (uint8_t)R4(p6 * 7 + p5 * 2 + p4 * 2 + p3 + p2 + p1 + p0 + q0);
        s[-5 * step] = (uint8_t)R4(p6 * 5 + p5 * 2 + p4 * 2 + p3 * 2 + p2 + p1 + p0 + q0 + q1);
        s[-4 * step] = (uint8_t)R4(p6 * 4 + p5 + p4 * 2 + p3 * 2 + p2 * 2 + p1 + p0 + q0 + q1 + q2);
        s[-3 * step] = (uint8_t)R4(p6 * 3 + p5 + p4 + p3 * 2 + p2 * 2 + p1 * 2 + p0 + q0 + q1 + q2 + q3);
        s[-2 * step] = (uint8_t)R4(p6 * 2 + p5 + p4 + p3 + p2 * 2 + p1 * 2 + p0 * 2 + q0 + q1 + q2 + q3 + q4);
        s[-step] = (uint8_t)R4(p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 + q2 + q3 + q4 + q5);
        s[0] = (uint8_t)R4(p5 + p4 + p3 + p2 + p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2 + q3 + q4 + q5 + q6);
        s[step] = (uint8_t)R4(p4 + p3 + p2 + p1 + p0 + q0 * 2 + q1 * 2 + q2 * 2 + q3 + q4 + q5 + q6 * 2);
        s[2 * step] = (uint8_t)R4(p3 + p2 + p1 + p0 + q0 + q1 * 2 + q2 * 2 + q3 * 2 + q4 + q5 + q6 * 3);
        s[3 * step] = (uint8_t)R4(p2 + p1 + p0 + q0 + q1 + q2 * 2 + q3 * 2 + q4 * 2 + q5 + q6 * 4);
        s[4 * step] = (uint8_t)R4(p1 + p0 + q0 + q1 + q2 + q3 * 2 + q4 * 2 + q5 * 2 + q6 * 5);
        s[5 * step] = (uint8_t)R4(p0 + q0 + q1 + q2 + q3 + q4 * 2 + q5 * 2 + q6 * 7);
    } else if (flat && mask) {
        int p3 = p[3], p2 = p[2], p1 = p[1], p0 = p[0];
        int q0 = q[0], q1 = q[1], q2 = q[2], q3 = q[3];
        s[-3 * step] = (uint8_t)R3(p3 + p3 + p3 + 2 * p2 + p1 + p0 + q0);
        s[-2 * step] = (uint8_t)R3(p3 + p3 + p2 + 2 * p1 + p0 + q0 + q1);
        s[-step] = (uint8_t)R3(p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2);
        s[0] = (uint8_t)R3(p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3);
        s[step] = (uint8_t)R3(p1 + p0 + q0 + 2 * q1 + q2 + q3 + q3);
        s[2 * step] = (uint8_t)R3(p0 + q0 + q1 + 2 * q2 + q3 + q3 + q3);
    } else {
        filter4(mask, thr, s - 2 * step, s - step, s, s + step);
    }
}

static int level_of(const av1_dec *d, int plane, int pass) {
    int base = plane == 0 ? d->lf_level[pass] : d->lf_level[plane + 1];
    if (d->lf_delta_enabled)
        base = av1_clip3(0, 63, base + d->lf_ref_intra * (1 << (base >> 5)));
    return base;
}

void av1_loop_filter(av1_dec *d) {
    if (!d->lf_level[0] && !d->lf_level[1]) return;
    int sharp = d->lf_sharp;
    for (int plane = 0; plane < 3; plane++) {
        if (plane && !d->lf_level[plane + 1]) continue;
        int sx = plane ? d->ss_x : 0, sy = plane ? d->ss_y : 0;
        int n4w = d->pw[plane] >> 2, n4h = d->ph[plane] >> 2;
        int ls = n4w + 1, stride = d->stride[plane];
        for (int pass = 0; pass < 2; pass++) {
            int lvl = level_of(d, plane, pass);
            if (!lvl) continue;
            int shift = sharp > 4 ? 2 : sharp > 0 ? 1 : 0;
            int lim = lvl >> shift;
            if (sharp > 0 && lim > 9 - sharp) lim = 9 - sharp;
            if (lim < 1) lim = 1;
            int blim = 2 * (lvl + 2) + lim, thr = lvl >> 4;
            for (int y4 = 0; y4 < n4h; y4++) {
                if ((y4 << sy) * 4 >= d->h) break;
                for (int x4 = 0; x4 < n4w; x4++) {
                    if ((x4 << sx) * 4 >= d->w) break;
                    if (pass == 0 ? x4 == 0 : y4 == 0) continue;
                    int t = d->lf_txsz[plane][(size_t)y4 * ls + x4];
                    int pt = pass == 0
                                 ? d->lf_txsz[plane][(size_t)y4 * ls + x4 - 1]
                                 : d->lf_txsz[plane][(size_t)(y4 - 1) * ls + x4];
                    int tl = pass == 0 ? av1_tx_w_log2[t] : av1_tx_h_log2[t];
                    int pl = pass == 0 ? av1_tx_w_log2[pt] : av1_tx_h_log2[pt];
                    int pos = pass == 0 ? x4 : y4;
                    if (pos % (1 << (tl - 2))) continue;  /* not a tx edge */
                    int dim = tl < pl ? tl : pl;
                    int len = plane ? (dim == 2 ? 4 : 6)
                                    : (dim == 2 ? 4 : dim == 3 ? 8 : 14);
                    uint8_t *s = d->plane[plane] + (size_t)(y4 * 4) * stride +
                                 x4 * 4;
                    for (int i = 0; i < 4; i++) {
                        if (pass == 0)
                            lf_line(s + (size_t)i * stride, 1, len, lim, blim, thr);
                        else
                            lf_line(s + i, stride, len, lim, blim, thr);
                    }
                }
            }
        }
    }
}

/* --- CDEF ---------------------------------------------------------------- */

static int find_dir(const int16_t *img, int stride, int *var) {
    static const int div_table[] = { 0, 840, 420, 280, 210, 168, 140, 120,
                                     105 };
    int cost[8] = { 0 }, partial[8][15] = { { 0 } };
    for (int i = 0; i < 8; i++) {
        for (int j = 0; j < 8; j++) {
            int x = img[i * stride + j] - 128;
            partial[0][i + j] += x;
            partial[1][i + j / 2] += x;
            partial[2][i] += x;
            partial[3][3 + i - j / 2] += x;
            partial[4][7 + i - j] += x;
            partial[5][3 - i / 2 + j] += x;
            partial[6][j] += x;
            partial[7][i / 2 + j] += x;
        }
    }
    for (int i = 0; i < 8; i++) {
        cost[2] += partial[2][i] * partial[2][i];
        cost[6] += partial[6][i] * partial[6][i];
    }
    cost[2] *= div_table[8];
    cost[6] *= div_table[8];
    for (int i = 0; i < 7; i++) {
        cost[0] += (partial[0][i] * partial[0][i] +
                    partial[0][14 - i] * partial[0][14 - i]) * div_table[i + 1];
        cost[4] += (partial[4][i] * partial[4][i] +
                    partial[4][14 - i] * partial[4][14 - i]) * div_table[i + 1];
    }
    cost[0] += partial[0][7] * partial[0][7] * div_table[8];
    cost[4] += partial[4][7] * partial[4][7] * div_table[8];
    for (int i = 1; i < 8; i += 2) {
        for (int j = 0; j < 5; j++) cost[i] += partial[i][3 + j] * partial[i][3 + j];
        cost[i] *= div_table[8];
        for (int j = 0; j < 3; j++)
            cost[i] += (partial[i][j] * partial[i][j] +
                        partial[i][10 - j] * partial[i][10 - j]) *
                       div_table[2 * j + 2];
    }
    int best = 0, best_dir = 0;
    for (int i = 0; i < 8; i++) {
        if (cost[i] > best) {
            best = cost[i];
            best_dir = i;
        }
    }
    *var = (best - cost[(best_dir + 4) & 7]) >> 10;
    return best_dir;
}

static int msb(int v) {
    int r = 0;
    while (v >>= 1) r++;
    return r;
}

/* a sample outside the frame, as libaom marks it: no tap takes it and it
 * bounds no clip from above */
#define CDEF_LARGE 30000
#define CDEF_BORDER 3

static inline int constrain(int diff, int thr, int shift) {
    int a = diff < 0 ? -diff : diff, m = thr - (a >> shift);
    if (m < 0) m = 0;
    if (a < m) m = a;
    return diff < 0 ? -m : m;
}

/* one 8x8 (luma) or 4x4 (chroma) block from src, the plane's pre-CDEF
 * samples padded with CDEF_LARGE (src at the block's first sample) */
static void cdef_block(uint8_t *dst, int dstride, const int16_t *src,
                       int sst, int bs, int pri, int sec, int dir,
                       int damping) {
    const int *pt = av1_cdef_pri_taps[pri & 1];
    int pshift = pri ? damping - msb(pri) : 0;
    int sshift = sec ? damping - msb(sec) : 0;
    if (pshift < 0) pshift = 0;
    if (sshift < 0) sshift = 0;
    int po[2], so[2][2];
    for (int k = 0; k < 2; k++) {
        po[k] = av1_cdef_directions[dir][k][0] * sst +
                av1_cdef_directions[dir][k][1];
        for (int e = 0; e < 2; e++) {
            int dd = (dir + (e ? 2 : -2)) & 7;
            so[e][k] = av1_cdef_directions[dd][k][0] * sst +
                       av1_cdef_directions[dd][k][1];
        }
    }
    int both = pri && sec;
    for (int i = 0; i < bs; i++) {
        for (int j = 0; j < bs; j++) {
            const int16_t *c = src + i * sst + j;
            int x = c[0], sum = 0, mx = x, mn = x;
            /* a zero strength constrains every tap to 0 */
            for (int k = 0; k < 2; k++) {
                int p0 = c[po[k]], p1 = c[-po[k]];
                sum += pt[k] * (constrain(p0 - x, pri, pshift) +
                                constrain(p1 - x, pri, pshift));
                int s0 = c[so[0][k]], s1 = c[-so[0][k]];
                int s2 = c[so[1][k]], s3 = c[-so[1][k]];
                sum += av1_cdef_sec_taps[k] *
                       (constrain(s0 - x, sec, sshift) +
                        constrain(s1 - x, sec, sshift) +
                        constrain(s2 - x, sec, sshift) +
                        constrain(s3 - x, sec, sshift));
                if (both) {
                    int t[6] = { p0, p1, s0, s1, s2, s3 };
                    for (int e = 0; e < 6; e++) {
                        if (t[e] != CDEF_LARGE && t[e] > mx) mx = t[e];
                        if (t[e] < mn) mn = t[e];
                    }
                }
            }
            int v = x + ((8 + sum - (sum < 0)) >> 4);
            if (both) v = v < mn ? mn : v > mx ? mx : v;
            dst[i * dstride + j] = (uint8_t)v;
        }
    }
}

void av1_cdef(av1_dec *d) {
    if (!d->enable_cdef) return;
    int16_t *src[3];
    int sst[3];
    for (int p = 0; p < 3; p++) {
        int w = (d->mi_cols * 4) >> (p ? d->ss_x : 0);
        int h = (d->mi_rows * 4) >> (p ? d->ss_y : 0);
        sst[p] = w + 2 * CDEF_BORDER;
        size_t n = (size_t)sst[p] * (h + 2 * CDEF_BORDER);
        src[p] = malloc(sizeof(int16_t) * n);
        if (!src[p]) {
            for (int q = 0; q < p; q++) free(src[q]);
            av1_fail(d, "out of memory (%zu bytes)", 2 * n);
        }
        for (size_t i = 0; i < n; i++) src[p][i] = CDEF_LARGE;
        for (int y = 0; y < h; y++) {
            int16_t *row = src[p] + (size_t)(y + CDEF_BORDER) * sst[p] +
                           CDEF_BORDER;
            const uint8_t *in = d->plane[p] + (size_t)y * d->stride[p];
            for (int x = 0; x < w; x++) row[x] = in[x];
        }
    }
    int cols64 = (d->mi_cols + 15) >> 4, rows64 = (d->mi_rows + 15) >> 4;
    for (int fr = 0; fr < rows64; fr++) {
        for (int fc = 0; fc < cols64; fc++) {
            int idx = d->cdef_idx[fr * cols64 + fc];
            if (idx < 0) continue;
            int ypri = d->cdef_y_pri[idx], ysec = d->cdef_y_sec[idx];
            int upri = d->cdef_uv_pri[idx], usec = d->cdef_uv_sec[idx];
            if (!ypri && !ysec && !upri && !usec) continue;
            for (int r = fr * 16; r < fr * 16 + 16 && r < d->mi_rows; r += 2) {
                for (int c = fc * 16; c < fc * 16 + 16 && c < d->mi_cols;
                     c += 2) {
                    const av1_mi *m = d->mi + (size_t)r * d->mi_cols + c;
                    if (m[0].skip && m[1].skip && m[d->mi_cols].skip &&
                        m[d->mi_cols + 1].skip)
                        continue;
                    for (int p = 0; p < 3; p++) {
                        if (p && !upri && !usec) break;   /* no change */
                        int x = (c * 4) >> (p ? d->ss_x : 0);
                        int y = (r * 4) >> (p ? d->ss_y : 0);
                        const int16_t *s = src[p] +
                                           (size_t)(y + CDEF_BORDER) * sst[p] +
                                           x + CDEF_BORDER;
                        uint8_t *o = d->plane[p] + (size_t)y * d->stride[p] + x;
                        if (p == 0) {
                            int var, dir = find_dir(s, sst[0], &var);
                            int i = (var >> 6) ? msb(var >> 6) : 0;
                            if (i > 12) i = 12;
                            int t = var ? (ypri * (4 + i) + 8) >> 4 : 0;
                            d->cdef_dir = dir;
                            if (!t && !ysec) continue;
                            cdef_block(o, d->stride[0], s, sst[0], 8, t, ysec,
                                       ypri ? dir : 0, d->cdef_damping);
                        } else {
                            cdef_block(o, d->stride[p], s, sst[p], 4, upri,
                                       usec, upri ? d->cdef_dir : 0,
                                       d->cdef_damping - 1);
                        }
                    }
                }
            }
        }
    }
    for (int p = 0; p < 3; p++) free(src[p]);
}

/* --- YUV -> RGB ------------------------------------------------------------ */

/* ScaleRowUp2_Linear_Any: one chroma row to width samples */
static void up_linear(const uint8_t *s, int *out, int width) {
    int work = (width - 1) & ~1;
    out[0] = s[0];
    for (int x = 0; x < work / 2; x++) {
        out[2 * x + 1] = (s[x] * 3 + s[x + 1] + 2) >> 2;
        out[2 * x + 2] = (s[x] + s[x + 1] * 3 + 2) >> 2;
    }
    out[width - 1] = s[(width - 1) / 2];
}

/* ScaleRowUp2_Bilinear_Any: chroma rows s (near) and t (far) to one
 * output row */
static void up_bilinear(const uint8_t *s, const uint8_t *t, int *out,
                        int width) {
    int work = (width - 1) & ~1;
    out[0] = (3 * s[0] + t[0] + 2) >> 2;
    for (int x = 0; x < work / 2; x++) {
        out[2 * x + 1] = (s[x] * 9 + s[x + 1] * 3 + t[x] * 3 + t[x + 1] + 8) >> 4;
        out[2 * x + 2] = (s[x] * 3 + s[x + 1] * 9 + t[x] + t[x + 1] * 3 + 8) >> 4;
    }
    int l = (width - 1) / 2;
    out[width - 1] = (3 * s[l] + t[l] + 2) >> 2;
}

static inline uint8_t clamp255(int v) {
    return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

int yolo_avif_yuv_to_rgb(const uint8_t *yp, const uint8_t *up,
                         const uint8_t *vp, int w, int h, int matrix,
                         int full_range, uint8_t *rgb, char *err,
                         size_t errlen) {
    /* kYuvJPEGConstants: BT.601 (matrix 5, 6, or unspecified 2) at full
     * range */
    if (!full_range || (matrix != 2 && matrix != 5 && matrix != 6)) {
        snprintf(err, errlen, "AVIF: YUV matrix %d at %s range is not read "
                 "(BT.601 at full range is)", matrix,
                 full_range ? "full" : "limited");
        return -1;
    }
    const int yg = 16320, yb = 32, ub = 113, ug = 22, vg = 46, vr = 90;
    int cw = (w + 1) / 2;
    int *u = malloc(sizeof(int) * 2 * (size_t)w);
    if (!u) {
        snprintf(err, errlen, "AVIF: out of memory");
        return -1;
    }
    int *v = u + w;
    for (int y = 0; y < h; y++) {
        if (y == 0 || (y == h - 1 && !(h & 1))) {
            int cy = y == 0 ? 0 : (h / 2) - 1;
            up_linear(up + (size_t)cy * cw, u, w);
            up_linear(vp + (size_t)cy * cw, v, w);
        } else {
            /* rows 2k + 1 and 2k + 2 between chroma rows k and k + 1 */
            int k = (y - 1) / 2, near = (y & 1) ? k : k + 1;
            int far = (y & 1) ? k + 1 : k;
            up_bilinear(up + (size_t)near * cw, up + (size_t)far * cw, u, w);
            up_bilinear(vp + (size_t)near * cw, vp + (size_t)far * cw, v, w);
        }
        const uint8_t *yr = yp + (size_t)y * w;
        uint8_t *o = rgb + (size_t)y * w * 3;
        for (int x = 0; x < w; x++) {
            int y1 = (int)((uint32_t)(yr[x] * 0x0101 * yg) >> 16);
            int uu = u[x] - 128, vv = v[x] - 128;
            o[3 * x] = clamp255((y1 + vr * vv + yb) >> 6);
            o[3 * x + 1] = clamp255((y1 - ug * uu - vg * vv + yb) >> 6);
            o[3 * x + 2] = clamp255((y1 + ub * uu + yb) >> 6);
        }
    }
    free(u);
    return 0;
}
