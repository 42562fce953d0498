/* The two cv2 resamplers of the training augmentation, without OpenCV
 * (the card machine has none): GaussianBlur and warpAffine on uint8
 * images of 1 or 3 interleaved channels, giving the bytes that OpenCV 5's
 * default (SIMD) paths give.
 *
 * int yolo_gaussian_blur_u8(const uint8_t *src, int h, int w, int c,
 *                           int ksize, uint8_t *dst, char *err,
 *                           size_t errlen)
 *   cv2.GaussianBlur(src, (ksize, ksize), 0), ksize odd, with the
 *   default border BORDER_REFLECT_101. OpenCV's bit-exact path for 8-bit
 *   images: the kernel is computed in double (sigma = 0.15 ksize + 0.35
 *   by one fused multiply-add; ksize <= 9 takes fixed tables), turned
 *   into 8-bit fixed-point taps that sum to 256 by error diffusion, and
 *   applied as two integer passes: rows into 8 fractional bits without
 *   rounding, then columns into 16 and (sum + 2^15) >> 16. Every sum is
 *   exact, so the order of the additions does not matter.
 *
 * int yolo_warp_affine_u8(const uint8_t *src, int sh, int sw, int c,
 *                         const double *m, int dh, int dw, uint8_t *dst,
 *                         char *err, size_t errlen)
 *   cv2.warpAffine(src, m, (dw, dh), flags=INTER_LINEAR |
 *   WARP_INVERSE_MAP, borderMode=BORDER_REPLICATE): dst(x, y) samples
 *   src at (m0 x + m1 y + m2, m3 x + m4 y + m5). OpenCV 5 computes in
 *   float32, not in the 1/32-pixel fixed point of OpenCV 4.10 and older:
 *   m is rounded to float, the source coordinate and the two-step linear
 *   blend are float multiply-adds, and the result is rounded half to
 *   even. Its vectorized body takes each row in blocks of kWarpBlock
 *   pixels and fuses differently from its scalar tail:
 *     body: sx = fma(m0, x, m1 y + m2), the row term rounded once;
 *     tail: sx = fma(x, m0, m1 y) + m2;
 *   both blend as v0 = fma(ax, p01 - p00, p00), v1 likewise, v =
 *   fma(ay, v1 - v0, v0). Neighbours past the edge are clamped to it.
 *
 * int yolo_hsv2rgb_u8(const uint8_t *src, int h, int w, uint8_t *dst,
 *                     char *err, size_t errlen)
 *   cv2.cvtColor(src, COLOR_HSV2RGB) of an (h, w, 3) uint8 HSV image,
 *   hue range 180, as OpenCV 5's AVX2 build computes it
 *   (color_hsv.simd.hpp, compiled with FMA contraction): hue times
 *   6.0f / 180, s and v times 1.0f / 255; the sector table v,
 *   v (1 - s), v fma(-s, f, 1), v fma(-s, 1 - f, 1) in float; the
 *   colour times 255. Each row in blocks of kHsvBlock pixels through
 *   the vector body, whose sector is trunc arithmetic and whose result
 *   truncates; the rest through the scalar code (fmod, floor), which
 *   rounds half to even.
 *
 * Each returns 0, or -1 with a message in err. The library is built with
 * -std=c11, which contracts no expression: every fused operation is an
 * explicit fmaf/fma call, and the warp is compiled a second time for
 * processors with FMA instructions (target_clones), which compute the
 * same values faster.
 */

#include <math.h>
#include <stdarg.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>

#include "native.h"

/* OpenCV's AVX2 warp kernel: two vectors of 8 floats a step. */
enum { kWarpBlock = 16 };
/* OpenCV's AVX2 HSV2RGB_b body: four vectors of 8 floats a step. */
enum { kHsvBlock = 32 };

static int fail(char *err, size_t errlen, const char *fmt, ...) {
    va_list ap;
    va_start(ap, fmt);
    vsnprintf(err, errlen, fmt, ap);
    va_end(ap);
    return -1;
}

/* cv::borderInterpolate for BORDER_REFLECT_101, repeated until inside */
static int reflect101(int p, int len) {
    if (len == 1) return 0;
    while ((unsigned)p >= (unsigned)len) p = p < 0 ? -p : 2 * len - 2 - p;
    return p;
}

/* getGaussianKernelBitExact + getGaussianKernelFixedPoint_ED, 8 bits */
static void gaussian_taps(int n, uint32_t *taps) {
    static const uint32_t k1[] = {256}, k3[] = {64, 128, 64},
        k5[] = {16, 64, 96, 64, 16}, k7[] = {8, 28, 56, 72, 56, 28, 8},
        k9[] = {4, 13, 30, 51, 60, 51, 30, 13, 4};
    static const uint32_t *fixed[] = {k1, k3, k5, k7, k9};
    if (n <= 9) {
        for (int i = 0; i < n; i++) taps[i] = fixed[n / 2][i];
        return;
    }
    int n2 = n / 2;
    double *val = malloc(sizeof(double) * n2);
    double sigma = fma((double)n, 0.15, 0.35);
    double scale2 = -0.125 / (sigma * sigma);
    double sum = 0.0;
    for (int i = 0, x = 1 - n; i < n2; i++, x += 2) {
        val[i] = exp((double)(x * x) * scale2);
        sum += val[i];
    }
    sum = sum * 2.0 + 1.0;
    double mul1 = 1.0 / sum, err = 0.0;
    uint32_t total = 0;
    for (int i = 0; i < n2; i++) {
        double adj = val[i] * mul1 * 256.0 + err;
        double v0 = nearbyint(adj);
        err = adj - v0;
        taps[i] = taps[n - 1 - i] = (uint32_t)v0;
        total += 2 * (uint32_t)v0;
    }
    taps[n2] = 256 - total;
    free(val);
}

int yolo_gaussian_blur_u8(const uint8_t *src, int h, int w, int c,
                          int ksize, uint8_t *dst, char *err,
                          size_t errlen) {
    if (h < 1 || w < 1 || (c != 1 && c != 3))
        return fail(err, errlen, "gaussian_blur_u8: a %dx%dx%d image "
                    "(1 or 3 channels)", h, w, c);
    if (ksize < 1 || ksize % 2 == 0)
        return fail(err, errlen, "gaussian_blur_u8: ksize %d is not a "
                    "positive odd number", ksize);
    int r = ksize / 2;
    uint32_t *taps = malloc(sizeof(uint32_t) * ksize);
    int *xi = malloc(sizeof(int) * (size_t)(w + 2 * r));
    int *yi = malloc(sizeof(int) * (size_t)(h + 2 * r));
    uint32_t *rows = malloc(sizeof(uint32_t) * (size_t)h * w * c);
    if (!taps || !xi || !yi || !rows) {
        free(taps), free(xi), free(yi), free(rows);
        return fail(err, errlen, "gaussian_blur_u8: out of memory");
    }
    gaussian_taps(ksize, taps);
    for (int i = 0; i < w + 2 * r; i++) xi[i] = reflect101(i - r, w);
    for (int i = 0; i < h + 2 * r; i++) yi[i] = reflect101(i - r, h);
    for (int y = 0; y < h; y++) {
        const uint8_t *s = src + (size_t)y * w * c;
        uint32_t *o = rows + (size_t)y * w * c;
        for (int x = 0; x < w; x++)
            for (int k = 0; k < c; k++) {
                uint32_t acc = 0;
                for (int j = 0; j < ksize; j++)
                    acc += taps[j] * s[xi[x + j] * c + k];
                o[x * c + k] = acc;
            }
    }
    size_t stride = (size_t)w * c;
    for (int y = 0; y < h; y++) {
        uint8_t *o = dst + y * stride;
        for (size_t i = 0; i < stride; i++) {
            uint32_t acc = 0;
            for (int j = 0; j < ksize; j++)
                acc += taps[j] * rows[yi[y + j] * stride + i];
            acc = (acc + (1u << 15)) >> 16;
            o[i] = (uint8_t)(acc > 255 ? 255 : acc);
        }
    }
    free(taps), free(xi), free(yi), free(rows);
    return 0;
}

static inline int clampi(int v, int hi) { return v < 0 ? 0 : v > hi ? hi : v; }

/* cvFloor of a float that may lie far outside the image: beyond 2^30
 * both neighbours clamp to the same edge pixel and the blend is exact. */
static inline int floor_i(float v) {
    if (v < -1073741824.0f) return -1073741824;
    if (v > 1073741824.0f) return 1073741824;
    int i = (int)v;
    return i - (v < (float)i);
}

__attribute__((target_clones("fma", "default")))
int yolo_warp_affine_u8(const uint8_t *src, int sh, int sw, int c,
                        const double *m, int dh, int dw, uint8_t *dst,
                        char *err, size_t errlen) {
    if (sh < 1 || sw < 1 || dh < 0 || dw < 0 || (c != 1 && c != 3))
        return fail(err, errlen, "warp_affine_u8: a %dx%dx%d image into "
                    "%dx%d (1 or 3 channels)", sh, sw, c, dh, dw);
    float m0 = (float)m[0], m1 = (float)m[1], m2 = (float)m[2];
    float m3 = (float)m[3], m4 = (float)m[4], m5 = (float)m[5];
    int body = dw / kWarpBlock * kWarpBlock;
    for (int y = 0; y < dh; y++) {
        float fy = (float)y;
        float rx = fy * m1, ry = fy * m4;  /* rounded products */
        float ox = rx + m2, oy = ry + m5;
        uint8_t *o = dst + (size_t)y * dw * c;
        for (int x = 0; x < dw; x++) {
            float fx = (float)x, sx, sy;
            if (x < body) {
                sx = fmaf(m0, fx, ox);
                sy = fmaf(m3, fx, oy);
            } else {
                sx = fmaf(fx, m0, rx) + m2;
                sy = fmaf(fx, m3, ry) + m5;
            }
            int ix = floor_i(sx), iy = floor_i(sy);
            float ax = sx - (float)ix, ay = sy - (float)iy;
            int x0 = clampi(ix, sw - 1), x1 = clampi(ix + 1, sw - 1);
            const uint8_t *r0 = src + (size_t)clampi(iy, sh - 1) * sw * c;
            const uint8_t *r1 = src + (size_t)clampi(iy + 1, sh - 1) * sw * c;
            for (int k = 0; k < c; k++) {
                float p00 = r0[x0 * c + k], p01 = r0[x1 * c + k];
                float p10 = r1[x0 * c + k], p11 = r1[x1 * c + k];
                float v0 = fmaf(ax, p01 - p00, p00);
                float v1 = fmaf(ax, p11 - p10, p10);
                int v = (int)lrintf(fmaf(ay, v1 - v0, v0));
                o[x * c + k] = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
            }
        }
    }
    return 0;
}

static inline uint8_t sat_u8(int v) {
    return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

int yolo_hsv2rgb_u8(const uint8_t *src, int h, int w, uint8_t *dst,
                    char *err, size_t errlen) {
    static const int sector_data[6][3] = {{1, 3, 0}, {1, 0, 2}, {3, 0, 1},
                                          {0, 2, 1}, {0, 1, 3}, {2, 1, 0}};
    if (h < 0 || w < 0)
        return fail(err, errlen, "hsv2rgb: shape %dx%d", h, w);
    const float hscale = 6.0f / 180, inv255 = 1.0f / 255.0f;
    const int body = w / kHsvBlock * kHsvBlock;
    for (int y = 0; y < h; y++) {
        const uint8_t *in = src + (size_t)y * w * 3;
        uint8_t *out = dst + (size_t)y * w * 3;
        for (int x = 0; x < w; x++) {
            const float s = in[3 * x + 1] * inv255, v = in[3 * x + 2] * inv255;
            float hue = in[3 * x] * hscale, tab[4];
            int sector;
            if (x < body) {
                const float pre = truncf(hue);
                hue -= pre;
                sector = (int)(pre - truncf(pre * (1.0f / 6.0f)) * 6.0f);
            } else {
                hue = fmodf(hue, 6.0f);
                sector = (int)floorf(hue);
                hue -= (float)sector;
                if ((unsigned)sector >= 6u) {
                    sector = 0;
                    hue = 0.0f;
                }
            }
            tab[0] = v;
            tab[1] = v * (1.0f - s);
            tab[2] = v * fmaf(-s, hue, 1.0f);
            tab[3] = v * fmaf(-s, 1.0f - hue, 1.0f);
            /* cv2 writes b, g, r; the output is r, g, b */
            for (int k = 0; k < 3; k++) {
                const float c = (x >= body && s == 0.0f
                                     ? v : tab[sector_data[sector][2 - k]])
                                * 255.0f;
                out[3 * x + k] = sat_u8(x < body ? (int)c : (int)lrintf(c));
            }
        }
    }
    return 0;
}
