/* PNG row unfiltering and pixel conversion for the host data pipeline.
 *
 * The chunk parsing and inflate stay in Python (zlib); this file takes
 * the inflated rows. yolo_png_unfilter undoes the five row filters of
 * the PNG specification (section 9) at any pixel byte distance.
 * yolo_png_decode_rows unfilters and converts the samples to what
 * cv2.imread gives (libpng 1.6 with OpenCV's transforms):
 *
 *   - bit depths 1, 2 and 4 expand (gray scaled to 0..255, palette
 *     indices looked up); 16-bit samples keep their high byte
 *     (png_set_strip_16);
 *   - alpha is dropped (png_set_strip_alpha), palettes expand to RGB;
 *   - gray replicates to RGB at 3 channels; RGB becomes gray at 1
 *     channel as png_set_rgb_to_gray(png, 1, 0.299, 0.587) computes it:
 *     coefficients 9797, 19234 and 3737 out of 32768 (a cHRM chunk does
 *     not replace coefficients the caller set), truncated at 8 bits,
 *     rounded at 16 bits before the high byte is kept;
 *   - where the file states a gamma (gAMA, sRGB) far enough from 1,
 *     that gray is computed in linear light through pngrtran.c's tables:
 *     each sample to linear (exponent 1/gamma), the weighted sum rounded,
 *     back through the inverse table; 8-bit tables for 8-bit samples and
 *     palettes, 16-bit ones (png_build_16bit_table, 11 significant bits
 *     as png_set_strip_16 keeps them) for 16-bit samples, whose gray
 *     pixels round to 8 bits through png_build_16to8_table.
 *
 * Plain C11, no state between calls.
 */

#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "native.h"

int yolo_png_unfilter(const uint8_t *raw, int h, size_t stride, int bpp,
                      uint8_t *out, char *err, size_t errlen) {
    const uint8_t *prior = NULL;
    for (int y = 0; y < h; y++) {
        const uint8_t *in = raw + (size_t)y * (stride + 1);
        const int ft = in[0];
        in++;
        uint8_t *line = out + (size_t)y * stride;
        size_t x;
        switch (ft) {
        case 0:
            memcpy(line, in, stride);
            break;
        case 1:
            for (x = 0; x < stride; x++)
                line[x] = (uint8_t)(in[x] + (x >= (size_t)bpp
                                             ? line[x - bpp] : 0));
            break;
        case 2:
            for (x = 0; x < stride; x++)
                line[x] = (uint8_t)(in[x] + (prior ? prior[x] : 0));
            break;
        case 3:
            for (x = 0; x < stride; x++) {
                int a = x >= (size_t)bpp ? line[x - bpp] : 0;
                int b = prior ? prior[x] : 0;
                line[x] = (uint8_t)(in[x] + ((a + b) >> 1));
            }
            break;
        case 4:
            for (x = 0; x < stride; x++) {
                int a = x >= (size_t)bpp ? line[x - bpp] : 0;
                int b = prior ? prior[x] : 0;
                int c = prior && x >= (size_t)bpp ? prior[x - bpp] : 0;
                int p = a + b - c;
                int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
                int pred = pa <= pb && pa <= pc ? a : (pb <= pc ? b : c);
                line[x] = (uint8_t)(in[x] + pred);
            }
            break;
        default:
            snprintf(err, errlen, "PNG row %d: unknown filter type %d", y,
                     ft);
            return -1;
        }
        prior = line;
    }
    return 0;
}

static inline int gray8(int r, int g, int b) {
    return (r * 9797 + g * 19234 + b * 3737) >> 15;
}

static inline int gray16(int r, int g, int b) {
    return ((r * 9797 + g * 19234 + b * 3737 + 16384) >> 15) >> 8;
}

/* png.c's fixed-point gamma helpers (PNG_FP_1 = 100000) */
static int fp_significant(int64_t g) { return g < 95000 || g > 105000; }

static int64_t fp_reciprocal(int64_t a) { return (int64_t)floor(1e10 / a + .5); }

static int64_t fp_product2(int64_t a, int64_t b) {
    double r = a * 1e-5;
    r *= b;
    return (int64_t)floor(r + .5);
}

/* png_build_8bit_table */
static void table8(uint8_t t[256], int64_t g) {
    for (int i = 0; i < 256; i++)
        t[i] = (uint8_t)(fp_significant(g) && i > 0 && i < 255
                             ? floor(255 * pow(i / 255., g * .00001) + .5)
                             : i);
}

/* png_build_16bit_table at gamma_shift 5, indexed by the sample >> 5 */
static void table16(uint16_t t[2048], int64_t g) {
    for (int ig = 0; ig < 2048; ig++)
        t[ig] = (uint16_t)(fp_significant(g)
                               ? floor(65535. * pow(ig * (1.0 / 2047),
                                                    g * .00001) + .5)
                               : (ig * 65535U + 1024U) / 2047U);
}

/* png_gamma_16bit_correct */
static unsigned correct16(unsigned v, int64_t g) {
    if (v > 0 && v < 65535)
        return (unsigned)floor(65535 * pow((int)v / 65535., g * .00001) + .5);
    return v;
}

/* png_build_16to8_table at gamma_shift 5: 16-bit gray -> its 8-bit
 * value times 257 (then cut to the high byte) */
static void table16to8(uint16_t t[2048], int64_t g) {
    unsigned last = 0;
    for (unsigned i = 0; i < 255; i++) {
        unsigned out = i * 257U;
        unsigned bound = (correct16(out + 128U, g) * 2047U + 32768U) / 65535U
                         + 1U;
        while (last < bound && last < 2048) t[last++] = (uint16_t)out;
    }
    while (last < 2048) t[last++] = 65535;
}

typedef struct {
    int on;
    uint8_t to1[256], from1[256];
    uint16_t to1_16[2048], from1_16[2048], gray_16[2048];
} linear_gray;

/* png_init_read_transformations with no screen gamma set (OpenCV sets
 * none): the screen gamma is 1/file gamma, so only rgb_to_gray builds
 * tables, and only if either is significant */
static void linear_gray_init(linear_gray *lg, int64_t file_gamma,
                             int depth) {
    lg->on = 0;
    if (file_gamma <= 0) return;
    const int64_t screen = fp_reciprocal(file_gamma);
    if (!fp_significant(file_gamma) && !fp_significant(screen)) return;
    lg->on = 1;
    if (depth <= 8) {
        table8(lg->to1, fp_reciprocal(file_gamma));
        table8(lg->from1, fp_reciprocal(screen));
    } else {
        table16(lg->to1_16, fp_reciprocal(file_gamma));
        table16(lg->from1_16, fp_reciprocal(screen));
        table16to8(lg->gray_16, fp_product2(file_gamma, screen));
    }
}

int yolo_png_decode_rows(const uint8_t *raw, size_t rawlen, int h, int w,
                         int depth, int color, const uint8_t *palette,
                         int channels, int gamma, uint8_t *out, char *err,
                         size_t errlen) {
    int spp;
    switch (color) {
    case 0: spp = 1; break;
    case 2: spp = 3; break;
    case 3: spp = 1; break;
    case 4: spp = 2; break;
    case 6: spp = 4; break;
    default:
        snprintf(err, errlen, "PNG color type %d", color);
        return -1;
    }
    const int bits = spp * depth;
    const size_t stride = ((size_t)w * bits + 7) / 8;
    if (rawlen != (size_t)h * (stride + 1)) {
        snprintf(err, errlen, "PNG data holds %zu bytes, expected %zu",
                 rawlen, (size_t)h * (stride + 1));
        return -1;
    }
    uint8_t *rows = malloc(stride * (size_t)h + 1);
    if (!rows) {
        snprintf(err, errlen, "out of memory");
        return -1;
    }
    if (yolo_png_unfilter(raw, h, stride, bits >= 8 ? bits / 8 : 1, rows,
                          err, errlen)) {
        free(rows);
        return -1;
    }
    const int scale = depth == 1 ? 255 : depth == 2 ? 85 : depth == 4 ? 17 : 1;
    linear_gray *lg = NULL;
    if (channels == 1 && (color == 2 || color == 3 || color == 6) &&
        gamma > 0) {
        lg = malloc(sizeof *lg);
        if (!lg) {
            free(rows);
            snprintf(err, errlen, "out of memory");
            return -1;
        }
        linear_gray_init(lg, gamma, depth);
        if (!lg->on) {
            free(lg);
            lg = NULL;
        }
    }
    for (int y = 0; y < h; y++) {
        const uint8_t *line = rows + (size_t)y * stride;
        uint8_t *op = out + (size_t)y * w * channels;
        for (int x = 0; x < w; x++) {
            int r, g, b, v;
            if (depth < 8) {
                size_t bit = (size_t)x * depth;
                v = (line[bit >> 3] >> (8 - depth - (int)(bit & 7))) &
                    ((1 << depth) - 1);
                if (color == 3) {
                    r = palette[3 * v];
                    g = palette[3 * v + 1];
                    b = palette[3 * v + 2];
                } else {
                    r = g = b = v * scale;
                }
            } else if (depth == 8) {
                const uint8_t *s = line + (size_t)x * spp;
                if (color == 3) {
                    r = palette[3 * s[0]];
                    g = palette[3 * s[0] + 1];
                    b = palette[3 * s[0] + 2];
                } else if (color == 0 || color == 4) {
                    r = g = b = s[0];
                } else {
                    r = s[0];
                    g = s[1];
                    b = s[2];
                }
            } else {
                const uint8_t *s = line + (size_t)x * spp * 2;
                if (color == 0 || color == 4) {
                    r = g = b = s[0];
                } else if (channels == 1) {
                    const int r16 = s[0] << 8 | s[1], g16 = s[2] << 8 | s[3],
                              b16 = s[4] << 8 | s[5];
                    if (!lg) {
                        op[x] = (uint8_t)gray16(r16, g16, b16);
                    } else if (r16 == g16 && r16 == b16) {
                        op[x] = (uint8_t)(lg->gray_16[r16 >> 5] >> 8);
                    } else {
                        int v = (lg->to1_16[r16 >> 5] * 9797 +
                                 lg->to1_16[g16 >> 5] * 19234 +
                                 lg->to1_16[b16 >> 5] * 3737 + 16384) >> 15;
                        op[x] = (uint8_t)(lg->from1_16[v >> 5] >> 8);
                    }
                    continue;
                } else {
                    r = s[0];
                    g = s[2];
                    b = s[4];
                }
            }
            if (channels == 3) {
                op[3 * x] = (uint8_t)r;
                op[3 * x + 1] = (uint8_t)g;
                op[3 * x + 2] = (uint8_t)b;
            } else if (lg && (r != g || r != b)) {
                op[x] = lg->from1[(lg->to1[r] * 9797 + lg->to1[g] * 19234 +
                                   lg->to1[b] * 3737 + 16384) >> 15];
            } else {
                op[x] = (uint8_t)gray8(r, g, b);
            }
        }
    }
    free(lg);
    free(rows);
    return 0;
}
