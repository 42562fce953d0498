/* PNG row unfiltering and pixel conversion for the host data pipeline.
 *
 * The chunk parsing and inflate stay in Python (zlib); this file takes
 * the inflated rows. yolo_png_unfilter undoes the five row filters of
 * the PNG specification (section 9) at any pixel byte distance.
 * yolo_png_decode_rows unfilters and converts the samples to what
 * cv2.imread gives (libpng with OpenCV's transforms):
 *
 *   - bit depths 1, 2 and 4 expand (gray scaled to 0..255, palette
 *     indices looked up); 16-bit samples keep their high byte
 *     (png_set_strip_16);
 *   - alpha is dropped (png_set_strip_alpha), palettes expand to RGB;
 *   - gray replicates to RGB at 3 channels; RGB becomes gray at 1
 *     channel as png_set_rgb_to_gray(png, 1, 0.299, 0.587) computes it
 *     for a file without gamma information: coefficients 9797, 19234
 *     and 3737 out of 32768, truncated at 8 bits, rounded at 16 bits
 *     before the high byte is kept.
 *
 * Plain C11, integer arithmetic only, no state between calls.
 */

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

int yolo_png_decode_rows(const uint8_t *raw, size_t rawlen, int h, int w,
                         int depth, int color, const uint8_t *palette,
                         int channels, uint8_t *out, char *err,
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
                    op[x] = (uint8_t)gray16(s[0] << 8 | s[1], s[2] << 8 | s[3],
                                            s[4] << 8 | s[5]);
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
            } else {
                op[x] = (uint8_t)gray8(r, g, b);
            }
        }
    }
    free(rows);
    return 0;
}
