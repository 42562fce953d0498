/* The image data of a GIF as OpenCV 5's own GIF encoder (grfmt_gif.cpp)
 * writes it for cv2.imwrite / cv2.imencode at their defaults
 * (IMWRITE_GIF_FAST_FLOYD_DITHER): data/gif.py::encode_gif writes the
 * blocks around it. Found by probing cv2 5.0.0 (no OpenCV source was at
 * hand):
 *
 *   - the palette is fixed, 3-3-2: R and G at the 8 levels 36 k, B at
 *     the 4 levels 85 k, entry r << 5 | g << 2 | b;
 *   - Floyd-Steinberg error diffusion in float, each channel on its
 *     own, rows top to bottom and each row left to right (no
 *     serpentine). The errors go to a buffer of their own, which starts
 *     at 0: a pixel's value is v = its sample + its error, its level k
 *     = floorf(v / step + 0.5f) clamped to the levels, its error e = v -
 *     k * step (v unclamped), and e * 7/16 goes right, e * 3/16 down and
 *     left, e * 5/16 down, e * 1/16 down and right; what would leave
 *     the image is dropped. The float sums are in that order: the
 *     pixel above-left's share, then the one above's, then the
 *     above-right's, then the left neighbour's (a double buffer, or one
 *     that adds into the sample itself, gives other levels). R and G
 *     top out at 252, so an area at 253..255 hands its surplus on
 *     without bound: a dark pixel right of or below a large white area
 *     can come out at 252, in cv2's file too;
 *   - LZW: minimum code size 8, one clear code first, codes LSB first,
 *     9 bits wide at first and one bit wider once the encoder's next
 *     free code passes 1 << width (to 12 bits); once it has handed out
 *     code 4095 it writes a clear code at 12 bits and starts again (a
 *     decoder then sees the clear with 4095 as its next free code); the
 *     end code last, the last byte padded with zeros, in sub-blocks of
 *     255 bytes and a shorter last one, then the block terminator.
 *
 * Plain C11 (ISO float: no contraction of multiply-adds), so every host
 * gives the same bytes. No state between calls.
 */

#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "native.h"

enum { MIN_CODE_SIZE = 8, CLEAR = 256, EOI = 257, MAX_CODES = 4096 };

static const int STEP[3] = {36, 36, 85}, TOP[3] = {7, 7, 3};

/* (h, w, 3) RGB -> the palette indices, error diffused */
static void quantize(const uint8_t *rgb, int h, int w, uint8_t *idx,
                     float *cur, float *next) {
    size_t row = (size_t)w * 3;
    memset(cur, 0, row * sizeof(float));
    for (int y = 0; y < h; y++) {
        const uint8_t *src = rgb + (size_t)y * row;
        int below = y + 1 < h;
        memset(next, 0, row * sizeof(float));
        for (int x = 0; x < w; x++) {
            int k3[3];
            for (int c = 0; c < 3; c++) {
                size_t o = (size_t)x * 3 + (size_t)c;
                float v = (float)src[o] + cur[o];
                float q = floorf(v / (float)STEP[c] + 0.5f);
                int k = q < 0.0f ? 0 : q > (float)TOP[c] ? TOP[c] : (int)q;
                float e = v - (float)(k * STEP[c]);
                k3[c] = k;
                if (x + 1 < w) cur[o + 3] += e * (7.0f / 16.0f);
                if (below) {
                    if (x > 0) next[o - 3] += e * (3.0f / 16.0f);
                    next[o] += e * (5.0f / 16.0f);
                    if (x + 1 < w) next[o + 3] += e * (1.0f / 16.0f);
                }
            }
            idx[(size_t)y * w + x] = (uint8_t)(k3[0] << 5 | k3[1] << 2 | k3[2]);
        }
        float *t = cur;
        cur = next;
        next = t;
    }
}

typedef struct {
    uint8_t *out;    /* sub-blocks: a length byte, then its bytes */
    size_t n, block; /* bytes written; where the open sub-block starts */
    uint32_t acc;    /* bits not yet written, LSB first */
    int nacc;
} Bits;

static void put_byte(Bits *b, uint8_t v) {
    if (b->n == b->block) b->out[b->n++] = 0;   /* open a sub-block */
    b->out[b->n++] = v;
    if (++b->out[b->block] == 255) b->block = b->n;
}

static void put_code(Bits *b, int code, int width) {
    b->acc |= (uint32_t)code << b->nacc;
    b->nacc += width;
    for (; b->nacc >= 8; b->nacc -= 8, b->acc >>= 8)
        put_byte(b, (uint8_t)(b->acc & 0xff));
}

/* indices -> the LZW stream in sub-blocks, after its minimum code size
 * byte and up to the block terminator; out holds lzw_bound(n) bytes */
static size_t lzw(const uint8_t *idx, size_t n, uint16_t *table,
                  uint32_t *used, uint8_t *out) {
    Bits b = {out, 1, 1, 0, 0};
    out[0] = MIN_CODE_SIZE;
    int width = MIN_CODE_SIZE + 1, next = EOI + 1, nused = 0;
    put_code(&b, CLEAR, width);
    int cur = idx[0];
    for (size_t i = 1; i < n; i++) {
        uint32_t slot = (uint32_t)cur << 8 | idx[i];
        if (table[slot]) {
            cur = table[slot];
            continue;
        }
        put_code(&b, cur, width);
        table[slot] = (uint16_t)next++;
        used[nused++] = slot;
        if (next > (1 << width) && width < 12) width++;
        if (next == MAX_CODES) {
            put_code(&b, CLEAR, width);
            for (int j = 0; j < nused; j++) table[used[j]] = 0;
            nused = 0;
            width = MIN_CODE_SIZE + 1;
            next = EOI + 1;
        }
        cur = idx[i];
    }
    put_code(&b, cur, width);
    put_code(&b, EOI, width);
    if (b.nacc) put_byte(&b, (uint8_t)(b.acc & 0xff));
    out[b.n++] = 0;
    return b.n;
}

/* at most one code a pixel, a clear code every 3838, 12 bits each */
static size_t lzw_bound(size_t n) {
    size_t bytes = ((n + n / 3838 + 4) * 12 + 7) / 8;
    return bytes + bytes / 255 + 4;
}

int yolo_gif_encode(const uint8_t *rgb, int h, int w, uint8_t **out,
                    size_t *outlen, char *err, size_t errlen) {
    if (h <= 0 || w <= 0 || h > 65535 || w > 65535) {
        snprintf(err, errlen, "cannot write a %dx%d image as GIF: a side "
                 "must be 1..65535 (cv2.imwrite refuses it too)", w, h);
        return -1;
    }
    size_t n = (size_t)h * (size_t)w, cap = lzw_bound(n);
    uint8_t *idx = malloc(n), *data = malloc(cap);
    float *rows = malloc((size_t)w * 6 * sizeof(float));
    uint16_t *table = calloc((size_t)MAX_CODES * 256, sizeof(uint16_t));
    uint32_t *used = malloc(MAX_CODES * sizeof(uint32_t));
    int rc = -1;
    if (!idx || !data || !rows || !table || !used) {
        snprintf(err, errlen, "out of memory for a %dx%d GIF", w, h);
        goto done;
    }
    quantize(rgb, h, w, idx, rows, rows + (size_t)w * 3);
    *outlen = lzw(idx, n, table, used, data);
    *out = data;
    data = NULL;
    rc = 0;
done:
    free(idx);
    free(data);
    free(rows);
    free(table);
    free(used);
    return rc;
}
