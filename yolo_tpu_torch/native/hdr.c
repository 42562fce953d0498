/* Radiance RGBE pixels for the host decoder and writer (data/hdr.py
 * reads and writes the header), as OpenCV 5's rgbe.cpp and
 * grfmt_hdr.cpp run them:
 *
 *   - reading (RGBE_ReadPixels_RLE): scanlines of width 8..0x7fff start
 *     with 2, 2 and the width's two bytes, then hold the four channels
 *     one after another, each in runs (a count above 128: count - 128
 *     copies of one byte) and literals (a count of 1..128 bytes); a
 *     scanline that does not start so ends the run-length coding: it and
 *     every pixel after it are flat 4-byte pixels. Other widths are flat
 *     throughout. Radiance's old run-length pixels (1, 1, 1, n) are not
 *     expanded: rgbe.cpp reads them as pixels. A zero count, a run past
 *     the scanline, a width that disagrees or data that ends early is
 *     an error (cv2 gives no image);
 *   - the conversion to 8 bits: each channel m of exponent e is the float
 *     m * ldexp(1, e - 136) (0 for e = 0), times 255 as a float, rounded
 *     half to even and clamped to 0..255 (OpenCV's convertTo);
 *   - writing (HdrEncoder, RGBE_WritePixels_RLE): the 8-bit samples
 *     times the float 1 / 255, float2rgbe (frexp of the largest channel,
 *     each channel * (mantissa * 256 / max) truncated), scanlines of
 *     width 8..0x7fff run-length coded as RGBE_WriteBytes_RLE codes
 *     them (runs of 4 or more, a shorter run before one written as a
 *     run, literals of at most 128), other widths flat.
 *
 * Plain C11, no state between calls.
 */

#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "native.h"

#define NO_IMAGE "; cv2 gives no image either"

/* saturate_cast<uchar>(x * 255.f): cvRound on x86 gives 0x80000000
 * (so 0) for +Inf and whatever int32 cannot hold; x is never negative */
static uint8_t to_u8(float x) {
    float r = x * 255.0f;
    if (!(r < 2147483648.0f)) return 0;
    long v = lrintf(r);
    return (uint8_t)(v > 255 ? 255 : v);
}

static void rgbe_to_u8(const uint8_t rgbe[4], uint8_t *rgb) {
    if (!rgbe[3]) {
        rgb[0] = rgb[1] = rgb[2] = 0;
        return;
    }
    float f = (float)ldexp(1.0, rgbe[3] - (128 + 8));
    for (int c = 0; c < 3; c++) rgb[c] = to_u8(rgbe[c] * f);
}

int yolo_hdr_decode_pixels(const uint8_t *data, size_t len, int w, int h,
                           uint8_t *rgb, char *err, size_t errlen) {
    size_t pos = 0, npix = (size_t)w * (size_t)h, done = 0;
    uint8_t *line = NULL;
    int flat = w < 8 || w > 0x7fff;
    while (!flat && done < npix) {
        if (len - pos < 4) goto short_data;
        const uint8_t *p = data + pos;
        if (p[0] != 2 || p[1] != 2 || (p[2] & 0x80)) {
            flat = 1;
            break;
        }
        if ((p[2] << 8 | p[3]) != w) {
            snprintf(err, errlen, "corrupt: a scanline of width %d in a "
                     "%d-wide image" NO_IMAGE, p[2] << 8 | p[3], w);
            free(line);
            return -1;
        }
        pos += 4;
        if (!line && !(line = malloc((size_t)w * 4))) {
            snprintf(err, errlen, "out of memory");
            return -1;
        }
        for (int c = 0; c < 4; c++) {
            uint8_t *q = line + (size_t)c * w, *end = q + w;
            while (q < end) {
                if (len - pos < 2) goto short_data;
                int count = data[pos];
                if (count > 128) {
                    count -= 128;
                    if (count > end - q) goto bad_run;
                    memset(q, data[pos + 1], (size_t)count);
                    q += count;
                    pos += 2;
                } else {
                    if (count == 0 || count > end - q) goto bad_run;
                    if (len - pos < (size_t)count + 1) goto short_data;
                    memcpy(q, data + pos + 1, (size_t)count);
                    q += count;
                    pos += (size_t)count + 1;
                }
            }
        }
        for (int x = 0; x < w; x++) {
            uint8_t px[4] = {line[x], line[w + x], line[2 * w + x],
                             line[3 * w + x]};
            rgbe_to_u8(px, rgb + 3 * (done + (size_t)x));
        }
        done += (size_t)w;
    }
    free(line);
    if (len - pos < 4 * (npix - done)) {
        snprintf(err, errlen, "truncated: flat pixel data ends %zu pixels "
                 "short" NO_IMAGE, npix - done - (len - pos) / 4);
        return -1;
    }
    for (; done < npix; done++, pos += 4) rgbe_to_u8(data + pos, rgb + 3 * done);
    return 0;
short_data:
    free(line);
    snprintf(err, errlen, "truncated: run-length data ends early" NO_IMAGE);
    return -1;
bad_run:
    free(line);
    snprintf(err, errlen, "corrupt: bad scanline data (a zero count or a run "
             "past the scanline)" NO_IMAGE);
    return -1;
}

static void float2rgbe(uint8_t rgbe[4], float r, float g, float b) {
    float v = r;
    if (g > v) v = g;
    if (b > v) v = b;
    if (v < 1e-32) {
        rgbe[0] = rgbe[1] = rgbe[2] = rgbe[3] = 0;
        return;
    }
    int e;
    v = (float)(frexp(v, &e) * 256.0 / v);
    rgbe[0] = (uint8_t)(int)(r * v);
    rgbe[1] = (uint8_t)(int)(g * v);
    rgbe[2] = (uint8_t)(int)(b * v);
    rgbe[3] = (uint8_t)(e + 128);
}

/* RGBE_WriteBytes_RLE of n bytes -> o; returns the bytes written. */
static size_t write_bytes_rle(const uint8_t *data, int n, uint8_t *o) {
    enum { MINRUN = 4 };
    uint8_t *start = o;
    int cur = 0;
    while (cur < n) {
        int beg = cur, run = 0, old_run = 0;
        while (run < MINRUN && beg < n) {
            beg += run;
            old_run = run;
            run = 1;
            while (beg + run < n && run < 127 && data[beg] == data[beg + run])
                run++;
        }
        if (old_run > 1 && old_run == beg - cur) {
            *o++ = (uint8_t)(128 + old_run);
            *o++ = data[cur];
            cur = beg;
        }
        while (cur < beg) {
            int lit = beg - cur;
            if (lit > 128) lit = 128;
            *o++ = (uint8_t)lit;
            memcpy(o, data + cur, (size_t)lit);
            o += lit;
            cur += lit;
        }
        if (run >= MINRUN) {
            *o++ = (uint8_t)(128 + run);
            *o++ = data[beg];
            cur += run;
        }
    }
    return (size_t)(o - start);
}

long yolo_hdr_encode_pixels(const uint8_t *rgb, int w, int h, uint8_t *out,
                            size_t outcap, char *err, size_t errlen) {
    size_t need = (size_t)w * (size_t)h * 5 + (size_t)h * 4 + 16;
    if (outcap < need) {
        snprintf(err, errlen, "HDR output buffer of %zu bytes for %zu",
                 outcap, need);
        return -1;
    }
    const float scale = 1.0f / 255.0f;
    uint8_t *o = out;
    int rle = w >= 8 && w <= 0x7fff;
    uint8_t *line = rle ? malloc((size_t)w * 4) : NULL;
    if (rle && !line) {
        snprintf(err, errlen, "out of memory");
        return -1;
    }
    for (int y = 0; y < h; y++) {
        const uint8_t *row = rgb + (size_t)y * w * 3;
        if (!rle) {
            for (int x = 0; x < w; x++, o += 4)
                float2rgbe(o, row[3 * x] * scale, row[3 * x + 1] * scale,
                           row[3 * x + 2] * scale);
            continue;
        }
        *o++ = 2;
        *o++ = 2;
        *o++ = (uint8_t)(w >> 8);
        *o++ = (uint8_t)(w & 0xff);
        for (int x = 0; x < w; x++) {
            uint8_t px[4];
            float2rgbe(px, row[3 * x] * scale, row[3 * x + 1] * scale,
                       row[3 * x + 2] * scale);
            for (int c = 0; c < 4; c++) line[(size_t)c * w + x] = px[c];
        }
        for (int c = 0; c < 4; c++)
            o += write_bytes_rle(line + (size_t)c * w, w, o);
    }
    free(line);
    return (long)(o - out);
}
