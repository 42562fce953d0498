/* BMP decoder for the host data pipeline: the bytes cv2.imread /
 * cv2.imdecode give (OpenCV 5's grfmt_bmp.cpp), after COLOR_BGR2RGB at 3
 * channels, IMREAD_GRAYSCALE's at 1:
 *
 *   - BITMAPCOREHEADER (12 bytes, 3-byte palette entries) and the
 *     INFO / V4 / V5 headers (36 bytes or more); rows bottom-up, or
 *     top-down where the height is negative;
 *   - 1, 4 and 8 bits through the palette (entries past the used ones
 *     are zero); 4 and 8 bits RLE-coded as grfmt_bmp.cpp reads them:
 *     runs and absolute runs may not cross a row's end (cv2 gives no
 *     image then), end-of-line, delta and end-of-bitmap escapes fill the
 *     pixels they pass over, in raster order, with palette entry 0 (in
 *     RLE4 a delta passes over its x only and the end of bitmap ends
 *     just the row, as OpenCV reads them);
 *   - 16 bits 555 (BI_RGB), 555 or 565 through BI_BITFIELDS, whose three
 *     masks OpenCV reads right after the header (for a V4 or V5 header,
 *     past its own masks); other masks give no image;
 *   - 24 bits, and 32 bits (BI_RGB or BI_BITFIELDS) with the fourth byte
 *     dropped; a V4 / V5 header's own masks of 32-bit BI_BITFIELDS must
 *     be 8-bit B, G, R (others raise, though cv2 reads them), and its
 *     gray is OpenCV's float weighting, truncated;
 *   - gray: icvCvt_BGR2Gray_8u_C3C1R's BT.601 weights (4899, 9617, 1868
 *     of 1 << 14, rounded) of the BGR pixel or palette entry; 16-bit
 *     pixels weighted after their expansion to 8 bits.
 *
 * What cv2 gives no image for fails, with a message that says so:
 * other bit depths or compressions (BI_JPEG, BI_PNG), a width of 0 or
 * less, more than 256 palette entries, and files that end before their
 * last row or RLE code.
 *
 * Plain C11, no state between calls.
 */

#include <stdarg.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "native.h"

#define NO_IMAGE "; cv2 gives no image either"

typedef struct {
    const uint8_t *data;
    size_t len, pos;
    char *err;
    size_t errlen;
    int failed;
} reader;

static void fail(reader *r, const char *fmt, ...) {
    if (r->failed) return;
    va_list ap;
    va_start(ap, fmt);
    vsnprintf(r->err, r->errlen, fmt, ap);
    va_end(ap);
    r->failed = 1;
}

/* RBaseStream: reading past the end throws, and cv2 gives no image */
static int take(reader *r, void *dst, size_t n) {
    if (r->failed) return 0;
    if (r->pos > r->len || r->len - r->pos < n) {
        fail(r, "truncated: the file ends inside its pixel data" NO_IMAGE);
        return 0;
    }
    memcpy(dst, r->data + r->pos, n);
    r->pos += n;
    return 1;
}

static int byte_at(reader *r) {
    uint8_t b = 0;
    take(r, &b, 1);
    return b;
}

static uint32_t le32(const uint8_t *p) {
    return (uint32_t)p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16 |
           (uint32_t)p[3] << 24;
}

static int bgr_gray(int b, int g, int r) {
    return (b * 1868 + g * 9617 + r * 4899 + 8192) >> 14;
}

/* the gray of a 32-bit pixel read through a V4 / V5 header's masks:
 * OpenCV weighs the channels in float and truncates */
static int masked_gray(const uint8_t bgr[3]) {
    float v = (float)bgr[2] * 0.299f + (float)bgr[1] * 0.587f;
    v += (float)bgr[0] * 0.114f;
    return (int)v;
}

/* the image as OpenCV fills it: nch bytes a pixel (BGR or gray), rows
 * from the bottom where origin_bl, so the write cursor moves as
 * grfmt_bmp.cpp's data pointer with its signed step */
typedef struct {
    uint8_t *img;
    int w, h, nch, bottom_up;
    int y;              /* rows done */
    int x;              /* pixels into the current row */
} canvas;

static uint8_t *cur(canvas *c) {
    int row = c->bottom_up ? c->h - 1 - c->y : c->y;
    return c->img + ((size_t)row * c->w + c->x) * c->nch;
}

static void put(canvas *c, const uint8_t bgr[3], int gray) {
    uint8_t *p = cur(c);
    if (c->nch == 3) memcpy(p, bgr, 3);
    else *p = (uint8_t)gray;
    c->x++;
}

/* FillUniColor / FillUniGray: count pixels of one colour from the
 * cursor, wrapping to the next row at a row's end (also when count is
 * 0 and the cursor stands at the end); stops after the last row */
static void fill_uni(canvas *c, long count, const uint8_t bgr[3], int gray) {
    do {
        long room = c->w - c->x;
        long n = count < room ? count : room;
        count -= n;
        while (n-- > 0) put(c, bgr, gray);
        if (c->x >= c->w) {
            c->x = 0;
            if (++c->y >= c->h) break;
        }
    } while (count > 0);
}

static int decode_rle(reader *r, canvas *c, int bpp, uint8_t pal[256][3],
                      const uint8_t *gpal) {
    int line_end_flag = 0;
    uint8_t src[256];
    for (;;) {
        int len = byte_at(r), code = byte_at(r);
        if (r->failed) return 0;
        if (len) {                             /* encoded run */
            if (c->x + len > c->w) return 0;
            if (bpp == 8) {
                int prev = c->y;
                fill_uni(c, len, pal[code], gpal[code]);
                line_end_flag = c->y - prev;
                if (c->y >= c->h) return 1;
            } else {
                const int idx[2] = {code >> 4, code & 15};
                for (int t = 0; t < len; t++)
                    put(c, pal[idx[t & 1]], gpal[idx[t & 1]]);
            }
        } else if (code > 2) {                 /* absolute run */
            if (c->x + code > c->w) return 0;
            int sz = bpp == 8 ? (code + 1) & ~1 : (((code + 1) >> 1) + 1) & ~1;
            if (!take(r, src, (size_t)sz)) return 0;
            for (int i = 0; i < code; i++) {
                int v = bpp == 8 ? src[i] : i & 1 ? src[i >> 1] & 15
                                                  : src[i >> 1] >> 4;
                put(c, pal[v], gpal[v]);
            }
            line_end_flag = 0;
        } else {                               /* escapes */
            long shift = c->w - c->x, yshift = c->h - c->y;
            if (bpp == 8 && !(code || !line_end_flag || shift < c->w)) {
                line_end_flag = 0;             /* EOL right after a wrap */
                continue;
            }
            if (code == 2) {
                shift = byte_at(r);
                yshift = byte_at(r);
                if (r->failed) return 0;
            }
            /* RLE4 moves by the delta's x alone, and its end of bitmap
             * ends the row only (reading goes on) */
            if (code && bpp == 8) shift += yshift * c->w;
            if (bpp == 8 && c->y >= c->h) return 1;
            fill_uni(c, shift, pal[0], gpal[0]);
            line_end_flag = 0;
            if (c->y >= c->h) return 1;
        }
    }
}

int yolo_bmp_decode(const uint8_t *data, size_t len, int channels,
                    uint8_t **out, int *out_h, int *out_w, char *err,
                    size_t errlen) {
    reader rd = {data, len, 0, err, errlen, 0};
    reader *r = &rd;
    uint8_t hdr[64] = {0};
    if (channels != 1 && channels != 3) {
        snprintf(err, errlen, "channels=%d (1 or 3)", channels);
        return -1;
    }
    if (len < 18 || data[0] != 'B' || data[1] != 'M') {
        snprintf(err, errlen, "not a BMP file" NO_IMAGE);
        return -1;
    }
    r->pos = 10;
    take(r, hdr, 8);
    const uint32_t offset = le32(hdr);
    const uint32_t size = le32(hdr + 4);
    long w, h;
    int bpp, comp = 0, masked = 0;
    uint32_t clrused = 0;
    uint8_t pal[256][3];                       /* BGR */
    memset(pal, 0, sizeof pal);
    if (size >= 36 && size < 0x80000000u) {
        take(r, hdr, 32);
        w = (int32_t)le32(hdr);
        h = (int32_t)le32(hdr + 4);
        bpp = (int)(le32(hdr + 8) >> 16);
        comp = (int)(int32_t)le32(hdr + 12);
        clrused = le32(hdr + 28);
        if (comp < 0 || comp > 3) {
            snprintf(err, errlen, "unsupported: BMP compression %d" NO_IMAGE,
                     comp);
            return -1;
        }
        r->pos = 14 + (size_t)size;            /* skip( size - 36 ) */
        int ok = w > 0 && h != 0 &&
                 ((((bpp == 1 || bpp == 4 || bpp == 8 || bpp == 24 ||
                     bpp == 32) && comp == 0) ||
                   ((bpp == 16 || bpp == 32) && (comp == 0 || comp == 3)) ||
                   (bpp == 4 && comp == 2) || (bpp == 8 && comp == 1)));
        if (!ok) {
            snprintf(err, errlen, "unsupported: a %d-bit BMP of compression "
                     "%d and size %ldx%ld" NO_IMAGE, bpp, comp, w, h);
            return -1;
        }
        if (bpp <= 8) {
            uint8_t raw[1024];
            if (clrused > 256) {
                snprintf(err, errlen, "corrupt: %u palette entries" NO_IMAGE,
                         clrused);
                return -1;
            }
            size_t n = clrused ? clrused : 1u << bpp;
            memset(raw, 0, sizeof raw);
            take(r, raw, n * 4);
            for (int i = 0; i < 256; i++) memcpy(pal[i], raw + 4 * i, 3);
        } else if (bpp == 16 && comp == 3) {
            uint8_t m[12];
            take(r, m, 12);
            uint32_t rm = le32(m), gm = le32(m + 4), bm = le32(m + 8);
            if (bm == 0x1f && gm == 0x3e0 && rm == 0x7c00) {
                bpp = 15;
            } else if (!(bm == 0x1f && gm == 0x7e0 && rm == 0xf800)) {
                if (!r->failed)
                    snprintf(err, errlen, "unsupported: 16-bit BMP masks "
                             "%08x %08x %08x (555 and 565 only)" NO_IMAGE,
                             rm, gm, bm);
                return -1;
            }
        } else if (bpp == 16) {
            bpp = 15;
        } else if (bpp == 32 && comp == 3 && size >= 56) {
            /* OpenCV reads the masks of a V4 / V5 header (at 54) and
             * takes the channels through them */
            if (len < 66) {
                snprintf(err, errlen, "truncated: the file ends inside its "
                         "header" NO_IMAGE);
                return -1;
            }
            uint32_t rm = le32(data + 54), gm = le32(data + 58),
                     bm = le32(data + 62);
            if (rm != 0xff0000 || gm != 0xff00 || bm != 0xff) {
                snprintf(err, errlen, "unsupported: 32-bit BMP masks %08x "
                         "%08x %08x (8-bit B, G, R only; cv2 reads them)",
                         rm, gm, bm);
                return -1;
            }
            masked = 1;
        }
    } else if (size == 12) {
        take(r, hdr, 8);
        w = hdr[0] | hdr[1] << 8;
        h = hdr[2] | hdr[3] << 8;
        bpp = (int)(le32(hdr + 4) >> 16);
        if (!(w > 0 && h != 0 && (bpp == 1 || bpp == 4 || bpp == 8 ||
                                  bpp == 24 || bpp == 32))) {
            snprintf(err, errlen, "unsupported: a %d-bit core BMP" NO_IMAGE,
                     bpp);
            return -1;
        }
        if (bpp <= 8) {
            uint8_t raw[768];
            take(r, raw, (size_t)3 << bpp);
            for (int i = 0; i < (1 << bpp); i++) memcpy(pal[i], raw + 3 * i, 3);
        }
    } else {
        snprintf(err, errlen, "unsupported: BMP header of %u bytes" NO_IMAGE,
                 size);
        return -1;
    }
    if (r->failed) return -1;
    const int bottom_up = h > 0;
    if (h < 0) h = -h;
    if ((uint64_t)h * (uint64_t)w * 3 >= (1ull << 30)) {
        snprintf(err, errlen, "unsupported: a %ldx%ld BMP (1 GiB or more)"
                 NO_IMAGE, w, h);
        return -1;
    }
    const int nch = channels;
    uint8_t gpal[256];
    for (int i = 0; i < 256; i++)
        gpal[i] = (uint8_t)bgr_gray(pal[i][0], pal[i][1], pal[i][2]);
    uint8_t *img = malloc((size_t)w * h * nch + 1);
    if (!img) {
        snprintf(err, errlen, "out of memory");
        return -1;
    }
    canvas cv = {img, (int)w, (int)h, nch, bottom_up, 0, 0};
    canvas *c = &cv;
    r->pos = offset;
    const size_t pitch = (((size_t)w * (bpp != 15 ? bpp : 16) + 7) / 8 + 3) &
                         ~(size_t)3;
    uint8_t *src = malloc(pitch + 32);
    int ok = src != NULL;
    if (ok && comp != 1 && comp != 2) {
        for (c->y = 0; c->y < h && ok; c->y++) {
            c->x = 0;
            if (!take(r, src, pitch)) {
                ok = 0;
                break;
            }
            if (bpp == 24 && nch == 3) {       /* the common file: a copy */
                memcpy(cur(c), src, (size_t)w * 3);
                continue;
            }
            for (long x = 0; x < w; x++) {
                uint8_t bgr[3];
                int v;
                switch (bpp) {
                case 1: v = src[x >> 3] >> (7 - (x & 7)) & 1;
                    memcpy(bgr, pal[v], 3); break;
                case 4: v = x & 1 ? src[x >> 1] & 15 : src[x >> 1] >> 4;
                    memcpy(bgr, pal[v], 3); break;
                case 8: memcpy(bgr, pal[src[x]], 3); break;
                case 15: case 16:
                    v = src[2 * x] | src[2 * x + 1] << 8;
                    bgr[0] = (uint8_t)((v << 3) & 0xf8);
                    bgr[1] = (uint8_t)(bpp == 15 ? (v >> 2) & 0xf8
                                                 : (v >> 3) & 0xfc);
                    bgr[2] = (uint8_t)(bpp == 15 ? (v >> 7) & 0xf8
                                                 : (v >> 8) & 0xf8);
                    break;
                case 24: memcpy(bgr, src + 3 * x, 3); break;
                default: memcpy(bgr, src + 4 * x, 3); break;
                }
                put(c, bgr, masked ? masked_gray(bgr) : bgr_gray(bgr[0], bgr[1],
                                                                 bgr[2]));
            }
        }
    } else if (ok) {
        c->y = c->x = 0;
        if (!decode_rle(r, c, comp == 1 ? 8 : 4, pal, gpal)) {
            ok = 0;
            if (!r->failed)
                fail(r, "corrupt: an RLE run past the end of its row"
                        NO_IMAGE);
        }
    }
    free(src);
    if (!ok) {
        if (!r->failed) snprintf(err, errlen, "out of memory");
        free(img);
        return -1;
    }
    if (nch == 3)      /* BGR -> RGB */
        for (size_t i = 0; i < (size_t)w * h; i++) {
            uint8_t t = img[3 * i];
            img[3 * i] = img[3 * i + 2];
            img[3 * i + 2] = t;
        }
    *out = img;
    *out_h = (int)h;
    *out_w = (int)w;
    return 0;
}
