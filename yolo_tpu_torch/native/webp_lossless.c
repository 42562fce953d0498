/* WebP lossless (VP8L) decoder for the host data pipeline, as libwebp
 * 1.x (vp8l_dec.c, lossless.c) decodes a "VP8L" chunk:
 *
 *   - the LSB-first bit reader and the image header (14-bit width and
 *     height less one, the alpha hint, version 0);
 *   - transforms, each at most once, undone in the reverse of their
 *     order: predictor (14 modes of the tile's green byte; black, then
 *     left along row 0, top down column 0; the top-right of a row's last
 *     pixel is the row's first), cross-colour (green-to-red,
 *     green-to-blue, red-to-blue deltas, (int8 * int8) >> 5),
 *     subtract-green, colour indexing (palette delta-coded, padded to its
 *     bit width with transparent black; 1, 2 or 4 bits an index packed
 *     into the green byte);
 *   - the colour cache (hash 0x1e35a7bd * argb >> (32 - bits)), every
 *     pixel inserted in order;
 *   - Huffman groups of five codes chosen per tile by the meta image,
 *     simple codes of one or two symbols, normal codes through the
 *     code-length code (order 17, 18, 0, 1, 2, 3, 4, 5, 16, 6, ...),
 *     repeat codes 16, 17 and 18, an optional max_symbol; a single-symbol
 *     code reads no bits; incomplete or over-subscribed codes fail;
 *   - backward references: length and distance prefix codes, distances
 *     1-120 through the plane map (at least 1).
 *
 * yolo_webp_decode_vp8l gives the (h, w, 4) RGBA bytes, alpha not
 * premultiplied (libwebp's MODE_RGBA). What libwebp refuses fails with
 * a message. Plain C11, no state between calls.
 */

#include <setjmp.h>
#include <stdarg.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "native.h"
#include "webp_tables.h"

#define NO_IMAGE "; cv2 gives no image either (libwebp fails there)"
#define NUM_LENGTH_CODES 24
#define NUM_DISTANCE_CODES 40
#define CODE_LENGTH_CODES 19
#define MAX_LENGTH 15

static const uint8_t kCodeLengthCodeOrder[CODE_LENGTH_CODES] = {
    17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};

typedef struct {
    const uint8_t *data;
    size_t len, pos;          /* bytes */
    uint64_t acc;
    int nacc;
    char *err;
    size_t errlen;
    jmp_buf jb;
    void **allocs;            /* every buffer, freed together */
    int nallocs, cap;
} lreader;

static void lfail(lreader *r, const char *fmt, ...) {
    va_list ap;
    va_start(ap, fmt);
    vsnprintf(r->err, r->errlen, fmt, ap);
    va_end(ap);
    longjmp(r->jb, 1);
}

static void *lalloc(lreader *r, size_t n) {
    if (r->nallocs == r->cap) {
        int cap = r->cap ? 2 * r->cap : 64;
        void **a = realloc(r->allocs, sizeof(void *) * (size_t)cap);
        if (!a) lfail(r, "out of memory");
        r->allocs = a;
        r->cap = cap;
    }
    void *p = calloc(n ? n : 1, 1);
    if (!p) lfail(r, "out of memory (%zu bytes)", n);
    r->allocs[r->nallocs++] = p;
    return p;
}

static void free_reader(lreader *r) {
    for (int i = 0; i < r->nallocs; i++) free(r->allocs[i]);
    free(r->allocs);
    free(r);
}

static uint32_t bits(lreader *r, int n) {
    if (n == 0) return 0;
    while (r->nacc < n) {
        if (r->pos >= r->len)
            lfail(r, "truncated: the lossless bitstream ends early" NO_IMAGE);
        r->acc |= (uint64_t)r->data[r->pos++] << r->nacc;
        r->nacc += 8;
    }
    uint32_t v = (uint32_t)(r->acc & ((1u << n) - 1));
    r->acc >>= n;
    r->nacc -= n;
    return v;
}

/* a canonical code as counts and sorted symbols; lookups walk it a bit
 * at a time (codes of at most 15 bits) */
typedef struct {
    int single;               /* the one symbol of a zero-bit code, or -1 */
    uint16_t count[MAX_LENGTH + 1];
    uint16_t *symbols;
} huffman;

static int read_symbol(lreader *r, const huffman *h) {
    if (h->single >= 0) return h->single;
    int code = 0, first = 0, index = 0;
    for (int len = 1; len <= MAX_LENGTH; len++) {
        code |= (int)bits(r, 1);
        int count = h->count[len];
        if (code - first < count) return h->symbols[index + code - first];
        index += count;
        first = (first + count) << 1;
        code <<= 1;
    }
    lfail(r, "corrupt: a Huffman code past its table" NO_IMAGE);
    return 0;
}

/* VP8LBuildHuffmanTable's checks: one symbol of any length is a zero-bit
 * code; otherwise the code must be complete */
static void build(lreader *r, huffman *h, const int *lengths, int n) {
    memset(h->count, 0, sizeof h->count);
    int nonzero = 0, last = 0;
    for (int s = 0; s < n; s++) {
        if (lengths[s] > MAX_LENGTH) lfail(r, "corrupt: code length" NO_IMAGE);
        if (lengths[s]) {
            h->count[lengths[s]]++;
            nonzero++;
            last = s;
        }
    }
    h->symbols = lalloc(r, sizeof(uint16_t) * (size_t)(n ? n : 1));
    h->single = -1;
    if (nonzero == 0)
        lfail(r, "corrupt: a Huffman code of no symbols" NO_IMAGE);
    if (nonzero == 1) {
        h->single = last;
        return;
    }
    int left = 1;
    for (int len = 1; len <= MAX_LENGTH; len++) {
        left = (left << 1) - h->count[len];
        if (left < 0) lfail(r, "corrupt: an over-subscribed Huffman code"
                               NO_IMAGE);
    }
    if (left != 0)
        lfail(r, "corrupt: an incomplete Huffman code" NO_IMAGE);
    int offs[MAX_LENGTH + 2];
    offs[1] = 0;
    for (int len = 1; len < MAX_LENGTH; len++)
        offs[len + 1] = offs[len] + h->count[len];
    for (int s = 0; s < n; s++)
        if (lengths[s]) h->symbols[offs[lengths[s]]++] = (uint16_t)s;
}

static void read_code_lengths(lreader *r, const int *cl_lengths, int n,
                              int *lengths) {
    huffman clh;
    build(r, &clh, cl_lengths, CODE_LENGTH_CODES);
    int max_symbol = n;
    if (bits(r, 1)) {
        int nbits = 2 + 2 * (int)bits(r, 3);
        max_symbol = 2 + (int)bits(r, nbits);
        if (max_symbol > n)
            lfail(r, "corrupt: max_symbol past the alphabet" NO_IMAGE);
    }
    int symbol = 0, prev = 8;
    while (symbol < n) {
        if (max_symbol-- == 0) break;
        int code = read_symbol(r, &clh);
        if (code < 16) {
            lengths[symbol++] = code;
            if (code) prev = code;
        } else {
            static const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
            int slot = code - 16;
            int repeat = (int)bits(r, extra[slot]) + offset[slot];
            if (symbol + repeat > n)
                lfail(r, "corrupt: a repeat past the alphabet" NO_IMAGE);
            int v = code == 16 ? prev : 0;
            while (repeat-- > 0) lengths[symbol++] = v;
        }
    }
}

static void read_code(lreader *r, huffman *h, int n) {
    int *lengths = lalloc(r, sizeof(int) * (size_t)n);
    if (bits(r, 1)) {                          /* simple code */
        int nsym = (int)bits(r, 1) + 1;
        int first = (int)bits(r, bits(r, 1) ? 8 : 1);
        if (first >= n) lfail(r, "corrupt: a symbol past the alphabet"
                                 NO_IMAGE);
        lengths[first] = 1;
        if (nsym == 2) {
            int second = (int)bits(r, 8);
            if (second >= n) lfail(r, "corrupt: a symbol past the alphabet"
                                      NO_IMAGE);
            lengths[second] = 1;
        }
    } else {
        int cl[CODE_LENGTH_CODES] = {0};
        int num = (int)bits(r, 4) + 4;
        for (int i = 0; i < num; i++) cl[kCodeLengthCodeOrder[i]] =
            (int)bits(r, 3);
        read_code_lengths(r, cl, n, lengths);
    }
    build(r, h, lengths, n);
}

typedef struct {
    huffman code[5];          /* green + lengths + cache, red, blue,
                               * alpha, distance */
} group;

typedef struct {
    int type, bits, xsize;    /* xsize: the width the transform undoes */
    uint32_t *data;           /* sub-image or palette */
} transform;

static uint32_t add_pixels(uint32_t a, uint32_t b) {
    uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
    uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
    return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

static int copy_distance(lreader *r, int sym) {
    if (sym < 4) return sym + 1;
    int extra = (sym - 2) >> 1;
    int offset = (2 + (sym & 1)) << extra;
    return offset + (int)bits(r, extra) + 1;
}

static uint32_t *decode_stream(lreader *r, int xsize, int ysize, int level0,
                               transform *tr, int *ntr, int *final_xsize);

/* the entropy-coded image of xsize x ysize (DecodeImageData) */
static uint32_t *decode_pixels(lreader *r, int xsize, int ysize,
                               int level0) {
    int cache_bits = 0;
    if (bits(r, 1)) {
        cache_bits = (int)bits(r, 4);
        if (cache_bits < 1 || cache_bits > 11)
            lfail(r, "corrupt: colour cache of %d bits" NO_IMAGE, cache_bits);
    }
    int meta_bits = 0, meta_xsize = 0, ngroups = 1;
    uint32_t *meta = NULL;
    if (level0 && bits(r, 1)) {
        meta_bits = (int)bits(r, 3) + 2;
        meta_xsize = (xsize + (1 << meta_bits) - 1) >> meta_bits;
        int meta_ysize = (ysize + (1 << meta_bits) - 1) >> meta_bits;
        meta = decode_stream(r, meta_xsize, meta_ysize, 0, NULL, NULL, NULL);
        int most = 0;
        for (size_t i = 0; i < (size_t)meta_xsize * meta_ysize; i++) {
            meta[i] = (meta[i] >> 8) & 0xffff;
            if ((int)meta[i] > most) most = (int)meta[i];
        }
        ngroups = most + 1;
    }
    const int cache_size = cache_bits ? 1 << cache_bits : 0;
    group *groups = lalloc(r, sizeof(group) * (size_t)ngroups);
    static const int base[5] = {256 + NUM_LENGTH_CODES, 256, 256, 256,
                                NUM_DISTANCE_CODES};
    for (int g = 0; g < ngroups; g++)
        for (int k = 0; k < 5; k++)
            read_code(r, &groups[g].code[k], base[k] + (k ? 0 : cache_size));
    uint32_t *cache = cache_size ? lalloc(r, sizeof(uint32_t) * cache_size)
                                 : NULL;
    const size_t total = (size_t)xsize * ysize;
    uint32_t *px = lalloc(r, sizeof(uint32_t) * (total ? total : 1));
    size_t pos = 0, cached = 0;
    while (pos < total) {
        const int x = (int)(pos % (size_t)xsize), y = (int)(pos / xsize);
        const group *gr = &groups[meta ? meta[(size_t)(y >> meta_bits) *
                                              meta_xsize + (x >> meta_bits)]
                                       : 0];
        int code = read_symbol(r, &gr->code[0]);
        if (code < 256) {
            int red = read_symbol(r, &gr->code[1]);
            int blue = read_symbol(r, &gr->code[2]);
            int alpha = read_symbol(r, &gr->code[3]);
            px[pos++] = (uint32_t)alpha << 24 | (uint32_t)red << 16 |
                        (uint32_t)code << 8 | (uint32_t)blue;
        } else if (code < 256 + NUM_LENGTH_CODES) {
            int length = copy_distance(r, code - 256);
            int dsym = read_symbol(r, &gr->code[4]);
            int dcode = copy_distance(r, dsym), dist;
            if (dcode > 120) {
                dist = dcode - 120;
            } else {
                int p = kCodeToPlane[dcode - 1];
                dist = (p >> 4) * xsize + (8 - (p & 0xf));
                if (dist < 1) dist = 1;
            }
            if ((size_t)dist > pos || (size_t)length > total - pos)
                lfail(r, "corrupt: a backward reference outside the image"
                         NO_IMAGE);
            for (int i = 0; i < length; i++, pos++) px[pos] = px[pos - dist];
        } else {
            if (!cache) lfail(r, "corrupt: a cache code without a cache"
                                 NO_IMAGE);
            while (cached < pos) {
                uint32_t v = px[cached++];
                cache[(0x1e35a7bdu * v) >> (32 - cache_bits)] = v;
            }
            px[pos++] = cache[code - 256 - NUM_LENGTH_CODES];
        }
        if (cache)
            while (cached < pos) {
                uint32_t v = px[cached++];
                cache[(0x1e35a7bdu * v) >> (32 - cache_bits)] = v;
            }
    }
    return px;
}

static uint32_t *decode_stream(lreader *r, int xsize, int ysize, int level0,
                               transform *tr, int *ntr, int *final_xsize) {
    if (level0) {
        int seen = 0;
        *ntr = 0;
        while (bits(r, 1)) {
            int type = (int)bits(r, 2);
            if (seen & (1 << type))
                lfail(r, "corrupt: a transform used twice" NO_IMAGE);
            seen |= 1 << type;
            transform *t = &tr[(*ntr)++];
            t->type = type;
            t->xsize = xsize;
            t->data = NULL;
            if (type == 0 || type == 1) {
                t->bits = (int)bits(r, 3) + 2;
                int bw = (xsize + (1 << t->bits) - 1) >> t->bits;
                int bh = (ysize + (1 << t->bits) - 1) >> t->bits;
                t->data = decode_stream(r, bw, bh, 0, NULL, NULL, NULL);
            } else if (type == 3) {
                int ncolors = (int)bits(r, 8) + 1;
                t->bits = ncolors > 16 ? 0 : ncolors > 4 ? 1
                          : ncolors > 2 ? 2 : 3;
                uint32_t *pal = decode_stream(r, ncolors, 1, 0, NULL, NULL,
                                              NULL);
                uint32_t *full = lalloc(r, sizeof(uint32_t) * 256);
                full[0] = pal[0];
                for (int i = 1; i < ncolors; i++)
                    full[i] = add_pixels(pal[i], full[i - 1]);
                t->data = full;
                xsize = (xsize + (1 << t->bits) - 1) >> t->bits;
            }
        }
        *final_xsize = xsize;
    }
    return decode_pixels(r, xsize, ysize, level0);
}

static uint32_t average2(uint32_t a, uint32_t b) {
    return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

static int sub3(int a, int b, int c) {
    int pb = b - c, pa = a - c;
    return abs(pb) - abs(pa);
}

static uint32_t select_px(uint32_t a, uint32_t b, uint32_t c) {
    int d = 0;
    for (int s = 0; s < 32; s += 8)
        d += sub3((int)(a >> s) & 0xff, (int)(b >> s) & 0xff,
                  (int)(c >> s) & 0xff);
    return d <= 0 ? a : b;
}

static uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }

static uint32_t clamped_full(uint32_t c0, uint32_t c1, uint32_t c2) {
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8) {
        int v = (int)((c0 >> s) & 0xff) + (int)((c1 >> s) & 0xff) -
                (int)((c2 >> s) & 0xff);
        out |= clip255((uint32_t)v) << s;
    }
    return out;
}

/* per channel clip(a + (a - c) / 2), a of average2(c0, c1) */
static uint32_t clamped_half(uint32_t c0, uint32_t c1, uint32_t c2) {
    uint32_t ave = average2(c0, c1), out = 0;
    for (int s = 0; s < 32; s += 8) {
        int a = (int)((ave >> s) & 0xff), c = (int)((c2 >> s) & 0xff);
        out |= clip255((uint32_t)(a + (a - c) / 2)) << s;
    }
    return out;
}

static uint32_t predict(int mode, const uint32_t *p, int x, int w) {
    const uint32_t L = p[x - 1], T = p[x - w], TL = p[x - w - 1],
                   TR = p[x - w + 1];
    switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return average2(average2(L, TR), T);
    case 6: return average2(L, TL);
    case 7: return average2(L, T);
    case 8: return average2(TL, T);
    case 9: return average2(T, TR);
    case 10: return average2(average2(L, TL), average2(T, TR));
    case 11: return select_px(T, L, TL);
    case 12: return clamped_full(L, T, TL);
    case 13: return clamped_half(L, T, TL);
    default: return 0xff000000u;
    }
}

/* one transform undone in place on px; colour indexing widens its rows
 * from the packed width to t->xsize (tmp: a row) */
static void undo(const transform *t, uint32_t *px, int ysize, uint32_t *tmp) {
    const int w = t->xsize;
    if (t->type == 2) {
        for (size_t i = 0; i < (size_t)w * ysize; i++) {
            uint32_t g = (px[i] >> 8) & 0xff, v = px[i];
            uint32_t rb = ((v & 0x00ff00ffu) + (g << 16 | g)) & 0x00ff00ffu;
            px[i] = (v & 0xff00ff00u) | rb;
        }
    } else if (t->type == 0) {
        const int tw = (w + (1 << t->bits) - 1) >> t->bits;
        for (int y = 0; y < ysize; y++) {
            uint32_t *row = px + (size_t)y * w;
            for (int x = 0; x < w; x++) {
                uint32_t pred;
                if (y == 0) pred = x == 0 ? 0xff000000u : row[x - 1];
                else if (x == 0) pred = row[-w];
                else pred = predict((int)(t->data[(size_t)(y >> t->bits) * tw +
                                                  (x >> t->bits)] >> 8) & 0xf,
                                    row, x, w);
                row[x] = add_pixels(row[x], pred);
            }
        }
    } else if (t->type == 1) {
        const int tw = (w + (1 << t->bits) - 1) >> t->bits;
        for (int y = 0; y < ysize; y++)
            for (int x = 0; x < w; x++) {
                uint32_t m = t->data[(size_t)(y >> t->bits) * tw +
                                     (x >> t->bits)];
                int8_t g2r = (int8_t)(m & 0xff), g2b = (int8_t)(m >> 8 & 0xff);
                int8_t r2b = (int8_t)(m >> 16 & 0xff);
                uint32_t *p = px + (size_t)y * w + x, v = *p;
                int8_t green = (int8_t)(v >> 8);
                int red = (int)(v >> 16 & 0xff), blue = (int)(v & 0xff);
                red += ((int)g2r * green) >> 5;
                red &= 0xff;
                blue += ((int)g2b * green) >> 5;
                blue += ((int)r2b * (int8_t)red) >> 5;
                blue &= 0xff;
                *p = (v & 0xff00ff00u) | (uint32_t)red << 16 | (uint32_t)blue;
            }
    } else {
        /* colour indexing: px holds the packed width; expand into width */
        const int b = t->bits, packed = (w + (1 << b) - 1) >> b;
        const int nbits = 8 >> b, mask = (1 << nbits) - 1;
        for (int y = ysize - 1; y >= 0; y--) {
            const uint32_t *src = px + (size_t)y * packed;
            memcpy(tmp, src, sizeof(uint32_t) * packed);
            uint32_t *dst = px + (size_t)y * w;
            for (int x = 0; x < w; x++) {
                int idx = (int)(tmp[x >> b] >> 8 & 0xff);
                if (b) idx = (idx >> ((x & ((1 << b) - 1)) * nbits)) & mask;
                dst[x] = t->data[idx];
            }
        }
    }
}

int yolo_webp_decode_vp8l(const uint8_t *data, size_t len, int channels,
                          uint8_t **out, int *out_h, int *out_w, char *err,
                          size_t errlen) {
    lreader *r = calloc(1, sizeof *r);
    if (!r) {
        snprintf(err, errlen, "out of memory");
        return -1;
    }
    r->data = data;
    r->len = len;
    r->err = err;
    r->errlen = errlen;
    if (setjmp(r->jb)) {
        free_reader(r);
        return -1;
    }
    if (channels != 4) lfail(r, "channels=%d (4: RGBA)", channels);
    if (len < 5 || data[0] != 0x2f)
        lfail(r, "corrupt: not a VP8L bitstream" NO_IMAGE);
    r->pos = 1;
    const int w = (int)bits(r, 14) + 1, h = (int)bits(r, 14) + 1;
    bits(r, 1);                                /* alpha hint */
    if (bits(r, 3) != 0) lfail(r, "unsupported: VP8L version" NO_IMAGE);
    transform tr[4];
    int ntr = 0, xs = w;
    uint32_t *px = decode_stream(r, w, h, 1, tr, &ntr, &xs);
    /* colour indexing widens the image in place: give it room */
    uint32_t *full = lalloc(r, sizeof(uint32_t) * (size_t)w * h);
    memcpy(full, px, sizeof(uint32_t) * (size_t)xs * h);
    uint32_t *tmp = lalloc(r, sizeof(uint32_t) * (size_t)w);
    for (int i = ntr - 1; i >= 0; i--)
        undo(&tr[i], full, h, tmp);
    uint8_t *img = malloc((size_t)w * h * 4);
    if (!img) lfail(r, "out of memory");
    for (size_t i = 0; i < (size_t)w * h; i++) {
        uint32_t v = full[i];
        img[4 * i] = (uint8_t)(v >> 16);
        img[4 * i + 1] = (uint8_t)(v >> 8);
        img[4 * i + 2] = (uint8_t)v;
        img[4 * i + 3] = (uint8_t)(v >> 24);
    }
    free_reader(r);
    *out = img;
    *out_h = h;
    *out_w = w;
    return 0;
}
