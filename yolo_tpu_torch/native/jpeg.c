/* Baseline JPEG decoder for the host data pipeline.
 *
 * Decodes sequential Huffman JPEGs (SOF0/SOF1, 8-bit samples, one
 * interleaved scan of 1 or 3 components) from memory into RGB or gray
 * bytes equal to what libjpeg-turbo gives with its default settings
 * (islow IDCT, fancy upsampling), i.e. to cv2.imread / cv2.imdecode
 * after COLOR_BGR2RGB, EXIF orientation applied as cv2 applies it:
 *
 *   - dequantization and the islow integer IDCT of jidctint.c
 *     (CONST_BITS 13, PASS1_BITS 2), its rounding and its post-IDCT
 *     range-limit table (jdmaster.c prepare_range_limit_table);
 *   - upsampling as jdsample.c selects it: h2v1 and h2v2 "fancy"
 *     (triangle) filters where the downsampled width exceeds 2, h1v2
 *     fancy always, box replication for the narrow cases and for any
 *     other integral factor; rows above the first and below the last
 *     real downsampled row repeat that row (jdmainct.c);
 *   - colour conversion with jdcolor.c's fixed-point tables
 *     (SCALEBITS 16); the colour space is chosen as jdapimin.c
 *     default_decompress_parms chooses it (JFIF, Adobe transform,
 *     component ids 'R','G','B');
 *   - the EXIF orientation tag of the first APP1 segment, read the way
 *     OpenCV's ExifReader reads it.
 *
 * Anything else (progressive, lossless, arithmetic or hierarchical
 * frames, 12-bit samples, 2 or 4 components, multi-scan files, corrupt
 * or truncated scan data) fails with a message; nothing is guessed.
 *
 * Plain C11, integer arithmetic only. Every call owns its state, so
 * calls on different threads run in parallel.
 */

#include <setjmp.h>
#include <stdarg.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "native.h"

#define CONST_BITS 13
#define PASS1_BITS 2
#define FIX_0_298631336 2446
#define FIX_0_390180644 3196
#define FIX_0_541196100 4433
#define FIX_0_765366865 6270
#define FIX_0_899976223 7373
#define FIX_1_175875602 9633
#define FIX_1_501321110 12299
#define FIX_1_847759065 15137
#define FIX_1_961570560 16069
#define FIX_2_053119869 16819
#define FIX_2_562915447 20995
#define FIX_3_072711026 25172
#define DESCALE(x, n) (((x) + ((int32_t)1 << ((n) - 1))) >> (n))

#define MAX_COMPS 3
#define MAX_ALLOCS 16

static const uint8_t natural_order[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

typedef struct {
    int defined;
    int32_t maxcode[18];
    int32_t valoffset[18];
    uint8_t huffval[256];
    uint8_t look_nbits[512]; /* 9-bit lookahead: code length, 0 = longer */
    uint8_t look_sym[512];
} huff_table;

typedef struct {
    int id, h, v, tq, td, ta;
    int dw, dh;               /* downsampled width and height */
    int bw, bh;               /* blocks across and down in the plane */
    int stride;               /* bw * 8 */
    uint8_t *plane;           /* bh * 8 rows of stride bytes */
    int16_t qt[64];           /* natural order, as ISLOW_MULT_TYPE */
    int dc_pred;
} component;

typedef struct {
    const uint8_t *data;
    size_t len, pos;
    char *err;
    size_t errlen;
    jmp_buf jb;
    void *allocs[MAX_ALLOCS];
    int nallocs;

    uint16_t qt[4][64];
    int qt_defined[4];
    huff_table dc[4], ac[4];
    int restart_interval;
    int width, height, ncomp, max_h, max_v, frame_seen;
    component comp[MAX_COMPS];
    int saw_jfif, saw_adobe, adobe_transform, orientation, saw_app1;

    /* scan bit reader */
    uint64_t bits;
    int nbits;                /* bits in the buffer, fill bits included */
    int fill;                 /* zero bits appended past a marker / end */
    int marker_hit;
} decoder;

static void fail(decoder *d, const char *fmt, ...) {
    va_list ap;
    va_start(ap, fmt);
    vsnprintf(d->err, d->errlen, fmt, ap);
    va_end(ap);
    longjmp(d->jb, 1);
}

static void *alloc(decoder *d, size_t n) {
    if (d->nallocs == MAX_ALLOCS) fail(d, "internal: too many buffers");
    void *p = calloc(n ? n : 1, 1);
    if (!p) fail(d, "out of memory (%zu bytes)", n);
    d->allocs[d->nallocs++] = p;
    return p;
}

static void free_all(decoder *d, void *keep) {
    for (int i = 0; i < d->nallocs; i++)
        if (d->allocs[i] != keep) free(d->allocs[i]);
    d->nallocs = 0;
}

static int u8(decoder *d) {
    if (d->pos >= d->len) fail(d, "truncated: the file ends inside a header");
    return d->data[d->pos++];
}

static int u16be(decoder *d) {
    int hi = u8(d);
    return (hi << 8) | u8(d);
}

/* ------------------------------------------------------------ markers */

static void read_dqt(decoder *d, size_t end) {
    while (d->pos < end) {
        int pq_tq = u8(d), pq = pq_tq >> 4, tq = pq_tq & 15;
        if (tq > 3) fail(d, "corrupt: DQT table index %d", tq);
        if (pq > 1) fail(d, "corrupt: DQT precision %d", pq);
        for (int k = 0; k < 64; k++)
            d->qt[tq][natural_order[k]] = (uint16_t)(pq ? u16be(d) : u8(d));
        d->qt_defined[tq] = 1;
    }
}

static void build_huff(decoder *d, huff_table *t, const uint8_t counts[17],
                       int is_dc) {
    char huffsize[257];
    uint32_t huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; l++) {
        int i = counts[l];
        if (p + i > 256) fail(d, "corrupt: bad Huffman table");
        while (i--) huffsize[p++] = (char)l;
    }
    huffsize[p] = 0;
    int nsym = p;
    uint32_t code = 0;
    int si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
        while (huffsize[p] == si) {
            huffcode[p++] = code;
            code++;
        }
        if (code >= ((uint32_t)1 << si))
            fail(d, "corrupt: bad Huffman table");
        code <<= 1;
        si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
        if (counts[l]) {
            t->valoffset[l] = p - (int32_t)huffcode[p];
            p += counts[l];
            t->maxcode[l] = (int32_t)huffcode[p - 1];
        } else {
            t->maxcode[l] = -1;
        }
    }
    t->valoffset[17] = 0;
    t->maxcode[17] = 0xFFFFF;
    memset(t->look_nbits, 0, sizeof t->look_nbits);
    p = 0;
    for (int l = 1; l <= 9; l++) {
        for (int i = 1; i <= counts[l]; i++, p++) {
            int lookbits = (int)(huffcode[p] << (9 - l));
            for (int ctr = 1 << (9 - l); ctr > 0; ctr--, lookbits++) {
                t->look_nbits[lookbits] = (uint8_t)l;
                t->look_sym[lookbits] = t->huffval[p];
            }
        }
    }
    if (is_dc)
        for (int i = 0; i < nsym; i++)
            if (t->huffval[i] > 15) fail(d, "corrupt: bad Huffman table");
    t->defined = 1;
}

static void read_dht(decoder *d, size_t end) {
    while (d->pos < end) {
        int tc_th = u8(d), tc = tc_th >> 4, th = tc_th & 15;
        if (tc > 1 || th > 3)
            fail(d, "corrupt: DHT class %d index %d", tc, th);
        uint8_t counts[17] = {0};
        int total = 0;
        for (int l = 1; l <= 16; l++) total += counts[l] = (uint8_t)u8(d);
        if (total > 256) fail(d, "corrupt: bad Huffman table");
        huff_table *t = tc ? &d->ac[th] : &d->dc[th];
        memset(t->huffval, 0, sizeof t->huffval);
        for (int i = 0; i < total; i++) t->huffval[i] = (uint8_t)u8(d);
        build_huff(d, t, counts, !tc);
    }
}

/* jstdhuff.c: Motion JPEG frames often leave out DHT; libjpeg-turbo then
 * loads the Annex K tables into the slots 0 and 1 still undefined when
 * decompression starts (the first SOS). */
static void std_huff_tables(decoder *d) {
    const uint8_t *bits[4] = {kDcLumaBits, kDcChromaBits, kAcLumaBits,
                              kAcChromaBits};
    const uint8_t *vals[4] = {kDcVals, kDcVals, kAcLumaVals, kAcChromaVals};
    for (int k = 0; k < 4; k++) {
        huff_table *t = k < 2 ? &d->dc[k] : &d->ac[k - 2];
        if (t->defined) continue;
        uint8_t counts[17] = {0};
        int total = 0;
        for (int l = 1; l <= 16; l++) total += counts[l] = bits[k][l - 1];
        memset(t->huffval, 0, sizeof t->huffval);
        memcpy(t->huffval, vals[k], (size_t)total);
        build_huff(d, t, counts, k < 2);
    }
}

static void read_sof(decoder *d, int marker) {
    if (d->frame_seen) fail(d, "unsupported: more than one frame header");
    d->frame_seen = 1;
    int precision = u8(d);
    d->height = u16be(d);
    d->width = u16be(d);
    d->ncomp = u8(d);
    if (precision != 8)
        fail(d, "unsupported: %d-bit samples (8-bit only)", precision);
    if (marker != 0xC0 && marker != 0xC1)
        fail(d, "internal: SOF%d", marker - 0xC0);
    if (d->height == 0)
        fail(d, "unsupported: frame height 0 (a DNL marker)");
    if (d->width == 0) fail(d, "corrupt: frame width 0");
    if (d->ncomp == 4)
        fail(d, "unsupported: 4-component (CMYK/YCCK) image");
    if (d->ncomp != 1 && d->ncomp != 3)
        fail(d, "unsupported: %d components", d->ncomp);
    d->max_h = d->max_v = 1;
    for (int i = 0; i < d->ncomp; i++) {
        component *c = &d->comp[i];
        c->id = u8(d);
        int hv = u8(d);
        c->h = hv >> 4;
        c->v = hv & 15;
        c->tq = u8(d);
        if (c->h < 1 || c->h > 4 || c->v < 1 || c->v > 4)
            fail(d, "corrupt: sampling factors %dx%d", c->h, c->v);
        if (c->tq > 3) fail(d, "corrupt: quantization table %d", c->tq);
        if (c->h > d->max_h) d->max_h = c->h;
        if (c->v > d->max_v) d->max_v = c->v;
    }
}

/* OpenCV's ExifReader on the first APP1 segment: the TIFF header 6 bytes
 * in, byte order, the 42 mark, IFD0, then tag 0x0112's short. */
static void read_exif(decoder *d, const uint8_t *p, size_t n) {
    if (n <= 6) return;
    p += 6;
    n -= 6;
    int le;
    if (n >= 2 && p[0] == 'I' && p[1] == 'I') le = 1;
    else if (n >= 2 && p[0] == 'M' && p[1] == 'M') le = 0;
    else return;
#define RD16(o) ((o) + 2 > n ? -1 : (int)(le ? (p[(o)] | p[(o) + 1] << 8) \
                                            : (p[(o)] << 8 | p[(o) + 1])))
    if (RD16(2) != 42 || n < 8) return;
    uint32_t ifd = le ? (uint32_t)p[4] | (uint32_t)p[5] << 8 |
                            (uint32_t)p[6] << 16 | (uint32_t)p[7] << 24
                      : (uint32_t)p[4] << 24 | (uint32_t)p[5] << 16 |
                            (uint32_t)p[6] << 8 | (uint32_t)p[7];
    int count = RD16((size_t)ifd);
    if (count < 0) return;
    for (int i = 0; i < count; i++) {
        size_t e = (size_t)ifd + 2 + (size_t)i * 12;
        int tag = RD16(e);
        if (tag < 0) return;
        if (tag == 0x0112) {
            int v = RD16(e + 8);
            if (v < 0) return;
            d->orientation = v;
        }
    }
#undef RD16
}

static void read_app(decoder *d, int marker, size_t end) {
    const uint8_t *p = d->data + d->pos;
    size_t n = end - d->pos;
    if (marker == 0xE0 && n >= 14 && memcmp(p, "JFIF", 5) == 0)
        d->saw_jfif = 1;
    if (marker == 0xEE && n >= 12 && memcmp(p, "Adobe", 5) == 0) {
        d->saw_adobe = 1;
        d->adobe_transform = p[11];
    }
    if (marker == 0xE1 && !d->saw_app1) {
        d->saw_app1 = 1;
        read_exif(d, p, n);
    }
}

/* --------------------------------------------------------- bit reader */

static void fill_bits(decoder *d) {
    while (d->nbits <= 56) {
        int byte = 0;
        if (!d->marker_hit && d->pos < d->len) {
            byte = d->data[d->pos];
            if (byte == 0xFF) {
                size_t q = d->pos + 1;
                while (q < d->len && d->data[q] == 0xFF) q++;
                if (q < d->len && d->data[q] == 0x00) {
                    d->pos = q + 1;
                } else {
                    d->marker_hit = 1;   /* pos stays on the marker */
                    d->pos = q - 1;
                    byte = 0;
                    d->fill += 8;
                }
            } else {
                d->pos++;
            }
        } else {
            d->fill += 8;
        }
        d->bits |= (uint64_t)byte << (56 - d->nbits);
        d->nbits += 8;
    }
}

static inline int get_bits(decoder *d, int n) {
    if (n == 0) return 0;
    if (d->nbits < n) fill_bits(d);
    int v = (int)(d->bits >> (64 - n));
    d->bits <<= n;
    d->nbits -= n;
    return v;
}

static inline int decode_huff(decoder *d, const huff_table *t) {
    if (d->nbits < 16) fill_bits(d);
    int look = (int)(d->bits >> (64 - 9));
    int nb = t->look_nbits[look];
    if (nb) {
        d->bits <<= nb;
        d->nbits -= nb;
        return t->look_sym[look];
    }
    int l = 10;
    int32_t code = (int32_t)(d->bits >> (64 - l));
    while (l <= 16 && code > t->maxcode[l]) {
        l++;
        code = (int32_t)(d->bits >> (64 - l));
    }
    if (l > 16) fail(d, "corrupt scan data: bad Huffman code");
    d->bits <<= l;
    d->nbits -= l;
    return t->huffval[(code + t->valoffset[l]) & 0xFF];
}

static inline int extend(int v, int s) {
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

static void check_not_past_end(decoder *d) {
    if (d->nbits < d->fill)
        fail(d, "truncated or corrupt scan data: the entropy-coded "
                "segment ends before the last MCU");
}

/* --------------------------------------------------------------- IDCT */

static uint8_t idct_limit[1024];   /* jdmaster.c's post-IDCT table */
static int cr_r[256], cb_b[256];   /* jdcolor.c build_ycc_rgb_table */
static int32_t cr_g[256], cb_g[256];

/* filled when the library loads, before any call can read them */
__attribute__((constructor)) static void init_tables(void) {
    /* v & 1023 -> sample: [0,128) -> v + 128, [128,512) -> 255,
     * [512,896) -> 0, [896,1024) -> v - 896 */
    for (int i = 0; i < 1024; i++) {
        int v;
        if (i < 128) v = i + 128;
        else if (i < 512) v = 255;
        else if (i < 896) v = 0;
        else v = i - 896;
        idct_limit[i] = (uint8_t)v;
    }
    /* SCALEBITS 16, x = i - 128 */
    for (int i = 0; i < 256; i++) {
        int32_t x = i - 128;
        cr_r[i] = (int)((91881 * x + 32768) >> 16);
        cb_b[i] = (int)((116130 * x + 32768) >> 16);
        cr_g[i] = -46802 * x;
        cb_g[i] = -22554 * x + 32768;
    }
}

static void idct_islow(const int16_t *in, const int16_t *qt, uint8_t *out,
                       int stride) {
    int32_t ws[64];
    for (int c = 0; c < 8; c++) {
        const int16_t *ip = in + c;
        const int16_t *qp = qt + c;
        int32_t *wp = ws + c;
        if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] &&
            !ip[48] && !ip[56]) {
            int32_t dc = ((int32_t)ip[0] * qp[0]) * (1 << PASS1_BITS);
            for (int r = 0; r < 8; r++) wp[r * 8] = dc;
            continue;
        }
        int32_t z1, z2, z3, z4, z5, t0, t1, t2, t3, t10, t11, t12, t13;
        z2 = (int32_t)ip[16] * qp[16];
        z3 = (int32_t)ip[48] * qp[48];
        z1 = (z2 + z3) * FIX_0_541196100;
        t2 = z1 + z3 * (-FIX_1_847759065);
        t3 = z1 + z2 * FIX_0_765366865;
        z2 = (int32_t)ip[0] * qp[0];
        z3 = (int32_t)ip[32] * qp[32];
        t0 = (z2 + z3) * (1 << CONST_BITS);
        t1 = (z2 - z3) * (1 << CONST_BITS);
        t10 = t0 + t3;
        t13 = t0 - t3;
        t11 = t1 + t2;
        t12 = t1 - t2;
        t0 = (int32_t)ip[56] * qp[56];
        t1 = (int32_t)ip[40] * qp[40];
        t2 = (int32_t)ip[24] * qp[24];
        t3 = (int32_t)ip[8] * qp[8];
        z1 = t0 + t3;
        z2 = t1 + t2;
        z3 = t0 + t2;
        z4 = t1 + t3;
        z5 = (z3 + z4) * FIX_1_175875602;
        t0 *= FIX_0_298631336;
        t1 *= FIX_2_053119869;
        t2 *= FIX_3_072711026;
        t3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        t0 += z1 + z3;
        t1 += z2 + z4;
        t2 += z2 + z3;
        t3 += z1 + z4;
        wp[0] = DESCALE(t10 + t3, CONST_BITS - PASS1_BITS);
        wp[56] = DESCALE(t10 - t3, CONST_BITS - PASS1_BITS);
        wp[8] = DESCALE(t11 + t2, CONST_BITS - PASS1_BITS);
        wp[48] = DESCALE(t11 - t2, CONST_BITS - PASS1_BITS);
        wp[16] = DESCALE(t12 + t1, CONST_BITS - PASS1_BITS);
        wp[40] = DESCALE(t12 - t1, CONST_BITS - PASS1_BITS);
        wp[24] = DESCALE(t13 + t0, CONST_BITS - PASS1_BITS);
        wp[32] = DESCALE(t13 - t0, CONST_BITS - PASS1_BITS);
    }
    for (int r = 0; r < 8; r++) {
        const int32_t *wp = ws + r * 8;
        uint8_t *op = out + (size_t)r * stride;
        if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] &&
            !wp[7]) {
            uint8_t v = idct_limit[DESCALE(wp[0], PASS1_BITS + 3) & 1023];
            memset(op, v, 8);
            continue;
        }
        int32_t z1, z2, z3, z4, z5, t0, t1, t2, t3, t10, t11, t12, t13;
        z2 = wp[2];
        z3 = wp[6];
        z1 = (z2 + z3) * FIX_0_541196100;
        t2 = z1 + z3 * (-FIX_1_847759065);
        t3 = z1 + z2 * FIX_0_765366865;
        t0 = (wp[0] + wp[4]) * (1 << CONST_BITS);
        t1 = (wp[0] - wp[4]) * (1 << CONST_BITS);
        t10 = t0 + t3;
        t13 = t0 - t3;
        t11 = t1 + t2;
        t12 = t1 - t2;
        t0 = wp[7];
        t1 = wp[5];
        t2 = wp[3];
        t3 = wp[1];
        z1 = t0 + t3;
        z2 = t1 + t2;
        z3 = t0 + t2;
        z4 = t1 + t3;
        z5 = (z3 + z4) * FIX_1_175875602;
        t0 *= FIX_0_298631336;
        t1 *= FIX_2_053119869;
        t2 *= FIX_3_072711026;
        t3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        t0 += z1 + z3;
        t1 += z2 + z4;
        t2 += z2 + z3;
        t3 += z1 + z4;
        const int n = CONST_BITS + PASS1_BITS + 3;
        op[0] = idct_limit[DESCALE(t10 + t3, n) & 1023];
        op[7] = idct_limit[DESCALE(t10 - t3, n) & 1023];
        op[1] = idct_limit[DESCALE(t11 + t2, n) & 1023];
        op[6] = idct_limit[DESCALE(t11 - t2, n) & 1023];
        op[2] = idct_limit[DESCALE(t12 + t1, n) & 1023];
        op[5] = idct_limit[DESCALE(t12 - t1, n) & 1023];
        op[3] = idct_limit[DESCALE(t13 + t0, n) & 1023];
        op[4] = idct_limit[DESCALE(t13 - t0, n) & 1023];
    }
}

/* --------------------------------------------------------------- scan */

static void decode_block(decoder *d, component *c, int16_t blk[64]) {
    memset(blk, 0, 64 * sizeof *blk);
    int s = decode_huff(d, &d->dc[c->td]);
    if (s) s = extend(get_bits(d, s), s);
    c->dc_pred += s;
    blk[0] = (int16_t)c->dc_pred;
    const huff_table *ac = &d->ac[c->ta];
    for (int k = 1; k < 64; k++) {
        int rs = decode_huff(d, ac);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
            k += r;
            if (k > 63) fail(d, "corrupt scan data: AC index past 63");
            blk[natural_order[k]] = (int16_t)extend(get_bits(d, s), s);
        } else {
            if (r != 15) break;
            k += 15;
        }
    }
    check_not_past_end(d);
}

static void restart(decoder *d, int *expected_rst) {
    /* drop the partial byte's padding and any bytes before the next
     * marker (libjpeg skips them with a warning), then read RSTn */
    d->bits = 0;
    d->nbits = 0;
    d->fill = 0;
    d->marker_hit = 0;
    while (d->pos + 1 < d->len &&
           (d->data[d->pos] != 0xFF || d->data[d->pos + 1] == 0x00 ||
            d->data[d->pos + 1] == 0xFF))
        d->pos++;
    if (d->pos + 1 >= d->len || d->data[d->pos] != 0xFF ||
        d->data[d->pos + 1] != 0xD0 + *expected_rst)
        fail(d, "corrupt scan data: missing or out-of-order RST%d marker",
             *expected_rst);
    d->pos += 2;
    *expected_rst = (*expected_rst + 1) & 7;
    for (int i = 0; i < d->ncomp; i++) d->comp[i].dc_pred = 0;
}

static void decode_scan(decoder *d, component **sc, int ns) {
    int16_t blk[64];
    int rst = 0, left = d->restart_interval;
    if (ns == 1) {
        component *c = sc[0];
        for (int by = 0; by < c->bh; by++)
            for (int bx = 0; bx < c->bw; bx++) {
                if (d->restart_interval) {
                    if (left == 0) {
                        restart(d, &rst);
                        left = d->restart_interval;
                    }
                    left--;
                }
                decode_block(d, c, blk);
                idct_islow(blk, c->qt,
                           c->plane + (size_t)by * 8 * c->stride + bx * 8,
                           c->stride);
            }
        return;
    }
    int mcux = (d->width + 8 * d->max_h - 1) / (8 * d->max_h);
    int mcuy = (d->height + 8 * d->max_v - 1) / (8 * d->max_v);
    for (int my = 0; my < mcuy; my++)
        for (int mx = 0; mx < mcux; mx++) {
            if (d->restart_interval) {
                if (left == 0) {
                    restart(d, &rst);
                    left = d->restart_interval;
                }
                left--;
            }
            for (int i = 0; i < ns; i++) {
                component *c = sc[i];
                for (int v = 0; v < c->v; v++)
                    for (int h = 0; h < c->h; h++) {
                        decode_block(d, c, blk);
                        size_t y = (size_t)(my * c->v + v) * 8;
                        size_t x = (size_t)(mx * c->h + h) * 8;
                        idct_islow(blk, c->qt,
                                   c->plane + y * c->stride + x, c->stride);
                    }
            }
        }
}

/* --------------------------------------------------------- upsampling */

static inline const uint8_t *row_at(const component *c, int y) {
    if (y < 0) y = 0;
    if (y >= c->dh) y = c->dh - 1;
    return c->plane + (size_t)y * c->stride;
}

/* component plane -> full-size width x height plane, jdsample.c's way */
static void upsample(decoder *d, const component *c, uint8_t *out,
                     uint8_t *tmp) {
    const int W = d->width, H = d->height;
    const int fh = d->max_h / c->h, fv = d->max_v / c->v;
    const int dw = c->dw;
    for (int y = 0; y < H; y++) {
        uint8_t *op = out + (size_t)y * W;
        if (fh == 1 && fv == 1) {
            memcpy(op, row_at(c, y), W);
        } else if (fh == 2 && fv == 1 && dw > 2) {
            const uint8_t *ip = row_at(c, y);
            int v = ip[0];
            tmp[0] = (uint8_t)v;
            tmp[1] = (uint8_t)((v * 3 + ip[1] + 2) >> 2);
            for (int x = 1; x < dw - 1; x++) {
                v = ip[x] * 3;
                tmp[2 * x] = (uint8_t)((v + ip[x - 1] + 1) >> 2);
                tmp[2 * x + 1] = (uint8_t)((v + ip[x + 1] + 2) >> 2);
            }
            v = ip[dw - 1];
            tmp[2 * dw - 2] = (uint8_t)((v * 3 + ip[dw - 2] + 1) >> 2);
            tmp[2 * dw - 1] = (uint8_t)v;
            memcpy(op, tmp, W);
        } else if (fh == 1 && fv == 2) {
            const int r = y >> 1, lower = y & 1;
            const uint8_t *p0 = row_at(c, r);
            const uint8_t *p1 = row_at(c, lower ? r + 1 : r - 1);
            const int bias = lower ? 2 : 1;
            for (int x = 0; x < W; x++)
                op[x] = (uint8_t)((p0[x] * 3 + p1[x] + bias) >> 2);
        } else if (fh == 2 && fv == 2 && dw > 2) {
            const int r = y >> 1, lower = y & 1;
            const uint8_t *p0 = row_at(c, r);
            const uint8_t *p1 = row_at(c, lower ? r + 1 : r - 1);
            int this_ = p0[0] * 3 + p1[0], next = p0[1] * 3 + p1[1], last;
            tmp[0] = (uint8_t)((this_ * 4 + 8) >> 4);
            tmp[1] = (uint8_t)((this_ * 3 + next + 7) >> 4);
            last = this_;
            this_ = next;
            for (int x = 2; x < dw; x++) {
                next = p0[x] * 3 + p1[x];
                tmp[2 * x - 2] = (uint8_t)((this_ * 3 + last + 8) >> 4);
                tmp[2 * x - 1] = (uint8_t)((this_ * 3 + next + 7) >> 4);
                last = this_;
                this_ = next;
            }
            tmp[2 * dw - 2] = (uint8_t)((this_ * 3 + last + 8) >> 4);
            tmp[2 * dw - 1] = (uint8_t)((this_ * 4 + 7) >> 4);
            memcpy(op, tmp, W);
        } else {
            const uint8_t *ip = row_at(c, y / fv);
            for (int x = 0; x < W; x++) op[x] = ip[x / fh];
        }
    }
}

/* ------------------------------------------------------ colour, EXIF */

static void ycc_to_rgb(const uint8_t *Y, const uint8_t *Cb, const uint8_t *Cr,
                       uint8_t *out, size_t n) {
    for (size_t i = 0; i < n; i++) {
        int y = Y[i], cb = Cb[i], cr = Cr[i];
        int r = y + cr_r[cr];
        int g = y + (int)((cb_g[cb] + cr_g[cr]) >> 16);
        int b = y + cb_b[cb];
        out[3 * i] = (uint8_t)(r < 0 ? 0 : r > 255 ? 255 : r);
        out[3 * i + 1] = (uint8_t)(g < 0 ? 0 : g > 255 ? 255 : g);
        out[3 * i + 2] = (uint8_t)(b < 0 ? 0 : b > 255 ? 255 : b);
    }
}

/* cv2's ApplyExifOrientation: 2 flip x, 3 flip both, 4 flip y,
 * 5 transpose, 6 transpose + flip x, 7 transpose + flip both,
 * 8 transpose + flip y. */
static void orient(const uint8_t *src, int h, int w, int ch, int o,
                   uint8_t *dst) {
    const int transpose = o >= 5;
    const int oh = transpose ? w : h, ow = transpose ? h : w;
    const int fx = o == 2 || o == 3 || o == 6 || o == 7;
    const int fy = o == 3 || o == 4 || o == 7 || o == 8;
    for (int y = 0; y < oh; y++)
        for (int x = 0; x < ow; x++) {
            int ty = fy ? oh - 1 - y : y, tx = fx ? ow - 1 - x : x;
            int sy = transpose ? tx : ty, sx = transpose ? ty : tx;
            memcpy(dst + ((size_t)y * ow + x) * ch,
                   src + ((size_t)sy * w + sx) * ch, ch);
        }
}

/* -------------------------------------------------------------- entry */

static uint8_t *decode(decoder *d, int channels, int *out_h, int *out_w) {
    if (d->len < 2 || d->data[0] != 0xFF || d->data[1] != 0xD8)
        fail(d, "not a JPEG file (no SOI marker)");
    d->pos = 2;
    component *scan[MAX_COMPS];
    int ns = 0;
    for (;;) {
        /* next marker: FF (FF...) xx */
        int b = u8(d);
        if (b != 0xFF)
            fail(d, "corrupt: expected a marker at byte %zu", d->pos - 1);
        int m;
        do m = u8(d); while (m == 0xFF);
        if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
        if (m == 0xD9) fail(d, "corrupt: EOI before any scan");
        size_t seg = (size_t)u16be(d);
        if (seg < 2 || d->pos + seg - 2 > d->len)
            fail(d, "truncated: segment 0x%02X runs past the end", m);
        size_t end = d->pos + seg - 2;
        if (m == 0xC0 || m == 0xC1) {
            read_sof(d, m);
        } else if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE) {
            fail(d, "unsupported: progressive JPEG (SOF%d)", m - 0xC0);
        } else if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF) {
            fail(d, "unsupported: lossless JPEG (SOF%d)", m - 0xC0);
        } else if (m == 0xC9 || m == 0xCC) {
            fail(d, "unsupported: arithmetic-coded JPEG");
        } else if (m == 0xC5 || m == 0xCD || m == 0xDE || m == 0xDF) {
            fail(d, "unsupported: hierarchical JPEG");
        } else if (m == 0xC4) {
            read_dht(d, end);
        } else if (m == 0xDB) {
            read_dqt(d, end);
        } else if (m == 0xDD) {
            if (seg < 4) fail(d, "corrupt: DRI segment");
            d->restart_interval = u16be(d);
        } else if (m >= 0xE0 && m <= 0xEF) {
            read_app(d, m, end);
        } else if (m == 0xDA) {
            if (!d->frame_seen) fail(d, "corrupt: SOS before the frame");
            std_huff_tables(d);
            ns = u8(d);
            if (ns != d->ncomp)
                fail(d, "unsupported: multi-scan sequential JPEG (a scan of "
                        "%d of %d components)", ns, d->ncomp);
            for (int i = 0; i < ns; i++) {
                int id = u8(d), t = u8(d), k;
                for (k = 0; k < d->ncomp && d->comp[k].id != id; k++) {}
                if (k == d->ncomp)
                    fail(d, "corrupt: scan names unknown component %d", id);
                scan[i] = &d->comp[k];
                scan[i]->td = t >> 4;
                scan[i]->ta = t & 15;
                if (scan[i]->td > 3 || scan[i]->ta > 3 ||
                    !d->dc[scan[i]->td].defined ||
                    !d->ac[scan[i]->ta].defined)
                    fail(d, "corrupt: scan uses an undefined Huffman table");
            }
            d->pos = end;
            break;
        } else if (m != 0xFE && m != 0xDC && !(m >= 0xF0 && m <= 0xFD)) {
            fail(d, "corrupt: unexpected marker 0x%02X", m);
        }
        d->pos = end;
    }

    const int W = d->width, H = d->height;
    int blocks = 0;
    for (int i = 0; i < d->ncomp; i++) {
        component *c = &d->comp[i];
        if (d->max_h % c->h || d->max_v % c->v)
            fail(d, "unsupported: non-integral sampling factors");
        if (!d->qt_defined[c->tq])
            fail(d, "corrupt: quantization table %d not defined", c->tq);
        for (int k = 0; k < 64; k++) c->qt[k] = (int16_t)d->qt[c->tq][k];
        c->dw = (int)(((int64_t)W * c->h + d->max_h - 1) / d->max_h);
        c->dh = (int)(((int64_t)H * c->v + d->max_v - 1) / d->max_v);
        if (ns == 1) {
            c->bw = (c->dw + 7) / 8;
            c->bh = (c->dh + 7) / 8;
        } else {
            c->bw = (W + 8 * d->max_h - 1) / (8 * d->max_h) * c->h;
            c->bh = (H + 8 * d->max_v - 1) / (8 * d->max_v) * c->v;
        }
        c->stride = c->bw * 8;
        c->plane = alloc(d, (size_t)c->stride * c->bh * 8);
        blocks += c->h * c->v;
    }
    if (ns > 1 && blocks > 10)
        fail(d, "corrupt: %d blocks in an MCU (at most 10)", blocks);

    decode_scan(d, scan, ns);

    /* after the scan: EOI, or markers before it; another scan is a
     * multi-scan file. A complete scan without EOI is accepted. */
    d->bits = 0;
    d->nbits = 0;
    while (d->pos + 1 < d->len) {
        if (d->data[d->pos] != 0xFF) {
            d->pos++;
            continue;
        }
        int m = d->data[d->pos + 1];
        if (m == 0xD9) break;
        if (m == 0xDA)
            fail(d, "unsupported: multi-scan sequential JPEG");
        d->pos += 2;
    }

    /* colour space: jdapimin.c default_decompress_parms */
    int rgb_source = 0;
    if (d->ncomp == 3) {
        if (d->saw_jfif) rgb_source = 0;
        else if (d->saw_adobe) rgb_source = d->adobe_transform == 0;
        else rgb_source = d->comp[0].id == 'R' && d->comp[1].id == 'G' &&
                          d->comp[2].id == 'B';
    }
    const size_t npix = (size_t)W * H;
    uint8_t *tmp = alloc(d, (size_t)W * 2 + 64);
    uint8_t *full[MAX_COMPS];
    int nfull = d->ncomp;
    if (channels == 1 && d->ncomp == 3 && !rgb_source) nfull = 1;
    for (int i = 0; i < nfull; i++) {
        full[i] = alloc(d, npix);
        upsample(d, &d->comp[i], full[i], tmp);
    }
    uint8_t *img = alloc(d, npix * channels);
    if (channels == 3) {
        if (d->ncomp == 1) {
            for (size_t i = 0; i < npix; i++)
                img[3 * i] = img[3 * i + 1] = img[3 * i + 2] = full[0][i];
        } else if (rgb_source) {
            for (size_t i = 0; i < npix; i++) {
                img[3 * i] = full[0][i];
                img[3 * i + 1] = full[1][i];
                img[3 * i + 2] = full[2][i];
            }
        } else {
            ycc_to_rgb(full[0], full[1], full[2], img, npix);
        }
    } else if (nfull == 1) {
        memcpy(img, full[0], npix);
    } else {
        /* jdcolor.c rgb_gray_convert: FIX(0.299), FIX(0.587), FIX(0.114) */
        for (size_t i = 0; i < npix; i++)
            img[i] = (uint8_t)((19595 * full[0][i] + 38470 * full[1][i] +
                                7471 * full[2][i] + 32768) >> 16);
    }
    int o = d->orientation;
    if (o >= 2 && o <= 8) {
        uint8_t *dst = alloc(d, npix * channels);
        orient(img, H, W, channels, o, dst);
        img = dst;
        *out_h = o >= 5 ? W : H;
        *out_w = o >= 5 ? H : W;
    } else {
        *out_h = H;
        *out_w = W;
    }
    return img;
}

int yolo_jpeg_decode(const uint8_t *data, size_t len, int channels,
                     uint8_t **out, int *out_h, int *out_w, char *err,
                     size_t errlen) {
    decoder *d = calloc(1, sizeof *d);
    if (!d) {
        snprintf(err, errlen, "out of memory");
        return -1;
    }
    d->data = data;
    d->len = len;
    d->err = err;
    d->errlen = errlen;
    d->orientation = 1;
    if (channels != 1 && channels != 3) {
        snprintf(err, errlen, "channels=%d (1 or 3)", channels);
        free(d);
        return -1;
    }
    if (setjmp(d->jb)) {
        free_all(d, NULL);
        free(d);
        return -1;
    }
    uint8_t *img = decode(d, channels, out_h, out_w);
    free_all(d, img);
    free(d);
    *out = img;
    return 0;
}

void yolo_native_free(void *p) { free(p); }
