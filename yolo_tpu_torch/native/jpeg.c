/* JPEG decoder for the host data pipeline.
 *
 * Decodes every JPEG that cv2.imread / cv2.imdecode (OpenCV 5 on
 * libjpeg-turbo 3.1) gives pixels for, into the same RGB (after
 * COLOR_BGR2RGB) or gray bytes, EXIF orientation applied as cv2 applies
 * it:
 *
 *   - sequential Huffman frames (SOF0/SOF1) of one interleaved scan
 *     stream through decode_scan, block by block into sample planes;
 *   - every other DCT frame goes through whole-image coefficient planes
 *     (jdcoefct.c's buffered mode): sequential frames split over several
 *     scans, progressive Huffman frames (SOF2, jdphuff.c), arithmetic-
 *     coded frames (SOF9 sequential, SOF10 progressive; jdarith.c's QM
 *     decoder, DAC conditioning, statistics reset at each restart). Each
 *     scan decodes into the planes; after EOI, jdcoefct.c's block
 *     smoothing (where a progressive script leaves low AC coefficients
 *     unrefined) and the IDCT make the sample planes;
 *   - lossless frames (SOF3, jddiffct.c, jdlhuff.c, jdpred.c): 8-bit,
 *     any sampling factors, the components split over scans any way,
 *     restart intervals of whole MCU rows; gray read as gray and RGB as
 *     RGB, the only lossless outputs libjpeg-turbo converts;
 *   - dequantization and the islow integer IDCT as libjpeg-turbo's SIMD
 *     code runs it (jidctint-avx2.asm: jidctint.c's CONST_BITS 13,
 *     PASS1_BITS 2 and rounding in 16-bit lanes, which wrap in the
 *     dequantization and a few sums and saturate at each pack), so
 *     coefficients that overflow give cv2's bytes;
 *   - upsampling as jdsample.c selects it: h2v1 and h2v2 "fancy"
 *     (triangle) filters where the downsampled width exceeds 2, h1v2
 *     fancy always, box replication for the narrow cases, for any
 *     other integral factor and for lossless frames; rows above the first and below the last
 *     real downsampled row repeat that row (jdmainct.c);
 *   - colour conversion with jdcolor.c's fixed-point tables
 *     (SCALEBITS 16); the colour space is chosen as jdapimin.c
 *     default_decompress_parms chooses it (JFIF, Adobe transform,
 *     component ids 'R','G','B'); 4-component frames are CMYK (Adobe
 *     transform 0 or no Adobe marker) or YCCK (jdcolor.c
 *     ycck_cmyk_convert), then RGB or gray as OpenCV's grfmt_jpeg.cpp
 *     converts CMYK (icvCvt_CMYK2BGR_8u_C4C3R, icvCvt_CMYK2Gray_8u_C4C1R);
 *   - the EXIF orientation tag of the first APP1 segment, read the way
 *     OpenCV's ExifReader reads it.
 *
 * What cv2 gives no image for fails with a message that says so:
 * hierarchical frames, samples of other than 8 bits, 2 or more than 4
 * components, colour conversions of lossless frames libjpeg-turbo does
 * not make, lossless restart intervals that are not whole MCU rows,
 * truncated files (cv2.imdecode suspends at the end of the
 * buffer). Damaged entropy-coded data decodes as libjpeg-turbo decodes
 * it, warnings aside: a bad Huffman code reads as symbol 0, data cut by
 * a marker reads zeros and leaves the MCUs up to the next restart zero,
 * a lost or wrong restart marker is resynced as jdmarker.c resyncs it;
 * and a frame of one scan is given when that scan ends, whatever
 * follows it.
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

/* The phrase of every refusal that cv2 shares: it reads JPEG through
 * libjpeg-turbo, whose own message follows. */
#define CV2_TOO "; cv2 gives no image either (libjpeg-turbo: "
/* libjpeg-turbo stops at these header faults (ERREXIT) */
#define CV2_STOPS "; cv2 gives no image either (libjpeg-turbo stops there)"
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

#define MAX_COMPS 4
#define MAX_ALLOCS 40
#define NUM_ARITH_TBLS 16

/* zigzag -> natural order, with jutils.c's 16 extra entries: a run
 * that overshoots the block writes coefficient 63, as libjpeg's does */
static const uint8_t natural_order[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

typedef struct {
    int defined;
    int32_t maxcode[18];
    int32_t valoffset[18];
    uint8_t huffval[256];
    uint8_t look_nbits[512]; /* 9-bit lookahead: code length, 0 = longer */
    uint8_t look_sym[512];
    int max_sym;              /* of a DC table: at most 15 (16 lossless) */
} huff_table;

typedef struct {
    int id, h, v, tq, td, ta;
    int dw, dh;               /* downsampled width and height */
    int bw, bh;               /* blocks across and down in the plane */
    int stride;               /* bw * 8 */
    uint8_t *plane;           /* bh * 8 rows of stride bytes */
    int16_t qt[64];           /* natural order, as ISLOW_MULT_TYPE */
    uint16_t qraw[64];        /* the same, as JQUANT_TBL's quantval */
    int latched;              /* qt taken at the component's first scan */
    int dc_pred;
    /* buffered path */
    int wib, hib;             /* width_in_blocks, height_in_blocks */
    int16_t *coef;            /* bh rows of bw blocks of 64, natural order */
    int coef_bits[64];        /* jdphuff.c's coef_bits: Al of the last
                               * scan of each zigzag coefficient, -1 none */
    int dc_context;           /* arithmetic DC conditioning category */
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
    int sof, progressive, arithmetic, lossless;
    component comp[MAX_COMPS];
    int saw_jfif, saw_adobe, adobe_transform, orientation, saw_app1;
    int transform;            /* -1: the file's colour space; 0 / 1:
                               * components as they are / YCbCr (TIFF) */

    /* the current scan */
    component *scan[MAX_COMPS];
    int ns, ss, se, ah, al, eobrun;

    /* arithmetic decoding (jdarith.c) */
    uint8_t arith_dc_L[NUM_ARITH_TBLS], arith_dc_U[NUM_ARITH_TBLS];
    uint8_t arith_ac_K[NUM_ARITH_TBLS];
    uint8_t dc_stats[NUM_ARITH_TBLS][64], ac_stats[NUM_ARITH_TBLS][256];
    uint8_t fixed_bin;
    int64_t ar_c;
    int32_t ar_a;
    int ar_ct;                /* -16 at a scan's start, -1 after an error */

    /* scan bit reader */
    uint64_t bits;
    int nbits;                /* bits in the buffer, fill bits included */
    int fill;                 /* zero bits appended past a marker / end */
    int marker_hit;           /* an unread marker: pos on its last FF */
    int insufficient;         /* jdhuff.c insufficient_data: bits were
                               * read past a marker; MCUs up to the next
                               * restart stay zero */
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
    if (d->pos >= d->len)
        fail(d, "truncated: the file ends inside a header" CV2_STOPS);
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
        if (tq > 3) fail(d, "corrupt: DQT table index %d" CV2_STOPS, tq);
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
        if (p + i > 256) fail(d, "corrupt: bad Huffman table" CV2_STOPS);
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
            fail(d, "corrupt: bad Huffman table" CV2_STOPS);
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
    t->max_sym = 0;
    if (is_dc)
        for (int i = 0; i < nsym; i++)
            if (t->huffval[i] > t->max_sym) t->max_sym = t->huffval[i];
    t->defined = 1;
}

static void read_dht(decoder *d, size_t end) {
    while (d->pos < end) {
        int tc_th = u8(d), tc = tc_th >> 4, th = tc_th & 15;
        if (tc > 1 || th > 3)
            fail(d, "corrupt: DHT class %d index %d" CV2_STOPS, tc, th);
        uint8_t counts[17] = {0};
        int total = 0;
        for (int l = 1; l <= 16; l++) total += counts[l] = (uint8_t)u8(d);
        if (total > 256) fail(d, "corrupt: bad Huffman table" CV2_STOPS);
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
    if (d->frame_seen)
        fail(d, "corrupt: more than one frame header" CV2_TOO
                "\"Invalid JPEG file structure: two SOF markers\")");
    d->frame_seen = 1;
    d->sof = marker;
    d->progressive = marker == 0xC2 || marker == 0xCA;
    d->arithmetic = marker >= 0xC9;
    d->lossless = marker == 0xC3 || marker == 0xCB;
    int precision = u8(d);
    d->height = u16be(d);
    d->width = u16be(d);
    d->ncomp = u8(d);
    if (d->lossless && d->arithmetic)
        fail(d, "unsupported: arithmetic-coded lossless JPEG (SOF11)" CV2_TOO
                "\"Requested features are incompatible\")");
    if (precision != 8)
        fail(d, "unsupported: %d-bit samples (8-bit only)" CV2_TOO
                "\"Unsupported JPEG data precision %d\" through the 8-bit "
                "interface OpenCV calls)", precision, precision);
    if (d->height == 0)
        fail(d, "unsupported: frame height 0 (a DNL marker)" CV2_TOO
                "\"Empty JPEG image (DNL not supported)\")");
    if (d->width == 0 || d->ncomp == 0)
        fail(d, "corrupt: frame width 0 or no components" CV2_TOO
                "\"Empty JPEG image\")");
    if (d->ncomp != 1 && d->ncomp != 3 && d->ncomp != 4)
        fail(d, "unsupported: %d components" CV2_TOO "\"Unsupported color "
                "conversion request\": it converts 1, 3 and 4 only)",
             d->ncomp);
    d->max_h = d->max_v = 1;
    for (int i = 0; i < d->ncomp; i++) {
        component *c = &d->comp[i];
        c->id = u8(d);
        int hv = u8(d);
        c->h = hv >> 4;
        c->v = hv & 15;
        c->tq = u8(d);
        if (c->h < 1 || c->h > 4 || c->v < 1 || c->v > 4)
            fail(d, "corrupt: sampling factors %dx%d" CV2_STOPS, c->h, c->v);
        if (c->tq > 3)
            fail(d, "corrupt: quantization table %d" CV2_STOPS, c->tq);
        if (c->h > d->max_h) d->max_h = c->h;
        if (c->v > d->max_v) d->max_v = c->v;
        for (int k = 0; k < 64; k++) c->coef_bits[k] = -1;
    }
}

/* jdmarker.c get_dac: arithmetic conditioning of DC (L, U) and AC (K)
 * tables 0-15 */
static void read_dac(decoder *d, size_t end) {
    while (d->pos + 2 <= end) {
        int index = u8(d), val = u8(d);
        if (index >= 2 * NUM_ARITH_TBLS)
            fail(d, "corrupt: DAC table index %d" CV2_STOPS, index);
        if (index >= NUM_ARITH_TBLS) {
            d->arith_ac_K[index - NUM_ARITH_TBLS] = (uint8_t)val;
        } else {
            d->arith_dc_L[index] = (uint8_t)(val & 15);
            d->arith_dc_U[index] = (uint8_t)(val >> 4);
            if ((val & 15) > (val >> 4))
                fail(d, "corrupt: DAC value 0x%02X" CV2_STOPS, val);
        }
    }
    if (d->pos != end) fail(d, "corrupt: DAC segment length" CV2_STOPS);
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
    if (d->nbits < 17) fill_bits(d);
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
    d->bits <<= l;             /* 17 bits of a bad code */
    d->nbits -= l;
    if (l > 16) return 0;      /* jpeg_huff_decode: a zero, with a warning */
    return t->huffval[(code + t->valoffset[l]) & 0xFF];
}

static inline int extend(int v, int s) {
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

/* after an MCU: were bits read past the data? Cut by a marker, libjpeg
 * (jpeg_fill_bit_buffer) has read zeros and warns, and the MCUs up to
 * the next restart stay zero; at the end of the buffer cv2.imdecode
 * suspends and gives no image */
static void check_not_past_end(decoder *d) {
    if (d->nbits >= d->fill) return;
    if (!d->marker_hit)
        fail(d, "truncated: the entropy-coded segment ends before the "
                "last MCU" CV2_TOO "cv2.imdecode suspends at the end of the "
                "buffer)");
    d->insufficient = 1;
}

/* --------------------------------------------------------------- IDCT */

static int cr_r[256], cb_b[256];   /* jdcolor.c build_ycc_rgb_table */
static int32_t cr_g[256], cb_g[256];

/* filled when the library loads, before any call can read them */
__attribute__((constructor)) static void init_tables(void) {
    /* SCALEBITS 16, x = i - 128 */
    for (int i = 0; i < 256; i++) {
        int32_t x = i - 128;
        cr_r[i] = (int)((91881 * x + 32768) >> 16);
        cb_b[i] = (int)((116130 * x + 32768) >> 16);
        cr_g[i] = -46802 * x;
        cb_g[i] = -22554 * x + 32768;
    }
}

/* 16-bit lanes of libjpeg-turbo's SIMD islow IDCT (jidctint-avx2.asm,
 * whose arithmetic jidctint-sse2.asm shares): dequantization by pmullw
 * and the sums in0 +- in4, in7 + in3, in5 + in1 wrap at 16 bits, pass 1
 * packs to 16 bits with signed saturation (packssdw), pass 2 saturates
 * to 8 bits (packssdw, packsswb) before adding 128 */
static inline int32_t wrap16(int32_t v) { return (int16_t)(uint16_t)v; }

static inline int32_t sat16(int32_t v) {
    return v < -32768 ? -32768 : v > 32767 ? 32767 : v;
}

/* the 32-bit lanes add and shift as two's complement */
static inline int32_t descale32(int32_t x, int n) {
    return (int32_t)((uint32_t)x + ((uint32_t)1 << (n - 1))) >> n;
}

/* the 32-bit lanes add as two's complement */
#define ADDW(a, b) ((int32_t)((uint32_t)(a) + (uint32_t)(b)))
#define SUBW(a, b) ((int32_t)((uint32_t)(a) - (uint32_t)(b)))

/* the 1-D transform of the eight 16-bit lanes L(0)..L(7), each of the
 * eight 32-bit sums handed to S(j, sum) before its descale: jidctint.c's
 * products, which the SIMD code's pmaddwd pairs give exactly, from the
 * lanes' 16-bit sums where it forms them */
#define IDCT_1D(L, S)                                                       \
    do {                                                                    \
        const int32_t e2 = L(2), e6 = L(6);                                 \
        const int32_t z1 = (e2 + e6) * FIX_0_541196100;                     \
        const int32_t tmp2 = z1 - e6 * FIX_1_847759065;                     \
        const int32_t tmp3 = z1 + e2 * FIX_0_765366865;                     \
        const int32_t e0 = L(0), e4 = L(4);                                 \
        const int32_t tmp0 = wrap16(e0 + e4) * (1 << CONST_BITS);          \
        const int32_t tmp1 = wrap16(e0 - e4) * (1 << CONST_BITS);          \
        const int32_t t10 = ADDW(tmp0, tmp3), t13 = SUBW(tmp0, tmp3);       \
        const int32_t t11 = ADDW(tmp1, tmp2), t12 = SUBW(tmp1, tmp2);       \
        const int32_t i1 = L(1), i3 = L(3), i5 = L(5), i7 = L(7);          \
        const int32_t s3 = wrap16(i7 + i3), s4 = wrap16(i5 + i1);          \
        const int32_t z5 = (s3 + s4) * FIX_1_175875602;                     \
        const int32_t z3o = z5 - s3 * FIX_1_961570560;                      \
        const int32_t z4o = z5 - s4 * FIX_0_390180644;                      \
        const int32_t za = (i7 + i1) * -FIX_0_899976223;                    \
        const int32_t zb = (i5 + i3) * -FIX_2_562915447;                    \
        const int32_t b3 = ADDW(i1 * FIX_1_501321110 + za, z4o);           \
        S(0, ADDW(t10, b3));                                                \
        S(7, SUBW(t10, b3));                                                \
        const int32_t b2 = ADDW(i3 * FIX_3_072711026 + zb, z3o);           \
        S(1, ADDW(t11, b2));                                                \
        S(6, SUBW(t11, b2));                                                \
        const int32_t b1 = ADDW(i5 * FIX_2_053119869 + zb, z4o);           \
        S(2, ADDW(t12, b1));                                                \
        S(5, SUBW(t12, b1));                                                \
        const int32_t b0 = ADDW(i7 * FIX_0_298631336 + za, z3o);           \
        S(3, ADDW(t13, b0));                                                \
        S(4, SUBW(t13, b0));                                                \
    } while (0)

/* pass 2's last step: descale by 18, saturate to [-128, 127], add 128;
 * pass-1 lanes are int16, so the descaled sums lie in (-8192, 8192) */
static uint8_t idct_out[16384];

__attribute__((constructor)) static void init_idct_out(void) {
    for (int i = 0; i < 16384; i++) {
        const int v = i - 8192;
        idct_out[i] = (uint8_t)((v < -128 ? -128 : v > 127 ? 127 : v) + 128);
    }
}

#define OUT(v) idct_out[(descale32((v), CONST_BITS + PASS1_BITS + 3) + 8192) \
                        & 16383]

static void idct_islow(const int16_t *in, const int16_t *qt, uint8_t *out,
                       int stride) {
    int32_t ws[64];
    uint64_t rows[14], ac = 0;
    memcpy(rows, in + 8, sizeof rows);
    for (int k = 0; k < 14; k++) ac |= rows[k];
    if (!ac) {   /* rows 1-7 all zero: the DC row shifted in 16 bits */
        for (int c = 0; c < 8; c++) {
            int32_t v = wrap16((int32_t)((uint32_t)wrap16(in[c] * qt[c])
                                         << PASS1_BITS));
            for (int r = 0; r < 8; r++) ws[r * 8 + c] = v;
        }
    } else {
        for (int c = 0; c < 8; c++) {
            const int16_t *ip = in + c;
            const int16_t *qp = qt + c;
            int32_t *wp = ws + c;
            if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] &&
                !ip[48] && !ip[56]) {    /* what the sums give the DC alone */
                const int32_t v = sat16(wrap16(ip[0] * qp[0]) *
                                        (1 << PASS1_BITS));
                for (int r = 0; r < 8; r++) wp[r * 8] = v;
                continue;
            }
#define DEQ(j) wrap16(ip[(j) * 8] * qp[(j) * 8])
#define WS(j, v) wp[(j) * 8] = sat16(descale32((v), CONST_BITS - PASS1_BITS))
            IDCT_1D(DEQ, WS);
#undef DEQ
#undef WS
        }
    }
    for (int r = 0; r < 8; r++) {
        uint8_t *op = out + (size_t)r * stride;
        const int32_t *wp = ws + r * 8;
        if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] &&
            !wp[7]) {                            /* likewise, a row */
            memset(op, OUT((int32_t)((uint32_t)wp[0] << CONST_BITS)), 8);
            continue;
        }
#define ROW(j) wp[j]
#define PIX(j, v) op[j] = OUT(v)
        IDCT_1D(ROW, PIX);
#undef ROW
#undef PIX
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
            k += r;     /* past 63 on damaged data: coefficient 63 */
            blk[natural_order[k]] = (int16_t)extend(get_bits(d, s), s);
        } else {
            if (r != 15) break;
            k += 15;
        }
    }
    check_not_past_end(d);
}

static void arith_reset(decoder *d);

static int next_marker(decoder *d);

/* jdhuff.c / jdarith.c process_restart: the bits left are dropped and
 * the marker read as jdmarker.c read_restart_marker and
 * jpeg_resync_to_restart read it: the marker the scan stopped at, else
 * the next one after any bytes (which libjpeg skips with a warning). The
 * expected RSTn is read. Of the others, a marker below SOF0 or one of
 * the two restarts before the expected one is passed over and the next
 * marker judged; another marker, or one of the next two restarts, is
 * left unread, and the interval then reads as empty (zero bits); any
 * other restart is read in place of the expected one. */
static void restart(decoder *d, int *expected_rst) {
    const int want = *expected_rst;
    int m, unread;
    if (d->marker_hit) {
        m = d->data[d->pos + 1];
        d->pos += 2;
    } else {
        m = next_marker(d);
    }
    for (;;) {
        const int rst = m >= 0xD0 && m <= 0xD7 ? m - 0xD0 : -1;
        if (rst == want || (rst >= 0 && rst != ((want + 1) & 7) &&
                            rst != ((want + 2) & 7) &&
                            rst != ((want + 7) & 7) &&
                            rst != ((want + 6) & 7))) {
            unread = 0;               /* action 1: read it */
            break;
        }
        if (m >= 0xC0 && (rst < 0 || rst == ((want + 1) & 7) ||
                          rst == ((want + 2) & 7))) {
            unread = 1;               /* action 3: leave it */
            d->pos -= 2;
            break;
        }
        m = next_marker(d);           /* action 2: scan on */
    }
    *expected_rst = (want + 1) & 7;
    d->bits = 0;
    d->nbits = 0;
    d->fill = 0;
    d->marker_hit = unread;
    if (!unread) d->insufficient = 0;
    for (int i = 0; i < d->ncomp; i++) d->comp[i].dc_pred = 0;
    d->eobrun = 0;
    if (d->arithmetic) arith_reset(d);
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
                if (d->insufficient) memset(blk, 0, sizeof blk);
                else decode_block(d, c, blk);
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
            const int skip = d->insufficient;   /* zero blocks */
            for (int i = 0; i < ns; i++) {
                component *c = sc[i];
                for (int v = 0; v < c->v; v++)
                    for (int h = 0; h < c->h; h++) {
                        if (skip) memset(blk, 0, sizeof blk);
                        else decode_block(d, c, blk);
                        size_t y = (size_t)(my * c->v + v) * 8;
                        size_t x = (size_t)(mx * c->h + h) * 8;
                        idct_islow(blk, c->qt,
                                   c->plane + y * c->stride + x, c->stride);
                    }
            }
        }
}

/* ------------------------------------------- progressive Huffman scans */

/* jdphuff.c decode_mcu_DC_first / _DC_refine / _AC_first / _AC_refine,
 * each on one MCU of coefficient blocks */
static void huff_dc_first(decoder *d, int16_t **blk, component **own,
                          int nb) {
    for (int b = 0; b < nb; b++) {
        component *c = own[b];
        int s = decode_huff(d, &d->dc[c->td]);
        if (s) s = extend(get_bits(d, s), s);
        c->dc_pred += s;
        blk[b][0] = (int16_t)(uint16_t)((unsigned)c->dc_pred << d->al);
    }
}

static void huff_dc_refine(decoder *d, int16_t **blk, int nb) {
    for (int b = 0; b < nb; b++)
        if (get_bits(d, 1)) blk[b][0] = (int16_t)(blk[b][0] | 1 << d->al);
}

static void huff_ac_first(decoder *d, int16_t *blk, const component *c) {
    if (d->eobrun > 0) {
        d->eobrun--;
        return;
    }
    const huff_table *t = &d->ac[c->ta];
    for (int k = d->ss; k <= d->se; k++) {
        int s = decode_huff(d, t), r = s >> 4;
        s &= 15;
        if (s) {
            k += r;
            int v = extend(get_bits(d, s), s);
            blk[natural_order[k]] = (int16_t)(uint16_t)((unsigned)v << d->al);
        } else if (r == 15) {
            k += 15;
        } else {
            d->eobrun = 1 << r;
            if (r) d->eobrun += get_bits(d, r);
            d->eobrun--;
            break;
        }
    }
}

/* a correction bit for a coefficient already nonzero: a 1 adds p1 to
 * its magnitude, once */
static inline void correct(decoder *d, int16_t *coef, int p1) {
    if (get_bits(d, 1) && (*coef & p1) == 0)
        *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef - p1);
}

static void huff_ac_refine(decoder *d, int16_t *blk, const component *c) {
    const int p1 = 1 << d->al;
    const huff_table *t = &d->ac[c->ta];
    int k = d->ss;
    if (d->eobrun == 0) {
        for (; k <= d->se; k++) {
            int s = decode_huff(d, t), r = s >> 4;
            s &= 15;
            if (s) {
                s = get_bits(d, 1) ? p1 : -p1;
            } else if (r != 15) {
                d->eobrun = 1 << r;
                if (r) d->eobrun += get_bits(d, r);
                break;
            }
            do {
                int16_t *coef = blk + natural_order[k];
                if (*coef) correct(d, coef, p1);
                else if (--r < 0) break;
                k++;
            } while (k <= d->se);
            if (s) blk[natural_order[k]] = (int16_t)s;
        }
    }
    if (d->eobrun > 0) {
        for (; k <= d->se; k++) {
            int16_t *coef = blk + natural_order[k];
            if (*coef) correct(d, coef, p1);
        }
        d->eobrun--;
    }
}

/* --------------------------------------------------- arithmetic scans */

/* jaricom.c's jpeg_aritab: T.81 Table D.2 as (Qe << 16) | (Next_Index_MPS
 * << 8) | (Switch_MPS << 7) | Next_Index_LPS; entry 113 is the fixed
 * 0.5 estimate */
static const uint16_t kQe[114] = {
    0x5A1D, 0x2586, 0x1114, 0x080B, 0x03D8, 0x01DA, 0x00E5, 0x006F, 0x0036,
    0x001A, 0x000D, 0x0006, 0x0003, 0x0001, 0x5A7F, 0x3F25, 0x2CF2, 0x207C,
    0x17B9, 0x1182, 0x0CEF, 0x09A1, 0x072F, 0x055C, 0x0406, 0x0303, 0x0240,
    0x01B1, 0x0144, 0x00F5, 0x00B7, 0x008A, 0x0068, 0x004E, 0x003B, 0x002C,
    0x5AE1, 0x484C, 0x3A0D, 0x2EF1, 0x261F, 0x1F33, 0x19A8, 0x1518, 0x1177,
    0x0E74, 0x0BFB, 0x09F8, 0x0861, 0x0706, 0x05CD, 0x04DE, 0x040F, 0x0363,
    0x02D4, 0x025C, 0x01F8, 0x01A4, 0x0160, 0x0125, 0x00F6, 0x00CB, 0x00AB,
    0x008F, 0x5B12, 0x4D04, 0x412C, 0x37D8, 0x2FE8, 0x293C, 0x2379, 0x1EDF,
    0x1AA9, 0x174E, 0x1424, 0x119C, 0x0F6B, 0x0D51, 0x0BB6, 0x0A40, 0x5832,
    0x4D1C, 0x438E, 0x3BDD, 0x34EE, 0x2EAE, 0x299A, 0x2516, 0x5570, 0x4CA9,
    0x44D9, 0x3E22, 0x3824, 0x32B4, 0x2E17, 0x56A8, 0x4F46, 0x47E5, 0x41CF,
    0x3C3D, 0x375E, 0x5231, 0x4C0F, 0x4639, 0x415E, 0x5627, 0x50E7, 0x4B85,
    0x5597, 0x504F, 0x5A10, 0x5522, 0x59EB, 0x5A1D};
static const uint8_t kNextLps[114] = {
    1,   14,  16,  18,  20,  23,  25,  28,  30,  33,  35,  9,   10,  12,
    15,  36,  38,  39,  40,  42,  43,  45,  46,  48,  49,  51,  52,  54,
    56,  57,  59,  60,  62,  63,  32,  33,  37,  64,  65,  67,  68,  69,
    70,  72,  73,  74,  75,  77,  78,  79,  48,  50,  50,  51,  52,  53,
    54,  55,  56,  57,  58,  59,  61,  61,  65,  80,  81,  82,  83,  84,
    86,  87,  87,  72,  72,  74,  74,  75,  77,  77,  80,  88,  89,  90,
    91,  92,  93,  86,  88,  95,  96,  97,  99,  99,  93,  95,  101, 102,
    103, 104, 99,  105, 106, 107, 103, 105, 108, 109, 110, 111, 110, 112,
    112, 113};
static const uint8_t kNextMps[114] = {
    1,   2,   3,   4,   5,   6,   7,   8,   9,   10,  11,  12,  13,  13,
    15,  16,  17,  18,  19,  20,  21,  22,  23,  24,  25,  26,  27,  28,
    29,  30,  31,  32,  33,  34,  35,  9,   37,  38,  39,  40,  41,  42,
    43,  44,  45,  46,  47,  48,  49,  50,  51,  52,  53,  54,  55,  56,
    57,  58,  59,  60,  61,  62,  63,  32,  65,  66,  67,  68,  69,  70,
    71,  72,  73,  74,  75,  76,  77,  78,  79,  48,  81,  82,  83,  84,
    85,  86,  87,  71,  89,  90,  91,  92,  93,  94,  86,  96,  97,  98,
    99,  100, 93,  102, 103, 104, 99,  106, 107, 103, 109, 107, 111, 109,
    111, 113};
static const uint8_t kSwitch[114] = {
    [0] = 1, [14] = 1, [36] = 1, [64] = 1, [80] = 1, [88] = 1, [95] = 1,
    [105] = 1, [110] = 1, [112] = 1};

/* jdarith.c get_byte and the byte input of arith_decode: past a marker
 * the decoder reads zeros, which is legal in arithmetic scans */
static int arith_byte(decoder *d) {
    if (d->marker_hit) return 0;
    if (d->pos >= d->len) goto truncated;
    int data = d->data[d->pos++];
    if (data == 0xFF) {
        do {
            if (d->pos >= d->len) goto truncated;
            data = d->data[d->pos++];
        } while (data == 0xFF);
        if (data == 0) return 0xFF;
        d->marker_hit = 1;        /* pos back on the marker's last FF */
        d->pos -= 2;
        return 0;
    }
    return data;
truncated:
    fail(d, "truncated: the file ends inside an arithmetic-coded scan"
            CV2_TOO "cv2.imdecode suspends at the end of the buffer)");
    return 0;
}

/* jdarith.c arith_decode: the QM decoder (T.81 D.2) on one bin */
static int arith_decode(decoder *d, uint8_t *st) {
    while (d->ar_a < 0x8000) {
        if (--d->ar_ct < 0) {
            d->ar_c = (d->ar_c << 8) | arith_byte(d);
            if ((d->ar_ct += 8) < 0)
                if (++d->ar_ct == 0) d->ar_a = 0x8000;
        }
        d->ar_a <<= 1;
    }
    int sv = *st, i = sv & 0x7F;
    int32_t qe = kQe[i];
    uint8_t nl = (uint8_t)(kSwitch[i] << 7 | kNextLps[i]), nm = kNextMps[i];
    d->ar_a -= qe;
    int64_t temp = (int64_t)d->ar_a << d->ar_ct;
    if (d->ar_c >= temp) {
        d->ar_c -= temp;
        if (d->ar_a < qe) {
            d->ar_a = qe;
            *st = (uint8_t)((sv & 0x80) ^ nm);
        } else {
            d->ar_a = qe;
            *st = (uint8_t)((sv & 0x80) ^ nl);
            sv ^= 0x80;
        }
    } else if (d->ar_a < 0x8000) {
        if (d->ar_a < qe) {
            *st = (uint8_t)((sv & 0x80) ^ nl);
            sv ^= 0x80;
        } else {
            *st = (uint8_t)((sv & 0x80) ^ nm);
        }
    }
    return sv >> 7;
}

/* start of a scan and every restart (jdarith.c start_pass,
 * process_restart): fresh statistics for the tables the scan codes */
static void arith_reset(decoder *d) {
    for (int i = 0; i < d->ns; i++) {
        component *c = d->scan[i];
        if (!d->progressive || (d->ss == 0 && d->ah == 0)) {
            memset(d->dc_stats[c->td], 0, 64);
            c->dc_pred = 0;
            c->dc_context = 0;
        }
        if (!d->progressive || d->ss)
            memset(d->ac_stats[c->ta], 0, 256);
    }
    d->fixed_bin = 113;
    d->ar_c = 0;
    d->ar_a = 0;
    d->ar_ct = -16;
}

/* a DC difference (T.81 F.1.4.4.1); 0 after a bad code (ct = -1) */
static int arith_dc_diff(decoder *d, component *c, int *diff) {
    const int tbl = c->td;
    uint8_t *st = d->dc_stats[tbl] + c->dc_context;
    if (arith_decode(d, st) == 0) {
        c->dc_context = 0;
        *diff = 0;
        return 1;
    }
    int sign = arith_decode(d, st + 1);
    st += 2 + sign;
    int m = arith_decode(d, st);
    if (m) {
        st = d->dc_stats[tbl] + 20;
        while (arith_decode(d, st)) {
            if ((m <<= 1) == 0x8000) {
                d->ar_ct = -1;
                return 0;
            }
            st++;
        }
    }
    if (m < (int)((1L << d->arith_dc_L[tbl]) >> 1))
        c->dc_context = 0;
    else if (m > (int)((1L << d->arith_dc_U[tbl]) >> 1))
        c->dc_context = 12 + sign * 4;
    else
        c->dc_context = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
        if (arith_decode(d, st)) v |= m;
    v += 1;
    *diff = sign ? -v : v;
    return 1;
}

/* AC coefficients ss..se of a first (or sequential) scan, scaled by al
 * (T.81 F.1.4.4.2); 0 after a bad code */
static int arith_ac_first(decoder *d, int16_t *blk, const component *c,
                          int ss, int se, int al) {
    const int tbl = c->ta;
    for (int k = ss; k <= se; k++) {
        uint8_t *st = d->ac_stats[tbl] + 3 * (k - 1);
        if (arith_decode(d, st)) break;            /* EOB */
        while (arith_decode(d, st + 1) == 0) {
            st += 3;
            if (++k > se) {
                d->ar_ct = -1;
                return 0;
            }
        }
        int sign = arith_decode(d, &d->fixed_bin);
        st += 2;
        int m = arith_decode(d, st);
        if (m && arith_decode(d, st)) {
            m <<= 1;
            st = d->ac_stats[tbl] + (k <= d->arith_ac_K[tbl] ? 189 : 217);
            while (arith_decode(d, st)) {
                if ((m <<= 1) == 0x8000) {
                    d->ar_ct = -1;
                    return 0;
                }
                st++;
            }
        }
        int v = m;
        st += 14;
        while (m >>= 1)
            if (arith_decode(d, st)) v |= m;
        v += 1;
        if (sign) v = -v;
        blk[natural_order[k]] = (int16_t)(uint16_t)((unsigned)v << al);
    }
    return 1;
}

static void arith_mcu(decoder *d, int16_t **blk, component **own, int nb) {
    if (d->progressive && d->ss == 0 && d->ah) {
        for (int b = 0; b < nb; b++)     /* DC refine: the next bit */
            if (arith_decode(d, &d->fixed_bin))
                blk[b][0] = (int16_t)(blk[b][0] | 1 << d->al);
        return;
    }
    if (d->ar_ct == -1) return;          /* after a bad code: nothing */
    if (!d->progressive || d->ss == 0) {
        for (int b = 0; b < nb; b++) {
            component *c = own[b];
            int diff;
            if (!arith_dc_diff(d, c, &diff)) return;
            if (d->progressive) {
                c->dc_pred += diff;
                blk[b][0] = (int16_t)(uint16_t)((unsigned)c->dc_pred
                                                << d->al);
            } else {
                c->dc_pred = (c->dc_pred + diff) & 0xFFFF;
                blk[b][0] = (int16_t)(uint16_t)c->dc_pred;
                if (!arith_ac_first(d, blk[b], c, 1, 63, 0)) return;
            }
        }
        return;
    }
    int16_t *b = blk[0];
    const component *c = own[0];
    if (d->ah == 0) {
        arith_ac_first(d, b, c, d->ss, d->se, d->al);
        return;
    }
    /* AC refine (T.81 G.1.3.3) */
    const int tbl = c->ta, p1 = 1 << d->al;
    int kex;
    for (kex = d->se; kex > 0; kex--)
        if (b[natural_order[kex]]) break;
    for (int k = d->ss; k <= d->se; k++) {
        uint8_t *st = d->ac_stats[tbl] + 3 * (k - 1);
        if (k > kex && arith_decode(d, st)) break;     /* EOB */
        for (;;) {
            int16_t *coef = b + natural_order[k];
            if (*coef) {
                if (arith_decode(d, st + 2))
                    *coef = (int16_t)(*coef < 0 ? *coef - p1 : *coef + p1);
                break;
            }
            if (arith_decode(d, st + 1)) {
                *coef = (int16_t)(arith_decode(d, &d->fixed_bin) ? -p1 : p1);
                break;
            }
            st += 3;
            if (++k > d->se) {
                d->ar_ct = -1;
                return;
            }
        }
    }
}

/* -------------------------------------------- buffered-coefficient path */

static inline int16_t *coef_at(const component *c, int by, int bx) {
    return c->coef + ((size_t)by * c->bw + bx) * 64;
}

/* jdphuff.c / jdarith.c start_pass validation, and what a scan needs
 * before its first MCU */
static void start_scan(decoder *d) {
    int blocks = 0;
    for (int i = 0; i < d->ns; i++) {
        component *c = d->scan[i];
        if (!c->latched && !d->lossless) { /* jdinput.c latch_quant_tables */
            if (!d->qt_defined[c->tq])
                fail(d, "corrupt: quantization table %d not defined" CV2_STOPS,
                        c->tq);
            for (int k = 0; k < 64; k++) {
                c->qraw[k] = d->qt[c->tq][k];
                c->qt[k] = (int16_t)d->qt[c->tq][k];
            }
            c->latched = 1;
        }
        blocks += c->h * c->v;
        c->dc_pred = 0;
    }
    if (d->ns > 1 && blocks > 10)
        fail(d, "corrupt: %d blocks in an MCU (at most 10)" CV2_STOPS, blocks);
    if (d->progressive) {
        int bad = d->ss == 0 ? d->se != 0
                             : d->ss > d->se || d->se > 63 || d->ns != 1;
        if ((d->ah && d->al != d->ah - 1) || d->al > 13) bad = 1;
        if (bad)
            fail(d, "corrupt: invalid progressive scan (Ss=%d Se=%d Ah=%d "
                    "Al=%d)" CV2_TOO "\"Invalid progressive parameters\")",
                 d->ss, d->se, d->ah, d->al);
        for (int i = 0; i < d->ns; i++)
            for (int k = d->ss; k <= d->se; k++)
                d->scan[i]->coef_bits[k] = d->al;
    }
    if (!d->arithmetic) {
        for (int i = 0; i < d->ns; i++) {
            const component *c = d->scan[i];
            int need_dc = !d->progressive || (d->ss == 0 && d->ah == 0);
            int need_ac = !d->progressive || d->ss != 0;
            if ((need_dc && (c->td > 3 || !d->dc[c->td].defined)) ||
                (need_ac && (c->ta > 3 || !d->ac[c->ta].defined)))
                fail(d, "corrupt: scan uses an undefined Huffman table"
                        CV2_STOPS);
            if (need_dc && d->dc[c->td].max_sym > (d->lossless ? 16 : 15))
                fail(d, "corrupt: bad Huffman table" CV2_STOPS);
        }
    }
    d->eobrun = 0;
    d->bits = 0;
    d->nbits = 0;
    d->fill = 0;
    d->marker_hit = 0;
    d->insufficient = 0;
    if (d->arithmetic) arith_reset(d);
}

static void decode_mcu(decoder *d, int16_t **blk, component **own,
                       int nb) {
    if (d->insufficient) return;          /* the blocks stay as they are */
    if (d->arithmetic) {
        arith_mcu(d, blk, own, nb);
    } else if (!d->progressive) {
        for (int b = 0; b < nb; b++) decode_block(d, own[b], blk[b]);
    } else if (d->ss == 0) {
        if (d->ah == 0) huff_dc_first(d, blk, own, nb);
        else huff_dc_refine(d, blk, nb);
    } else if (d->ah == 0) {
        huff_ac_first(d, blk[0], own[0]);
    } else {
        huff_ac_refine(d, blk[0], own[0]);
    }
    if (!d->arithmetic) check_not_past_end(d);
}

/* one scan into the coefficient planes (jdcoefct.c consume_data): a
 * single-component scan codes the component's own blocks, an
 * interleaved one whole MCUs, padding blocks included */
static void decode_scan_buffered(decoder *d) {
    int16_t *blk[10];
    component *own[10];
    const int ns = d->ns;
    int rst = 0, left = d->restart_interval;
    int across = d->scan[0]->wib, down = d->scan[0]->hib;
    if (ns > 1) {
        across = (d->width + 8 * d->max_h - 1) / (8 * d->max_h);
        down = (d->height + 8 * d->max_v - 1) / (8 * d->max_v);
    }
    for (int my = 0; my < down; my++)
        for (int mx = 0; mx < across; mx++) {
            if (d->restart_interval) {
                if (left == 0) {
                    restart(d, &rst);
                    left = d->restart_interval;
                }
                left--;
            }
            int nb = 0;
            if (ns == 1) {
                blk[0] = coef_at(d->scan[0], my, mx);
                own[nb++] = d->scan[0];
            } else {
                for (int i = 0; i < ns; i++) {
                    component *c = d->scan[i];
                    for (int v = 0; v < c->v; v++)
                        for (int h = 0; h < c->h; h++) {
                            blk[nb] = coef_at(c, my * c->v + v,
                                              mx * c->h + h);
                            own[nb++] = c;
                        }
                }
            }
            decode_mcu(d, blk, own, nb);
        }
}

/* jdcoefct.c smoothing_ok: progressive, every component's DC partly
 * known and its first ten quantizers nonzero, and some of coefficients
 * 1-9 of some component not fully known */
static int smoothing_ok(const decoder *d) {
    static const int qpos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    if (!d->progressive) return 0;
    int useful = 0;
    for (int i = 0; i < d->ncomp; i++) {
        const component *c = &d->comp[i];
        if (!c->latched || c->coef_bits[0] < 0) return 0;
        for (int k = 0; k < 10; k++)
            if (!c->qraw[qpos[k]]) return 0;
        for (int k = 1; k < 10; k++)
            if (c->coef_bits[k] != 0) useful = 1;
    }
    return useful;
}

/* an estimate of one coefficient from the DC neighbourhood (jdcoefct.c
 * decompress_smooth_data): num / (Q << 8) rounded, kept below 1 << Al */
static int16_t smooth_pred(int64_t num, int64_t q, int al) {
    int pred;
    if (num >= 0) {
        pred = (int)(((q << 7) + num) / (q << 8));
        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    } else {
        pred = (int)(((q << 7) - num) / (q << 8));
        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
        pred = -pred;
    }
    return (int16_t)pred;
}

/* the IDCT of a component's blocks into its sample plane after EOI,
 * through jdcoefct.c decompress_smooth_data where smooth is set: per
 * block, the 5x5 DC neighbourhood (edges replicated, rows chosen by
 * its iMCU-row arithmetic) estimates the AC coefficients 1-9 that are
 * still zero and not fully known, and, where no AC data came at all,
 * interpolates the DC itself */
static void output_component(decoder *d, component *c, int smooth) {
    const int total_rows = (d->height + 8 * d->max_v - 1) / (8 * d->max_v);
    const int *bits = c->coef_bits;
    int change_dc = 1;
    for (int k = 1; k < 10; k++)
        if (bits[k] != -1) change_dc = 0;
    const int64_t Q00 = c->qraw[0], Q01 = c->qraw[1], Q10 = c->qraw[8],
                  Q20 = c->qraw[16], Q11 = c->qraw[9], Q02 = c->qraw[2],
                  Q03 = c->qraw[3], Q12 = c->qraw[10], Q21 = c->qraw[17],
                  Q30 = c->qraw[24];
    int16_t ws[64];
    for (int R = 0; R < c->hib; R++) {
        if (!smooth) {
            for (int bx = 0; bx < c->wib; bx++)
                idct_islow(coef_at(c, R, bx), c->qt,
                           c->plane + (size_t)R * 8 * c->stride + bx * 8,
                           c->stride);
            continue;
        }
        const int ir = R / c->v, br = R % c->v;
        int b = c->v;
        if (ir == total_rows - 1 && c->hib % c->v) b = c->hib % c->v;
        const int ibr = ir * b + br, ibrs = b * total_rows;
        const int rp = ibr > 0 ? R - 1 : R;
        const int rpp = ibr > 1 ? R - 2 : rp;
        const int rn = ibr < ibrs - 1 ? R + 1 : R;
        const int rnn = ibr < ibrs - 2 ? R + 2 : rn;
        const int rows[5] = {rpp, rp, R, rn, rnn};
        int dc[5][5];
        for (int y = 0; y < 5; y++)
            for (int x = 0; x < 5; x++) dc[y][x] = coef_at(c, rows[y], 0)[0];
        const int last = c->wib - 1;
        for (int bx = 0; bx < c->wib; bx++) {
            if (bx == 0 && bx < last)
                for (int y = 0; y < 5; y++)
                    dc[y][3] = dc[y][4] = coef_at(c, rows[y], 1)[0];
            if (bx + 1 < last)
                for (int y = 0; y < 5; y++)
                    dc[y][4] = coef_at(c, rows[y], bx + 2)[0];
            memcpy(ws, coef_at(c, R, bx), sizeof ws);
#define DC(n) ((int64_t)dc[((n) - 1) / 5][((n) - 1) % 5])
            int al;
            if ((al = bits[1]) != 0 && ws[1] == 0) {
                int64_t num = Q00 * (change_dc
                    ? -DC(1) - DC(2) + DC(4) + DC(5) - 3 * DC(6) +
                      13 * DC(7) - 13 * DC(9) + 3 * DC(10) - 3 * DC(11) +
                      38 * DC(12) - 38 * DC(14) + 3 * DC(15) - 3 * DC(16) +
                      13 * DC(17) - 13 * DC(19) + 3 * DC(20) - DC(21) -
                      DC(22) + DC(24) + DC(25)
                    : -7 * DC(11) + 50 * DC(12) - 50 * DC(14) + 7 * DC(15));
                ws[1] = smooth_pred(num, Q01, al);
            }
            if ((al = bits[2]) != 0 && ws[8] == 0) {
                int64_t num = Q00 * (change_dc
                    ? -DC(1) - 3 * DC(2) - 3 * DC(3) - 3 * DC(4) - DC(5) -
                      DC(6) + 13 * DC(7) + 38 * DC(8) + 13 * DC(9) - DC(10) +
                      DC(16) - 13 * DC(17) - 38 * DC(18) - 13 * DC(19) +
                      DC(20) + DC(21) + 3 * DC(22) + 3 * DC(23) +
                      3 * DC(24) + DC(25)
                    : -7 * DC(3) + 50 * DC(8) - 50 * DC(18) + 7 * DC(23));
                ws[8] = smooth_pred(num, Q10, al);
            }
            if ((al = bits[3]) != 0 && ws[16] == 0) {
                int64_t num = Q00 * (change_dc
                    ? DC(3) + 2 * DC(7) + 7 * DC(8) + 2 * DC(9) -
                      5 * DC(12) - 14 * DC(13) - 5 * DC(14) + 2 * DC(17) +
                      7 * DC(18) + 2 * DC(19) + DC(23)
                    : -DC(3) + 13 * DC(8) - 24 * DC(13) + 13 * DC(18) -
                      DC(23));
                ws[16] = smooth_pred(num, Q20, al);
            }
            if ((al = bits[4]) != 0 && ws[9] == 0) {
                int64_t num = Q00 * (change_dc
                    ? -DC(1) + DC(5) + 9 * DC(7) - 9 * DC(9) - 9 * DC(17) +
                      9 * DC(19) + DC(21) - DC(25)
                    : DC(10) + DC(16) - 10 * DC(17) + 10 * DC(19) - DC(2) -
                      DC(20) + DC(22) - DC(24) + DC(4) - DC(6) +
                      10 * DC(7) - 10 * DC(9));
                ws[9] = smooth_pred(num, Q11, al);
            }
            if ((al = bits[5]) != 0 && ws[2] == 0) {
                int64_t num = Q00 * (change_dc
                    ? 2 * DC(7) - 5 * DC(8) + 2 * DC(9) + DC(11) +
                      7 * DC(12) - 14 * DC(13) + 7 * DC(14) + DC(15) +
                      2 * DC(17) - 5 * DC(18) + 2 * DC(19)
                    : -DC(11) + 13 * DC(12) - 24 * DC(13) + 13 * DC(14) -
                      DC(15));
                ws[2] = smooth_pred(num, Q02, al);
            }
            if (change_dc) {
                if ((al = bits[6]) != 0 && ws[3] == 0)
                    ws[3] = smooth_pred(Q00 * (DC(7) - DC(9) + 2 * DC(12) -
                                               2 * DC(14) + DC(17) - DC(19)),
                                        Q03, al);
                if ((al = bits[7]) != 0 && ws[10] == 0)
                    ws[10] = smooth_pred(Q00 * (DC(7) - 3 * DC(8) + DC(9) -
                                                DC(17) + 3 * DC(18) - DC(19)),
                                         Q12, al);
                if ((al = bits[8]) != 0 && ws[17] == 0)
                    ws[17] = smooth_pred(Q00 * (DC(7) - DC(9) - 3 * DC(12) +
                                                3 * DC(14) + DC(17) - DC(19)),
                                         Q21, al);
                if ((al = bits[9]) != 0 && ws[24] == 0)
                    ws[24] = smooth_pred(Q00 * (DC(7) + 2 * DC(8) + DC(9) -
                                                DC(17) - 2 * DC(18) - DC(19)),
                                         Q30, al);
                int64_t num = Q00 *
                    (-2 * DC(1) - 6 * DC(2) - 8 * DC(3) - 6 * DC(4) -
                     2 * DC(5) - 6 * DC(6) + 6 * DC(7) + 42 * DC(8) +
                     6 * DC(9) - 6 * DC(10) - 8 * DC(11) + 42 * DC(12) +
                     152 * DC(13) + 42 * DC(14) - 8 * DC(15) - 6 * DC(16) +
                     6 * DC(17) + 42 * DC(18) + 6 * DC(19) - 6 * DC(20) -
                     2 * DC(21) - 6 * DC(22) - 8 * DC(23) - 6 * DC(24) -
                     2 * DC(25));
                ws[0] = smooth_pred(num, Q00, 0);
            }
#undef DC
            idct_islow(ws, c->qt,
                       c->plane + (size_t)R * 8 * c->stride + bx * 8,
                       c->stride);
            for (int y = 0; y < 5; y++) {
                dc[y][0] = dc[y][1];
                dc[y][1] = dc[y][2];
                dc[y][2] = dc[y][3];
                dc[y][3] = dc[y][4];
            }
        }
    }
}

/* ------------------------------------------------------------ lossless */

/* jdpred.c: one row of differences -> samples (16 bits), from the row
 * above; the first row of a scan or of a restart interval predicts from
 * init and then the left sample, the others' first column from above */
static void undifference(const int32_t *diff, const int32_t *up,
                         int32_t *out, int w, int psv, int first, int init) {
    out[0] = (diff[0] + (first ? init : up[0])) & 0xFFFF;
    for (int x = 1; x < w; x++) {
        int32_t pred;
        const int32_t ra = out[x - 1], rb = up[x], rc = up[x - 1];
        if (first) pred = ra;
        else switch (psv) {
            case 1: pred = ra; break;
            case 2: pred = rb; break;
            case 3: pred = rc; break;
            case 4: pred = ra + rb - rc; break;
            case 5: pred = ra + ((rb - rc) >> 1); break;
            case 6: pred = rb + ((ra - rc) >> 1); break;
            default: pred = (ra + rb) >> 1; break;
            }
        out[x] = (diff[x] + pred) & 0xFFFF;
    }
}

/* one lossless scan, as jddiffct.c decompress_data runs it with
 * jdlhuff.c and jdpred.c: the differences of an iMCU row (one MCU row
 * of an interleaved scan, v sample rows of a single component's) are
 * Huffman decoded with the DC tables, MCUs of h x v samples a component
 * padded past the plane's edge as DCT MCUs are; then each component's
 * real rows are undifferenced with predictor Ss and written to the
 * plane shifted up by the point transform Al and cut to 8 bits. A
 * restart, every restart_interval / MCUs-per-row MCU rows, resets the
 * predictors of the iMCU row being decoded. */
static void decode_lossless_scan(decoder *d, int32_t **diffs,
                                 int32_t **rows) {
    const int ns = d->ns, psv = d->ss, pt = d->al;
    if (psv < 1 || psv > 7 || d->se != 0 || d->ah != 0 || pt >= 8)
        fail(d, "corrupt: invalid lossless scan (Ss=%d Se=%d Ah=%d Al=%d)"
                CV2_TOO "\"Invalid progressive/lossless parameters\")",
             d->ss, d->se, d->ah, d->al);
    const int across = ns > 1 ? (d->width + d->max_h - 1) / d->max_h
                              : d->scan[0]->dw;
    const int imcu_rows = (d->height + d->max_v - 1) / d->max_v;
    if (d->restart_interval % across)
        fail(d, "unsupported: a lossless restart interval of %d MCUs, not "
                "a whole number of MCU rows of %d" CV2_TOO "\"Invalid "
                "restart interval %d; must be an integer multiple of the "
                "number of MCUs in an MCU row (%d)\")",
             d->restart_interval, across, d->restart_interval, across);
    start_scan(d);
    int32_t *diff[MAX_COMPS], *prev[MAX_COMPS], *cur[MAX_COMPS];
    int width[MAX_COMPS], first[MAX_COMPS];
    for (int i = 0; i < ns; i++) {
        const component *c = d->scan[i];
        const int k = (int)(c - d->comp);
        width[i] = ns > 1 ? across * c->h : c->dw;
        diff[i] = diffs[k];
        prev[i] = rows[2 * k];
        cur[i] = rows[2 * k + 1];
        first[i] = 1;
    }
    const int init = 1 << (8 - pt - 1);
    const int per = d->restart_interval / across;
    int rst = 0, to_go = per;
    for (int im = 0; im < imcu_rows; im++) {
        const component *c0 = d->scan[0];
        const int mrows = ns > 1 ? 1 : c0->v < c0->dh - im * c0->v
                                           ? c0->v : c0->dh - im * c0->v;
        for (int k = 0; k < mrows; k++) {
            if (per && to_go == 0) {
                restart(d, &rst);
                for (int i = 0; i < ns; i++) first[i] = 1;
                to_go = per;
            }
            if (d->insufficient) {
                /* jdlhuff.c decode_mcus past a marker: zero differences
                 * and the predictors reset, so the row reads 128 */
                for (int i = 0; i < ns; i++) {
                    const int v = ns > 1 ? d->scan[i]->v : 1;
                    memset(diff[i] + (size_t)k * width[i], 0,
                           sizeof(int32_t) * (size_t)v * width[i]);
                    first[i] = 1;
                }
                if (per) to_go--;
                continue;
            }
            for (int mx = 0; mx < across; mx++) {
                for (int i = 0; i < ns; i++) {
                    component *c = d->scan[i];
                    const int h = ns > 1 ? c->h : 1, v = ns > 1 ? c->v : 1;
                    for (int yo = 0; yo < v; yo++)
                        for (int xo = 0; xo < h; xo++) {
                            int s = decode_huff(d, &d->dc[c->td]);
                            diff[i][(size_t)(k + yo) * width[i] + mx * h +
                                    xo] = s == 16 ? 32768
                                          : s ? extend(get_bits(d, s), s)
                                              : 0;
                        }
                }
                check_not_past_end(d);
            }
            if (per) to_go--;
        }
        for (int i = 0; i < ns; i++) {
            component *c = d->scan[i];
            const int y0 = im * c->v;
            const int rows = c->v < c->dh - y0 ? c->v : c->dh - y0;
            for (int r = 0; r < rows; r++) {
                undifference(diff[i] + (size_t)r * width[i], prev[i], cur[i],
                             c->dw, psv, first[i], init);
                first[i] = 0;
                uint8_t *out = c->plane + (size_t)(y0 + r) * c->stride;
                for (int x = 0; x < c->dw; x++)
                    out[x] = (uint8_t)(cur[i][x] << pt);
                int32_t *t = prev[i];
                prev[i] = cur[i];
                cur[i] = t;
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
    const int dw = c->dw, fancy = !d->lossless;
    for (int y = 0; y < H; y++) {
        uint8_t *op = out + (size_t)y * W;
        if (fh == 1 && fv == 1) {
            memcpy(op, row_at(c, y), W);
        } else if (fancy && fh == 2 && fv == 1 && dw > 2) {
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
        } else if (fancy && fh == 1 && fv == 2) {
            const int r = y >> 1, lower = y & 1;
            const uint8_t *p0 = row_at(c, r);
            const uint8_t *p1 = row_at(c, lower ? r + 1 : r - 1);
            const int bias = lower ? 2 : 1;
            for (int x = 0; x < W; x++)
                op[x] = (uint8_t)((p0[x] * 3 + p1[x] + bias) >> 2);
        } else if (fancy && fh == 2 && fv == 2 && dw > 2) {
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

/* jdmarker.c next_marker: bytes up to an FF are skipped (libjpeg warns
 * of them), then fill FFs and stuffed FF 00 pairs */
static int next_marker(decoder *d) {
    for (;;) {
        while (d->pos < d->len && d->data[d->pos] != 0xFF) d->pos++;
        while (d->pos < d->len && d->data[d->pos] == 0xFF) d->pos++;
        if (d->pos >= d->len)
            fail(d, "truncated: the file ends before its EOI marker" CV2_TOO
                    "cv2.imdecode suspends at the end of the buffer)");
        int m = d->data[d->pos++];
        if (m) return m;
    }
}

/* jdmarker.c get_sos */
static void read_sos(decoder *d, size_t seg) {
    if (!d->frame_seen) fail(d, "corrupt: SOS before the frame" CV2_STOPS);
    const int ns = u8(d);
    if (ns < 1 || ns > 4 || seg != (size_t)(ns * 2 + 6))
        fail(d, "corrupt: SOS segment of %d components" CV2_STOPS, ns);
    for (int i = 0; i < ns; i++) {
        int id = u8(d), t = u8(d), k;
        for (k = 0; k < d->ncomp && d->comp[k].id != id; k++) {}
        if (k == d->ncomp)
            fail(d, "corrupt: scan names unknown component %d" CV2_STOPS, id);
        for (int j = 0; j < i; j++)
            if (d->scan[j] == &d->comp[k])
                fail(d, "corrupt: scan names component %d twice" CV2_STOPS, id);
        d->scan[i] = &d->comp[k];
        d->scan[i]->td = t >> 4;
        d->scan[i]->ta = t & 15;
    }
    d->ns = ns;
    d->ss = u8(d);
    d->se = u8(d);
    const int a = u8(d);
    d->ah = a >> 4;
    d->al = a & 15;
}

/* one marker of the headers or between scans, its segment read:
 * 1 at SOS (the scan header read), 2 at EOI, else 0 */
static int read_marker(decoder *d, int m) {
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) return 0;
    if (m == 0xD9) return 2;
    size_t seg = (size_t)u16be(d);
    if (seg < 2 || d->pos + seg - 2 > d->len)
        fail(d, "truncated: segment 0x%02X runs past the end" CV2_TOO
                "cv2.imdecode suspends at the end of the buffer)", m);
    size_t end = d->pos + seg - 2;
    int sos = 0;
    if ((m >= 0xC0 && m <= 0xC3) || (m >= 0xC9 && m <= 0xCB)) {
        read_sof(d, m);
    } else if (m == 0xC5 || m == 0xC6 || m == 0xC7 || m == 0xCD ||
               m == 0xCE || m == 0xCF || m == 0xC8) {
        fail(d, "unsupported: hierarchical or extension JPEG (SOF%d)" CV2_TOO
                "\"Unsupported JPEG process: SOF type 0x%02x\")",
             m - 0xC0, m);
    } else if (m == 0xC4) {
        read_dht(d, end);
    } else if (m == 0xDB) {
        read_dqt(d, end);
    } else if (m == 0xDD) {
        if (seg != 4) fail(d, "corrupt: DRI segment" CV2_STOPS);
        d->restart_interval = u16be(d);
    } else if (m == 0xCC) {
        read_dac(d, end);
    } else if (m >= 0xE0 && m <= 0xEF) {
        read_app(d, m, end);
    } else if (m == 0xDA) {
        read_sos(d, seg);
        sos = 1;
    } else if (m != 0xFE && m != 0xDC && !(m >= 0xF0 && m <= 0xFD)) {
        fail(d, "corrupt: unexpected marker 0x%02X" CV2_STOPS, m);
    }
    d->pos = end;
    return sos;
}

/* the markers after a scan, up to the next SOS (1) or EOI (2) */
static int after_scan(decoder *d) {
    d->bits = 0;
    d->nbits = 0;
    d->fill = 0;
    d->marker_hit = 0;
    int r;
    do r = read_marker(d, next_marker(d)); while (r == 0);
    return r;
}

/* whether the frame is one scan of every component (jdinput.c: no
 * multiple scans): libjpeg then gives the image when that scan ends, and
 * cv2 gives it whatever follows (a fault there is met only in
 * jpeg_finish_decompress) */
static int one_pass(const decoder *d) {
    return !d->progressive && d->ns == d->ncomp;
}

/* every scan of a buffered frame (the first one's header read), then
 * the IDCT after EOI */
static void decode_buffered(decoder *d) {
    do {
        start_scan(d);
        decode_scan_buffered(d);
    } while (!one_pass(d) && after_scan(d) == 1);
    const int smooth = smoothing_ok(d);
    for (int i = 0; i < d->ncomp; i++)
        output_component(d, &d->comp[i], smooth);
}

/* every scan of a lossless frame (the first one's header read); per
 * component the differences of an iMCU row, MCU padding included, and
 * two rows of samples */
static void decode_lossless(decoder *d) {
    int32_t *diffs[MAX_COMPS], *rows[2 * MAX_COMPS];
    const int across = (d->width + d->max_h - 1) / d->max_h;
    for (int k = 0; k < d->ncomp; k++) {
        const component *c = &d->comp[k];
        diffs[k] = alloc(d, sizeof(int32_t) * (size_t)across * c->h * c->v);
        rows[2 * k] = alloc(d, sizeof(int32_t) * (size_t)c->dw);
        rows[2 * k + 1] = alloc(d, sizeof(int32_t) * (size_t)c->dw);
    }
    do decode_lossless_scan(d, diffs, rows);
    while (!one_pass(d) && after_scan(d) == 1);
}

/* jdcolor.c ycck_cmyk_convert, in place on the first three planes */
static void ycck_to_cmyk(uint8_t *Y, uint8_t *Cb, uint8_t *Cr, size_t n) {
    for (size_t i = 0; i < n; i++) {
        int y = Y[i], cb = Cb[i], cr = Cr[i];
        int c = 255 - (y + cr_r[cr]);
        int m = 255 - (y + (int)((cb_g[cb] + cr_g[cr]) >> 16));
        int ye = 255 - (y + cb_b[cb]);
        Y[i] = (uint8_t)(c < 0 ? 0 : c > 255 ? 255 : c);
        Cb[i] = (uint8_t)(m < 0 ? 0 : m > 255 ? 255 : m);
        Cr[i] = (uint8_t)(ye < 0 ? 0 : ye > 255 ? 255 : ye);
    }
}

/* -------------------------------------------------------------- entry */

static uint8_t *decode(decoder *d, int channels, int *out_h, int *out_w) {
    if (d->len < 2 || d->data[0] != 0xFF || d->data[1] != 0xD8)
        fail(d, "not a JPEG file (no SOI marker)" CV2_STOPS);
    d->pos = 2;
    for (int i = 0; i < NUM_ARITH_TBLS; i++) {     /* jdmarker.c get_soi */
        d->arith_dc_L[i] = 0;
        d->arith_dc_U[i] = 1;
        d->arith_ac_K[i] = 5;
    }
    for (;;) {
        int r = read_marker(d, next_marker(d));
        if (r == 2) fail(d, "corrupt: EOI before any scan" CV2_STOPS);
        if (r == 1) break;
    }
    if (!d->arithmetic) std_huff_tables(d);

    /* colour space: jdapimin.c default_decompress_parms */
    int rgb_source = 0, ycck = 0;
    if (d->ncomp == 3 && d->transform >= 0) {
        rgb_source = !d->transform;
    } else if (d->ncomp == 3) {
        if (d->saw_jfif) rgb_source = 0;
        else if (d->saw_adobe) rgb_source = d->adobe_transform == 0;
        else rgb_source = d->comp[0].id == 'R' && d->comp[1].id == 'G' &&
                          d->comp[2].id == 'B';
    } else if (d->ncomp == 4) {
        ycck = d->saw_adobe && d->adobe_transform != 0;
    }
    /* libjpeg-turbo converts lossless samples only where the output
     * space is the frame's own (RGB to BGR included): gray to gray, RGB
     * to colour, CMYK to CMYK */
    if (d->lossless && !(d->ncomp == 1 ? channels == 1
                         : d->ncomp == 3 ? rgb_source && channels == 3
                         : !ycck))
        fail(d, "unsupported: a lossless %s JPEG read as %s" CV2_TOO
                "\"Unsupported color conversion request\")",
             d->ncomp == 1 ? "gray" : d->ncomp == 4 ? "YCCK"
             : rgb_source ? "RGB" : "YCbCr",
             channels == 1 ? "gray" : "colour");

    const int W = d->width, H = d->height;
    const int mcux = (W + 8 * d->max_h - 1) / (8 * d->max_h);
    const int mcuy = (H + 8 * d->max_v - 1) / (8 * d->max_v);
    const int streaming = !d->progressive && !d->arithmetic &&
                          !d->lossless && d->ns == d->ncomp;
    for (int i = 0; i < d->ncomp; i++) {
        component *c = &d->comp[i];
        if (d->max_h % c->h || d->max_v % c->v)
            fail(d, "unsupported: non-integral sampling factors" CV2_TOO
                    "\"Fractional sampling not implemented yet\")");
        c->dw = (int)(((int64_t)W * c->h + d->max_h - 1) / d->max_h);
        c->dh = (int)(((int64_t)H * c->v + d->max_v - 1) / d->max_v);
        c->wib = (c->dw + 7) / 8;
        c->hib = (c->dh + 7) / 8;
        if (d->ncomp == 1) {      /* jdcoefct.c: whole iMCU rows */
            c->bw = (c->wib + c->h - 1) / c->h * c->h;
            c->bh = (c->hib + c->v - 1) / c->v * c->v;
        } else {
            c->bw = mcux * c->h;
            c->bh = mcuy * c->v;
        }
        c->stride = c->bw * 8;
        c->plane = alloc(d, (size_t)c->stride * c->bh * 8);
        if (!streaming && !d->lossless)
            c->coef = alloc(d, (size_t)c->bw * c->bh * 64 * sizeof(int16_t));
    }

    if (streaming) {
        int blocks = 0;
        for (int i = 0; i < d->ncomp; i++) {
            component *c = &d->comp[i];
            if (!d->qt_defined[c->tq])
                fail(d, "corrupt: quantization table %d not defined" CV2_STOPS,
                        c->tq);
            for (int k = 0; k < 64; k++) c->qt[k] = (int16_t)d->qt[c->tq][k];
            if (c->td > 3 || c->ta > 3 || !d->dc[c->td].defined ||
                !d->ac[c->ta].defined)
                fail(d, "corrupt: scan uses an undefined Huffman table"
                        CV2_STOPS);
            if (d->dc[c->td].max_sym > 15)
                fail(d, "corrupt: bad Huffman table" CV2_STOPS);
            blocks += c->h * c->v;
        }
        if (d->ns > 1 && blocks > 10)
            fail(d, "corrupt: %d blocks in an MCU (at most 10)" CV2_STOPS,
                    blocks);
        decode_scan(d, d->scan, d->ns);   /* one_pass: nothing after */
    } else if (d->lossless) {
        decode_lossless(d);
    } else {
        decode_buffered(d);
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
    if (d->ncomp == 4) {
        /* OpenCV's CMYK conversions of what libjpeg gives as CMYK */
        if (ycck) ycck_to_cmyk(full[0], full[1], full[2], npix);
        for (size_t i = 0; i < npix; i++) {
            int k = full[3][i];
            int c = k - ((255 - full[0][i]) * k >> 8);
            int m = k - ((255 - full[1][i]) * k >> 8);
            int y = k - ((255 - full[2][i]) * k >> 8);
            if (channels == 3) {
                img[3 * i] = (uint8_t)c;
                img[3 * i + 1] = (uint8_t)m;
                img[3 * i + 2] = (uint8_t)y;
            } else {
                img[i] = (uint8_t)((y * 1868 + m * 9617 + c * 4899 + 8192)
                                   >> 14);
            }
        }
    } else if (channels == 3) {
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
    int o = d->transform >= 0 ? 1 : d->orientation;
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

static int decode_as(const uint8_t *data, size_t len, int channels,
                     int transform, uint8_t **out, int *out_h, int *out_w,
                     char *err, size_t errlen) {
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
    d->transform = transform;
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

int yolo_jpeg_decode(const uint8_t *data, size_t len, int channels,
                     uint8_t **out, int *out_h, int *out_w, char *err,
                     size_t errlen) {
    return decode_as(data, len, channels, -1, out, out_h, out_w, err, errlen);
}

int yolo_jpeg_decode_ycc(const uint8_t *data, size_t len, int channels,
                         uint8_t **out, int *out_h, int *out_w, char *err,
                         size_t errlen) {
    return decode_as(data, len, channels, 1, out, out_h, out_w, err, errlen);
}

int yolo_jpeg_decode_raw(const uint8_t *data, size_t len, int channels,
                         uint8_t **out, int *out_h, int *out_w, char *err,
                         size_t errlen) {
    return decode_as(data, len, channels, 0, out, out_h, out_w, err, errlen);
}

void yolo_native_free(void *p) { free(p); }
