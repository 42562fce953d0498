/* WebP lossy (VP8 key frame) decoder for the host data pipeline, as
 * libwebp 1.x (vp8_dec.c, tree_dec.c, frame_dec.c, dsp/dec.c,
 * upsampling.c, yuv.h) decodes a "VP8 " chunk into RGB:
 *
 *   - the boolean decoder, reading past a partition's end an error as
 *     libwebp's eof flag makes it (checked after each row of modes and
 *     each macroblock's tokens);
 *   - the frame header: segments (quantizer and filter strength, absolute
 *     or delta, the segment map's tree), the loop filter (simple or
 *     normal, level, sharpness, reference and mode deltas), 1-8 token
 *     partitions, the quantizers (y2 AC * 155 / 100 at least 8, uv DC at
 *     most index 117), token probability updates and the skip flag;
 *   - intra modes: 16x16 (DC, V, H, TM) and 4x4 (ten modes, the key
 *     frame's contextual probabilities), chroma (DC, V, H, TM); DC of a
 *     missing edge as libwebp chooses it, the top row 127, the left
 *     column 129, the top-right of the last column repeated;
 *   - tokens with their band and neighbour contexts, dequantized into
 *     int16 (as libwebp stores them), the Walsh-Hadamard transform of the
 *     y2 block and the 4x4 inverse DCT (20091 / 35468 multipliers);
 *   - the loop filter over the whole frame in macroblock order: left
 *     edge, inner vertical edges, top edge, inner horizontal edges (inner
 *     ones for 4x4-predicted or coded macroblocks), simple (luma only)
 *     or normal (luma and chroma, high edge variance thresholds);
 *   - libwebp's "fancy" upsampling of the chroma (the 9-3-3-1 filter,
 *     the edges repeating their row) and its 14-bit YUV -> RGB
 *     (VP8YUVToR/G/B), cropped to the frame's size.
 *
 * yolo_webp_decode_vp8 gives the (h, w, 3) RGB bytes. What libwebp
 * refuses fails with a message. Plain C11, no state between calls.
 */

#include <setjmp.h>
#include <stdarg.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "native.h"
#include "webp_tables.h"

#define NO_IMAGE "; cv2 gives no image either (libwebp fails there)"

enum { B_DC = 0, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };

static const uint8_t kZigzag[16] = {0, 1, 4,  8,  5, 2,  3,  6,
                                    9, 12, 13, 10, 7, 11, 14, 15};
static const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6,
                                   6, 6, 6, 6, 6, 6, 7, 0};
static const uint8_t kCat3[] = {173, 148, 140, 0};
static const uint8_t kCat4[] = {176, 155, 140, 135, 0};
static const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
static const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177,
                                153, 140, 133, 130, 129, 0};
static const uint8_t *const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};
static const int8_t kYModesIntra4[18] = {
    -B_DC, 1, -B_TM, 2, -B_VE, 3, 4, 6, -B_HE, 5,
    -B_RD, -B_VR, -B_LD, 7, -B_VL, 8, -B_HD, -B_HU};

/* ------------------------------------------------------ boolean decoder */

typedef struct {
    const uint8_t *buf, *end;
    uint64_t value;
    uint32_t range;           /* range - 1, as libwebp keeps it */
    int bits;                 /* bits in value beyond the 8 of the window */
    int eof;
} bool_dec;

static void load(bool_dec *br) {
    if (br->buf < br->end) {
        br->bits += 8;
        br->value = (uint64_t)(*br->buf++) | (br->value << 8);
    } else if (!br->eof) {
        br->value <<= 8;
        br->bits += 8;
        br->eof = 1;
    } else {
        br->bits = 0;
    }
}

static void bool_init(bool_dec *br, const uint8_t *start, size_t size) {
    br->range = 255 - 1;
    br->value = 0;
    br->bits = -8;
    br->eof = 0;
    br->buf = start;
    br->end = start + size;
    load(br);
}

static int get_bit(bool_dec *br, int prob) {
    uint32_t range = br->range;
    if (br->bits < 0) load(br);
    const int pos = br->bits;
    const uint32_t split = (range * (uint32_t)prob) >> 8;
    const uint32_t value = (uint32_t)(br->value >> pos);
    const int bit = value > split;
    if (bit) {
        range -= split;
        br->value -= (uint64_t)(split + 1) << pos;
    } else {
        range = split + 1;
    }
    int shift = 0;
    while ((range << shift) < 128) shift++;
    range <<= shift;
    br->bits -= shift;
    br->range = range - 1;
    return bit;
}

static int get_value(bool_dec *br, int n) {
    int v = 0;
    while (n-- > 0) v |= get_bit(br, 0x80) << n;
    return v;
}

static int get_signed_value(bool_dec *br, int n) {
    const int v = get_value(br, n);
    return get_bit(br, 0x80) ? -v : v;
}

/* ------------------------------------------------------------- decoder */

typedef struct {
    int f_limit, f_ilevel, f_inner, hev_thresh;
} finfo;

typedef struct {
    int y1[2], y2[2], uv[2];
} quant;

typedef struct {
    char *err;
    size_t errlen;
    jmp_buf jb;
    int width, height, mb_w, mb_h;
    /* segments and filter */
    int use_segment, update_map, absolute_delta;
    int quantizer[4], filter_strength[4];
    uint8_t seg_proba[3];
    int filter_type, level, sharpness, use_lf_delta;
    int ref_lf_delta[4], mode_lf_delta[4];
    finfo fstrengths[4][2];
    quant dqm[4];
    uint8_t proba[4][8][3][11];
    int use_skip_proba, skip_p;
    bool_dec br, parts[8];
    int num_parts;
    /* planes, whole macroblocks */
    uint8_t *y, *u, *v;
    int ystride, uvstride;
    /* per macroblock: filter info; contexts */
    finfo *f_info;
    uint8_t *intra_t;         /* 4 a macroblock column */
    uint8_t intra_l[4];
    uint8_t *nz_top;          /* 9 a column: 4 y, 2 u, 2 v, 1 y2 */
    uint8_t nz_left[9];
} vp8;

static void vfail(vp8 *d, const char *fmt, ...) {
    va_list ap;
    va_start(ap, fmt);
    vsnprintf(d->err, d->errlen, fmt, ap);
    va_end(ap);
    longjmp(d->jb, 1);
}

static int clip(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }

static void parse_headers(vp8 *d, const uint8_t *buf, size_t size) {
    if (size < 10) vfail(d, "truncated: a VP8 frame header" NO_IMAGE);
    const uint32_t bits = buf[0] | buf[1] << 8 | (uint32_t)buf[2] << 16;
    const int key_frame = !(bits & 1), profile = (bits >> 1) & 7;
    const int show = (bits >> 4) & 1;
    const uint32_t part0 = bits >> 5;
    if (!key_frame) vfail(d, "unsupported: a VP8 inter frame" NO_IMAGE);
    if (profile > 3) vfail(d, "corrupt: VP8 profile %d" NO_IMAGE, profile);
    if (!show) vfail(d, "corrupt: a VP8 frame not to show" NO_IMAGE);
    if (buf[3] != 0x9d || buf[4] != 0x01 || buf[5] != 0x2a)
        vfail(d, "corrupt: bad VP8 start code" NO_IMAGE);
    d->width = (buf[6] | buf[7] << 8) & 0x3fff;
    d->height = (buf[8] | buf[9] << 8) & 0x3fff;
    if (!d->width || !d->height)
        vfail(d, "corrupt: a VP8 frame of width or height 0" NO_IMAGE);
    d->mb_w = (d->width + 15) >> 4;
    d->mb_h = (d->height + 15) >> 4;
    buf += 10;
    size -= 10;
    if (part0 > size)
        vfail(d, "corrupt: bad VP8 partition length" NO_IMAGE);
    bool_dec *br = &d->br;
    bool_init(br, buf, part0);
    get_value(br, 1);                           /* colour space */
    get_value(br, 1);                           /* clamping type */
    d->use_segment = get_value(br, 1);
    if (d->use_segment) {
        d->update_map = get_value(br, 1);
        if (get_value(br, 1)) {                 /* update data */
            d->absolute_delta = get_value(br, 1);
            for (int s = 0; s < 4; s++)
                d->quantizer[s] = get_value(br, 1) ? get_signed_value(br, 7)
                                                   : 0;
            for (int s = 0; s < 4; s++)
                d->filter_strength[s] =
                    get_value(br, 1) ? get_signed_value(br, 6) : 0;
        }
        if (d->update_map)
            for (int s = 0; s < 3; s++)
                d->seg_proba[s] =
                    (uint8_t)(get_value(br, 1) ? get_value(br, 8) : 255);
    } else {
        d->update_map = 0;
    }
    const int simple = get_value(br, 1);
    d->level = get_value(br, 6);
    d->sharpness = get_value(br, 3);
    d->use_lf_delta = get_value(br, 1);
    if (d->use_lf_delta && get_value(br, 1)) {
        for (int i = 0; i < 4; i++)
            if (get_value(br, 1)) d->ref_lf_delta[i] = get_signed_value(br, 6);
        for (int i = 0; i < 4; i++)
            if (get_value(br, 1)) d->mode_lf_delta[i] = get_signed_value(br, 6);
    }
    d->filter_type = d->level == 0 ? 0 : simple ? 1 : 2;
    if (br->eof) vfail(d, "corrupt: cannot parse the VP8 headers" NO_IMAGE);

    /* partitions */
    const uint8_t *sz = buf + part0;
    const uint8_t *buf_end = buf + size;
    d->num_parts = 1 << get_value(br, 2);
    const int last = d->num_parts - 1;
    if ((size_t)(buf_end - sz) < 3u * last)
        vfail(d, "corrupt: cannot parse the VP8 partitions" NO_IMAGE);
    const uint8_t *part_start = sz + last * 3;
    size_t size_left = (size_t)(buf_end - part_start);
    for (int p = 0; p < last; p++) {
        size_t psize = sz[0] | sz[1] << 8 | (size_t)sz[2] << 16;
        if (psize > size_left) psize = size_left;
        bool_init(&d->parts[p], part_start, psize);
        part_start += psize;
        size_left -= psize;
        sz += 3;
    }
    bool_init(&d->parts[last], part_start, size_left);
    if (part_start >= buf_end)
        vfail(d, "truncated: no data for the last VP8 partition" NO_IMAGE);

    /* quantizers */
    const int base_q0 = get_value(br, 7);
    const int dqy1_dc = get_value(br, 1) ? get_signed_value(br, 4) : 0;
    const int dqy2_dc = get_value(br, 1) ? get_signed_value(br, 4) : 0;
    const int dqy2_ac = get_value(br, 1) ? get_signed_value(br, 4) : 0;
    const int dquv_dc = get_value(br, 1) ? get_signed_value(br, 4) : 0;
    const int dquv_ac = get_value(br, 1) ? get_signed_value(br, 4) : 0;
    for (int i = 0; i < 4; i++) {
        int q;
        if (d->use_segment) {
            q = d->quantizer[i];
            if (!d->absolute_delta) q += base_q0;
        } else if (i > 0) {
            d->dqm[i] = d->dqm[0];
            continue;
        } else {
            q = base_q0;
        }
        quant *m = &d->dqm[i];
        m->y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
        m->y1[1] = kAcTable[clip(q, 127)];
        m->y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
        m->y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
        if (m->y2[1] < 8) m->y2[1] = 8;
        m->uv[0] = kDcTable[clip(q + dquv_dc, 117)];
        m->uv[1] = kAcTable[clip(q + dquv_ac, 127)];
    }
    get_value(br, 1);                           /* update_proba: ignored */
    for (int t = 0; t < 4; t++)
        for (int b = 0; b < 8; b++)
            for (int c = 0; c < 3; c++)
                for (int p = 0; p < 11; p++)
                    d->proba[t][b][c][p] = (uint8_t)(
                        get_bit(br, kCoeffsUpdateProba[t][b][c][p])
                            ? get_value(br, 8)
                            : kCoeffsProba0[t][b][c][p]);
    d->use_skip_proba = get_value(br, 1);
    if (d->use_skip_proba) d->skip_p = get_value(br, 8);
}

static void filter_strengths(vp8 *d) {
    if (!d->filter_type) return;
    for (int s = 0; s < 4; s++) {
        int base = d->level;
        if (d->use_segment) {
            base = d->filter_strength[s];
            if (!d->absolute_delta) base += d->level;
        }
        for (int i4 = 0; i4 <= 1; i4++) {
            finfo *info = &d->fstrengths[s][i4];
            int level = base;
            if (d->use_lf_delta) {
                level += d->ref_lf_delta[0];
                if (i4) level += d->mode_lf_delta[0];
            }
            level = level < 0 ? 0 : level > 63 ? 63 : level;
            if (level > 0) {
                int ilevel = level;
                if (d->sharpness > 0) {
                    ilevel >>= d->sharpness > 4 ? 2 : 1;
                    if (ilevel > 9 - d->sharpness) ilevel = 9 - d->sharpness;
                }
                if (ilevel < 1) ilevel = 1;
                info->f_ilevel = ilevel;
                info->f_limit = 2 * level + ilevel;
                info->hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
            } else {
                info->f_limit = 0;
            }
            info->f_inner = i4;
        }
    }
}

/* --------------------------------------------------------------- tokens */

static int large_value(bool_dec *br, const uint8_t *p) {
    int v;
    if (!get_bit(br, p[3])) {
        v = !get_bit(br, p[4]) ? 2 : 3 + get_bit(br, p[5]);
    } else if (!get_bit(br, p[6])) {
        if (!get_bit(br, p[7])) {
            v = 5 + get_bit(br, 159);
        } else {
            v = 7 + 2 * get_bit(br, 165);
            v += get_bit(br, 145);
        }
    } else {
        const int bit1 = get_bit(br, p[8]);
        const int bit0 = get_bit(br, p[9 + bit1]);
        const int cat = 2 * bit1 + bit0;
        v = 0;
        for (const uint8_t *tab = kCat3456[cat]; *tab; tab++)
            v += v + get_bit(br, *tab);
        v += 3 + (8 << cat);
    }
    return v;
}

/* GetCoeffs: tokens from position n into out (dequantized, int16) ->
 * the position after the last non-zero one (or 16) */
static int get_coeffs(bool_dec *br, uint8_t (*bands)[3][11], int ctx,
                      const int *dq, int n, int16_t *out) {
    const uint8_t *p = bands[kBands[n]][ctx];
    for (; n < 16; n++) {
        if (!get_bit(br, p[0])) return n;
        while (!get_bit(br, p[1])) {
            p = bands[kBands[++n]][0];
            if (n == 16) return 16;
        }
        int v;
        if (!get_bit(br, p[2])) {
            v = 1;
            p = bands[kBands[n + 1]][1];
        } else {
            v = large_value(br, p);
            p = bands[kBands[n + 1]][2];
        }
        if (get_bit(br, 0x80)) v = -v;
        out[kZigzag[n]] = (int16_t)(uint16_t)(uint32_t)(v * dq[n > 0]);
    }
    return 16;
}

static void transform_wht(const int16_t *in, int16_t *out) {
    int tmp[16];
    for (int i = 0; i < 4; i++) {
        const int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
        const int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
        tmp[0 + i] = a0 + a1;
        tmp[8 + i] = a0 - a1;
        tmp[4 + i] = a3 + a2;
        tmp[12 + i] = a3 - a2;
    }
    for (int i = 0; i < 4; i++) {
        const int dc = tmp[0 + i * 4] + 3;
        const int *t = tmp + i * 4;
        const int a0 = dc + t[3], a1 = t[1] + t[2];
        const int a2 = t[1] - t[2], a3 = dc - t[3];
        out[0] = (int16_t)((a0 + a1) >> 3);
        out[16] = (int16_t)((a3 + a2) >> 3);
        out[32] = (int16_t)((a0 - a1) >> 3);
        out[48] = (int16_t)((a3 - a2) >> 3);
        out += 64;
    }
}

/* one macroblock's residuals (ParseResiduals) -> coeffs[384]; returns
 * whether every block is zero */
static int parse_residuals(vp8 *d, bool_dec *br, int mb_x, int i4x4,
                           const quant *q, int16_t *coeffs) {
    uint8_t *tnz = d->nz_top + 9 * mb_x, *lnz = d->nz_left;
    int16_t *dst = coeffs;
    int any = 0, first;
    uint8_t (*ac)[3][11];
    memset(coeffs, 0, 384 * sizeof *coeffs);
    if (!i4x4) {
        int16_t dc[16] = {0};
        const int ctx = tnz[8] + lnz[8];
        const int nz = get_coeffs(br, d->proba[1], ctx, q->y2, 0, dc);
        tnz[8] = lnz[8] = nz > 0;
        if (nz > 1) {
            transform_wht(dc, dst);
        } else {
            const int dc0 = (dc[0] + 3) >> 3;
            for (int i = 0; i < 256; i += 16) dst[i] = (int16_t)dc0;
        }
        first = 1;
        ac = d->proba[0];
    } else {
        first = 0;
        ac = d->proba[3];
    }
    for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++) {
            const int ctx = lnz[y] + tnz[x];
            const int nz = get_coeffs(br, ac, ctx, q->y1, first, dst);
            tnz[x] = lnz[y] = nz > first;
            any |= nz > 3 || nz > 1 || dst[0] != 0;   /* NzCodeBits */
            dst += 16;
        }
    for (int ch = 0; ch < 2; ch++)
        for (int y = 0; y < 2; y++)
            for (int x = 0; x < 2; x++) {
                uint8_t *t = tnz + 4 + 2 * ch + x, *l = lnz + 4 + 2 * ch + y;
                const int nz = get_coeffs(br, d->proba[2], *t + *l, q->uv, 0,
                                          dst);
                *t = *l = nz > 0;
                any |= nz > 1 || dst[0] != 0;
                dst += 16;
            }
    return !any;
}

/* ----------------------------------------------------------- prediction */

#define BPS 32        /* the work area: a row of 32 bytes a row of pixels */

static uint8_t clip8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

#define MUL1(a) ((((a) * 20091) >> 16) + (a))
#define MUL2(a) (((a) * 35468) >> 16)

static void transform_one(const int16_t *in, uint8_t *dst) {
    int C[16], *tmp = C;
    for (int i = 0; i < 4; i++) {
        const int a = in[0] + in[8], b = in[0] - in[8];
        const int c = MUL2(in[4]) - MUL1(in[12]);
        const int d = MUL1(in[4]) + MUL2(in[12]);
        tmp[0] = a + d;
        tmp[1] = b + c;
        tmp[2] = b - c;
        tmp[3] = a - d;
        tmp += 4;
        in++;
    }
    tmp = C;
    for (int i = 0; i < 4; i++) {
        const int dc = tmp[0] + 4;
        const int a = dc + tmp[8], b = dc - tmp[8];
        const int c = MUL2(tmp[4]) - MUL1(tmp[12]);
        const int d = MUL1(tmp[4]) + MUL2(tmp[12]);
        dst[0] = clip8(dst[0] + ((a + d) >> 3));
        dst[1] = clip8(dst[1] + ((b + c) >> 3));
        dst[2] = clip8(dst[2] + ((b - c) >> 3));
        dst[3] = clip8(dst[3] + ((a - d) >> 3));
        tmp++;
        dst += BPS;
    }
}

#define AVG3(a, b, c) ((uint8_t)(((a) + 2 * (b) + (c) + 2) >> 2))
#define AVG2(a, b) (((a) + (b) + 1) >> 1)
#define DST(x, y) dst[(x) + (y) * BPS]

static void true_motion(uint8_t *dst, int size) {
    const uint8_t *top = dst - BPS;
    const int tl = top[-1];
    for (int y = 0; y < size; y++) {
        const int l = dst[-1 + y * BPS];
        for (int x = 0; x < size; x++)
            dst[x + y * BPS] = clip8(top[x] + l - tl);
    }
}

static void fill(uint8_t *dst, int v, int size) {
    for (int y = 0; y < size; y++) memset(dst + y * BPS, v, size);
}

static void pred4(uint8_t *dst, int mode) {
    const uint8_t *top = dst - BPS;
    const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
              L = dst[-1 + 3 * BPS], X = top[-1];
    const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4],
              F = top[5], G = top[6], H = top[7];
    switch (mode) {
    case B_DC: {
        int dc = 4;
        for (int i = 0; i < 4; i++) dc += top[i] + dst[-1 + i * BPS];
        fill(dst, dc >> 3, 4);
        break;
    }
    case B_TM: true_motion(dst, 4); break;
    case B_VE: {
        const uint8_t v[4] = {AVG3(X, A, B), AVG3(A, B, C), AVG3(B, C, D),
                              AVG3(C, D, E)};
        for (int i = 0; i < 4; i++) memcpy(dst + i * BPS, v, 4);
        break;
    }
    case B_HE:
        memset(dst, AVG3(X, I, J), 4);
        memset(dst + BPS, AVG3(I, J, K), 4);
        memset(dst + 2 * BPS, AVG3(J, K, L), 4);
        memset(dst + 3 * BPS, AVG3(K, L, L), 4);
        break;
    case B_RD:
        DST(0, 3) = AVG3(J, K, L);
        DST(1, 3) = DST(0, 2) = AVG3(I, J, K);
        DST(2, 3) = DST(1, 2) = DST(0, 1) = AVG3(X, I, J);
        DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = AVG3(A, X, I);
        DST(3, 2) = DST(2, 1) = DST(1, 0) = AVG3(B, A, X);
        DST(3, 1) = DST(2, 0) = AVG3(C, B, A);
        DST(3, 0) = AVG3(D, C, B);
        break;
    case B_LD:
        DST(0, 0) = AVG3(A, B, C);
        DST(1, 0) = DST(0, 1) = AVG3(B, C, D);
        DST(2, 0) = DST(1, 1) = DST(0, 2) = AVG3(C, D, E);
        DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = AVG3(D, E, F);
        DST(3, 1) = DST(2, 2) = DST(1, 3) = AVG3(E, F, G);
        DST(3, 2) = DST(2, 3) = AVG3(F, G, H);
        DST(3, 3) = AVG3(G, H, H);
        break;
    case B_VR:
        DST(0, 0) = DST(1, 2) = (uint8_t)AVG2(X, A);
        DST(1, 0) = DST(2, 2) = (uint8_t)AVG2(A, B);
        DST(2, 0) = DST(3, 2) = (uint8_t)AVG2(B, C);
        DST(3, 0) = (uint8_t)AVG2(C, D);
        DST(0, 3) = AVG3(K, J, I);
        DST(0, 2) = AVG3(J, I, X);
        DST(0, 1) = DST(1, 3) = AVG3(I, X, A);
        DST(1, 1) = DST(2, 3) = AVG3(X, A, B);
        DST(2, 1) = DST(3, 3) = AVG3(A, B, C);
        DST(3, 1) = AVG3(B, C, D);
        break;
    case B_VL:
        DST(0, 0) = (uint8_t)AVG2(A, B);
        DST(1, 0) = DST(0, 2) = (uint8_t)AVG2(B, C);
        DST(2, 0) = DST(1, 2) = (uint8_t)AVG2(C, D);
        DST(3, 0) = DST(2, 2) = (uint8_t)AVG2(D, E);
        DST(0, 1) = AVG3(A, B, C);
        DST(1, 1) = DST(0, 3) = AVG3(B, C, D);
        DST(2, 1) = DST(1, 3) = AVG3(C, D, E);
        DST(3, 1) = DST(2, 3) = AVG3(D, E, F);
        DST(3, 2) = AVG3(E, F, G);
        DST(3, 3) = AVG3(F, G, H);
        break;
    case B_HD:
        DST(0, 0) = DST(2, 1) = (uint8_t)AVG2(I, X);
        DST(0, 1) = DST(2, 2) = (uint8_t)AVG2(J, I);
        DST(0, 2) = DST(2, 3) = (uint8_t)AVG2(K, J);
        DST(0, 3) = (uint8_t)AVG2(L, K);
        DST(3, 0) = AVG3(A, B, C);
        DST(2, 0) = AVG3(X, A, B);
        DST(1, 0) = DST(3, 1) = AVG3(I, X, A);
        DST(1, 1) = DST(3, 2) = AVG3(J, I, X);
        DST(1, 2) = DST(3, 3) = AVG3(K, J, I);
        DST(1, 3) = AVG3(L, K, J);
        break;
    default: /* B_HU */
        DST(0, 0) = (uint8_t)AVG2(I, J);
        DST(2, 0) = DST(0, 1) = (uint8_t)AVG2(J, K);
        DST(2, 1) = DST(0, 2) = (uint8_t)AVG2(K, L);
        DST(1, 0) = AVG3(I, J, K);
        DST(3, 0) = DST(1, 1) = AVG3(J, K, L);
        DST(3, 1) = DST(1, 2) = AVG3(K, L, L);
        DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) =
            DST(3, 3) = (uint8_t)L;
        break;
    }
}

/* 16x16 luma (size 16) or 8x8 chroma (size 8) prediction, DC as
 * CheckMode picks it at the frame's edges */
static void pred_block(uint8_t *dst, int mode, int size, int mb_x, int mb_y) {
    const int shift = size == 16 ? 4 : 3;
    switch (mode) {
    case B_DC: {
        int dc = 0;
        if (mb_x > 0 && mb_y > 0) {
            for (int i = 0; i < size; i++)
                dc += dst[i - BPS] + dst[-1 + i * BPS];
            dc = (dc + size) >> (shift + 1);
        } else if (mb_y > 0) {                 /* no left */
            for (int i = 0; i < size; i++) dc += dst[i - BPS];
            dc = (dc + (size >> 1)) >> shift;
        } else if (mb_x > 0) {                 /* no top */
            for (int i = 0; i < size; i++) dc += dst[-1 + i * BPS];
            dc = (dc + (size >> 1)) >> shift;
        } else {
            dc = 0x80;
        }
        fill(dst, dc, size);
        break;
    }
    case B_TM: true_motion(dst, size); break;
    case B_VE:
        for (int y = 0; y < size; y++) memcpy(dst + y * BPS, dst - BPS, size);
        break;
    default: /* B_HE */
        for (int y = 0; y < size; y++)
            memset(dst + y * BPS, dst[-1 + y * BPS], size);
        break;
    }
}

/* -------------------------------------------------------------- filters */

static int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
static int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

static void do_filter2(uint8_t *p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
    const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
    p[-step] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
}

static void do_filter4(uint8_t *p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0);
    const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
    const int a3 = (a1 + 1) >> 1;
    p[-2 * step] = clip8(p1 + a3);
    p[-step] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
    p[step] = clip8(q1 - a3);
}

static void do_filter6(uint8_t *p, int step) {
    const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
    const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
    const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7;
    const int a3 = (9 * a + 63) >> 7;
    p[-3 * step] = clip8(p2 + a3);
    p[-2 * step] = clip8(p1 + a2);
    p[-step] = clip8(p0 + a1);
    p[0] = clip8(q0 - a1);
    p[step] = clip8(q1 - a2);
    p[2 * step] = clip8(q2 - a3);
}

static int hev(const uint8_t *p, int step, int thresh) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    return abs(p1 - p0) > thresh || abs(q1 - q0) > thresh;
}

static int needs_filter(const uint8_t *p, int step, int t) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    return 4 * abs(p0 - q0) + abs(p1 - q1) <= t;
}

static int needs_filter2(const uint8_t *p, int step, int t, int it) {
    const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
    const int p0 = p[-step], q0 = p[0], q1 = p[step], q2 = p[2 * step],
              q3 = p[3 * step];
    if (4 * abs(p0 - q0) + abs(p1 - q1) > t) return 0;
    return abs(p3 - p2) <= it && abs(p2 - p1) <= it && abs(p1 - p0) <= it &&
           abs(q3 - q2) <= it && abs(q2 - q1) <= it && abs(q1 - q0) <= it;
}

/* hstride across the edge, vstride along it */
static void simple_edge(uint8_t *p, int hstride, int vstride, int thresh) {
    const int t2 = 2 * thresh + 1;
    for (int i = 0; i < 16; i++, p += vstride)
        if (needs_filter(p, hstride, t2)) do_filter2(p, hstride);
}

static void loop_edge(uint8_t *p, int hstride, int vstride, int size,
                      int thresh, int ithresh, int hev_t, int inner) {
    const int t2 = 2 * thresh + 1;
    for (int i = 0; i < size; i++, p += vstride)
        if (needs_filter2(p, hstride, t2, ithresh)) {
            if (hev(p, hstride, hev_t)) do_filter2(p, hstride);
            else if (inner) do_filter4(p, hstride);
            else do_filter6(p, hstride);
        }
}

static void filter_mb(vp8 *d, int mb_x, int mb_y) {
    const finfo *f = &d->f_info[(size_t)mb_y * d->mb_w + mb_x];
    const int limit = f->f_limit, il = f->f_ilevel, hv = f->hev_thresh;
    if (limit == 0) return;
    const int ys = d->ystride, us = d->uvstride;
    uint8_t *y = d->y + (size_t)mb_y * 16 * ys + mb_x * 16;
    uint8_t *u = d->u + (size_t)mb_y * 8 * us + mb_x * 8;
    uint8_t *v = d->v + (size_t)mb_y * 8 * us + mb_x * 8;
    if (d->filter_type == 1) {
        if (mb_x > 0) simple_edge(y, 1, ys, limit + 4);
        if (f->f_inner)
            for (int k = 1; k < 4; k++) simple_edge(y + 4 * k, 1, ys, limit);
        if (mb_y > 0) simple_edge(y, ys, 1, limit + 4);
        if (f->f_inner)
            for (int k = 1; k < 4; k++)
                simple_edge(y + 4 * k * ys, ys, 1, limit);
        return;
    }
    if (mb_x > 0) {
        loop_edge(y, 1, ys, 16, limit + 4, il, hv, 0);
        loop_edge(u, 1, us, 8, limit + 4, il, hv, 0);
        loop_edge(v, 1, us, 8, limit + 4, il, hv, 0);
    }
    if (f->f_inner) {
        for (int k = 1; k < 4; k++) loop_edge(y + 4 * k, 1, ys, 16, limit,
                                              il, hv, 1);
        loop_edge(u + 4, 1, us, 8, limit, il, hv, 1);
        loop_edge(v + 4, 1, us, 8, limit, il, hv, 1);
    }
    if (mb_y > 0) {
        loop_edge(y, ys, 1, 16, limit + 4, il, hv, 0);
        loop_edge(u, us, 1, 8, limit + 4, il, hv, 0);
        loop_edge(v, us, 1, 8, limit + 4, il, hv, 0);
    }
    if (f->f_inner) {
        for (int k = 1; k < 4; k++)
            loop_edge(y + 4 * k * ys, ys, 1, 16, limit, il, hv, 1);
        loop_edge(u + 4 * us, us, 1, 8, limit, il, hv, 1);
        loop_edge(v + 4 * us, us, 1, 8, limit, il, hv, 1);
    }
}

/* ------------------------------------------------------------ the frame */

static const int kScan[16] = {0,  4,  8,  12, 0 + 4 * BPS, 4 + 4 * BPS,
                              8 + 4 * BPS, 12 + 4 * BPS, 0 + 8 * BPS,
                              4 + 8 * BPS, 8 + 8 * BPS, 12 + 8 * BPS,
                              0 + 12 * BPS, 4 + 12 * BPS, 8 + 12 * BPS,
                              12 + 12 * BPS};

typedef struct {
    int segment, skip, i4x4, imodes[16], uvmode;
} mbinfo;

static void parse_intra_mode(vp8 *d, int mb_x, mbinfo *mb) {
    bool_dec *br = &d->br;
    uint8_t *top = d->intra_t + 4 * mb_x, *left = d->intra_l;
    if (d->update_map)
        mb->segment = !get_bit(br, d->seg_proba[0])
                          ? get_bit(br, d->seg_proba[1])
                          : get_bit(br, d->seg_proba[2]) + 2;
    else
        mb->segment = 0;
    mb->skip = d->use_skip_proba ? get_bit(br, d->skip_p) : 0;
    mb->i4x4 = !get_bit(br, 145);
    if (!mb->i4x4) {
        const int ymode = get_bit(br, 156)
                              ? (get_bit(br, 128) ? B_TM : B_HE)
                              : (get_bit(br, 163) ? B_VE : B_DC);
        mb->imodes[0] = ymode;
        memset(top, ymode, 4);
        memset(left, ymode, 4);
    } else {
        for (int y = 0; y < 4; y++) {
            int ymode = left[y];
            for (int x = 0; x < 4; x++) {
                const uint8_t *prob = kBModesProba[top[x]][ymode];
                int i = kYModesIntra4[get_bit(br, prob[0])];
                while (i > 0) i = kYModesIntra4[2 * i + get_bit(br, prob[i])];
                ymode = -i;
                top[x] = (uint8_t)ymode;
                mb->imodes[y * 4 + x] = ymode;
            }
            left[y] = (uint8_t)ymode;
        }
    }
    mb->uvmode = !get_bit(br, 142) ? B_DC
                 : !get_bit(br, 114) ? B_VE
                 : get_bit(br, 183) ? B_TM : B_HE;
}

/* reconstruct one macroblock into the planes, from unfiltered samples:
 * the work area holds the left column and the top row (with four
 * top-right bytes) as ReconstructRow fills them */
static void reconstruct(vp8 *d, int mb_x, int mb_y, const mbinfo *mb,
                        const int16_t *coeffs, uint8_t *ytop, uint8_t *utop,
                        uint8_t *vtop, uint8_t *yleft, uint8_t *uleft,
                        uint8_t *vleft) {
    uint8_t work[BPS * 17 + BPS * 9 * 2];
    uint8_t *yd = work + BPS + 8, *ud = work + BPS * 18 + 8,
            *vd = work + BPS * 18 + 16 + 8;
    /* top row (and top-left) */
    if (mb_y > 0) {
        memcpy(yd - BPS - 1, ytop + mb_x * 16 - 1, 1);
        memcpy(yd - BPS, ytop + mb_x * 16, 16);
        memcpy(ud - BPS, utop + mb_x * 8, 8);
        memcpy(vd - BPS, vtop + mb_x * 8, 8);
        if (mb_x > 0) {
            ud[-BPS - 1] = utop[mb_x * 8 - 1];
            vd[-BPS - 1] = vtop[mb_x * 8 - 1];
        } else {
            yd[-BPS - 1] = ud[-BPS - 1] = vd[-BPS - 1] = 129;
        }
    } else {
        memset(yd - BPS - 1, 127, 16 + 4 + 1);
        memset(ud - BPS - 1, 127, 8 + 1);
        memset(vd - BPS - 1, 127, 8 + 1);
    }
    for (int j = 0; j < 16; j++) yd[j * BPS - 1] = mb_x > 0 ? yleft[j] : 129;
    for (int j = 0; j < 8; j++) {
        ud[j * BPS - 1] = mb_x > 0 ? uleft[j] : 129;
        vd[j * BPS - 1] = mb_x > 0 ? vleft[j] : 129;
    }
    if (mb->i4x4) {
        uint8_t *tr = yd - BPS + 16;
        if (mb_y > 0) {
            if (mb_x >= d->mb_w - 1) memset(tr, ytop[mb_x * 16 + 15], 4);
            else memcpy(tr, ytop + mb_x * 16 + 16, 4);
        }
        for (int k = 1; k < 4; k++) memcpy(tr + k * 4 * BPS, tr, 4);
        for (int n = 0; n < 16; n++) {
            uint8_t *dst = yd + kScan[n];
            pred4(dst, mb->imodes[n]);
            transform_one(coeffs + n * 16, dst);
        }
    } else {
        pred_block(yd, mb->imodes[0], 16, mb_x, mb_y);
        for (int n = 0; n < 16; n++) transform_one(coeffs + n * 16,
                                                   yd + kScan[n]);
    }
    pred_block(ud, mb->uvmode, 8, mb_x, mb_y);
    pred_block(vd, mb->uvmode, 8, mb_x, mb_y);
    for (int n = 0; n < 4; n++) {
        const int off = (n & 1) * 4 + (n >> 1) * 4 * BPS;
        transform_one(coeffs + 256 + n * 16, ud + off);
        transform_one(coeffs + 320 + n * 16, vd + off);
    }
    /* out to the planes, and the unfiltered edges kept for the
     * neighbours' prediction */
    for (int j = 0; j < 16; j++) {
        memcpy(d->y + (size_t)(mb_y * 16 + j) * d->ystride + mb_x * 16,
               yd + j * BPS, 16);
        yleft[j] = yd[j * BPS + 15];
    }
    for (int j = 0; j < 8; j++) {
        memcpy(d->u + (size_t)(mb_y * 8 + j) * d->uvstride + mb_x * 8,
               ud + j * BPS, 8);
        memcpy(d->v + (size_t)(mb_y * 8 + j) * d->uvstride + mb_x * 8,
               vd + j * BPS, 8);
        uleft[j] = ud[j * BPS + 7];
        vleft[j] = vd[j * BPS + 7];
    }
}

/* ----------------------------------------------------- YUV -> RGB out */

static int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }

static int yuv_clip8(int v) {
    return (v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255;
}

static void yuv_to_rgb(int y, int u, int v, uint8_t *rgb) {
    rgb[0] = (uint8_t)yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
    rgb[1] = (uint8_t)yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) -
                                mult_hi(v, 13320) + 8708);
    rgb[2] = (uint8_t)yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

#define LOAD_UV(u, v) ((uint32_t)(u) | ((uint32_t)(v) << 16))

/* upsampling.c's UPSAMPLE_FUNC on one pair of rows (bottom may be NULL) */
static void upsample_pair(const uint8_t *top_y, const uint8_t *bottom_y,
                          const uint8_t *top_u, const uint8_t *top_v,
                          const uint8_t *cur_u, const uint8_t *cur_v,
                          uint8_t *top_dst, uint8_t *bottom_dst, int len) {
    const int last_pair = (len - 1) >> 1;
    uint32_t tl_uv = LOAD_UV(top_u[0], top_v[0]);
    uint32_t l_uv = LOAD_UV(cur_u[0], cur_v[0]);
    {
        const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
        yuv_to_rgb(top_y[0], uv0 & 0xff, (int)(uv0 >> 16), top_dst);
    }
    if (bottom_y) {
        const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
        yuv_to_rgb(bottom_y[0], uv0 & 0xff, (int)(uv0 >> 16), bottom_dst);
    }
    for (int x = 1; x <= last_pair; x++) {
        const uint32_t t_uv = LOAD_UV(top_u[x], top_v[x]);
        const uint32_t uv = LOAD_UV(cur_u[x], cur_v[x]);
        const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
        const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
        const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
        {
            const uint32_t uv0 = (diag_12 + tl_uv) >> 1;
            const uint32_t uv1 = (diag_03 + t_uv) >> 1;
            yuv_to_rgb(top_y[2 * x - 1], uv0 & 0xff, (int)(uv0 >> 16),
                       top_dst + (2 * x - 1) * 3);
            yuv_to_rgb(top_y[2 * x], uv1 & 0xff, (int)(uv1 >> 16),
                       top_dst + (2 * x) * 3);
        }
        if (bottom_y) {
            const uint32_t uv0 = (diag_03 + l_uv) >> 1;
            const uint32_t uv1 = (diag_12 + uv) >> 1;
            yuv_to_rgb(bottom_y[2 * x - 1], uv0 & 0xff, (int)(uv0 >> 16),
                       bottom_dst + (2 * x - 1) * 3);
            yuv_to_rgb(bottom_y[2 * x], uv1 & 0xff, (int)(uv1 >> 16),
                       bottom_dst + (2 * x) * 3);
        }
        tl_uv = t_uv;
        l_uv = uv;
    }
    if (!(len & 1)) {
        {
            const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
            yuv_to_rgb(top_y[len - 1], uv0 & 0xff, (int)(uv0 >> 16),
                       top_dst + (len - 1) * 3);
        }
        if (bottom_y) {
            const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
            yuv_to_rgb(bottom_y[len - 1], uv0 & 0xff, (int)(uv0 >> 16),
                       bottom_dst + (len - 1) * 3);
        }
    }
}

/* EmitFancyRGB over the whole frame */
static void emit_rgb(const vp8 *d, uint8_t *rgb) {
    const int w = d->width, h = d->height, ys = d->ystride, us = d->uvstride;
    const size_t stride = (size_t)w * 3;
    upsample_pair(d->y, NULL, d->u, d->v, d->u, d->v, rgb, NULL, w);
    int y = 1;
    for (; y + 1 < h; y += 2) {
        const int uvr = (y + 1) >> 1;
        upsample_pair(d->y + (size_t)y * ys, d->y + (size_t)(y + 1) * ys,
                      d->u + (size_t)(uvr - 1) * us,
                      d->v + (size_t)(uvr - 1) * us,
                      d->u + (size_t)uvr * us, d->v + (size_t)uvr * us,
                      rgb + (size_t)y * stride, rgb + (size_t)(y + 1) * stride,
                      w);
    }
    if (y < h) {       /* the last row of an even height */
        const int uvr = (h - 1) >> 1;
        upsample_pair(d->y + (size_t)y * ys, NULL,
                      d->u + (size_t)uvr * us, d->v + (size_t)uvr * us,
                      d->u + (size_t)uvr * us, d->v + (size_t)uvr * us,
                      rgb + (size_t)y * stride, NULL, w);
    }
}

int yolo_webp_decode_vp8(const uint8_t *data, size_t len, int channels,
                         uint8_t **out, int *out_h, int *out_w, char *err,
                         size_t errlen) {
    vp8 *d = calloc(1, sizeof *d);
    if (!d) {
        snprintf(err, errlen, "out of memory");
        return -1;
    }
    d->err = err;
    d->errlen = errlen;
    void *bufs[4] = {NULL, NULL, NULL, NULL};
    uint8_t *rgb = NULL;
    if (setjmp(d->jb)) {
        for (int i = 0; i < 4; i++) free(bufs[i]);
        free(rgb);
        free(d);
        return -1;
    }
    if (channels != 3) vfail(d, "channels=%d (3: RGB)", channels);
    parse_headers(d, data, len);
    filter_strengths(d);
    const int mb_w = d->mb_w, mb_h = d->mb_h;
    d->ystride = mb_w * 16;
    d->uvstride = mb_w * 8;
    const size_t ysize = (size_t)d->ystride * mb_h * 16;
    const size_t uvsize = (size_t)d->uvstride * mb_h * 8;
    uint8_t *planes = bufs[0] = malloc(ysize + 2 * uvsize);
    /* per column: top samples (unfiltered, 16 + 8 + 8, plus one byte
     * before), contexts, filter info */
    uint8_t *tops = bufs[1] = calloc((size_t)mb_w * 48 + 64, 1);
    d->f_info = bufs[2] = calloc((size_t)mb_w * mb_h, sizeof(finfo));
    mbinfo *mbs = bufs[3] = calloc((size_t)mb_w, sizeof(mbinfo));
    if (!planes || !tops || !d->f_info || !mbs) vfail(d, "out of memory");
    d->y = planes;
    d->u = planes + ysize;
    d->v = planes + ysize + uvsize;
    uint8_t *ytop = tops + 16, *utop = ytop + (size_t)mb_w * 16 + 8;
    uint8_t *vtop = utop + (size_t)mb_w * 8 + 8;
    d->intra_t = vtop + (size_t)mb_w * 8;
    d->nz_top = d->intra_t + (size_t)mb_w * 4;
    /* intra_t and nz_top: B_DC (0) and zero, from calloc */
    int16_t coeffs[384];
    uint8_t yleft[16], uleft[8], vleft[8];
    for (int mb_y = 0; mb_y < mb_h; mb_y++) {
        memset(d->intra_l, B_DC, sizeof d->intra_l);
        memset(d->nz_left, 0, sizeof d->nz_left);
        for (int mb_x = 0; mb_x < mb_w; mb_x++)
            parse_intra_mode(d, mb_x, &mbs[mb_x]);
        if (d->br.eof)
            vfail(d, "corrupt: premature end of the VP8 modes" NO_IMAGE);
        bool_dec *tbr = &d->parts[mb_y & (d->num_parts - 1)];
        /* the unfiltered bottom rows of this macroblock row, kept as the
         * next row's top samples once the row is done */
        uint8_t *ynext = malloc((size_t)mb_w * 32 + 16);
        if (!ynext) vfail(d, "out of memory");
        uint8_t *unext = ynext + (size_t)mb_w * 16, *vnext = unext + mb_w * 8;
        for (int mb_x = 0; mb_x < mb_w; mb_x++) {
            mbinfo *mb = &mbs[mb_x];
            int skip = mb->skip;
            if (!skip) {
                skip = parse_residuals(d, tbr, mb_x, mb->i4x4,
                                       &d->dqm[mb->segment], coeffs);
            } else {
                memset(coeffs, 0, sizeof coeffs);
                uint8_t *tnz = d->nz_top + 9 * mb_x;
                memset(tnz, 0, 8);
                memset(d->nz_left, 0, 8);
                if (!mb->i4x4) tnz[8] = d->nz_left[8] = 0;
            }
            if (d->filter_type) {
                finfo *fi = &d->f_info[(size_t)mb_y * mb_w + mb_x];
                *fi = d->fstrengths[mb->segment][mb->i4x4];
                fi->f_inner |= !skip;
            }
            if (tbr->eof) {
                free(ynext);
                vfail(d, "truncated: premature end of the VP8 tokens"
                         NO_IMAGE);
            }
            reconstruct(d, mb_x, mb_y, mb, coeffs, ytop, utop, vtop, yleft,
                        uleft, vleft);
            memcpy(ynext + mb_x * 16,
                   d->y + (size_t)(mb_y * 16 + 15) * d->ystride + mb_x * 16,
                   16);
            memcpy(unext + mb_x * 8,
                   d->u + (size_t)(mb_y * 8 + 7) * d->uvstride + mb_x * 8, 8);
            memcpy(vnext + mb_x * 8,
                   d->v + (size_t)(mb_y * 8 + 7) * d->uvstride + mb_x * 8, 8);
        }
        memcpy(ytop, ynext, (size_t)mb_w * 16);
        memcpy(utop, unext, (size_t)mb_w * 8);
        memcpy(vtop, vnext, (size_t)mb_w * 8);
        free(ynext);
    }
    if (d->filter_type)
        for (int mb_y = 0; mb_y < mb_h; mb_y++)
            for (int mb_x = 0; mb_x < mb_w; mb_x++) filter_mb(d, mb_x, mb_y);
    rgb = malloc((size_t)d->width * d->height * 3);
    if (!rgb) vfail(d, "out of memory");
    emit_rgb(d, rgb);
    for (int i = 0; i < 4; i++) free(bufs[i]);
    *out = rgb;
    *out_h = d->height;
    *out_w = d->width;
    free(d);
    return 0;
}
