/* Baseline JPEG encoder of the port (the writer behind utils/viz.py's
 * save_image; the card machine has no OpenCV).
 *
 * It produces the file libjpeg-turbo writes with cv2.imwrite's defaults:
 * JFIF 1.01, quality scaling of the Annex K tables (jcparam.c,
 * force_baseline), 4:2:0 chroma (h2v2) for RGB input and one component
 * for gray input, the accurate integer FDCT (jfdctint.c), quantization by
 * libjpeg-turbo's reciprocal multiply (jcdctmgr.c, 16-bit DCTELEM), the
 * standard Huffman tables and no restart markers. The steps follow the
 * library's:
 *   - RGB -> YCbCr with jccolor.c's 16-bit fixed-point tables;
 *   - the image's right edge replicated to whole blocks and its bottom
 *     edge replicated to whole MCUs (jcsample.c expand_right_edge,
 *     jcprepct.c expand_bottom_edge);
 *   - chroma downsampled by the mean of each 2x2 cell with the alternating
 *     rounding bias 1, 2 (jcsample.c h2v2_downsample);
 *   - blocks of an MCU past the luma's last block column or row are
 *     "dummy" blocks: AC zero, DC copied from the block before them
 *     (jccoefct.c compress_data).
 *
 * int yolo_jpeg_encode(const uint8_t *pixels, int h, int w, int channels,
 *                      int quality, uint8_t **out, size_t *out_len,
 *                      char *err, size_t errlen)
 *   pixels: (h, w, channels) uint8, RGB (channels 3) or gray (1).
 *   Returns 0 and a malloc'ed buffer (free with yolo_native_free), or
 *   nonzero with a message in err.
 */

#include <stdarg.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "native.h"

static const uint8_t kZigzag[64] = {  /* zigzag index -> row-major index */
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

static const uint16_t kQLuma[64] = {  /* Annex K.1, row-major */
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};

static const uint16_t kQChroma[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

/* Annex K.3: code counts of lengths 1..16, then the symbols (native.h:
 * the decoder loads them for a frame without DHT) */
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1,
                                        1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1,
                                          1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3,
                                        5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4,
                                          7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

typedef struct {
  uint16_t code[256];
  uint8_t len[256];
} huff_codes;

typedef struct {
  uint8_t *buf;
  size_t len, cap;
  uint32_t acc;  /* pending bits, right-aligned */
  int nacc;
  int failed;
} writer;

typedef struct {
  uint32_t recip[64], corr[64];
  int shift[64];
  uint8_t table[64];  /* the scaled table, row-major (the DQT values) */
} quant;

static void put(writer *wr, const void *p, size_t n) {
  if (wr->failed) return;
  if (wr->len + n > wr->cap) {
    size_t cap = wr->cap ? wr->cap : 4096;
    while (cap < wr->len + n) cap *= 2;
    uint8_t *nb = (uint8_t *)realloc(wr->buf, cap);
    if (!nb) {
      wr->failed = 1;
      return;
    }
    wr->buf = nb;
    wr->cap = cap;
  }
  memcpy(wr->buf + wr->len, p, n);
  wr->len += n;
}

static void put_byte(writer *wr, int b) {
  uint8_t v = (uint8_t)b;
  put(wr, &v, 1);
}

static void put_u16(writer *wr, int v) {
  put_byte(wr, (v >> 8) & 0xFF);
  put_byte(wr, v & 0xFF);
}

static void put_bits(writer *wr, uint32_t bits, int n) {
  /* n <= 16; MSB first, 0xFF bytes followed by a stuffed 0x00 */
  wr->acc = (wr->acc << n) | (bits & ((1u << n) - 1));
  wr->nacc += n;
  while (wr->nacc >= 8) {
    int b = (int)((wr->acc >> (wr->nacc - 8)) & 0xFF);
    put_byte(wr, b);
    if (b == 0xFF) put_byte(wr, 0);
    wr->nacc -= 8;
  }
  wr->acc &= (1u << wr->nacc) - 1;
}

static void flush_bits(writer *wr) {  /* jchuff.c flush_bits: pad with 1s */
  if (wr->nacc) put_bits(wr, 0x7F, 8 - wr->nacc);
}

static void make_codes(huff_codes *hc, const uint8_t bits[16],
                       const uint8_t *vals) {
  int code = 0, k = 0;
  memset(hc, 0, sizeof(*hc));
  for (int l = 1; l <= 16; l++) {
    for (int i = 0; i < bits[l - 1]; i++, k++) {
      hc->code[vals[k]] = (uint16_t)code++;
      hc->len[vals[k]] = (uint8_t)l;
    }
    code <<= 1;
  }
}

static int flss(uint32_t v) {  /* 1-based position of the highest set bit */
  int n = 0;
  while (v) {
    n++;
    v >>= 1;
  }
  return n;
}

/* jcparam.c jpeg_quality_scaling + jpeg_add_quant_table (force_baseline),
 * then jcdctmgr.c compute_reciprocal on the islow divisors (q << 3) */
static void make_quant(quant *q, const uint16_t base[64], int quality) {
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; i++) {
    long t = ((long)base[i] * scale + 50L) / 100L;
    if (t <= 0L) t = 1L;
    if (t > 32767L) t = 32767L;
    if (t > 255L) t = 255L;
    q->table[i] = (uint8_t)t;
    uint32_t divisor = (uint32_t)t << 3;
    int b = flss(divisor) - 1;
    int r = 16 + b;
    uint32_t fq = (1u << r) / divisor;
    uint32_t fr = (1u << r) % divisor;
    uint32_t c = divisor / 2;
    if (fr == 0) {
      fq >>= 1;
      r--;
    } else if (fr <= divisor / 2u) {
      c++;
    } else {
      fq++;
    }
    q->recip[i] = fq;
    q->corr[i] = c;
    q->shift[i] = r;
  }
}

#define CONST_BITS 13
#define PASS1_BITS 2
#define DESCALE(x, n) (((x) + (1L << ((n) - 1))) >> (n))
#define FIX_0_298631336 ((long)2446)
#define FIX_0_390180644 ((long)3196)
#define FIX_0_541196100 ((long)4433)
#define FIX_0_765366865 ((long)6270)
#define FIX_0_899976223 ((long)7373)
#define FIX_1_175875602 ((long)9633)
#define FIX_1_501321110 ((long)12299)
#define FIX_1_847759065 ((long)15137)
#define FIX_1_961570560 ((long)16069)
#define FIX_2_053119869 ((long)16819)
#define FIX_2_562915447 ((long)20995)
#define FIX_3_072711026 ((long)25172)

/* jfdctint.c jpeg_fdct_islow, in place; outputs scaled up by 8 */
static void fdct_islow(int *data) {
  long tmp0, tmp1, tmp2, tmp3, tmp4, tmp5, tmp6, tmp7;
  long tmp10, tmp11, tmp12, tmp13, z1, z2, z3, z4, z5;
  for (int pass = 0; pass < 2; pass++) {
    int step = pass ? 8 : 1, stride = pass ? 1 : 8;
    int sh_even = pass ? PASS1_BITS : 0;
    int sh_odd = pass ? CONST_BITS + PASS1_BITS : CONST_BITS - PASS1_BITS;
    for (int k = 0; k < 8; k++) {
      int *d = data + k * stride;
      tmp0 = d[0] + d[7 * step];
      tmp7 = d[0] - d[7 * step];
      tmp1 = d[step] + d[6 * step];
      tmp6 = d[step] - d[6 * step];
      tmp2 = d[2 * step] + d[5 * step];
      tmp5 = d[2 * step] - d[5 * step];
      tmp3 = d[3 * step] + d[4 * step];
      tmp4 = d[3 * step] - d[4 * step];
      tmp10 = tmp0 + tmp3;
      tmp13 = tmp0 - tmp3;
      tmp11 = tmp1 + tmp2;
      tmp12 = tmp1 - tmp2;
      if (pass) {
        d[0] = (int)DESCALE(tmp10 + tmp11, sh_even);
        d[4 * step] = (int)DESCALE(tmp10 - tmp11, sh_even);
      } else {
        d[0] = (int)((tmp10 + tmp11) * (1 << PASS1_BITS));
        d[4 * step] = (int)((tmp10 - tmp11) * (1 << PASS1_BITS));
      }
      z1 = (tmp12 + tmp13) * FIX_0_541196100;
      d[2 * step] = (int)DESCALE(z1 + tmp13 * FIX_0_765366865, sh_odd);
      d[6 * step] = (int)DESCALE(z1 + tmp12 * (-FIX_1_847759065), sh_odd);
      z1 = tmp4 + tmp7;
      z2 = tmp5 + tmp6;
      z3 = tmp4 + tmp6;
      z4 = tmp5 + tmp7;
      z5 = (z3 + z4) * FIX_1_175875602;
      tmp4 = tmp4 * FIX_0_298631336;
      tmp5 = tmp5 * FIX_2_053119869;
      tmp6 = tmp6 * FIX_3_072711026;
      tmp7 = tmp7 * FIX_1_501321110;
      z1 = z1 * (-FIX_0_899976223);
      z2 = z2 * (-FIX_2_562915447);
      z3 = z3 * (-FIX_1_961570560);
      z4 = z4 * (-FIX_0_390180644);
      z3 += z5;
      z4 += z5;
      d[7 * step] = (int)DESCALE(tmp4 + z1 + z3, sh_odd);
      d[5 * step] = (int)DESCALE(tmp5 + z2 + z4, sh_odd);
      d[3 * step] = (int)DESCALE(tmp6 + z2 + z3, sh_odd);
      d[step] = (int)DESCALE(tmp7 + z1 + z4, sh_odd);
    }
  }
}

/* one 8x8 block of a plane (stride columns) -> quantized coefficients,
 * row-major */
static void forward_block(const uint8_t *plane, size_t stride, int bx,
                          int by, const quant *q, int out[64]) {
  int ws[64];
  for (int y = 0; y < 8; y++) {
    const uint8_t *row = plane + (size_t)(by * 8 + y) * stride + bx * 8;
    for (int x = 0; x < 8; x++) ws[y * 8 + x] = (int)row[x] - 128;
  }
  fdct_islow(ws);
  for (int i = 0; i < 64; i++) {
    int t = ws[i];
    uint32_t a = (uint32_t)(t < 0 ? -t : t);
    uint32_t v = (uint32_t)(((uint64_t)(a + q->corr[i]) * q->recip[i]) >>
                            q->shift[i]);
    out[i] = t < 0 ? -(int)v : (int)v;
  }
}

static void encode_block(writer *wr, const int coef[64], int *last_dc,
                         const huff_codes *dc, const huff_codes *ac) {
  int diff = coef[0] - *last_dc;
  *last_dc = coef[0];
  int a = diff < 0 ? -diff : diff;
  int nbits = flss((uint32_t)a);
  put_bits(wr, dc->code[nbits], dc->len[nbits]);
  if (nbits) put_bits(wr, (uint32_t)(diff < 0 ? diff - 1 : diff), nbits);
  int run = 0;
  for (int k = 1; k < 64; k++) {
    int v = coef[kZigzag[k]];
    if (v == 0) {
      run++;
      continue;
    }
    while (run > 15) {
      put_bits(wr, ac->code[0xF0], ac->len[0xF0]);
      run -= 16;
    }
    a = v < 0 ? -v : v;
    nbits = flss((uint32_t)a);
    int sym = (run << 4) + nbits;
    put_bits(wr, ac->code[sym], ac->len[sym]);
    put_bits(wr, (uint32_t)(v < 0 ? v - 1 : v), nbits);
    run = 0;
  }
  if (run > 0) put_bits(wr, ac->code[0], ac->len[0]);
}

static void put_dqt(writer *wr, const quant *q, int id) {
  put_byte(wr, 0xFF);
  put_byte(wr, 0xDB);
  put_u16(wr, 67);
  put_byte(wr, id);
  for (int k = 0; k < 64; k++) put_byte(wr, q->table[kZigzag[k]]);
}

static void put_dht(writer *wr, int cls_id, const uint8_t bits[16],
                    const uint8_t *vals) {
  int n = 0;
  for (int i = 0; i < 16; i++) n += bits[i];
  put_byte(wr, 0xFF);
  put_byte(wr, 0xC4);
  put_u16(wr, 2 + 1 + 16 + n);
  put_byte(wr, cls_id);
  put(wr, bits, 16);
  put(wr, vals, (size_t)n);
}

static void set_err(char *err, size_t errlen, const char *fmt, ...) {
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(err, errlen, fmt, ap);
  va_end(ap);
}

/* jccolor.c rgb_ycc_convert (SCALEBITS 16) */
#define FIX16(x) ((long)((x) * 65536.0 + 0.5))
static void rgb_to_ycc(const uint8_t *p, uint8_t *y, uint8_t *cb,
                       uint8_t *cr) {
  const long half = 1L << 15, off = 128L << 16;
  long r = p[0], g = p[1], b = p[2];
  *y = (uint8_t)((FIX16(0.29900) * r + FIX16(0.58700) * g +
                  FIX16(0.11400) * b + half) >> 16);
  *cb = (uint8_t)((-FIX16(0.16874) * r - FIX16(0.33126) * g +
                   FIX16(0.50000) * b + off + half - 1) >> 16);
  *cr = (uint8_t)((FIX16(0.50000) * r - FIX16(0.41869) * g -
                   FIX16(0.08131) * b + off + half - 1) >> 16);
}

int yolo_jpeg_encode(const uint8_t *pixels, int h, int w, int channels,
                     int quality, uint8_t **out, size_t *out_len, char *err,
                     size_t errlen) {
  if (h < 1 || w < 1 || h > 65535 || w > 65535) {
    set_err(err, errlen, "jpeg encode: image size %dx%d (1..65535)", w, h);
    return 1;
  }
  if (channels != 1 && channels != 3) {
    set_err(err, errlen, "jpeg encode: channels=%d (1 or 3)", channels);
    return 1;
  }
  if (quality < 1 || quality > 100) {
    set_err(err, errlen, "jpeg encode: quality %d (1..100)", quality);
    return 1;
  }
  int color = channels == 3;
  int mcu = color ? 16 : 8;             /* MCU size in luma pixels */
  int mcux = (w + mcu - 1) / mcu, mcuy = (h + mcu - 1) / mcu;
  int ybw = (w + 7) / 8, ybh = (h + 7) / 8;   /* luma blocks */
  size_t ys = (size_t)mcux * mcu;             /* luma plane stride */
  size_t ch_w = (size_t)mcux * 8, ch_h = (size_t)mcuy * 8;
  uint8_t *Y = (uint8_t *)malloc(ys * (size_t)mcuy * mcu);
  uint8_t *Cb = NULL, *Cr = NULL, *cb_full = NULL, *cr_full = NULL;
  int rc = 1;
  writer wr = {0};
  if (!Y) goto oom;
  /* full-resolution planes: right edge replicated over the MCU columns,
   * bottom edge replicated over the MCU rows */
  size_t fw = ys, fh = (size_t)mcuy * mcu;
  if (color) {
    cb_full = (uint8_t *)malloc(fw * fh);
    cr_full = (uint8_t *)malloc(fw * fh);
    Cb = (uint8_t *)malloc(ch_w * ch_h);
    Cr = (uint8_t *)malloc(ch_w * ch_h);
    if (!cb_full || !cr_full || !Cb || !Cr) goto oom;
  }
  for (size_t yy = 0; yy < fh; yy++) {
    const uint8_t *src = pixels + (size_t)(yy < (size_t)h ? yy : h - 1) *
                                      (size_t)w * channels;
    for (size_t xx = 0; xx < fw; xx++) {
      const uint8_t *p = src + (xx < (size_t)w ? xx : (size_t)w - 1) *
                                   (size_t)channels;
      size_t o = yy * fw + xx;
      if (color)
        rgb_to_ycc(p, &Y[o], &cb_full[o], &cr_full[o]);
      else
        Y[o] = p[0];
    }
  }
  if (color) {
    /* h2v2_downsample over row pairs of the image (the last pair of an
     * odd height repeats its row); rows past the image's last pair repeat
     * that pair's output row */
    size_t last_pair = (size_t)(h - 1) / 2;
    for (size_t oy = 0; oy < ch_h; oy++) {
      size_t py = oy < last_pair ? oy : last_pair;
      const uint8_t *r0b = cb_full + 2 * py * fw, *r1b = r0b + fw;
      const uint8_t *r0r = cr_full + 2 * py * fw, *r1r = r0r + fw;
      int bias = 1;
      for (size_t ox = 0; ox < ch_w; ox++) {
        size_t x = 2 * ox;
        Cb[oy * ch_w + ox] =
            (uint8_t)((r0b[x] + r0b[x + 1] + r1b[x] + r1b[x + 1] + bias) >> 2);
        Cr[oy * ch_w + ox] =
            (uint8_t)((r0r[x] + r0r[x + 1] + r1r[x] + r1r[x + 1] + bias) >> 2);
        bias ^= 3;
      }
    }
  }

  quant ql, qc;
  make_quant(&ql, kQLuma, quality);
  make_quant(&qc, kQChroma, quality);
  huff_codes dcl, acl, dcc, acc;
  make_codes(&dcl, kDcLumaBits, kDcVals);
  make_codes(&acl, kAcLumaBits, kAcLumaVals);
  make_codes(&dcc, kDcChromaBits, kDcVals);
  make_codes(&acc, kAcChromaBits, kAcChromaVals);

  static const uint8_t jfif[16] = {0xFF, 0xD8, 0xFF, 0xE0, 0, 16,  'J', 'F',
                                   'I',  'F',  0,    1,    1, 0,   0,   1};
  put(&wr, jfif, sizeof(jfif));
  put_u16(&wr, 1);        /* Ydensity */
  put_byte(&wr, 0);       /* no thumbnail */
  put_byte(&wr, 0);
  put_dqt(&wr, &ql, 0);
  if (color) put_dqt(&wr, &qc, 1);
  put_byte(&wr, 0xFF);
  put_byte(&wr, 0xC0);
  put_u16(&wr, 8 + 3 * channels);
  put_byte(&wr, 8);
  put_u16(&wr, h);
  put_u16(&wr, w);
  put_byte(&wr, channels);
  if (color) {
    static const uint8_t comps[9] = {1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
    put(&wr, comps, 9);
  } else {
    static const uint8_t comps[3] = {1, 0x11, 0};
    put(&wr, comps, 3);
  }
  put_dht(&wr, 0x00, kDcLumaBits, kDcVals);
  put_dht(&wr, 0x10, kAcLumaBits, kAcLumaVals);
  if (color) {
    put_dht(&wr, 0x01, kDcChromaBits, kDcVals);
    put_dht(&wr, 0x11, kAcChromaBits, kAcChromaVals);
  }
  put_byte(&wr, 0xFF);
  put_byte(&wr, 0xDA);
  put_u16(&wr, 6 + 2 * channels);
  put_byte(&wr, channels);
  if (color) {
    static const uint8_t sc[6] = {1, 0x00, 2, 0x11, 3, 0x11};
    put(&wr, sc, 6);
  } else {
    static const uint8_t sc[2] = {1, 0x00};
    put(&wr, sc, 2);
  }
  put_byte(&wr, 0);
  put_byte(&wr, 63);
  put_byte(&wr, 0);

  int dc_y = 0, dc_cb = 0, dc_cr = 0;
  int blk[4][64], cblk[64];
  for (int my = 0; my < mcuy; my++) {
    for (int mx = 0; mx < mcux; mx++) {
      int n = color ? 2 : 1;
      for (int v = 0; v < n; v++) {
        for (int u = 0; u < n; u++) {
          int bx = mx * n + u, by = my * n + v, k = v * n + u;
          if (by >= ybh) {        /* a dummy row: DC of the block before */
            memset(blk[k], 0, sizeof(blk[k]));
            blk[k][0] = blk[n * v - 1][0];
          } else if (bx >= ybw) {  /* a dummy column */
            memset(blk[k], 0, sizeof(blk[k]));
            blk[k][0] = blk[k - 1][0];
          } else {
            forward_block(Y, ys, bx, by, &ql, blk[k]);
          }
          encode_block(&wr, blk[k], &dc_y, &dcl, &acl);
        }
      }
      if (color) {
        forward_block(Cb, ch_w, mx, my, &qc, cblk);
        encode_block(&wr, cblk, &dc_cb, &dcc, &acc);
        forward_block(Cr, ch_w, mx, my, &qc, cblk);
        encode_block(&wr, cblk, &dc_cr, &dcc, &acc);
      }
    }
  }
  flush_bits(&wr);
  put_byte(&wr, 0xFF);
  put_byte(&wr, 0xD9);
  if (wr.failed) goto oom;
  *out = wr.buf;
  *out_len = wr.len;
  wr.buf = NULL;
  rc = 0;
  goto done;
oom:
  set_err(err, errlen, "jpeg encode: out of memory (%dx%d)", w, h);
done:
  free(wr.buf);
  free(Y);
  free(Cb);
  free(Cr);
  free(cb_full);
  free(cr_full);
  return rc;
}
