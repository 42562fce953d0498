/* JPEG 2000's inverse wavelet and component transforms, as OpenJPEG 2.5
 * computes them (dwt.c, mct.c):
 *
 *   - the reversible 5/3 in integers (F.3.8), symmetric extension at
 *     both ends; a single sample at an odd origin is halved (C division);
 *   - the irreversible 9/7 in float with OpenJPEG's constants and order
 *     of operations: the low samples scaled by K and the high ones by
 *     2/K (the band step sizes carry no gain to match), then the four
 *     lifting steps, each w += (left + right) * c with the end sample
 *     taking 2c times its one neighbour. A one-sample signal is left as
 *     it is, whatever its origin's parity;
 *   - rows first, then columns, at each resolution; the parity of the
 *     resolution's origin says whether the first sample is low-pass;
 *   - RCT in integers, ICT in float with OpenJPEG's coefficients.
 *
 * The float operations are written unfused and the library is built
 * without -mfma, so that no multiply-add is contracted: OpenJPEG's SSE
 * code has none either. Plain C11, no state between calls. */

#include <string.h>

#include "j2k.h"

/* --- 5/3 --------------------------------------------------------------- */

/* x: n interleaved samples; the one at index i is low-pass where
 * (i + cas) is even. The ends mirror: x[-1] is x[1], x[n] is x[n - 2]. */
static void idwt53_1d(int32_t *x, int n, int cas) {
    if (n == 1) {
        if (cas) x[0] /= 2;
        return;
    }
    int i = cas;                           /* low positions */
    if (i == 0) {
        x[0] -= (x[1] + x[1] + 2) >> 2;
        i = 2;
    }
    for (; i + 1 < n; i += 2) x[i] -= (x[i - 1] + x[i + 1] + 2) >> 2;
    if (i < n) x[i] -= (x[i - 1] + x[i - 1] + 2) >> 2;
    i = 1 - cas;                           /* high positions */
    if (i == 0) {
        x[0] += (x[1] + x[1]) >> 1;
        i = 2;
    }
    for (; i + 1 < n; i += 2) x[i] += (x[i - 1] + x[i + 1]) >> 1;
    if (i < n) x[i] += (x[i - 1] + x[i - 1]) >> 1;
}

static void interleave_i(const j2k_sample *src, size_t stride, int sn,
                         int dn, int cas, int32_t *x) {
    for (int i = 0; i < sn; i++) x[cas + 2 * i] = src[(size_t)i * stride].i;
    for (int i = 0; i < dn; i++)
        x[1 - cas + 2 * i] = src[(size_t)(sn + i) * stride].i;
}

void j2k_dwt_decode_53(j2k_ctx *c, j2k_tilec *tc) {
    size_t w = (size_t)(tc->x1 - tc->x0);
    int maxn = j2k_imax(tc->x1 - tc->x0, tc->y1 - tc->y0);
    int32_t *x = j2k_alloc(c, sizeof(int32_t) * (size_t)(maxn + 2));
    j2k_res *r = tc->res;
    int rw = r->x1 - r->x0, rh = r->y1 - r->y0;
    for (int l = 1; l < tc->numres; l++) {
        int sw = rw, sh = rh;
        r++;
        rw = r->x1 - r->x0;
        rh = r->y1 - r->y0;
        int cas = r->x0 & 1;
        for (int j = 0; j < rh; j++) {
            j2k_sample *row = tc->data + (size_t)j * w;
            if (rw == 0) break;
            interleave_i(row, 1, sw, rw - sw, cas, x);
            idwt53_1d(x, rw, cas);
            for (int i = 0; i < rw; i++) row[i].i = x[i];
        }
        cas = r->y0 & 1;
        for (int k = 0; k < rw; k++) {
            j2k_sample *col = tc->data + k;
            if (rh == 0) break;
            interleave_i(col, w, sh, rh - sh, cas, x);
            idwt53_1d(x, rh, cas);
            for (int i = 0; i < rh; i++) col[(size_t)i * w].i = x[i];
        }
    }
}

/* --- 9/7 --------------------------------------------------------------- */

static const float ALPHA = -1.586134342f;
static const float BETA = -0.052980118f;
static const float GAMMA = 0.882911075f;
static const float DELTA = 0.443506852f;
static const float K = 1.230174105f;
static const float TWO_INVK = 1.625732422f;

static void step1(float *w, int n, float c) {
    for (int i = 0; i < n; i++) w[2 * i] = w[2 * i] * c;
}

/* w[2i - 1] += (l[2i - 2 or start] + w[2i]) * c, OpenJPEG's
 * opj_v8dwt_decode_step2 for one lane */
static void step2(float *l, float *w, int end, int m, float c) {
    float *fl = l, *fw = w;
    int imax = end < m ? end : m;
    for (int i = 0; i < imax; i++) {
        fw[-1] = fw[-1] + ((fl[0] + fw[0]) * c);
        fl = fw;
        fw += 2;
    }
    if (m < end) {
        c += c;
        fw[-1] = fw[-1] + (fl[0] * c);
    }
}

static void idwt97_1d(float *x, int sn, int dn, int cas) {
    int a, b;
    if (cas == 0) {
        if (!(dn > 0 || sn > 1)) return;
        a = 0;
        b = 1;
    } else {
        if (!(sn > 0 || dn > 1)) return;
        a = 1;
        b = 0;
    }
    step1(x + a, sn, K);
    step1(x + b, dn, TWO_INVK);
    step2(x + b, x + a + 1, sn, j2k_imin(sn, dn - a), -DELTA);
    step2(x + a, x + b + 1, dn, j2k_imin(dn, sn - b), -GAMMA);
    step2(x + b, x + a + 1, sn, j2k_imin(sn, dn - a), -BETA);
    step2(x + a, x + b + 1, dn, j2k_imin(dn, sn - b), -ALPHA);
}

static void interleave_f(const j2k_sample *src, size_t stride, int sn,
                         int dn, int cas, float *x) {
    for (int i = 0; i < sn; i++) x[cas + 2 * i] = src[(size_t)i * stride].f;
    for (int i = 0; i < dn; i++)
        x[1 - cas + 2 * i] = src[(size_t)(sn + i) * stride].f;
}

void j2k_dwt_decode_97(j2k_ctx *c, j2k_tilec *tc) {
    size_t w = (size_t)(tc->x1 - tc->x0);
    int maxn = j2k_imax(tc->x1 - tc->x0, tc->y1 - tc->y0);
    /* room past the end for step2's reads at an odd length */
    float *x = j2k_alloc(c, sizeof(float) * (size_t)(maxn + 4));
    j2k_res *r = tc->res;
    int rw = r->x1 - r->x0, rh = r->y1 - r->y0;
    for (int l = 1; l < tc->numres; l++) {
        int sw = rw, sh = rh;
        r++;
        rw = r->x1 - r->x0;
        rh = r->y1 - r->y0;
        int cas = r->x0 & 1;
        for (int j = 0; j < rh && rw > 0; j++) {
            j2k_sample *row = tc->data + (size_t)j * w;
            interleave_f(row, 1, sw, rw - sw, cas, x);
            idwt97_1d(x, sw, rw - sw, cas);
            for (int i = 0; i < rw; i++) row[i].f = x[i];
        }
        cas = r->y0 & 1;
        for (int k = 0; k < rw && rh > 0; k++) {
            j2k_sample *col = tc->data + k;
            interleave_f(col, w, sh, rh - sh, cas, x);
            idwt97_1d(x, sh, rh - sh, cas);
            for (int i = 0; i < rh; i++) col[(size_t)i * w].f = x[i];
        }
    }
}

/* --- component transforms ---------------------------------------------- */

void j2k_mct_decode(j2k_sample *c0, j2k_sample *c1, j2k_sample *c2,
                    size_t n) {
    for (size_t i = 0; i < n; i++) {
        int32_t y = c0[i].i, u = c1[i].i, v = c2[i].i;
        int32_t g = y - ((u + v) >> 2);
        c0[i].i = v + g;
        c1[i].i = g;
        c2[i].i = u + g;
    }
}

void j2k_mct_decode_real(j2k_sample *c0, j2k_sample *c1, j2k_sample *c2,
                         size_t n) {
    for (size_t i = 0; i < n; i++) {
        float y = c0[i].f, u = c1[i].f, v = c2[i].f;
        float r = y + (v * 1.402f);
        float g = y - (u * 0.34413f) - (v * 0.71414f);
        float b = y + (u * 1.772f);
        c0[i].f = r;
        c1[i].f = g;
        c2[i].f = b;
    }
}
