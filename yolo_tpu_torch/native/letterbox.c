/* The host letterbox of the training and file loaders: uint8 images of 1
 * or 3 interleaved channels -> float32 in [0, 1] on a gray (0.5) canvas,
 * byte for byte the letterbox of the JAX package's native library
 * (native/letterbox_core.h, native/preproc.cpp), which is cv2.INTER_LINEAR
 * with half-pixel centres and clamped borders.
 *
 * int yolo_letterbox_batch(const uint8_t *src, int batch, int src_h,
 *                          int src_w, int c, float *dst, int net_h,
 *                          int net_w, int n_threads, char *err,
 *                          size_t errlen)
 *   src (batch, src_h, src_w, c) -> dst (batch, net_h, net_w, c).
 *   Geometry: scale = min(net_w / src_w, net_h / src_h) in double, the
 *   resized size nearbyint(src * scale) (half to even, as Python's round
 *   in ops/letterbox.py), the pad (net - resized) / 2 on each axis.
 *   Axis tables in double: c = (o + 0.5) * in / out - 0.5, i0 = floor(c)
 *   and i1 = i0 + 1 clamped to the image, w1 = (float)(c - floor(c)).
 *   Per channel, in float: top = p00 + w1x (p01 - p00), bot likewise on
 *   the next row, out = (top + w1y (bot - top)) * (1.0f / 255).
 *   The batch is split over min(n_threads, batch) threads, thread t
 *   taking images t, t + threads, ...
 *
 * int yolo_stretch(const uint8_t *src, int src_h, int src_w, int c,
 *                  float *dst, int net_h, int net_w, char *err,
 *                  size_t errlen)
 *   src (src_h, src_w, c) -> dst (net_h, net_w, c), aspect ratio not
 *   kept: the stretch of the JAX package's host loaders,
 *   numpy_ref.stretch_resize, which is cv2.resize of the image / 255 in
 *   float32 to (net_w, net_h), INTER_LINEAR, as OpenCV hands it to
 *   Intel IPP: source x = (o + 0.5) * in / out - 0.5 in double, outside
 *   the image clamped to the edge pixel with fraction 0, the fraction
 *   rounded to float a; per channel, in float, the row pass
 *   fmaf(p1 - p0, a, p0) and then the column pass likewise, each with
 *   one rounding. (OpenCV runs its own code instead for sources of one
 *   row or one column, whose taps are float; the stretch differs there
 *   by a float ulp or two.)
 *
 * Returns 0, or -1 with a message in err. The library is built with
 * -std=c11, which contracts no expression, so every multiply and add
 * rounds on its own as in the reference build.
 */

#include <math.h>
#include <pthread.h>
#include <stdarg.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>

#include "native.h"

typedef struct {
    int *i0, *i1;
    float *w1;
} Axis;

typedef struct {
    const uint8_t *src;
    float *dst;
    int batch, src_h, src_w, c, net_h, net_w, rh, rw, px, py;
    int first, step;
    const Axis *ay, *ax;
} Job;

static int fail(char *err, size_t errlen, const char *fmt, ...) {
    va_list ap;
    va_start(ap, fmt);
    vsnprintf(err, errlen, fmt, ap);
    va_end(ap);
    return -1;
}

static int clampi(int v, int hi) { return v < 0 ? 0 : v > hi ? hi : v; }

static int make_axis(int in_size, int out_size, Axis *ax) {
    ax->i0 = malloc(sizeof(int) * (size_t)out_size);
    ax->i1 = malloc(sizeof(int) * (size_t)out_size);
    ax->w1 = malloc(sizeof(float) * (size_t)out_size);
    if (out_size > 0 && (!ax->i0 || !ax->i1 || !ax->w1)) return -1;
    const double scale = (double)in_size / out_size;
    for (int o = 0; o < out_size; ++o) {
        const double c = (o + 0.5) * scale - 0.5;
        const double f = floor(c);
        const int i0 = (int)f;
        ax->i0[o] = clampi(i0, in_size - 1);
        ax->i1[o] = clampi(i0 + 1, in_size - 1);
        ax->w1[o] = (float)(c - f);
    }
    return 0;
}

static void free_axis(Axis *ax) {
    free(ax->i0);
    free(ax->i1);
    free(ax->w1);
}

static void letterbox_one(const Job *j, const uint8_t *src, float *dst) {
    const int c = j->c;
    const size_t n = (size_t)j->net_h * j->net_w * c;
    for (size_t k = 0; k < n; ++k) dst[k] = 0.5f;
    const float inv255 = 1.0f / 255.0f;
    for (int oy = 0; oy < j->rh; ++oy) {
        const uint8_t *r0 = src + (size_t)j->ay->i0[oy] * j->src_w * c;
        const uint8_t *r1 = src + (size_t)j->ay->i1[oy] * j->src_w * c;
        const float wy = j->ay->w1[oy];
        float *out = dst + ((size_t)(j->py + oy) * j->net_w + j->px) * c;
        for (int ox = 0; ox < j->rw; ++ox) {
            const float wx = j->ax->w1[ox];
            const int x0 = j->ax->i0[ox] * c, x1 = j->ax->i1[ox] * c;
            for (int ch = 0; ch < c; ++ch) {
                const float top =
                    r0[x0 + ch] + wx * (r0[x1 + ch] - r0[x0 + ch]);
                const float bot =
                    r1[x0 + ch] + wx * (r1[x1 + ch] - r1[x0 + ch]);
                out[ox * c + ch] = (top + wy * (bot - top)) * inv255;
            }
        }
    }
}

static void *run_job(void *arg) {
    const Job *j = arg;
    const size_t in_stride = (size_t)j->src_h * j->src_w * j->c;
    const size_t out_stride = (size_t)j->net_h * j->net_w * j->c;
    for (int b = j->first; b < j->batch; b += j->step)
        letterbox_one(j, j->src + b * in_stride, j->dst + b * out_stride);
    return NULL;
}

int yolo_letterbox_batch(const uint8_t *src, int batch, int src_h,
                         int src_w, int c, float *dst, int net_h, int net_w,
                         int n_threads, char *err, size_t errlen) {
    if (c != 1 && c != 3)
        return fail(err, errlen, "letterbox: %d channels (1 or 3 are "
                    "supported)", c);
    if (batch <= 0 || src_h <= 0 || src_w <= 0 || net_h <= 0 || net_w <= 0)
        return fail(err, errlen, "letterbox: empty shape (batch %d, image "
                    "%dx%d, net %dx%d)", batch, src_h, src_w, net_h, net_w);
    const double sw = (double)net_w / src_w, sh = (double)net_h / src_h;
    const double scale = sw < sh ? sw : sh;
    const int rw = (int)nearbyint(src_w * scale);
    const int rh = (int)nearbyint(src_h * scale);
    Axis ay = {0}, ax = {0};
    if (make_axis(src_h, rh, &ay) || make_axis(src_w, rw, &ax)) {
        free_axis(&ay);
        free_axis(&ax);
        return fail(err, errlen, "letterbox: out of memory");
    }
    int workers = n_threads < batch ? n_threads : batch;
    if (workers < 1) workers = 1;
    Job base = {src, dst, batch, src_h, src_w, c, net_h, net_w, rh, rw,
                (net_w - rw) / 2, (net_h - rh) / 2, 0, workers, &ay, &ax};
    Job *jobs = malloc(sizeof(Job) * (size_t)workers);
    pthread_t *threads = malloc(sizeof(pthread_t) * (size_t)workers);
    int *started = calloc((size_t)workers, sizeof(int));
    int rc = 0;
    if (!jobs || !threads || !started) {
        rc = fail(err, errlen, "letterbox: out of memory");
    } else {
        /* thread t takes images t, t + workers, ...; one that cannot
         * start is run on this thread instead */
        for (int t = 0; t < workers; ++t) {
            jobs[t] = base;
            jobs[t].first = t;
            started[t] = t > 0 &&
                pthread_create(&threads[t], NULL, run_job, &jobs[t]) == 0;
        }
        for (int t = 0; t < workers; ++t)
            if (!started[t]) run_job(&jobs[t]);
        for (int t = 1; t < workers; ++t)
            if (started[t]) pthread_join(threads[t], NULL);
    }
    free(jobs);
    free(threads);
    free(started);
    free_axis(&ay);
    free_axis(&ax);
    return rc;
}

/* the taps of the stretch: a = (float) of the fraction in double;
 * outside the image the edge pixel with a = 0 */
static int make_stretch_axis(int in_size, int out_size, Axis *ax) {
    ax->i0 = malloc(sizeof(int) * (size_t)out_size);
    ax->i1 = malloc(sizeof(int) * (size_t)out_size);
    ax->w1 = malloc(sizeof(float) * (size_t)out_size);
    if (!ax->i0 || !ax->i1 || !ax->w1) return -1;
    const double scale = (double)in_size / out_size;
    for (int o = 0; o < out_size; ++o) {
        const double c = (o + 0.5) * scale - 0.5;
        const double f = floor(c);
        int i0 = (int)f;
        double frac = c - f;
        if (i0 < 0 || i0 >= in_size - 1) {
            i0 = i0 < 0 ? 0 : in_size - 1;
            frac = 0.0;
        }
        ax->i0[o] = i0;
        ax->i1[o] = i0 + 1 < in_size ? i0 + 1 : in_size - 1;
        ax->w1[o] = (float)frac;
    }
    return 0;
}

/* rows: two row passes of net_w * c floats */
static void stretch_rows(const uint8_t *src, int src_w, int c, float *dst,
                         int net_h, int net_w, const Axis *ay,
                         const Axis *ax, float *rows) {
    float *row0 = rows, *row1 = rows + (size_t)net_w * c;
    for (int oy = 0; oy < net_h; ++oy) {
        const float b = ay->w1[oy];
        const uint8_t *rs[2] = {src + (size_t)ay->i0[oy] * src_w * c,
                                src + (size_t)ay->i1[oy] * src_w * c};
        float *pass[2] = {row0, row1};
        for (int k = 0; k < 2; ++k)
            for (int ox = 0; ox < net_w; ++ox) {
                const float a = ax->w1[ox];
                const int x0 = ax->i0[ox] * c, x1 = ax->i1[ox] * c;
                for (int ch = 0; ch < c; ++ch) {
                    const float p0 = rs[k][x0 + ch] / 255.0f;
                    const float p1 = rs[k][x1 + ch] / 255.0f;
                    pass[k][ox * c + ch] = fmaf(p1 - p0, a, p0);
                }
            }
        float *out = dst + (size_t)oy * net_w * c;
        for (int k = 0; k < net_w * c; ++k)
            out[k] = fmaf(row1[k] - row0[k], b, row0[k]);
    }
}

int yolo_stretch(const uint8_t *src, int src_h, int src_w, int c,
                 float *dst, int net_h, int net_w, char *err,
                 size_t errlen) {
    if (c != 1 && c != 3)
        return fail(err, errlen, "stretch: %d channels (1 or 3 are "
                    "supported)", c);
    if (src_h <= 0 || src_w <= 0 || net_h <= 0 || net_w <= 0)
        return fail(err, errlen, "stretch: empty shape (image %dx%d, net "
                    "%dx%d)", src_h, src_w, net_h, net_w);
    Axis ay = {0}, ax = {0};
    float *rows = malloc(sizeof(float) * 2 * (size_t)net_w * c);
    int rc = 0;
    if (!rows || make_stretch_axis(src_h, net_h, &ay) ||
        make_stretch_axis(src_w, net_w, &ax))
        rc = fail(err, errlen, "stretch: out of memory");
    else
        stretch_rows(src, src_w, c, dst, net_h, net_w, &ay, &ax, rows);
    free(rows);
    free_axis(&ay);
    free_axis(&ax);
    return rc;
}
