/* AV1 intra blocks: the superblock loop of a tile, the partition tree,
 * intra frame mode info (skip, CDEF index, delta q, luma and chroma
 * modes with their angle deltas, CfL alphas, filter intra), the
 * transform size, and each transform block's prediction, coefficients
 * (all-zero, end of block, base levels, ranges, signs, Golomb
 * remainders and their contexts) and reconstruction, as the AV1
 * specification's decode_partition / decode_block / residual read them.
 * Coefficient positions are row-major within the (at most 32x32)
 * coded area. Plain C11. */

#include <stdlib.h>
#include <string.h>

#include "av1.h"
#include "av1_tables.h"

const uint8_t av1_bw4_log2[NBLOCKS] = { 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3,
                                        4, 4, 4, 5, 5, 0, 2, 1, 3, 2, 4 };
const uint8_t av1_bh4_log2[NBLOCKS] = { 0, 1, 0, 1, 2, 1, 2, 3, 2, 3, 4,
                                        3, 4, 5, 4, 5, 2, 0, 3, 1, 4, 2 };
const uint8_t av1_tx_w_log2[NTX] = { 2, 3, 4, 5, 6, 2, 3, 3, 4, 4,
                                     5, 5, 6, 2, 4, 3, 5, 4, 6 };
const uint8_t av1_tx_h_log2[NTX] = { 2, 3, 4, 5, 6, 3, 2, 4, 3, 5,
                                     4, 6, 5, 4, 2, 5, 3, 6, 4 };

enum { CLASS_2D, CLASS_HORIZ, CLASS_VERT };

int av1_tx_from_log2(int lw, int lh) {
    for (int t = 0; t < NTX; t++)
        if (av1_tx_w_log2[t] == lw && av1_tx_h_log2[t] == lh) return t;
    return -1;
}

int av1_block_from_log2(int lw, int lh) {
    for (int b = 0; b < NBLOCKS; b++)
        if (av1_bw4_log2[b] == lw && av1_bh4_log2[b] == lh) return b;
    return -1;
}

int av1_plane_bsize(const av1_dec *d, int bsize, int plane) {
    if (!plane) return bsize;
    int lw = av1_bw4_log2[bsize] - d->ss_x, lh = av1_bh4_log2[bsize] - d->ss_y;
    return av1_block_from_log2(lw < 0 ? 0 : lw, lh < 0 ? 0 : lh);
}

static int max_tx(int bsize) {
    int lw = av1_bw4_log2[bsize] + 2, lh = av1_bh4_log2[bsize] + 2;
    return av1_tx_from_log2(lw > 6 ? 6 : lw, lh > 6 ? 6 : lh);
}

int av1_uv_txsz(const av1_dec *d, int bsize) {
    int t = max_tx(av1_plane_bsize(d, bsize, 1));
    int lw = av1_tx_w_log2[t], lh = av1_tx_h_log2[t];
    if (lw == 6 || lh == 6) {
        if (lw == 4) return TX16X32;
        if (lh == 4) return TX32X16;
        return TX32X32;
    }
    return t;
}

static int split_tx(int t) {
    int lw = av1_tx_w_log2[t], lh = av1_tx_h_log2[t];
    if (lw == lh) {
        if (lw > 2) lw--, lh--;
    } else if (lw > lh) {
        lw--;
    } else {
        lh--;
    }
    return av1_tx_from_log2(lw, lh);
}

static int is_inside(const av1_dec *d, int r, int c) {
    return c >= d->tile_col0 && c < d->tile_col1 && r >= d->tile_row0 &&
           r < d->tile_row1;
}

static av1_mi *mi_at(av1_dec *d, int r, int c) {
    return &d->mi[(size_t)r * d->mi_cols + c];
}

/* --- mode info ---------------------------------------------------------- */

static int directional(int mode) { return mode >= AV1_V && mode <= AV1_D67; }

static void read_cdef(av1_dec *d) {
    if (d->skip || !d->enable_cdef) return;
    int cols64 = (d->mi_cols + 15) >> 4;
    int8_t *idx = &d->cdef_idx[(d->mi_row >> 4) * cols64 + (d->mi_col >> 4)];
    if (*idx == -1) {
        *idx = (int8_t)av1_read_literal(d, d->cdef_bits);
        /* a block of 128 samples spans several 64x64 units */
        for (int y = 0; y < d->bh4; y += 16)
            for (int x = 0; x < d->bw4; x += 16)
                if ((d->mi_row >> 4) + (y >> 4) < (d->mi_rows + 15) >> 4 &&
                    (d->mi_col >> 4) + (x >> 4) < cols64)
                    idx[(y >> 4) * cols64 + (x >> 4)] = *idx;
    }
}

static void read_delta_qindex(av1_dec *d) {
    if (d->bsize == (d->sb128 ? B128X128 : B64X64) && d->skip) return;
    if (!d->read_deltas) return;
    int a = av1_read_symbol(d, d->cdf.delta_q, 4);
    if (a == 3) {
        int rem = av1_read_literal(d, 3) + 1;
        a = av1_read_literal(d, rem) + (1 << rem) + 1;
    }
    if (a) {
        int v = av1_read_literal(d, 1) ? -a : a;
        d->cur_q = av1_clip3(1, 255, d->cur_q + v * (1 << d->delta_q_res));
    }
}

static void read_cfl_alphas(av1_dec *d) {
    int s = av1_read_symbol(d, d->cdf.cfl_sign, 8);
    int su = (s + 1) / 3, sv = (s + 1) % 3;
    d->cfl_u = d->cfl_v = 0;
    if (su) {
        int a = 1 + av1_read_symbol(d, d->cdf.cfl_alpha[(su - 1) * 3 + sv],
                                    16);
        d->cfl_u = su == 1 ? -a : a;
    }
    if (sv) {
        int a = 1 + av1_read_symbol(d, d->cdf.cfl_alpha[(sv - 1) * 3 + su],
                                    16);
        d->cfl_v = sv == 1 ? -a : a;
    }
}

/* --- palette ------------------------------------------------------------ */

static int ns_literal(av1_dec *d, int n) {
    int w = 0;
    for (int x = n; x; x >>= 1) w++;
    int m = (1 << w) - n, v = av1_read_literal(d, w - 1);
    return v < m ? v : (v << 1) - m + av1_read_literal(d, 1);
}

static int ceil_log2(int x) {
    int i = 1, p = 2;
    if (x < 2) return 0;
    while (p < x) i++, p <<= 1;
    return i;
}

/* the sorted, distinct colours of the above (within the 64-row
 * superblock) and left blocks' palettes of plane (0 Y, 1 U) */
static int palette_cache(av1_dec *d, int plane, uint8_t *cache) {
    int r = d->mi_row, c = d->mi_col, an = 0, ln = 0, n = 0, ai = 0, li = 0;
    const av1_mi *above = NULL, *left = NULL;
    if ((r * 4) % 64 && d->avail_u) {
        above = mi_at(d, r - 1, c);
        an = above->pal_n[plane];
    }
    if (d->avail_l) {
        left = mi_at(d, r, c - 1);
        ln = left->pal_n[plane];
    }
    while (ai < an && li < ln) {
        int a = above->pal[plane][ai], l = left->pal[plane][li];
        if (l < a) {
            if (n == 0 || l != cache[n - 1]) cache[n++] = (uint8_t)l;
            li++;
        } else {
            if (n == 0 || a != cache[n - 1]) cache[n++] = (uint8_t)a;
            ai++;
            if (l == a) li++;
        }
    }
    for (; ai < an; ai++) {
        int v = above->pal[plane][ai];
        if (n == 0 || v != cache[n - 1]) cache[n++] = (uint8_t)v;
    }
    for (; li < ln; li++) {
        int v = left->pal[plane][li];
        if (n == 0 || v != cache[n - 1]) cache[n++] = (uint8_t)v;
    }
    return n;
}

static void sort_colors(uint8_t *c, int n) {
    for (int i = 1; i < n; i++)
        for (int j = i; j > 0 && c[j - 1] > c[j]; j--) {
            uint8_t t = c[j];
            c[j] = c[j - 1];
            c[j - 1] = t;
        }
}

/* palette_colors_y / _u: cached colours, then a literal and deltas */
static void read_colors(av1_dec *d, int plane, int n, uint8_t *out) {
    uint8_t cache[16];
    int cn = palette_cache(d, plane, cache), idx = 0;
    for (int i = 0; i < cn && idx < n; i++)
        if (av1_read_literal(d, 1)) out[idx++] = cache[i];
    if (idx < n) out[idx++] = (uint8_t)av1_read_literal(d, 8);
    int bits = 0;
    if (idx < n) bits = 8 - 3 + av1_read_literal(d, 2);
    for (; idx < n; idx++) {
        int delta = av1_read_literal(d, bits) + (plane == 0);
        int v = out[idx - 1] + delta;
        out[idx] = (uint8_t)(v > 255 ? 255 : v);
        int range = 256 - out[idx] - (plane == 0);
        int cb = ceil_log2(range);
        if (cb < bits) bits = cb;
    }
    sort_colors(out, n);
}

static void palette_mode_info(av1_dec *d) {
    int r = d->mi_row, c = d->mi_col;
    int bctx = av1_bw4_log2[d->bsize] + av1_bh4_log2[d->bsize] - 2;
    if (d->ymode == AV1_DC) {
        int ctx = (d->avail_u && mi_at(d, r - 1, c)->pal_n[0] > 0) +
                  (d->avail_l && mi_at(d, r, c - 1)->pal_n[0] > 0);
        if (av1_read_symbol(d, d->cdf.pal_y_mode[bctx][ctx], 2)) {
            d->pal_n[0] = av1_read_symbol(d, d->cdf.pal_y_size[bctx], 7) + 2;
            read_colors(d, 0, d->pal_n[0], d->pal[0]);
        }
    }
    if (d->has_chroma && d->uvmode == AV1_DC) {
        if (av1_read_symbol(d, d->cdf.pal_uv_mode[d->pal_n[0] > 0], 2)) {
            int n = av1_read_symbol(d, d->cdf.pal_uv_size[bctx], 7) + 2;
            d->pal_n[1] = n;
            read_colors(d, 1, n, d->pal[1]);
            if (av1_read_literal(d, 1)) {
                int bits = 8 - 4 + av1_read_literal(d, 2);
                d->pal[2][0] = (uint8_t)av1_read_literal(d, 8);
                for (int i = 1; i < n; i++) {
                    int delta = av1_read_literal(d, bits);
                    if (delta && av1_read_literal(d, 1)) delta = -delta;
                    int v = d->pal[2][i - 1] + delta;
                    if (v < 0) v += 256;
                    if (v >= 256) v -= 256;
                    d->pal[2][i] = (uint8_t)v;
                }
            } else {
                for (int i = 0; i < n; i++)
                    d->pal[2][i] = (uint8_t)av1_read_literal(d, 8);
            }
        }
    }
}

/* one colour index map, in wavefront order with each index's context */
static void color_map(av1_dec *d, int plane, int n, int bw, int bh, int ow,
                      int oh) {
    uint8_t (*m)[64] = d->cmap[plane];
    uint16_t (*cdf)[9] = plane ? d->cdf.pal_uv_color[n - 2]
                               : d->cdf.pal_y_color[n - 2];
    m[0][0] = (uint8_t)ns_literal(d, n);
    for (int i = 1; i < oh + ow - 1; i++) {
        int j0 = i < ow - 1 ? i : ow - 1, j1 = i - oh + 1 > 0 ? i - oh + 1 : 0;
        for (int j = j0; j >= j1; j--) {
            int rr = i - j, cc = j, scores[8] = { 0 }, order[8];
            if (cc > 0) scores[m[rr][cc - 1]] += 2;
            if (rr > 0 && cc > 0) scores[m[rr - 1][cc - 1]] += 1;
            if (rr > 0) scores[m[rr - 1][cc]] += 2;
            for (int k = 0; k < 8; k++) order[k] = k;
            for (int k = 0; k < 3; k++) {
                int best = scores[k], bi = k;
                for (int q = k + 1; q < n; q++)
                    if (scores[q] > best) best = scores[q], bi = q;
                if (bi != k) {
                    int bo = order[bi];
                    for (int q = bi; q > k; q--) {
                        scores[q] = scores[q - 1];
                        order[q] = order[q - 1];
                    }
                    scores[k] = best;
                    order[k] = bo;
                }
            }
            int hash = scores[0] + scores[1] * 2 + scores[2] * 2;
            int ctx = av1_palette_color_context[hash];
            if (ctx < 0) av1_fail(d, "a palette colour context out of range");
            m[rr][cc] = (uint8_t)order[av1_read_symbol(d, cdf[ctx], n)];
        }
    }
    for (int i = 0; i < oh; i++)
        for (int j = ow; j < bw; j++) m[i][j] = m[i][ow - 1];
    for (int i = oh; i < bh; i++)
        for (int j = 0; j < bw; j++) m[i][j] = m[oh - 1][j];
}

static void palette_tokens(av1_dec *d) {
    int bw = 4 << av1_bw4_log2[d->bsize], bh = 4 << av1_bh4_log2[d->bsize];
    int oh = (d->mi_rows - d->mi_row) * 4, ow = (d->mi_cols - d->mi_col) * 4;
    if (oh > bh) oh = bh;
    if (ow > bw) ow = bw;
    if (d->pal_n[0]) color_map(d, 0, d->pal_n[0], bw, bh, ow, oh);
    if (d->pal_n[1]) {
        bw >>= d->ss_x, bh >>= d->ss_y, ow >>= d->ss_x, oh >>= d->ss_y;
        if (bw < 4) bw += 2, ow += 2;
        if (bh < 4) bh += 2, oh += 2;
        color_map(d, 1, d->pal_n[1], bw, bh, ow, oh);
    }
}

/* --- intra block copy ---------------------------------------------------- */

#define STACK 8                   /* MAX_REF_MV_STACK_SIZE */

typedef struct {
    int n;
    int16_t mv[STACK][2];
    uint16_t weight[STACK];
} mv_stack;

/* libaom's add_ref_mv_candidate for one reference, INTRA_FRAME: only intra
 * block copy blocks are candidates */
static void add_candidate(mv_stack *st, const av1_mi *c, int weight) {
    if (!c->is_inter) return;
    int i;
    for (i = 0; i < st->n; i++) {
        if (st->mv[i][0] == c->dv[0] && st->mv[i][1] == c->dv[1]) {
            st->weight[i] += (uint16_t)weight;
            break;
        }
    }
    if (i == st->n && st->n < STACK) {
        st->mv[i][0] = c->dv[0];
        st->mv[i][1] = c->dv[1];
        st->weight[i] = (uint16_t)weight;
        st->n++;
    }
}

static void scan_row(av1_dec *d, mv_stack *st, int row_offset,
                     int max_row_offset, int *processed) {
    int bw = d->bw4, end = d->mi_cols - d->mi_col;
    if (end > bw) end = bw;
    if (end > 16) end = 16;
    int col_offset = 0;
    if (abs(row_offset) > 1) {
        col_offset = 1;
        if ((d->mi_col & 1) && bw < 2) col_offset--;
    }
    int step16 = bw >= 16;
    for (int i = 0; i < end;) {
        const av1_mi *c = mi_at(d, d->mi_row + row_offset,
                                d->mi_col + col_offset + i);
        int n4w = 1 << av1_bw4_log2[c->bsize];
        int len = bw < n4w ? bw : n4w;
        if (step16) len = len > 4 ? len : 4;
        else if (abs(row_offset) > 1) len = len > 2 ? len : 2;
        int weight = 2;
        if (bw >= 2 && bw <= n4w) {
            int inc = -max_row_offset + row_offset + 1;
            int n4h = 1 << av1_bh4_log2[c->bsize];
            if (inc > n4h) inc = n4h;
            if (inc > weight) weight = inc;
            *processed = inc - row_offset - 1;
        }
        add_candidate(st, c, len * weight);
        i += len;
    }
}

static void scan_col(av1_dec *d, mv_stack *st, int col_offset,
                     int max_col_offset, int *processed) {
    int bh = d->bh4, end = d->mi_rows - d->mi_row;
    if (end > bh) end = bh;
    if (end > 16) end = 16;
    int row_offset = 0;
    if (abs(col_offset) > 1) {
        row_offset = 1;
        if ((d->mi_row & 1) && bh < 2) row_offset--;
    }
    int step16 = bh >= 16;
    for (int i = 0; i < end;) {
        const av1_mi *c = mi_at(d, d->mi_row + row_offset + i,
                                d->mi_col + col_offset);
        int n4h = 1 << av1_bh4_log2[c->bsize];
        int len = bh < n4h ? bh : n4h;
        if (step16) len = len > 4 ? len : 4;
        else if (abs(col_offset) > 1) len = len > 2 ? len : 2;
        int weight = 2;
        if (bh >= 2 && bh <= n4h) {
            int inc = -max_col_offset + col_offset + 1;
            int n4w = 1 << av1_bw4_log2[c->bsize];
            if (inc > n4w) inc = n4w;
            if (inc > weight) weight = inc;
            *processed = inc - col_offset - 1;
        }
        add_candidate(st, c, len * weight);
        i += len;
    }
}

static void scan_point(av1_dec *d, mv_stack *st, int row_offset,
                       int col_offset) {
    int r = d->mi_row + row_offset, c = d->mi_col + col_offset;
    if (r < d->tile_row0 || r >= d->tile_row1 || c < d->tile_col0 ||
        c >= d->tile_col1)
        return;
    add_candidate(st, mi_at(d, r, c), 4);
}

/* whether the 8x8 above and right of the block is decoded (libaom's
 * has_top_right: none for blocks wider or taller than 64) */
static int has_top_right(av1_dec *d) {
    int bs = d->bw4 > d->bh4 ? d->bw4 : d->bh4;
    if (bs > 16) return 0;
    int r = d->mi_row - 1, c = d->mi_col + d->bw4;
    if (r < d->tile_row0 || c >= d->tile_col1) return 0;
    return mi_at(d, r, c)->has_mi;
}

static int clamp_mv(int v, int lo, int hi) { return v < lo ? lo : v > hi ? hi : v; }

static int read_mv_component(av1_dec *d, int comp) {
    int sign = av1_read_symbol(d, d->cdf.dv.comp[comp].sign, 2);
    int cls = av1_read_symbol(d, d->cdf.dv.comp[comp].classes, 11);
    int mag, dd = 0;
    if (cls == 0) {
        dd = av1_read_symbol(d, d->cdf.dv.comp[comp].class0, 2);
        mag = 0;
    } else {
        for (int i = 0; i < cls; i++)
            dd |= av1_read_symbol(d, d->cdf.dv.comp[comp].bits[i], 2) << i;
        mag = 2 << (cls + 2);
    }
    mag += ((dd << 3) | (3 << 1) | 1) + 1;
    return sign ? -mag : mag;
}

/* libaom's read_intrabc_info: the reference DVs of the neighbours'
 * intra block copies (setup_ref_mv_list for INTRA_FRAME), a default one
 * a superblock up or left, then the coded difference */
static void read_intrabc_dv(av1_dec *d) {
    mv_stack st = { 0 };
    int row_adj = d->bh4 < 2 && (d->mi_row & 1);
    int col_adj = d->bw4 < 2 && (d->mi_col & 1);
    int max_row = 0, max_col = 0, prow = 0, pcol = 0;
    if (d->avail_u) {
        max_row = d->bh4 < 2 ? -4 + row_adj : -6 + row_adj;
        max_row = clamp_mv(max_row, d->tile_row0 - d->mi_row,
                           d->tile_row1 - d->mi_row - 1);
    }
    if (d->avail_l) {
        max_col = d->bw4 < 2 ? -4 + col_adj : -6 + col_adj;
        max_col = clamp_mv(max_col, d->tile_col0 - d->mi_col,
                           d->tile_col1 - d->mi_col - 1);
    }
    if (abs(max_row) >= 1) scan_row(d, &st, -1, max_row, &prow);
    if (abs(max_col) >= 1) scan_col(d, &st, -1, max_col, &pcol);
    if (has_top_right(d)) scan_point(d, &st, -1, d->bw4);
    int nearest = st.n;
    for (int i = 0; i < nearest; i++) st.weight[i] += 640;   /* REF_CAT_LEVEL */
    scan_point(d, &st, -1, -1);
    for (int idx = 2; idx <= 3; idx++) {
        int ro = -(idx << 1) + 1 + row_adj, co = -(idx << 1) + 1 + col_adj;
        if (abs(ro) <= abs(max_row) && abs(ro) > prow)
            scan_row(d, &st, ro, max_row, &prow);
        if (abs(co) <= abs(max_col) && abs(co) > pcol)
            scan_col(d, &st, co, max_col, &pcol);
    }
    /* rank by weight: the nearest ones, then the rest */
    for (int part = 0; part < 2; part++) {
        int lo = part ? nearest : 0, len = part ? st.n : nearest;
        while (len > lo) {
            int nr = lo;
            for (int i = lo + 1; i < len; i++) {
                if (st.weight[i - 1] < st.weight[i]) {
                    int16_t m0 = st.mv[i - 1][0], m1 = st.mv[i - 1][1];
                    uint16_t w = st.weight[i - 1];
                    st.mv[i - 1][0] = st.mv[i][0];
                    st.mv[i - 1][1] = st.mv[i][1];
                    st.weight[i - 1] = st.weight[i];
                    st.mv[i][0] = m0;
                    st.mv[i][1] = m1;
                    st.weight[i] = w;
                    nr = i;
                }
            }
            len = nr;
        }
    }
    /* clamp_mv_ref: within the frame, 16 samples past it */
    int bw = d->bw4 * 4, bh = d->bh4 * 4;
    int left = -(d->mi_col * 4) * 8, right = (d->mi_cols - d->bw4 - d->mi_col) * 4 * 8;
    int top = -(d->mi_row * 4) * 8, bottom = (d->mi_rows - d->bh4 - d->mi_row) * 4 * 8;
    int ref[2][2] = { { 0, 0 }, { 0, 0 } };
    for (int i = 0; i < st.n && i < 2; i++) {
        ref[i][0] = clamp_mv(st.mv[i][0], top - bh * 8 - 128,
                             bottom + bh * 8 + 128);
        ref[i][1] = clamp_mv(st.mv[i][1], left - bw * 8 - 128,
                             right + bw * 8 + 128);
        for (int k = 0; k < 2; k++)                 /* lower_mv_precision */
            if (ref[i][k] & 1) ref[i][k] += ref[i][k] > 0 ? -1 : 1;
    }
    int *dv = ref[0][0] || ref[0][1] ? ref[0] : ref[1];
    int pred[2] = { dv[0], dv[1] };
    if (!pred[0] && !pred[1]) {
        int sb = d->sb128 ? 32 : 16;
        if (d->mi_row - sb < d->tile_row0) {
            pred[0] = 0;
            pred[1] = -(4 * sb + 256) * 8;   /* INTRABC_DELAY_PIXELS */
        } else {
            pred[0] = -(4 * sb) * 8;
            pred[1] = 0;
        }
    }
    for (int k = 0; k < 2; k++) pred[k] = (pred[k] >> 3) * 8;
    int joint = av1_read_symbol(d, d->cdf.dv.joints, 4);
    int diff[2] = { 0, 0 };
    if (joint == 2 || joint == 3) diff[0] = read_mv_component(d, 0);
    if (joint == 1 || joint == 3) diff[1] = read_mv_component(d, 1);
    for (int k = 0; k < 2; k++) {
        int v = pred[k] + diff[k];
        d->dv[k] = (v >> 3) * 8;
        if (d->dv[k] < -32768 || d->dv[k] > 32767)
            av1_fail(d, "an intra block copy vector out of range");
    }
}

static void intra_frame_mode_info(av1_dec *d) {
    int r = d->mi_row, c = d->mi_col;
    int ctx = (d->avail_u ? mi_at(d, r - 1, c)->skip : 0) +
              (d->avail_l ? mi_at(d, r, c - 1)->skip : 0);
    d->skip = av1_read_symbol(d, d->cdf.skip[ctx], 2);
    read_cdef(d);
    read_delta_qindex(d);
    d->read_deltas = 0;
    d->use_intrabc = d->allow_intrabc
                         ? av1_read_symbol(d, d->cdf.intrabc, 2) : 0;
    d->pal_n[0] = d->pal_n[1] = 0;
    if (d->use_intrabc) {
        d->ymode = d->uvmode = AV1_DC;
        d->angle_y = d->angle_uv = d->use_fi = 0;
        read_intrabc_dv(d);
        return;
    }
    int above = d->avail_u ? mi_at(d, r - 1, c)->ymode : AV1_DC;
    int left = d->avail_l ? mi_at(d, r, c - 1)->ymode : AV1_DC;
    d->ymode = av1_read_symbol(
        d, d->cdf.kf_y[av1_intra_mode_context[above]]
                      [av1_intra_mode_context[left]], 13);
    d->angle_y = 0;
    if (d->bsize >= B8X8 && directional(d->ymode))
        d->angle_y = av1_read_symbol(d, d->cdf.angle[d->ymode - AV1_V], 7) - 3;
    d->uvmode = AV1_DC;
    d->angle_uv = 0;
    int bw = 4 << av1_bw4_log2[d->bsize], bh = 4 << av1_bh4_log2[d->bsize];
    if (d->has_chroma) {
        int cfl = bw <= 32 && bh <= 32;
        d->uvmode = av1_read_symbol(d, d->cdf.uv[cfl][d->ymode],
                                    cfl ? 14 : 13);
        if (d->uvmode == AV1_UV_CFL) read_cfl_alphas(d);
        if (d->bsize >= B8X8 && directional(d->uvmode))
            d->angle_uv =
                av1_read_symbol(d, d->cdf.angle[d->uvmode - AV1_V], 7) - 3;
    }
    if (d->sct && d->bsize >= B8X8 && bw <= 64 && bh <= 64)
        palette_mode_info(d);
    d->use_fi = 0;
    if (d->filter_intra && d->ymode == AV1_DC && !d->pal_n[0] && bw <= 32 &&
        bh <= 32) {
        d->use_fi = av1_read_symbol(d, d->cdf.fi[d->bsize], 2);
        if (d->use_fi) d->fi_mode = av1_read_symbol(d, d->cdf.fi_mode, 5);
    }
}

/* the tx width over the block's top edge at mi column c (the spec's
 * get_above_tx_width), or its height over the left edge at row r */
static int above_tx_w(av1_dec *d, int r, int c) {
    if (r == d->mi_row) {
        if (!d->avail_u) return 64;
        const av1_mi *m = mi_at(d, r - 1, c);
        if (m->skip && m->is_inter) return 4 << av1_bw4_log2[m->bsize];
        return 1 << av1_tx_w_log2[m->inter_txsz];
    }
    return 1 << av1_tx_w_log2[d->vtx[r - 1 - d->mi_row][c - d->mi_col]];
}

static int left_tx_h(av1_dec *d, int r, int c) {
    if (c == d->mi_col) {
        if (!d->avail_l) return 64;
        const av1_mi *m = mi_at(d, r, c - 1);
        if (m->skip && m->is_inter) return 4 << av1_bh4_log2[m->bsize];
        return 1 << av1_tx_h_log2[m->inter_txsz];
    }
    return 1 << av1_tx_h_log2[d->vtx[r - d->mi_row][c - 1 - d->mi_col]];
}

/* read_var_tx_size: an inter block's transform tree, depth <= 2 */
static void read_var_tx(av1_dec *d, int r, int c, int t, int depth) {
    if (r >= d->mi_rows || c >= d->mi_cols) return;
    int split = 0;
    if (t != TX4X4 && depth < 2) {
        int above = above_tx_w(d, r, c) < (1 << av1_tx_w_log2[t]);
        int left = left_tx_h(d, r, c) < (1 << av1_tx_h_log2[t]);
        int bl = av1_bw4_log2[d->bsize] > av1_bh4_log2[d->bsize]
                     ? av1_bw4_log2[d->bsize] : av1_bh4_log2[d->bsize];
        int maxsq = bl + 2 > 6 ? 4 : bl;      /* the square tx index */
        int lw = av1_tx_w_log2[t], lh = av1_tx_h_log2[t];
        int up = (lw > lh ? lw : lh) - 2;
        int ctx = (up != maxsq) * 3 + (4 - maxsq) * 6 + above + left;
        split = av1_read_symbol(d, d->cdf.txfm_split[ctx], 2);
    }
    int w4 = 1 << (av1_tx_w_log2[t] - 2), h4 = 1 << (av1_tx_h_log2[t] - 2);
    if (split) {
        int st = split_tx(t);
        int sw = 1 << (av1_tx_w_log2[st] - 2), sh = 1 << (av1_tx_h_log2[st] - 2);
        for (int i = 0; i < h4; i += sh)
            for (int j = 0; j < w4; j += sw)
                read_var_tx(d, r + i, c + j, st, depth + 1);
    } else {
        for (int i = 0; i < h4; i++)
            for (int j = 0; j < w4; j++) {
                int rr = r + i - d->mi_row, cc = c + j - d->mi_col;
                if (rr < 32 && cc < 32) d->vtx[rr][cc] = (uint8_t)t;
            }
        d->txsz = t;
    }
}

static void read_tx_size(av1_dec *d) {
    int t = max_tx(d->bsize);
    d->txsz = t;
    if (d->use_intrabc && d->tx_select && d->bsize != B4X4 && !d->skip) {
        int w4 = 1 << (av1_tx_w_log2[t] - 2), h4 = 1 << (av1_tx_h_log2[t] - 2);
        for (int r = 0; r < d->bh4; r += h4)
            for (int c = 0; c < d->bw4; c += w4)
                read_var_tx(d, d->mi_row + r, d->mi_col + c, t, 0);
        return;
    }
    if (d->bsize != B4X4 && d->tx_select && !(d->use_intrabc && d->skip)) {
        int depth = 0, cat = -1;
        for (int s = t; s != TX4X4; s = split_tx(s)) cat++;
        int maxdepth = cat + 1 > 2 ? 2 : cat + 1;
        int r = d->mi_row, c = d->mi_col;
        int ctx = 0;
        if (d->avail_u) {
            const av1_mi *m = mi_at(d, r - 1, c);
            ctx += m->is_inter ? av1_bw4_log2[m->bsize] + 2 >= av1_tx_w_log2[t]
                               : av1_tx_w_log2[m->txsz] >= av1_tx_w_log2[t];
        }
        if (d->avail_l) {
            const av1_mi *m = mi_at(d, r, c - 1);
            ctx += m->is_inter ? av1_bh4_log2[m->bsize] + 2 >= av1_tx_h_log2[t]
                               : av1_tx_h_log2[m->txsz] >= av1_tx_h_log2[t];
        }
        depth = av1_read_symbol(d, d->cdf.tx_size[cat][ctx], maxdepth + 1);
        for (int i = 0; i < depth; i++) d->txsz = split_tx(d->txsz);
    }
    for (int r = 0; r < d->bh4 && r < 32; r++)
        for (int c = 0; c < d->bw4 && c < 32; c++)
            d->vtx[r][c] = (uint8_t)d->txsz;
}

static void reset_block_context(av1_dec *d) {
    for (int p = 0; p < (d->has_chroma ? 3 : 1); p++) {
        int sx = p ? d->ss_x : 0, sy = p ? d->ss_y : 0;
        for (int i = d->mi_col >> sx; i < ((d->mi_col + d->bw4 - 1) >> sx) + 1;
             i++)
            d->above_level[p][i] = d->above_dc[p][i] = 0;
        for (int i = d->mi_row >> sy; i < ((d->mi_row + d->bh4 - 1) >> sy) + 1;
             i++)
            d->left_level[p][i] = d->left_dc[p][i] = 0;
    }
}

/* --- coefficients -------------------------------------------------------- */

/* libaom's av1_get_ext_tx_set_type (TxSetType) of an intra block, or
 * of an intra block copy's (inter) */
static int tx_set(const av1_dec *d, int t) {
    int lw = av1_tx_w_log2[t], lh = av1_tx_h_log2[t];
    int up = lw > lh ? lw : lh, sqr = lw < lh ? lw : lh;
    if (up > 5) return 0;                        /* DCT only */
    if (d->use_intrabc) {
        if (up == 5 || d->reduced_tx) return 1;  /* DCT_IDTX */
        return sqr == 4 ? 4 : 5;                 /* DTT9_IDTX_1DDCT, ALL16 */
    }
    if (up == 5) return 0;
    if (d->reduced_tx || sqr == 4) return 2;     /* DTT4_IDTX */
    return 3;                                    /* DTT4_IDTX_1DDCT */
}

static int tx_class(int type) {
    switch (type) {
    case V_DCT: case V_ADST: case V_FLIPADST: return CLASS_VERT;
    case H_DCT: case H_ADST: case H_FLIPADST: return CLASS_HORIZ;
    default: return CLASS_2D;
    }
}

static int txb_skip_ctx(av1_dec *d, int plane, int t, int x4, int y4, int w4,
                        int h4) {
    int maxx4 = d->mi_cols, maxy4 = d->mi_rows;
    if (plane) {
        maxx4 >>= d->ss_x;
        maxy4 >>= d->ss_y;
    }
    int pbs = av1_plane_bsize(d, d->bsize, plane);
    int bw = 4 << av1_bw4_log2[pbs], bh = 4 << av1_bh4_log2[pbs];
    int w = 1 << av1_tx_w_log2[t], h = 1 << av1_tx_h_log2[t];
    if (plane == 0) {
        int top = 0, left = 0;
        for (int k = 0; k < w4; k++)
            if (x4 + k < maxx4 && d->above_level[0][x4 + k] > top)
                top = d->above_level[0][x4 + k];
        for (int k = 0; k < h4; k++)
            if (y4 + k < maxy4 && d->left_level[0][y4 + k] > left)
                left = d->left_level[0][y4 + k];
        int mx = top > left ? top : left, mn = top < left ? top : left;
        if (bw == w && bh == h) return 0;
        if (top == 0 && left == 0) return 1;
        if (top == 0 || left == 0) return 2 + (mx > 3);
        if (mx <= 3) return 4;
        if (mn <= 3) return 5;
        return 6;
    }
    int above = 0, left = 0;
    for (int i = 0; i < w4; i++)
        if (x4 + i < maxx4)
            above |= d->above_level[plane][x4 + i] | d->above_dc[plane][x4 + i];
    for (int i = 0; i < h4; i++)
        if (y4 + i < maxy4)
            left |= d->left_level[plane][y4 + i] | d->left_dc[plane][y4 + i];
    int ctx = (above != 0) + (left != 0) + 7;
    if (bw * bh > w * h) ctx += 3;
    return ctx;
}

static int dc_sign_ctx(av1_dec *d, int plane, int x4, int y4, int w4,
                       int h4) {
    int maxx4 = d->mi_cols, maxy4 = d->mi_rows;
    if (plane) {
        maxx4 >>= d->ss_x;
        maxy4 >>= d->ss_y;
    }
    int s = 0;
    for (int k = 0; k < w4; k++) {
        if (x4 + k >= maxx4) continue;
        int v = d->above_dc[plane][x4 + k];
        s += v == 1 ? -1 : v == 2 ? 1 : 0;
    }
    for (int k = 0; k < h4; k++) {
        if (y4 + k >= maxy4) continue;
        int v = d->left_dc[plane][y4 + k];
        s += v == 1 ? -1 : v == 2 ? 1 : 0;
    }
    return s < 0 ? 1 : s > 0 ? 2 : 0;
}

static const int8_t sig_ref[3][5][2] = {
    { { 0, 1 }, { 1, 0 }, { 1, 1 }, { 0, 2 }, { 2, 0 } },
    { { 0, 1 }, { 1, 0 }, { 0, 2 }, { 0, 3 }, { 0, 4 } },
    { { 0, 1 }, { 1, 0 }, { 2, 0 }, { 3, 0 }, { 4, 0 } } };
static const int8_t mag_ref[3][3][2] = {
    { { 0, 1 }, { 1, 0 }, { 1, 1 } },
    { { 0, 1 }, { 1, 0 }, { 0, 2 } },
    { { 0, 1 }, { 1, 0 }, { 2, 0 } } };

static int base_ctx(const int32_t *q, int t, int cls, int bwl, int txh,
                    int pos) {
    int row = pos >> bwl, col = pos - (row << bwl), mag = 0;
    for (int i = 0; i < 5; i++) {
        int rr = row + sig_ref[cls][i][0], cc = col + sig_ref[cls][i][1];
        if (rr < txh && cc < (1 << bwl)) {
            int v = q[(rr << bwl) + cc];
            mag += v > 3 ? 3 : v;
        }
    }
    int ctx = (mag + 1) >> 1;
    if (ctx > 4) ctx = 4;
    if (cls == CLASS_2D) {
        if (pos == 0) return 0;
        return ctx + av1_nz_map_ctx_offset[t][pos];
    }
    int idx = cls == CLASS_VERT ? row : col;
    return ctx + av1_nz_map_ctx_offset_1d[idx > 2 ? 2 : idx];
}

static int br_ctx(const int32_t *q, int cls, int bwl, int txh, int pos) {
    int row = pos >> bwl, col = pos - (row << bwl), mag = 0;
    for (int i = 0; i < 3; i++) {
        int rr = row + mag_ref[cls][i][0], cc = col + mag_ref[cls][i][1];
        if (rr < txh && cc < (1 << bwl)) {
            int v = q[(rr << bwl) + cc];
            mag += v > 15 ? 15 : v;
        }
    }
    mag = (mag + 1) >> 1;
    if (mag > 6) mag = 6;
    if (pos == 0) return mag;
    if (cls == CLASS_2D) return mag + (row < 2 && col < 2 ? 7 : 14);
    if (cls == CLASS_HORIZ) return mag + (col == 0 ? 7 : 14);
    return mag + (row == 0 ? 7 : 14);
}

static int read_eob_pt(av1_dec *d, int ptype, int ctx, int n) {
    av1_cdfs *c = &d->cdf;
    switch (n) {
    case 0: return av1_read_symbol(d, c->eob16[ptype][ctx], 5);
    case 1: return av1_read_symbol(d, c->eob32[ptype][ctx], 6);
    case 2: return av1_read_symbol(d, c->eob64[ptype][ctx], 7);
    case 3: return av1_read_symbol(d, c->eob128[ptype][ctx], 8);
    case 4: return av1_read_symbol(d, c->eob256[ptype][ctx], 9);
    case 5: return av1_read_symbol(d, c->eob512[ptype][ctx], 10);
    default: return av1_read_symbol(d, c->eob1024[ptype][ctx], 11);
    }
}

static int compute_tx_type(av1_dec *d, int plane, int t, int x4, int y4) {
    int lw = av1_tx_w_log2[t], lh = av1_tx_h_log2[t];
    if ((lw > lh ? lw : lh) > 5) return DCT_DCT;
    if (plane == 0) return d->tx_type[(size_t)y4 * d->mi_cols + x4];
    int type;
    if (d->use_intrabc) {
        /* the luma type at the block's co-located 4x4 */
        int lx = x4 << d->ss_x, ly = y4 << d->ss_y;
        if (lx < d->mi_col) lx = d->mi_col;
        if (ly < d->mi_row) ly = d->mi_row;
        type = d->tx_type[(size_t)ly * d->mi_cols + lx];
    } else {
        type = d->uvmode == AV1_UV_CFL ? DCT_DCT
                                       : av1_mode_to_tx_type[d->uvmode];
    }
    return av1_ext_tx_used[tx_set(d, t)][type] ? type : DCT_DCT;
}

/* reads one transform block's coefficients into d->coef (row-major over
 * the coded area); returns eob and its tx type through *type */
static int coeffs(av1_dec *d, int plane, int x, int y, int t, int *type) {
    int x4 = x >> 2, y4 = y >> 2;
    int lw = av1_tx_w_log2[t], lh = av1_tx_h_log2[t];
    int w4 = 1 << (lw - 2), h4 = 1 << (lh - 2);
    int sqr = (lw < lh ? lw : lh) - 2, up = (lw > lh ? lw : lh) - 2;
    int ctx_sz = (sqr + up + 1) >> 1, ptype = plane > 0;
    int bwl = lw > 5 ? 5 : lw, txh = 1 << (lh > 5 ? 5 : lh);
    int n = txh << bwl;
    int32_t *q = d->coef;
    memset(q, 0, sizeof(int32_t) * (size_t)n);
    int zero = av1_read_symbol(
        d, d->cdf.txb_skip[ctx_sz][txb_skip_ctx(d, plane, t, x4, y4, w4, h4)],
        2);
    int eob = 0, cul = 0, dc_cat = 0;
    *type = DCT_DCT;
    if (zero) {
        if (plane == 0) {
            for (int j = 0; j < h4 && y4 + j < d->mi_rows; j++)
                for (int i = 0; i < w4 && x4 + i < d->mi_cols; i++)
                    d->tx_type[(size_t)(y4 + j) * d->mi_cols + x4 + i] = DCT_DCT;
        }
    } else {
        if (plane == 0) {
            int set = tx_set(d, t), tt = DCT_DCT;
            if (set && d->use_intrabc) {
                int eset = av1_ext_tx_set_index[1][set];
                int sym = av1_read_symbol(d, d->cdf.inter_ext_tx[eset][sqr],
                                          av1_num_ext_tx_set[set]);
                tt = av1_ext_tx_inv[set][sym];
            } else if (set) {
                int dir = d->use_fi ? av1_fimode_to_intradir[d->fi_mode]
                                    : d->ymode;
                int eset = av1_ext_tx_set_index[0][set];
                int sym = av1_read_symbol(
                    d, d->cdf.ext_tx[eset][sqr][dir], av1_num_ext_tx_set[set]);
                tt = av1_ext_tx_inv[set][sym];
            }
            for (int j = 0; j < h4 && y4 + j < d->mi_rows; j++)
                for (int i = 0; i < w4 && x4 + i < d->mi_cols; i++)
                    d->tx_type[(size_t)(y4 + j) * d->mi_cols + x4 + i] =
                        (uint8_t)tt;
        }
        *type = compute_tx_type(d, plane, t, x4, y4);
        int cls = tx_class(*type);
        int kind = 0;
        if (up <= 3 && *type != IDTX) {
            if (cls == CLASS_VERT) kind = 1;
            else if (cls == CLASS_HORIZ) kind = 2;
        }
        const uint16_t *scan = av1_scans + av1_scan_offset[kind][t];
        int ms = (lw > 5 ? 5 : lw) + (lh > 5 ? 5 : lh) - 4;
        int pt = read_eob_pt(d, ptype, cls == CLASS_2D ? 0 : 1, ms) + 1;
        eob = pt < 2 ? pt : (1 << (pt - 2)) + 1;
        if (pt >= 3) {
            if (av1_read_symbol(d, d->cdf.eob_extra[ctx_sz][ptype][pt - 3],
                                2))
                eob += 1 << (pt - 3);
            for (int i = 1; i < pt - 2; i++) {
                if (av1_read_literal(d, 1)) eob += 1 << (pt - 3 - i);
            }
        }
        if (eob > n) av1_fail(d, "an end of block past the transform");
        for (int c = eob - 1; c >= 0; c--) {
            int pos = scan[c], level;
            if (c == eob - 1) {
                int ctx = c == 0 ? 0 : c <= n / 8 ? 1 : c <= n / 4 ? 2 : 3;
                level = av1_read_symbol(
                            d, d->cdf.base_eob[ctx_sz][ptype][ctx], 3) + 1;
            } else {
                level = av1_read_symbol(
                    d, d->cdf.base[ctx_sz][ptype]
                                  [base_ctx(q, t, cls, bwl, txh, pos)], 4);
            }
            if (level > 2) {
                int bc = br_ctx(q, cls, bwl, txh, pos);
                for (int i = 0; i < 4; i++) {
                    int br = av1_read_symbol(
                        d, d->cdf.br[ctx_sz > 3 ? 3 : ctx_sz][ptype][bc], 4);
                    level += br;
                    if (br < 3) break;
                }
            }
            q[pos] = level;
        }
        for (int c = 0; c < eob; c++) {
            int pos = scan[c], sign = 0;
            if (!q[pos]) continue;
            if (c == 0)
                sign = av1_read_symbol(
                    d, d->cdf.dc_sign[ptype]
                                     [dc_sign_ctx(d, plane, x4, y4, w4, h4)],
                    2);
            else
                sign = av1_read_literal(d, 1);
            if (q[pos] > 14) {
                int len = 0;
                do {
                    if (++len > 32) av1_fail(d, "a Golomb code is too long");
                } while (!av1_read_literal(d, 1));
                int v = 1;
                for (int i = len - 2; i >= 0; i--)
                    v = (v << 1) | av1_read_literal(d, 1);
                q[pos] = v + 14;
            }
            if (pos == 0) dc_cat = sign ? 1 : 2;
            q[pos] &= 0xfffff;
            cul += q[pos];
            if (sign) q[pos] = -q[pos];
        }
        if (cul > 63) cul = 63;
    }
    for (int i = 0; i < w4; i++) {
        d->above_level[plane][x4 + i] = (uint8_t)cul;
        d->above_dc[plane][x4 + i] = (uint8_t)dc_cat;
    }
    for (int i = 0; i < h4; i++) {
        d->left_level[plane][y4 + i] = (uint8_t)cul;
        d->left_dc[plane][y4 + i] = (uint8_t)dc_cat;
    }
    return eob;
}

/* --- blocks -------------------------------------------------------------- */

static void transform_block(av1_dec *d, int plane, int bx, int by, int t,
                            int x, int y) {
    int sx = plane ? d->ss_x : 0, sy = plane ? d->ss_y : 0;
    int sx0 = bx + 4 * x, sy0 = by + 4 * y;
    int row = (sy0 << sy) >> 2, col = (sx0 << sx) >> 2;
    int sbmask = d->sb128 ? 31 : 15;
    int sbr = row & sbmask, sbc = col & sbmask;
    int stepx = 1 << (av1_tx_w_log2[t] - 2), stepy = 1 << (av1_tx_h_log2[t] - 2);
    if (sx0 >= (d->mi_cols * 4) >> sx || sy0 >= (d->mi_rows * 4) >> sy) return;
    int cfl = plane && d->uvmode == AV1_UV_CFL;
    int mode = plane == 0 ? d->ymode : cfl ? AV1_DC : d->uvmode;
    int have_left = (plane ? d->avail_lc : d->avail_l) || x > 0;
    int have_above = (plane ? d->avail_uc : d->avail_u) || y > 0;
    int dr = (sbr >> sy) + 1, dc = (sbc >> sx) + 1;
    int have_ar = d->decoded[plane][dr - 1][dc + stepx];
    int have_bl = d->decoded[plane][dr + stepy][dc - 1];
    if (d->use_intrabc)
        ;                       /* predicted for the whole block */
    else if (d->pal_n[plane > 0])
        av1_predict_palette(d, plane, sx0, sy0, x, y, t);
    else
        av1_predict_intra(d, plane, sx0, sy0, have_left, have_above, have_ar,
                          have_bl, mode, av1_tx_w_log2[t], av1_tx_h_log2[t]);
    if (cfl) av1_predict_cfl(d, plane, sx0, sy0, t);
    if (plane == 0) {
        d->max_luma_w = sx0 + stepx * 4;
        d->max_luma_h = sy0 + stepy * 4;
    }
    if (!d->skip) {
        int type;
        int eob = coeffs(d, plane, sx0, sy0, t, &type);
        if (eob > 0) av1_reconstruct(d, plane, sx0, sy0, t, type, eob);
    }
    int n4w = (d->pw[plane] >> 2), n4h = (d->ph[plane] >> 2);
    for (int i = 0; i < stepy; i++) {
        for (int j = 0; j < stepx; j++) {
            int rr = (row >> sy) + i, cc = (col >> sx) + j;
            if (rr < n4h && cc < n4w)
                d->lf_txsz[plane][(size_t)rr * (n4w + 1) + cc] = (uint8_t)t;
            if (dr + i < 34 && dc + j < 34) d->decoded[plane][dr + i][dc + j] = 1;
        }
    }
}

/* an intra block copy's luma transform blocks, each of its InterTxSizes
 * (the spec's transform_tree) */
static void transform_tree(av1_dec *d, int x, int y, int w, int h) {
    if (x >= d->mi_cols * 4 || y >= d->mi_rows * 4) return;
    int t = d->vtx[(y >> 2) - d->mi_row][(x >> 2) - d->mi_col];
    int tw = 1 << av1_tx_w_log2[t], th = 1 << av1_tx_h_log2[t];
    if (w <= tw && h <= th) {
        transform_block(d, 0, x, y, t, 0, 0);
    } else if (w > h) {
        transform_tree(d, x, y, w / 2, h);
        transform_tree(d, x + w / 2, y, w / 2, h);
    } else if (w < h) {
        transform_tree(d, x, y, w, h / 2);
        transform_tree(d, x, y + h / 2, w, h / 2);
    } else {
        transform_tree(d, x, y, w / 2, h / 2);
        transform_tree(d, x + w / 2, y, w / 2, h / 2);
        transform_tree(d, x, y + h / 2, w / 2, h / 2);
        transform_tree(d, x + w / 2, y + h / 2, w / 2, h / 2);
    }
}

/* the block's transform blocks, plane by plane within each 64x64 chunk
 * (blocks of 128 have two or four) */
static void residual(av1_dec *d) {
    int wch = d->bw4 > 16 ? d->bw4 / 16 : 1, hch = d->bh4 > 16 ? d->bh4 / 16 : 1;
    for (int cy = 0; cy < hch; cy++) {
        for (int cx = 0; cx < wch; cx++) {
            for (int p = 0; p < (d->has_chroma ? 3 : 1); p++) {
                int t = p ? av1_uv_txsz(d, d->bsize) : d->txsz;
                int sx = p ? d->ss_x : 0, sy = p ? d->ss_y : 0;
                int stepx = 1 << (av1_tx_w_log2[t] - 2);
                int stepy = 1 << (av1_tx_h_log2[t] - 2);
                int pbs = av1_plane_bsize(d, d->bsize, p);
                int n4w = 1 << av1_bw4_log2[pbs], n4h = 1 << av1_bh4_log2[pbs];
                int bx = (d->mi_col >> sx) * 4, by = (d->mi_row >> sy) * 4;
                int ox = (cx << 4) >> sx, oy = (cy << 4) >> sy;
                if (p == 0 && d->use_intrabc) {
                    int cw = n4w < 16 ? n4w : 16, chh = n4h < 16 ? n4h : 16;
                    transform_tree(d, bx + 4 * ox, by + 4 * oy, 4 * cw, 4 * chh);
                    continue;
                }
                for (int y = 0; y < n4h && y < (16 >> sy); y += stepy)
                    for (int x = 0; x < n4w && x < (16 >> sx); x += stepx)
                        transform_block(d, p, bx, by, t, x + ox, y + oy);
            }
        }
    }
}

static void decode_block(av1_dec *d, int r, int c, int bsize) {
    d->mi_row = r;
    d->mi_col = c;
    d->bsize = bsize;
    d->bw4 = 1 << av1_bw4_log2[bsize];
    d->bh4 = 1 << av1_bh4_log2[bsize];
    d->has_chroma = !((d->bh4 == 1 && (r & 1) == 0) ||
                      (d->bw4 == 1 && (c & 1) == 0));
    d->avail_u = is_inside(d, r - 1, c);
    d->avail_l = is_inside(d, r, c - 1);
    d->avail_uc = d->avail_u;
    d->avail_lc = d->avail_l;
    if (d->has_chroma) {
        if (d->bh4 == 1) d->avail_uc = is_inside(d, r - 2, c);
        if (d->bw4 == 1) d->avail_lc = is_inside(d, r, c - 2);
    }
    intra_frame_mode_info(d);
    palette_tokens(d);
    read_tx_size(d);
    if (d->skip) reset_block_context(d);
    for (int y = 0; y < d->bh4 && r + y < d->mi_rows; y++) {
        for (int x = 0; x < d->bw4 && c + x < d->mi_cols; x++) {
            av1_mi *m = mi_at(d, r + y, c + x);
            m->bsize = (uint8_t)bsize;
            m->ymode = (uint8_t)d->ymode;
            m->uvmode = (uint8_t)d->uvmode;
            m->skip = (uint8_t)d->skip;
            m->txsz = (uint8_t)d->txsz;
            m->has_mi = 1;
            m->pal_n[0] = (uint8_t)d->pal_n[0];
            m->pal_n[1] = (uint8_t)d->pal_n[1];
            memcpy(m->pal, d->pal, sizeof m->pal);
            m->is_inter = (uint8_t)d->use_intrabc;
            m->inter_txsz = d->vtx[y < 32 ? y : 31][x < 32 ? x : 31];
            m->dv[0] = (int16_t)(d->use_intrabc ? d->dv[0] : 0);
            m->dv[1] = (int16_t)(d->use_intrabc ? d->dv[1] : 0);
        }
    }
    if (d->use_intrabc) av1_predict_intrabc(d);
    residual(d);
}

static int partition_icdf_prob(const uint16_t *icdf, int e) {
    return (e > 0 ? icdf[e - 1] : 32768) - icdf[e];
}

static void decode_partition(av1_dec *d, int r, int c, int bsize) {
    if (r >= d->mi_rows || c >= d->mi_cols) return;
    int avail_u = is_inside(d, r - 1, c), avail_l = is_inside(d, r, c - 1);
    int n4 = 1 << av1_bw4_log2[bsize], half = n4 >> 1, quarter = half >> 1;
    int has_rows = r + half < d->mi_rows, has_cols = c + half < d->mi_cols;
    int part;
    if (bsize == B4X4) {
        part = PART_NONE;
    } else {
        int bsl = av1_bw4_log2[bsize];
        int above = avail_u && av1_bw4_log2[mi_at(d, r - 1, c)->bsize] < bsl;
        int left = avail_l && av1_bh4_log2[mi_at(d, r, c - 1)->bsize] < bsl;
        uint16_t *cdf = d->cdf.partition[(bsl - 1) * 4 + left * 2 + above];
        int nsym = bsl == 1 ? 4 : bsl == 5 ? 8 : 10;
        if (has_rows && has_cols) {
            part = av1_read_symbol(d, cdf, nsym);
        } else if (has_cols) {
            static const int vert_alike[] = { PART_VERT, PART_SPLIT,
                                              PART_HORZ_A, PART_VERT_A,
                                              PART_VERT_B, PART_VERT_4 };
            int psum = 0;
            for (int i = 0; i < (bsl == 5 ? 5 : 6); i++)
                psum += partition_icdf_prob(cdf, vert_alike[i]);
            uint16_t b[3] = { (uint16_t)psum, 0, 0 };
            part = av1_read_cdf_fixed(d, b, 2) ? PART_SPLIT : PART_HORZ;
        } else if (has_rows) {
            static const int horz_alike[] = { PART_HORZ, PART_SPLIT,
                                              PART_HORZ_A, PART_HORZ_B,
                                              PART_VERT_A, PART_HORZ_4 };
            int psum = 0;
            for (int i = 0; i < (bsl == 5 ? 5 : 6); i++)
                psum += partition_icdf_prob(cdf, horz_alike[i]);
            uint16_t b[3] = { (uint16_t)psum, 0, 0 };
            part = av1_read_cdf_fixed(d, b, 2) ? PART_SPLIT : PART_VERT;
        } else {
            part = PART_SPLIT;
        }
    }
    int lw = av1_bw4_log2[bsize];
    int sub_split = lw > 0 ? av1_block_from_log2(lw - 1, lw - 1) : B4X4;
    int sub_h = lw > 0 ? av1_block_from_log2(lw, lw - 1) : B4X4;
    int sub_v = lw > 0 ? av1_block_from_log2(lw - 1, lw) : B4X4;
    switch (part) {
    case PART_NONE: decode_block(d, r, c, bsize); break;
    case PART_HORZ:
        decode_block(d, r, c, sub_h);
        if (has_rows) decode_block(d, r + half, c, sub_h);
        break;
    case PART_VERT:
        decode_block(d, r, c, sub_v);
        if (has_cols) decode_block(d, r, c + half, sub_v);
        break;
    case PART_SPLIT:
        decode_partition(d, r, c, sub_split);
        decode_partition(d, r, c + half, sub_split);
        decode_partition(d, r + half, c, sub_split);
        decode_partition(d, r + half, c + half, sub_split);
        break;
    case PART_HORZ_A:
        decode_block(d, r, c, sub_split);
        decode_block(d, r, c + half, sub_split);
        decode_block(d, r + half, c, sub_h);
        break;
    case PART_HORZ_B:
        decode_block(d, r, c, sub_h);
        decode_block(d, r + half, c, sub_split);
        decode_block(d, r + half, c + half, sub_split);
        break;
    case PART_VERT_A:
        decode_block(d, r, c, sub_split);
        decode_block(d, r + half, c, sub_split);
        decode_block(d, r, c + half, sub_v);
        break;
    case PART_VERT_B:
        decode_block(d, r, c, sub_v);
        decode_block(d, r, c + half, sub_split);
        decode_block(d, r + half, c + half, sub_split);
        break;
    case PART_HORZ_4: {
        int b = av1_block_from_log2(lw, lw - 2);
        for (int i = 0; i < 4; i++)
            if (i < 3 || r + quarter * 3 < d->mi_rows)
                decode_block(d, r + quarter * i, c, b);
        break;
    }
    case PART_VERT_4: {
        int b = av1_block_from_log2(lw - 2, lw);
        for (int i = 0; i < 4; i++)
            if (i < 3 || c + quarter * 3 < d->mi_cols)
                decode_block(d, r, c + quarter * i, b);
        break;
    }
    default: av1_fail(d, "partition %d", part);
    }
}

static void clear_block_decoded(av1_dec *d, int r, int c) {
    for (int p = 0; p < 3; p++) {
        int sx = p ? d->ss_x : 0, sy = p ? d->ss_y : 0;
        int w4 = (d->tile_col1 - c) >> sx, h4 = (d->tile_row1 - r) >> sy;
        int n = d->sb128 ? 32 : 16;
        for (int y = -1; y <= (n >> sy); y++)
            for (int x = -1; x <= (n >> sx); x++)
                d->decoded[p][y + 1][x + 1] =
                    (y < 0 && x < w4) || (x < 0 && y < h4);
        d->decoded[p][(n >> sy) + 1][0] = 0;
    }
}

void av1_decode_tile(av1_dec *d) {
    av1_init_cdfs(d);
    for (int p = 0; p < 3; p++) {
        memset(d->above_level[p], 0, (size_t)(d->pw[p] >> 2) + 32);
        memset(d->above_dc[p], 0, (size_t)(d->pw[p] >> 2) + 32);
    }
    d->cur_q = d->base_q;
    int cols64 = (d->mi_cols + 15) >> 4, rows64 = (d->mi_rows + 15) >> 4;
    int sb = d->sb128 ? 32 : 16;
    for (int r = d->tile_row0; r < d->tile_row1; r += sb) {
        for (int p = 0; p < 3; p++) {
            memset(d->left_level[p], 0, (size_t)(d->ph[p] >> 2) + 32);
            memset(d->left_dc[p], 0, (size_t)(d->ph[p] >> 2) + 32);
        }
        for (int c = d->tile_col0; c < d->tile_col1; c += sb) {
            d->read_deltas = d->delta_q_present;
            for (int y = r >> 4; y < (r + sb) >> 4 && y < rows64; y++)
                for (int x = c >> 4; x < (c + sb) >> 4 && x < cols64; x++)
                    d->cdef_idx[y * cols64 + x] = -1;
            clear_block_decoded(d, r, c);
            decode_partition(d, r, c, d->sb128 ? B128X128 : B64X64);
        }
    }
}
