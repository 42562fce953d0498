/* AV1 OBUs for the port's AVIF decoder: OBU headers and leb128 sizes,
 * the sequence header, the uncompressed header of one key frame, tile
 * info and tile groups; then the loop filter and CDEF over the frame.
 *
 *   yolo_av1_decode(obus, len, &out, info, err, errlen) decodes an AVIF
 *   item's OBUs to the cropped Y, U and V planes (one malloc'd block:
 *   Y w*h, then U and V cw*ch each); info receives [w, h, cw, ch,
 *   colour_description_present, primaries, transfer, matrix,
 *   full_range].
 *
 * What this decoder leaves out raises naming it: profiles 1-2, 10/12-bit,
 * monochrome, 4:4:4 / 4:2:2, superres, loop
 * restoration, film grain, segmentation, delta loop filter, lossless
 * frames and frames other than a shown key frame. Every length read from the data is
 * bounded by the data. Plain C11, no state between calls. */

#include <stdarg.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "av1.h"
#include "native.h"

void av1_fail(av1_dec *d, const char *fmt, ...) {
    va_list ap;
    va_start(ap, fmt);
    int n = snprintf(d->err, d->errlen, "AV1: ");
    if (n >= 0 && (size_t)n < d->errlen)
        vsnprintf(d->err + n, d->errlen - (size_t)n, fmt, ap);
    va_end(ap);
    longjmp(d->jmp, 1);
}

typedef struct {
    const uint8_t *buf;
    size_t len, pos;   /* pos in bits */
    av1_dec *d;
} bits;

static unsigned f(bits *b, int n) {
    unsigned v = 0;
    if (b->pos + (size_t)n > b->len * 8)
        av1_fail(b->d, "a header is cut short");
    for (int i = 0; i < n; i++, b->pos++)
        v = (v << 1) | ((b->buf[b->pos >> 3] >> (7 - (b->pos & 7))) & 1);
    return v;
}

static int su(bits *b, int n) {
    int v = (int)f(b, n);
    int sign = 1 << (n - 1);
    return (v & sign) ? v - 2 * sign : v;
}

static unsigned uvlc(bits *b) {
    int zeros = 0;
    while (!f(b, 1)) {
        if (++zeros >= 32) av1_fail(b->d, "a uvlc code is too long");
    }
    return zeros ? f(b, zeros) + (1u << zeros) - 1 : 0;
}

static int ns(bits *b, int n) {
    int w = 0;
    for (int x = n; x; x >>= 1) w++;
    int m = (1 << w) - n;
    int v = (int)f(b, w - 1);
    if (v < m) return v;
    return (v << 1) - m + (int)f(b, 1);
}

static int tile_log2(int blk, int target) {
    int k = 0;
    while ((blk << k) < target) k++;
    return k;
}

/* --- sequence header ---------------------------------------------------- */

static void sequence_header(av1_dec *d, bits *b) {
    int profile = (int)f(b, 3);
    if (profile == 1) av1_fail(d, "4:4:4 (profile 1; only 8-bit 4:2:0 is read)");
    if (profile != 0)
        av1_fail(d, "4:2:2 or 12-bit (profile %d; only 8-bit 4:2:0 is read)",
                 profile);
    f(b, 1);                                     /* still_picture */
    d->reduced = (int)f(b, 1);
    d->decoder_model = 0;
    d->op_count = 1;
    d->op_idc[0] = 0;
    d->op_model[0] = 0;
    if (d->reduced) {
        f(b, 5);                                  /* seq_level_idx[0] */
    } else {
        if (f(b, 1)) {                          /* timing_info_present */
            f(b, 32);
            f(b, 32);
            d->equal_interval = (int)f(b, 1);
            if (d->equal_interval) uvlc(b);
            d->decoder_model = (int)f(b, 1);
            if (d->decoder_model) {
                d->buffer_delay_len = (int)f(b, 5) + 1;
                f(b, 32);
                d->removal_len = (int)f(b, 5) + 1;
                d->presentation_len = (int)f(b, 5) + 1;
            }
        }
        int initial_delay = (int)f(b, 1);
        d->op_count = (int)f(b, 5) + 1;
        for (int i = 0; i < d->op_count; i++) {
            d->op_idc[i] = (int)f(b, 12);
            int level = (int)f(b, 5);
            if (level > 7) f(b, 1);
            d->op_model[i] = 0;
            if (d->decoder_model) {
                d->op_model[i] = (int)f(b, 1);
                if (d->op_model[i]) {
                    f(b, d->buffer_delay_len);
                    f(b, d->buffer_delay_len);
                    f(b, 1);
                }
            }
            if (initial_delay && f(b, 1)) f(b, 4);
        }
    }
    d->frame_w_bits = (int)f(b, 4) + 1;
    d->frame_h_bits = (int)f(b, 4) + 1;
    d->max_w = (int)f(b, d->frame_w_bits) + 1;
    d->max_h = (int)f(b, d->frame_h_bits) + 1;
    d->frame_ids = d->reduced ? 0 : (int)f(b, 1);
    if (d->frame_ids) {
        int delta = (int)f(b, 4) + 2;
        d->id_len = (int)f(b, 3) + 1 + delta;
    }
    d->sb128 = (int)f(b, 1);
    d->filter_intra = (int)f(b, 1);
    d->edge_filter = (int)f(b, 1);
    d->order_hint_bits = 0;
    d->force_sct = 2;
    d->force_imv = 2;
    if (!d->reduced) {
        f(b, 4);   /* interintra, masked, warped, dual filter */
        int order_hint = (int)f(b, 1);
        if (order_hint) f(b, 2);                 /* jnt_comp, ref_frame_mvs */
        if (f(b, 1))
            d->force_sct = 2;
        else
            d->force_sct = (int)f(b, 1);
        if (d->force_sct > 0) {
            if (f(b, 1))
                d->force_imv = 2;
            else
                d->force_imv = (int)f(b, 1);
        }
        if (order_hint) d->order_hint_bits = (int)f(b, 3) + 1;
    }
    d->superres = (int)f(b, 1);
    d->enable_cdef = (int)f(b, 1);
    d->enable_lr = (int)f(b, 1);
    /* color_config */
    if (f(b, 1)) av1_fail(d, "10/12-bit samples (only 8-bit is read)");
    if (f(b, 1)) av1_fail(d, "monochrome (only 4:2:0 is read)");
    d->color_desc = (int)f(b, 1);
    d->cp = d->tc = d->mc = 2;
    if (d->color_desc) {
        d->cp = (int)f(b, 8);
        d->tc = (int)f(b, 8);
        d->mc = (int)f(b, 8);
    }
    if (d->cp == 1 && d->tc == 13 && d->mc == 0)
        av1_fail(d, "4:4:4 (sRGB identity matrix; only 4:2:0 is read)");
    d->full_range = (int)f(b, 1);
    d->ss_x = d->ss_y = 1;                        /* profile 0 */
    f(b, 2);                                     /* chroma_sample_position */
    d->sep_uv_dq = (int)f(b, 1);
    d->film_grain = (int)f(b, 1);
    d->have_seq = 1;
}

/* --- frame header ------------------------------------------------------- */

static int delta_q(bits *b) { return f(b, 1) ? su(b, 7) : 0; }

static void tile_info(av1_dec *d, bits *b) {
    int sh = d->sb128 ? 5 : 4, sbsz = sh + 2;
    int sb_cols = (d->mi_cols + (1 << sh) - 1) >> sh;
    int sb_rows = (d->mi_rows + (1 << sh) - 1) >> sh;
    int max_w_sb = 4096 >> sbsz, max_area_sb = (4096 * 2304) >> (2 * sbsz);
    int min_log2_cols = tile_log2(max_w_sb, sb_cols);
    int max_log2_cols = tile_log2(1, sb_cols < 64 ? sb_cols : 64);
    int max_log2_rows = tile_log2(1, sb_rows < 64 ? sb_rows : 64);
    int a = tile_log2(max_area_sb, sb_rows * sb_cols);
    int min_log2_tiles = min_log2_cols > a ? min_log2_cols : a;
    int i;
    if (f(b, 1)) {                                /* uniform */
        d->tile_cols_log2 = min_log2_cols;
        while (d->tile_cols_log2 < max_log2_cols && f(b, 1))
            d->tile_cols_log2++;
        int wsb = (sb_cols + (1 << d->tile_cols_log2) - 1) >>
                  d->tile_cols_log2;
        i = 0;
        for (int s = 0; s < sb_cols; s += wsb) d->col_starts[i++] = s << sh;
        d->col_starts[i] = d->mi_cols;
        d->tile_cols = i;
        int min_log2_rows = min_log2_tiles - d->tile_cols_log2;
        d->tile_rows_log2 = min_log2_rows > 0 ? min_log2_rows : 0;
        while (d->tile_rows_log2 < max_log2_rows && f(b, 1))
            d->tile_rows_log2++;
        int hsb = (sb_rows + (1 << d->tile_rows_log2) - 1) >>
                  d->tile_rows_log2;
        i = 0;
        for (int s = 0; s < sb_rows; s += hsb) d->row_starts[i++] = s << sh;
        d->row_starts[i] = d->mi_rows;
        d->tile_rows = i;
    } else {
        int widest = 0, s = 0;
        for (i = 0; s < sb_cols; i++) {
            if (i >= 64) av1_fail(d, "more than 64 tile columns");
            d->col_starts[i] = s << sh;
            int mw = sb_cols - s < max_w_sb ? sb_cols - s : max_w_sb;
            int size = ns(b, mw) + 1;
            if (size > widest) widest = size;
            s += size;
        }
        d->col_starts[i] = d->mi_cols;
        d->tile_cols = i;
        d->tile_cols_log2 = tile_log2(1, d->tile_cols);
        int area = min_log2_tiles > 0
                       ? (sb_rows * sb_cols) >> (min_log2_tiles + 1)
                       : sb_rows * sb_cols;
        int max_h_sb = area / widest > 1 ? area / widest : 1;
        s = 0;
        for (i = 0; s < sb_rows; i++) {
            if (i >= 64) av1_fail(d, "more than 64 tile rows");
            d->row_starts[i] = s << sh;
            int mh = sb_rows - s < max_h_sb ? sb_rows - s : max_h_sb;
            s += ns(b, mh) + 1;
        }
        d->row_starts[i] = d->mi_rows;
        d->tile_rows = i;
        d->tile_rows_log2 = tile_log2(1, d->tile_rows);
    }
    d->tile_size_bytes = 4;
    if (d->tile_cols_log2 > 0 || d->tile_rows_log2 > 0) {
        f(b, d->tile_rows_log2 + d->tile_cols_log2);
        d->tile_size_bytes = (int)f(b, 2) + 1;
    }
}

static void *zalloc(av1_dec *d, size_t n) {
    void *p = calloc(1, n ? n : 1);
    if (!p) av1_fail(d, "out of memory (%zu bytes)", n);
    return p;
}

static void alloc_frame(av1_dec *d) {
    for (int p = 0; p < 3; p++) {
        int sx = p ? d->ss_x : 0, sy = p ? d->ss_y : 0;
        d->pw[p] = (d->mi_cols * 4) >> sx;
        d->ph[p] = (d->mi_rows * 4) >> sy;
        /* a transform block may run 64 samples past the mi-aligned edge */
        d->stride[p] = d->pw[p] + 80;
        d->plane[p] = zalloc(d, (size_t)d->stride[p] * (d->ph[p] + 72));
        int n4 = (d->pw[p] >> 2) + 1, m4 = (d->ph[p] >> 2) + 1;
        d->lf_txsz[p] = zalloc(d, (size_t)n4 * m4);
        d->above_level[p] = zalloc(d, (size_t)n4 + 32);
        d->above_dc[p] = zalloc(d, (size_t)n4 + 32);
        d->left_level[p] = zalloc(d, (size_t)m4 + 32);
        d->left_dc[p] = zalloc(d, (size_t)m4 + 32);
    }
    d->mi = zalloc(d, sizeof(av1_mi) * (size_t)d->mi_rows * d->mi_cols);
    d->tx_type = zalloc(d, (size_t)d->mi_rows * d->mi_cols);
    d->cdef_idx = zalloc(d, (size_t)((d->mi_rows + 15) >> 4) *
                                ((d->mi_cols + 15) >> 4));
}

static void frame_header(av1_dec *d, bits *b, int temporal_id,
                         int spatial_id) {
    if (!d->have_seq) av1_fail(d, "a frame header before the sequence header");
    int show = 1;
    if (!d->reduced) {
        if (f(b, 1)) av1_fail(d, "show_existing_frame (not a still image)");
        int type = (int)f(b, 2);
        if (type != 0)
            av1_fail(d, "a frame of type %d (only a key frame is read)",
                     type);
        show = (int)f(b, 1);
        if (show && d->decoder_model && !d->equal_interval)
            f(b, d->presentation_len);
        if (!show) f(b, 1);                      /* showable_frame */
        if (!show) f(b, 1);                      /* error_resilient_mode */
    }
    d->disable_cdf_update = (int)f(b, 1);
    d->sct = d->force_sct == 2 ? (int)f(b, 1) : d->force_sct;
    if (d->sct && d->force_imv == 2) f(b, 1);
    if (d->frame_ids) f(b, d->id_len);
    int override = d->reduced ? 0 : (int)f(b, 1);
    f(b, d->order_hint_bits);
    if (d->decoder_model && f(b, 1)) {
        for (int op = 0; op < d->op_count; op++) {
            if (!d->op_model[op]) continue;
            int idc = d->op_idc[op];
            if (idc == 0 || (((idc >> temporal_id) & 1) &&
                             ((idc >> (spatial_id + 8)) & 1)))
                f(b, d->removal_len);
        }
    }
    if (!show) {
        if (f(b, 8) != 0xff)
            av1_fail(d, "a hidden key frame (not a still image)");
    }
    if (override) {
        d->w = (int)f(b, d->frame_w_bits) + 1;
        d->h = (int)f(b, d->frame_h_bits) + 1;
    } else {
        d->w = d->max_w;
        d->h = d->max_h;
    }
    /* libavif's default imageSizeLimit and imageDimensionLimit: the
     * planes are allocated before any tile is read */
    if ((int64_t)d->w * d->h > 16384 * 16384 || d->w > 32768 || d->h > 32768)
        av1_fail(d, "a %dx%d frame is past libavif's size limit", d->w, d->h);
    if (d->superres && f(b, 1)) av1_fail(d, "superres");
    d->mi_cols = 2 * ((d->w + 7) >> 3);
    d->mi_rows = 2 * ((d->h + 7) >> 3);
    if (f(b, 1)) {                               /* render size */
        f(b, 16);
        f(b, 16);
    }
    d->allow_intrabc = d->sct ? (int)f(b, 1) : 0;
    if (!d->reduced && !d->disable_cdf_update) f(b, 1);
    tile_info(d, b);
    /* quantization_params */
    d->base_q = (int)f(b, 8);
    d->dq_ydc = delta_q(b);
    int diff_uv = d->sep_uv_dq ? (int)f(b, 1) : 0;
    d->dq_udc = delta_q(b);
    d->dq_uac = delta_q(b);
    d->dq_vdc = diff_uv ? delta_q(b) : d->dq_udc;
    d->dq_vac = diff_uv ? delta_q(b) : d->dq_uac;
    d->using_qm = (int)f(b, 1);
    if (d->using_qm) {
        d->qm[0] = (int)f(b, 4);
        d->qm[1] = (int)f(b, 4);
        d->qm[2] = d->sep_uv_dq ? (int)f(b, 4) : d->qm[1];
    }
    if (f(b, 1)) av1_fail(d, "segmentation");
    d->delta_q_present = 0;
    d->delta_q_res = 0;
    if (d->base_q > 0) {
        d->delta_q_present = (int)f(b, 1);
        if (d->delta_q_present) d->delta_q_res = (int)f(b, 2);
    }
    if (d->delta_q_present && !d->allow_intrabc && f(b, 1))
        av1_fail(d, "delta loop filter levels");
    d->lossless = d->base_q == 0 && !d->dq_ydc && !d->dq_udc &&
                  !d->dq_uac && !d->dq_vdc && !d->dq_vac;
    if (d->lossless) av1_fail(d, "a lossless frame");
    /* loop_filter_params: none with intra block copy (nor CDEF nor loop
     * restoration) */
    d->lf_level[0] = d->lf_level[1] = d->lf_level[2] = d->lf_level[3] = 0;
    d->lf_sharp = d->lf_delta_enabled = 0;
    if (!d->allow_intrabc) {
        d->lf_level[0] = (int)f(b, 6);
        d->lf_level[1] = (int)f(b, 6);
        if (d->lf_level[0] || d->lf_level[1]) {
            d->lf_level[2] = (int)f(b, 6);
            d->lf_level[3] = (int)f(b, 6);
        }
        d->lf_sharp = (int)f(b, 3);
        d->lf_delta_enabled = (int)f(b, 1);
    }
    d->lf_ref_intra = 1;   /* setup_past_independence's ref_deltas[INTRA] */
    if (d->lf_delta_enabled && f(b, 1)) {
        for (int i = 0; i < 8; i++) {
            if (f(b, 1)) {
                int v = su(b, 7);
                if (i == 0) d->lf_ref_intra = v;
            }
        }
        for (int i = 0; i < 2; i++) {
            if (f(b, 1)) su(b, 7);
        }
    }
    /* cdef_params */
    d->cdef_bits = 0;
    d->cdef_y_pri[0] = d->cdef_y_sec[0] = 0;
    d->cdef_uv_pri[0] = d->cdef_uv_sec[0] = 0;
    d->cdef_damping = 3;
    if (d->allow_intrabc) d->enable_cdef = 0;
    if (d->enable_cdef) {
        d->cdef_damping = (int)f(b, 2) + 3;
        d->cdef_bits = (int)f(b, 2);
        for (int i = 0; i < (1 << d->cdef_bits); i++) {
            d->cdef_y_pri[i] = (int)f(b, 4);
            d->cdef_y_sec[i] = (int)f(b, 2);
            if (d->cdef_y_sec[i] == 3) d->cdef_y_sec[i]++;
            d->cdef_uv_pri[i] = (int)f(b, 4);
            d->cdef_uv_sec[i] = (int)f(b, 2);
            if (d->cdef_uv_sec[i] == 3) d->cdef_uv_sec[i]++;
        }
    }
    /* lr_params */
    if (d->enable_lr && !d->allow_intrabc) {
        for (int p = 0; p < 3; p++) {
            if (f(b, 2)) av1_fail(d, "loop restoration");
        }
    }
    d->tx_select = (int)f(b, 1);
    d->reduced_tx = (int)f(b, 1);
    if (d->film_grain && f(b, 1)) av1_fail(d, "film grain");
    alloc_frame(d);
    d->have_frame = 1;
    d->tiles_done = 0;
}

/* --- tiles -------------------------------------------------------------- */

static void tile_group(av1_dec *d, const uint8_t *p, size_t size) {
    bits b = { p, size, 0, d };
    int ntiles = d->tile_cols * d->tile_rows;
    int start = 0, end = ntiles - 1;
    if (ntiles > 1 && f(&b, 1)) {
        int n = d->tile_cols_log2 + d->tile_rows_log2;
        start = (int)f(&b, n);
        end = (int)f(&b, n);
    }
    if (start != d->tiles_done || end < start || end >= ntiles)
        av1_fail(d, "tile group %d-%d out of order", start, end);
    size_t pos = (b.pos + 7) >> 3;
    for (int t = start; t <= end; t++) {
        size_t tsize;
        if (t == end) {
            tsize = size - pos;
        } else {
            if (pos + (size_t)d->tile_size_bytes > size)
                av1_fail(d, "a tile size is cut short");
            tsize = 0;
            for (int i = 0; i < d->tile_size_bytes; i++)
                tsize |= (size_t)p[pos + i] << (8 * i);
            tsize += 1;
            pos += (size_t)d->tile_size_bytes;
            if (tsize > size - pos) av1_fail(d, "a tile runs past its data");
        }
        int r = t / d->tile_cols, c = t % d->tile_cols;
        d->tile_row0 = d->row_starts[r];
        d->tile_row1 = d->row_starts[r + 1];
        d->tile_col0 = d->col_starts[c];
        d->tile_col1 = d->col_starts[c + 1];
        av1_sym_init(d, p + pos, tsize);
        av1_decode_tile(d);
        pos += tsize;
    }
    d->tiles_done = end + 1;
}

static size_t leb128(av1_dec *d, const uint8_t *p, size_t len, size_t *pos) {
    uint64_t v = 0;
    for (int i = 0; i < 8; i++) {
        if (*pos >= len) av1_fail(d, "an OBU size is cut short");
        uint8_t byte = p[(*pos)++];
        v |= (uint64_t)(byte & 0x7f) << (7 * i);
        if (!(byte & 0x80)) return (size_t)v;
    }
    av1_fail(d, "an OBU size of more than 8 bytes");
}

static void decode(av1_dec *d, const uint8_t *p, size_t len) {
    size_t pos = 0;
    while (pos < len) {
        uint8_t h = p[pos++];
        int type = (h >> 3) & 15, ext = (h >> 2) & 1, has_size = (h >> 1) & 1;
        int tid = 0, sid = 0;
        if (h & 0x80) av1_fail(d, "an OBU's forbidden bit is set");
        if (ext) {
            if (pos >= len) av1_fail(d, "an OBU header is cut short");
            tid = p[pos] >> 5;
            sid = (p[pos] >> 3) & 3;
            pos++;
        }
        size_t size = has_size ? leb128(d, p, len, &pos) : len - pos;
        if (size > len - pos) av1_fail(d, "an OBU runs past the data");
        const uint8_t *q = p + pos;
        int done = d->have_frame &&
                   d->tiles_done == d->tile_cols * d->tile_rows;
        if (type == 1 && !d->have_frame) {
            bits b = { q, size, 0, d };
            sequence_header(d, &b);
        } else if ((type == 3 || type == 6) && !d->have_frame) {
            bits b = { q, size, 0, d };
            frame_header(d, &b, tid, sid);
            if (type == 6) {
                size_t hdr = (b.pos + 7) >> 3;
                tile_group(d, q + hdr, size - hdr);
            }
        } else if (type == 4 && d->have_frame && !done) {
            tile_group(d, q, size);
        }
        pos += size;
    }
    if (!d->have_frame) av1_fail(d, "no frame in the data");
    if (d->tiles_done != d->tile_cols * d->tile_rows)
        av1_fail(d, "the frame's tiles are cut short (%d of %d)",
                 d->tiles_done, d->tile_cols * d->tile_rows);
    av1_loop_filter(d);
    av1_cdef(d);
}

static void release(av1_dec *d) {
    for (int p = 0; p < 3; p++) {
        free(d->plane[p]);
        free(d->lf_txsz[p]);
        free(d->above_level[p]);
        free(d->above_dc[p]);
        free(d->left_level[p]);
        free(d->left_dc[p]);
    }
    free(d->mi);
    free(d->tx_type);
    free(d->cdef_idx);
}

int yolo_av1_decode(const uint8_t *data, size_t len, uint8_t **out,
                    int32_t *info, char *err, size_t errlen) {
    av1_dec *d = calloc(1, sizeof *d);
    *out = NULL;
    if (!d) {
        snprintf(err, errlen, "AV1: out of memory");
        return -1;
    }
    d->err = err;
    d->errlen = errlen;
    int rc = 0;
    if (setjmp(d->jmp)) {
        rc = -1;
    } else {
        decode(d, data, len);
        int cw = (d->w + d->ss_x) >> d->ss_x, ch = (d->h + d->ss_y) >> d->ss_y;
        size_t n = (size_t)d->w * d->h + 2 * (size_t)cw * ch;
        uint8_t *o = malloc(n);
        if (!o) av1_fail(d, "out of memory (%zu bytes)", n);
        uint8_t *w = o;
        for (int p = 0; p < 3; p++) {
            int pw = p ? cw : d->w, ph = p ? ch : d->h;
            for (int y = 0; y < ph; y++, w += pw)
                memcpy(w, d->plane[p] + (size_t)y * d->stride[p], (size_t)pw);
        }
        *out = o;
        int32_t v[9] = { d->w, d->h, cw, ch, d->color_desc, d->cp, d->tc,
                         d->mc, d->full_range };
        memcpy(info, v, sizeof v);
    }
    release(d);
    free(d);
    return rc;
}
