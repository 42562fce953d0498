/* The AV1 intra decoder's shared state (av1_obu.c: OBUs and headers;
 * av1_entropy.c: the symbol decoder and CDFs; av1_block.c: partitions,
 * modes and coefficients; av1_recon.c: dequantization, inverse
 * transforms and intra prediction; av1_filter.c: deblocking, CDEF and
 * the YUV -> RGB step). It decodes the one key frame of an AVIF still
 * image, profile 0, 8-bit 4:2:0, to the planes libaom 3.14.1 (the
 * decoder of cv2's libavif) gives. Not part of native.h's interface. */
#ifndef YOLO_TPU_TORCH_AV1_H
#define YOLO_TPU_TORCH_AV1_H

#include <setjmp.h>
#include <stddef.h>
#include <stdint.h>

enum { AV1_DC, AV1_V, AV1_H, AV1_D45, AV1_D135, AV1_D113, AV1_D157,
       AV1_D203, AV1_D67, AV1_SMOOTH, AV1_SMOOTH_V, AV1_SMOOTH_H,
       AV1_PAETH, AV1_UV_CFL };

enum { PART_NONE, PART_HORZ, PART_VERT, PART_SPLIT, PART_HORZ_A,
       PART_HORZ_B, PART_VERT_A, PART_VERT_B, PART_HORZ_4, PART_VERT_4 };

/* block sizes in libaom's order (BLOCK_SIZES_ALL) */
enum { B4X4, B4X8, B8X4, B8X8, B8X16, B16X8, B16X16, B16X32, B32X16,
       B32X32, B32X64, B64X32, B64X64, B64X128, B128X64, B128X128, B4X16,
       B16X4, B8X32, B32X8, B16X64, B64X16, NBLOCKS };

/* transform sizes in libaom's order (TX_SIZES_ALL) */
enum { TX4X4, TX8X8, TX16X16, TX32X32, TX64X64, TX4X8, TX8X4, TX8X16,
       TX16X8, TX16X32, TX32X16, TX32X64, TX64X32, TX4X16, TX16X4, TX8X32,
       TX32X8, TX16X64, TX64X16, NTX };

/* transform types */
enum { DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT, DCT_FLIPADST,
       FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST, IDTX, V_DCT, H_DCT,
       V_ADST, H_ADST, V_FLIPADST, H_FLIPADST };

/* the adaptive CDFs of one tile (coefficient CDFs for the frame's
 * quantizer context), libaom's inverted layout */
typedef struct {
    uint16_t kf_y[5][5][14], uv[2][13][15], partition[20][11];
    uint16_t ext_tx[3][4][13][17], skip[3][3], fi_mode[6], fi[22][3];
    uint16_t angle[8][8], tx_size[4][3][4], delta_q[5], cfl_sign[9];
    uint16_t intrabc[3], txfm_split[21][3], inter_ext_tx[4][4][17];
    struct {
        uint16_t joints[5];
        struct {
            uint16_t classes[12], class0_fp[2][5], fp[5], sign[3];
            uint16_t class0_hp[3], hp[3], class0[3], bits[10][3];
        } comp[2];
    } dv;
    uint16_t cfl_alpha[6][17], pal_y_size[7][8], pal_uv_size[7][8];
    uint16_t pal_y_mode[7][3][3], pal_uv_mode[2][3], pal_y_color[7][5][9];
    uint16_t pal_uv_color[7][5][9];
    uint16_t txb_skip[5][13][3], eob_extra[5][2][9][3], dc_sign[2][3][3];
    uint16_t eob16[2][2][6], eob32[2][2][7], eob64[2][2][8];
    uint16_t eob128[2][2][9], eob256[2][2][10], eob512[2][2][11];
    uint16_t eob1024[2][2][12], base_eob[5][2][4][4], base[5][2][42][5];
    uint16_t br[5][2][21][5];
} av1_cdfs;

typedef struct {
    const uint8_t *buf;
    size_t size, bitpos;     /* the tile's bytes, the next byte to read */
    uint64_t win;            /* bits read ahead, wbits of them unused */
    int wbits;
    uint32_t value, range;
    int maxbits, adapt;
} av1_symdec;

/* per 4x4 luma unit (mode info) */
typedef struct {
    uint8_t bsize, ymode, uvmode, skip, txsz, has_mi;
    uint8_t pal_n[2], pal[2][8];   /* palette sizes and colours: Y, U */
    uint8_t is_inter;              /* intra block copy */
    uint8_t inter_txsz;            /* InterTxSizes: the unit's tx size */
    int16_t dv[2];                 /* its displacement (row, col), 1/8 */
} av1_mi;

typedef struct {
    jmp_buf jmp;
    char *err;
    size_t errlen;

    /* sequence header */
    int reduced, decoder_model, equal_interval;
    int buffer_delay_len, removal_len, presentation_len, op_count;
    int op_idc[32], op_model[32];
    int frame_w_bits, frame_h_bits, max_w, max_h, frame_ids, id_len;
    int sb128, filter_intra, edge_filter, order_hint_bits;
    int force_sct, force_imv, superres, enable_cdef, enable_lr;
    int ss_x, ss_y, color_desc, cp, tc, mc, full_range;
    int sep_uv_dq, film_grain;
    int have_seq;

    /* frame header */
    int w, h, mi_cols, mi_rows, sct, disable_cdf_update, allow_intrabc;
    int base_q, dq_ydc, dq_udc, dq_uac, dq_vdc, dq_vac, using_qm, qm[3];
    int delta_q_present, delta_q_res, lossless, tx_select, reduced_tx;
    int lf_level[4], lf_sharp, lf_delta_enabled, lf_ref_intra;
    int cdef_damping, cdef_bits, cdef_y_pri[8], cdef_y_sec[8];
    int cdef_uv_pri[8], cdef_uv_sec[8];
    int tile_cols, tile_rows, tile_cols_log2, tile_rows_log2;
    int tile_size_bytes, col_starts[65], row_starts[65];
    int tiles_done, have_frame;

    /* tile state */
    av1_cdfs cdf;
    av1_symdec sd;
    int tile_row0, tile_row1, tile_col0, tile_col1, cur_q;

    /* block state */
    int mi_row, mi_col, bsize, bw4, bh4, has_chroma;
    int avail_u, avail_l, avail_uc, avail_lc, skip, ymode, uvmode;
    int angle_y, angle_uv, use_fi, fi_mode, cfl_u, cfl_v, txsz;
    int max_luma_w, max_luma_h, read_deltas, cdef_dir;
    int use_intrabc, dv[2];
    uint8_t vtx[32][32];           /* the block's InterTxSizes, by mi */
    int pal_n[2];                  /* palette sizes: Y, UV */
    uint8_t pal[3][8];             /* palette colours: Y, U, V */
    uint8_t cmap[2][64][64];       /* colour index maps: Y, UV */

    /* frame arrays */
    uint8_t *plane[3];
    int stride[3], pw[3], ph[3];   /* allocated (mi-aligned) sizes */
    av1_mi *mi;                    /* mi_rows x mi_cols */
    uint8_t *lf_txsz[3];           /* per 4x4 unit of each plane */
    uint8_t *tx_type;              /* per 4x4 luma unit */
    int8_t *cdef_idx;              /* per 64x64 */
    uint8_t *above_level[3], *above_dc[3], *left_level[3], *left_dc[3];
    uint8_t decoded[3][34][34];    /* the superblock's, offset by 1 */
    int32_t coef[64 * 64];         /* the transform block's levels */
    int32_t deq[32 * 32];          /* ... dequantized */
    int32_t tbuf[64 * 64];         /* the row transforms' output */
    int fipred[64][64];            /* filter intra's prediction */
} av1_dec;

void av1_fail(av1_dec *d, const char *fmt, ...)
#if defined(__GNUC__)
    __attribute__((noreturn, format(printf, 2, 3)))
#endif
    ;

/* av1_entropy.c */
void av1_init_cdfs(av1_dec *d);
void av1_sym_init(av1_dec *d, const uint8_t *buf, size_t size);
int av1_read_symbol(av1_dec *d, uint16_t *icdf, int nsyms);
int av1_read_cdf_fixed(av1_dec *d, const uint16_t *icdf, int nsyms);
int av1_read_bool(av1_dec *d);
int av1_read_literal(av1_dec *d, int n);

/* av1_block.c */
void av1_decode_tile(av1_dec *d);

/* av1_recon.c */
void av1_predict_intra(av1_dec *d, int plane, int x, int y, int have_left,
                       int have_above, int have_ar, int have_bl, int mode,
                       int log2w, int log2h);
void av1_predict_cfl(av1_dec *d, int plane, int x, int y, int txsz);
void av1_predict_palette(av1_dec *d, int plane, int x, int y, int bx,
                         int by, int txsz);
void av1_predict_intrabc(av1_dec *d);
void av1_reconstruct(av1_dec *d, int plane, int x, int y, int txsz,
                     int tx_type, int eob);

/* av1_filter.c */
void av1_loop_filter(av1_dec *d);
void av1_cdef(av1_dec *d);

/* shared size helpers (av1_block.c) */
extern const uint8_t av1_bw4_log2[NBLOCKS], av1_bh4_log2[NBLOCKS];
extern const uint8_t av1_tx_w_log2[NTX], av1_tx_h_log2[NTX];
int av1_tx_from_log2(int log2w, int log2h);
int av1_block_from_log2(int log2w, int log2h);
int av1_plane_bsize(const av1_dec *d, int bsize, int plane);
int av1_uv_txsz(const av1_dec *d, int bsize);

static inline int av1_clip3(int lo, int hi, int v) {
    return v < lo ? lo : v > hi ? hi : v;
}

#endif
