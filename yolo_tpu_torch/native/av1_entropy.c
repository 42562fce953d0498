/* AV1's symbol decoder and its CDFs: the arithmetic decoder of the
 * specification (8.2), CDFs adapted after each symbol unless the frame
 * disables it (libaom's update_cdf: rate 4-6 by the row's counter and
 * size), the literal bits, and each tile's CDFs reset to the defaults
 * (the coefficient ones by base_q_idx's context).
 * Plain C11. */

#include <string.h>

#include "av1.h"
#include "av1_tables.h"

#define EC_PROB_SHIFT 6
#define EC_MIN_PROB 4

/* the next n <= 16 bits of the tile, zeros past its end */
static unsigned get_bits(av1_symdec *s, int n) {
    while (s->wbits < n) {
        s->win = (s->win << 8) | (s->bitpos < s->size ? s->buf[s->bitpos] : 0);
        s->bitpos++;
        s->wbits += 8;
    }
    s->wbits -= n;
    return (unsigned)(s->win >> s->wbits) & ((1u << n) - 1);
}

void av1_sym_init(av1_dec *d, const uint8_t *buf, size_t size) {
    av1_symdec *s = &d->sd;
    s->buf = buf;
    s->size = size;
    s->bitpos = 0;
    s->win = 0;
    s->wbits = 0;
    int nbits = size * 8 < 15 ? (int)size * 8 : 15;
    unsigned b = get_bits(s, nbits) << (15 - nbits);
    s->value = ((1u << 15) - 1) ^ b;
    s->range = 1u << 15;
    s->maxbits = (int)(8 * size) - 15;
    s->adapt = !d->disable_cdf_update;
}

static void renormalize(av1_symdec *s) {
    int bits = 15;
    for (unsigned r = s->range; r > 1; r >>= 1) bits--;
    s->range <<= bits;
    int nbits = bits < (s->maxbits > 0 ? s->maxbits : 0)
                    ? bits
                    : (s->maxbits > 0 ? s->maxbits : 0);
    unsigned data = get_bits(s, nbits) << (bits - nbits);
    s->value = data ^ (((s->value + 1) << bits) - 1);
    s->maxbits -= bits;
}

static int decode(av1_symdec *s, const uint16_t *icdf, int n) {
    unsigned cur = s->range, prev;
    int sym = -1;
    do {
        sym++;
        prev = cur;
        cur = ((s->range >> 8) * (unsigned)(icdf[sym] >> EC_PROB_SHIFT) >>
               (7 - EC_PROB_SHIFT)) +
              EC_MIN_PROB * (unsigned)(n - sym - 1);
    } while (s->value < cur);
    s->range = prev - cur;
    s->value -= cur;
    renormalize(s);
    return sym;
}

int av1_read_symbol(av1_dec *d, uint16_t *icdf, int n) {
    int sym = decode(&d->sd, icdf, n);
    if (d->sd.adapt) {
        int count = icdf[n];
        int rate = 3 + (count > 15) + (count > 31) + (n > 3 ? 2 : 1);
        int tmp = 32768;
        for (int i = 0; i < n - 1; i++) {
            if (i == sym) tmp = 0;
            if (tmp < icdf[i])
                icdf[i] -= (uint16_t)((icdf[i] - tmp) >> rate);
            else
                icdf[i] += (uint16_t)((tmp - icdf[i]) >> rate);
        }
        icdf[n] += count < 32;
    }
    return sym;
}

int av1_read_cdf_fixed(av1_dec *d, const uint16_t *icdf, int n) {
    return decode(&d->sd, icdf, n);
}

int av1_read_bool(av1_dec *d) {
    static const uint16_t half[2] = { 16384, 0 };
    return decode(&d->sd, half, 2);
}

int av1_read_literal(av1_dec *d, int n) {
    int v = 0;
    for (int i = 0; i < n; i++) v = 2 * v + av1_read_bool(d);
    return v;
}

void av1_init_cdfs(av1_dec *d) {
    av1_cdfs *c = &d->cdf;
    int q = d->base_q <= 20 ? 0 : d->base_q <= 60 ? 1 : d->base_q <= 120 ? 2
                                                                         : 3;
#define COPY(dst, src) memcpy(c->dst, src, sizeof c->dst)
    COPY(kf_y, av1_kf_y_mode_cdf);
    COPY(uv, av1_uv_mode_cdf);
    COPY(partition, av1_partition_cdf);
    COPY(ext_tx, av1_intra_ext_tx_cdf);
    COPY(skip, av1_skip_cdf);
    COPY(fi_mode, av1_filter_intra_mode_cdf);
    COPY(fi, av1_filter_intra_cdf);
    COPY(angle, av1_angle_delta_cdf);
    COPY(tx_size, av1_tx_size_cdf);
    COPY(delta_q, av1_delta_q_cdf);
    COPY(cfl_sign, av1_cfl_sign_cdf);
    COPY(cfl_alpha, av1_cfl_alpha_cdf);
    COPY(intrabc, av1_intrabc_cdf);
    COPY(txfm_split, av1_txfm_partition_cdf);
    COPY(inter_ext_tx, av1_inter_ext_tx_cdf);
    _Static_assert(sizeof c->dv == sizeof av1_nmv_cdf, "the MV context");
    memcpy(&c->dv, av1_nmv_cdf, sizeof c->dv);
    COPY(pal_y_size, av1_palette_y_size_cdf);
    COPY(pal_uv_size, av1_palette_uv_size_cdf);
    COPY(pal_y_mode, av1_palette_y_mode_cdf);
    COPY(pal_uv_mode, av1_palette_uv_mode_cdf);
    COPY(pal_y_color, av1_palette_y_color_cdf);
    COPY(pal_uv_color, av1_palette_uv_color_cdf);
    COPY(txb_skip, av1_txb_skip_cdf[q]);
    COPY(eob_extra, av1_eob_extra_cdf[q]);
    COPY(dc_sign, av1_dc_sign_cdf[q]);
    COPY(eob16, av1_eob_multi16_cdf[q]);
    COPY(eob32, av1_eob_multi32_cdf[q]);
    COPY(eob64, av1_eob_multi64_cdf[q]);
    COPY(eob128, av1_eob_multi128_cdf[q]);
    COPY(eob256, av1_eob_multi256_cdf[q]);
    COPY(eob512, av1_eob_multi512_cdf[q]);
    COPY(eob1024, av1_eob_multi1024_cdf[q]);
    COPY(base_eob, av1_coeff_base_eob_cdf[q]);
    COPY(base, av1_coeff_base_cdf[q]);
    COPY(br, av1_coeff_br_cdf[q]);
#undef COPY
}
