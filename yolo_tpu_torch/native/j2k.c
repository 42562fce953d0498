/* JPEG 2000 Part 1 codestream decoder for the host data pipeline: a raw
 * codestream (FF4F FF51 ...) -> its components as OpenJPEG 2.5 gives
 * them to OpenCV (data/jp2.py reads the JP2 boxes around it and does
 * OpenCV's conversion to 8 bits).
 *
 *   - the main and tile-part headers: SIZ (image and tile offsets, any
 *     tile grid, per-component sub-sampling), COD / COC, QCD / QCC (no
 *     quantization, scalar derived, scalar expounded; guard bits), RGN,
 *     POC, PPM / PPT, SOT / SOD with a tile's parts in sequence and the
 *     tiles' parts interleaved, EOC; TLM, PLM, PLT, CRG, COM and other
 *     unknown markers skipped as OpenJPEG skips them; the Part 2 and
 *     Part 15 markers (CAP, CBD, MCT, MCC, MCO, ...) fail naming the
 *     marker, as they are not ported;
 *   - each tile decoded when its last part is read (the number of parts
 *     known from TNsot), the rest at the end in tile order; packets by
 *     j2k_t2.c, code-blocks by j2k_t1.c, scaled as OpenJPEG scales them
 *     (reversible: halved; irreversible: times half the band's step
 *     (1 + mant / 2048) * 2^(prec - expn) in float), the inverse DWT,
 *     RCT / ICT, the DC level shift and the clamp (float samples rounded
 *     by lrintf);
 *   - a codestream cut short fails where OpenJPEG's strict mode fails:
 *     a tile-part longer than the data left, a missing marker after a
 *     tile's data; an image of more than 2^20 a side or 2^30 pixels
 *     fails before any allocation, as OpenCV refuses it.
 *
 * yolo_j2k_decode returns every component's samples as int32; info
 * receives [ncomp, x0, y0, x1, y1] and then, per component, [prec,
 * sgnd, dx, dy, x0, y0, w, h].
 *
 * Plain C11, no state between calls. */

#include <math.h>
#include <stdarg.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "j2k.h"
#include "native.h"

/* --- allocation and errors ---------------------------------------------- */

static j2k_block *block_of(void *p) {
    return (j2k_block *)((char *)p - offsetof(j2k_block, pad));
}

void *j2k_alloc(j2k_ctx *c, size_t n) {
    j2k_block *b = calloc(1, sizeof(j2k_block) + n);
    if (!b) j2k_fail(c, "JPEG 2000: out of memory (%zu bytes)", n);
    b->next = c->blocks;
    if (b->next) b->next->prev = b;
    c->blocks = b;
    return b->pad;
}

void *j2k_realloc(j2k_ctx *c, void *p, size_t n) {
    if (!p) return j2k_alloc(c, n);
    j2k_block *b = realloc(block_of(p), sizeof(j2k_block) + n);
    if (!b) j2k_fail(c, "JPEG 2000: out of memory (%zu bytes)", n);
    /* the block keeps its place in the list */
    if (b->prev) b->prev->next = b;
    else c->blocks = b;
    if (b->next) b->next->prev = b;
    return b->pad;
}

void j2k_free(j2k_ctx *c, void *p) {
    if (!p) return;
    j2k_block *b = block_of(p);
    if (b->prev) b->prev->next = b->next;
    else c->blocks = b->next;
    if (b->next) b->next->prev = b->prev;
    free(b);
}

void j2k_release(j2k_ctx *c, j2k_block *mark) {
    while (c->blocks && c->blocks != mark) {
        j2k_block *n = c->blocks->next;
        free(c->blocks);
        c->blocks = n;
    }
    if (c->blocks) c->blocks->prev = NULL;
}

void j2k_fail(j2k_ctx *c, const char *fmt, ...) {
    va_list ap;
    va_start(ap, fmt);
    vsnprintf(c->err, c->errlen, fmt, ap);
    va_end(ap);
    longjmp(c->jmp, 1);
}

/* --- reading ------------------------------------------------------------ */

typedef struct {
    const uint8_t *p;
    size_t len, pos;
} rd;

static unsigned get(j2k_ctx *c, rd *r, int n) {
    if (r->pos + (size_t)n > r->len)
        j2k_fail(c, "JPEG 2000: a marker segment ends early");
    unsigned v = 0;
    for (int i = 0; i < n; i++) v = (v << 8) | r->p[r->pos++];
    return v;
}

static void buf_append(j2k_ctx *c, j2k_buf *b, const uint8_t *p, size_t n) {
    /* n is a part of the codestream, never more than half the address
     * space: anything larger is a length that went wrong */
    if (!n) return;
    if (n > SIZE_MAX / 4 - b->len)
        j2k_fail(c, "JPEG 2000: a segment of %zu bytes", n);
    if (b->len + n > b->cap) {
        size_t cap = b->cap ? b->cap * 2 : 1024;
        while (cap < b->len + n) cap *= 2;
        b->data = j2k_realloc(c, b->data, cap);
        b->cap = cap;
    }
    memcpy(b->data + b->len, p, n);
    b->len += n;
}

static const char *marker_name(unsigned m) {
    switch (m) {
    case 0xff50: return "CAP (Part 15, high-throughput)";
    case 0xff59: return "CPF (Part 15)";
    case 0xff74: return "MCT (Part 2)";
    case 0xff75: return "MCC (Part 2)";
    case 0xff77: return "MCO (Part 2)";
    case 0xff78: return "CBD (Part 2)";
    case 0xff76: return "NLT (Part 2)";
    case 0xff72: return "DFS (Part 2)";
    case 0xff73: return "ADS (Part 2)";
    case 0xff79: return "ATK (Part 2)";
    default: return NULL;
    }
}

static void read_spcod(j2k_ctx *c, rd *r, j2k_tccp *t, int prt) {
    t->numres = (int)get(c, r, 1) + 1;
    if (t->numres > J2K_MAXRES)
        j2k_fail(c, "JPEG 2000: %d decomposition levels (more than 32)",
                 t->numres - 1);
    t->cblkw = (int)get(c, r, 1) + 2;
    t->cblkh = (int)get(c, r, 1) + 2;
    if (t->cblkw > 10 || t->cblkh > 10 || t->cblkw + t->cblkh > 12)
        j2k_fail(c, "JPEG 2000: code-blocks of 2^%d x 2^%d", t->cblkw,
                 t->cblkh);
    t->cblksty = (int)get(c, r, 1);
    if (t->cblksty & 0xc0)
        j2k_fail(c, "JPEG 2000: code-block style 0x%02x (Part 15 "
                 "high-throughput blocks are not ported)", t->cblksty);
    t->qmfbid = (int)get(c, r, 1);
    if (t->qmfbid > 1)
        j2k_fail(c, "JPEG 2000: wavelet transform %d (Part 2 kernels are "
                 "not ported)", t->qmfbid);
    t->prt = prt;
    for (int i = 0; i < t->numres; i++) {
        if (prt) {
            unsigned v = get(c, r, 1);
            t->prcw[i] = (int)(v & 0xf);
            t->prch[i] = (int)(v >> 4);
            if (i && (t->prcw[i] == 0 || t->prch[i] == 0))
                j2k_fail(c, "JPEG 2000: a precinct of size 1 at "
                         "resolution %d", i);
        } else {
            t->prcw[i] = t->prch[i] = 15;
        }
    }
}

static void read_sqcd(j2k_ctx *c, rd *r, size_t end, j2k_tccp *t) {
    unsigned s = get(c, r, 1);
    t->qntsty = (int)(s & 0x1f);
    t->numgbits = (int)(s >> 5);
    if (t->qntsty > 2)
        j2k_fail(c, "JPEG 2000: quantization style %d", t->qntsty);
    if (t->qntsty == 0) {
        int n = (int)(end - r->pos);
        if (n > J2K_MAXBANDS) n = J2K_MAXBANDS;
        for (int i = 0; i < n; i++) {
            t->steps[i].expn = (int)(get(c, r, 1) >> 3);
            t->steps[i].mant = 0;
        }
    } else if (t->qntsty == 1) {
        unsigned v = get(c, r, 2);
        t->steps[0].expn = (int)(v >> 11);
        t->steps[0].mant = (int)(v & 0x7ff);
        for (int i = 1; i < J2K_MAXBANDS; i++) {
            int e = t->steps[0].expn - (i - 1) / 3;
            t->steps[i].expn = e > 0 ? e : 0;
            t->steps[i].mant = t->steps[0].mant;
        }
    } else {
        int n = (int)(end - r->pos) / 2;
        if (n > J2K_MAXBANDS) n = J2K_MAXBANDS;
        for (int i = 0; i < n; i++) {
            unsigned v = get(c, r, 2);
            t->steps[i].expn = (int)(v >> 11);
            t->steps[i].mant = (int)(v & 0x7ff);
        }
    }
}

/* a main- or tile-part-header marker segment of parameters */
static void read_param(j2k_ctx *c, j2k_cp *cp, j2k_tcp *tcp, unsigned m,
                       rd *r, size_t end, int main_header) {
    int n = cp->ncomp, cbytes = n >= 257 ? 2 : 1;
    switch (m) {
    case 0xff52: { /* COD */
        tcp->csty = (int)get(c, r, 1);
        tcp->prg = (int)get(c, r, 1);
        if (tcp->prg > 4)
            j2k_fail(c, "JPEG 2000: progression order %d (not 0-4)",
                     tcp->prg);
        tcp->numlayers = (int)get(c, r, 2);
        if (tcp->numlayers == 0)
            j2k_fail(c, "JPEG 2000: a COD of 0 layers");
        tcp->mct = (int)get(c, r, 1);
        if (tcp->mct > 1)
            j2k_fail(c, "JPEG 2000: multiple component transform %d "
                     "(Part 2, not ported)", tcp->mct);
        j2k_tccp t0;
        memset(&t0, 0, sizeof t0);
        read_spcod(c, r, &t0, tcp->csty & 1);
        for (int i = 0; i < n; i++) {
            j2k_tccp *t = &tcp->tccps[i];
            t->prt = t0.prt;
            t->numres = t0.numres;
            t->cblkw = t0.cblkw;
            t->cblkh = t0.cblkh;
            t->cblksty = t0.cblksty;
            t->qmfbid = t0.qmfbid;
            memcpy(t->prcw, t0.prcw, sizeof t0.prcw);
            memcpy(t->prch, t0.prch, sizeof t0.prch);
        }
        break;
    }
    case 0xff53: { /* COC */
        int ci = (int)get(c, r, cbytes);
        if (ci >= n) j2k_fail(c, "JPEG 2000: a COC of component %d", ci);
        int s = (int)get(c, r, 1);
        read_spcod(c, r, &tcp->tccps[ci], s & 1);
        break;
    }
    case 0xff5c: /* QCD */
        read_sqcd(c, r, end, &tcp->tccps[0]);
        for (int i = 1; i < n; i++) {
            tcp->tccps[i].qntsty = tcp->tccps[0].qntsty;
            tcp->tccps[i].numgbits = tcp->tccps[0].numgbits;
            memcpy(tcp->tccps[i].steps, tcp->tccps[0].steps,
                   sizeof tcp->tccps[0].steps);
        }
        break;
    case 0xff5d: { /* QCC */
        int ci = (int)get(c, r, cbytes);
        if (ci >= n) j2k_fail(c, "JPEG 2000: a QCC of component %d", ci);
        read_sqcd(c, r, end, &tcp->tccps[ci]);
        break;
    }
    case 0xff5e: { /* RGN */
        int ci = (int)get(c, r, cbytes);
        int style = (int)get(c, r, 1);
        if (ci >= n) j2k_fail(c, "JPEG 2000: an RGN of component %d", ci);
        if (style != 0)
            j2k_fail(c, "JPEG 2000: RGN style %d (only maxshift)", style);
        tcp->tccps[ci].roishift = (int)get(c, r, 1);
        break;
    }
    case 0xff5f: { /* POC */
        size_t each = 5 + 2 * (size_t)cbytes;
        size_t k = (end - r->pos) / each;
        if (k == 0) j2k_fail(c, "JPEG 2000: an empty POC");
        tcp->pocs = j2k_realloc(c, tcp->pocs,
                                sizeof(j2k_poc) * (size_t)(tcp->npocs + k));
        for (size_t i = 0; i < k; i++) {
            j2k_poc *p = &tcp->pocs[tcp->npocs++];
            p->resno0 = (int)get(c, r, 1);
            p->compno0 = (int)get(c, r, cbytes);
            p->layno1 = (int)get(c, r, 2);
            p->resno1 = (int)get(c, r, 1);
            p->compno1 = (int)get(c, r, cbytes);
            p->prg = (int)get(c, r, 1);
            if (p->compno1 > n) p->compno1 = n;
            if (p->prg > 4)
                j2k_fail(c, "JPEG 2000: a POC of progression order %d",
                         p->prg);
        }
        break;
    }
    case 0xff61: { /* PPT */
        if (main_header) j2k_fail(c, "JPEG 2000: a PPT in the main header");
        if (cp->has_ppm)
            j2k_fail(c, "JPEG 2000: a PPT after the main header's PPM");
        /* Zppt and at least one byte of Ippt, as OpenJPEG requires */
        if (end - r->pos < 2)
            j2k_fail(c, "JPEG 2000: a PPT of length %zu", end - r->pos + 2);
        int z = (int)get(c, r, 1);
        if (tcp->ppt[z].len)
            j2k_fail(c, "JPEG 2000: Zppt %d read twice", z);
        tcp->has_ppt = 1;
        buf_append(c, &tcp->ppt[z], r->p + r->pos, end - r->pos);
        break;
    }
    default:
        break;
    }
    if (r->pos > end)
        j2k_fail(c, "JPEG 2000: marker 0x%04x is shorter than its "
                 "parameters", m);
    r->pos = end;
}

/* --- the tile's decomposition (opj_tcd_init_tile) ------------------------- */

/* a band's edge (B-15): ceil((t - o * 2^lv) / 2^(lv + 1)) */
static int band_edge(int t, int o, int lv) {
    int64_t s = (int64_t)1 << (lv + 1);
    return (int)(((int64_t)t - ((int64_t)o << lv) + s - 1) >> (lv + 1));
}

static void init_tile(j2k_ctx *c, j2k_cp *cp, j2k_tcp *tcp, int tileno,
                      j2k_tile *tile) {
    int p = tileno % cp->tw, q = tileno / cp->tw;
    tile->x0 = j2k_imax(cp->tx0 + p * cp->tdx, cp->x0);
    tile->y0 = j2k_imax(cp->ty0 + q * cp->tdy, cp->y0);
    tile->x1 = (int)((int64_t)cp->tx0 + (int64_t)(p + 1) * cp->tdx <
                     cp->x1 ? cp->tx0 + (p + 1) * cp->tdx : cp->x1);
    tile->y1 = (int)((int64_t)cp->ty0 + (int64_t)(q + 1) * cp->tdy <
                     cp->y1 ? cp->ty0 + (q + 1) * cp->tdy : cp->y1);
    tile->comps = j2k_alloc(c, sizeof(j2k_tilec) * (size_t)cp->ncomp);
    for (int ci = 0; ci < cp->ncomp; ci++) {
        j2k_tilec *tc = &tile->comps[ci];
        j2k_tccp *t = &tcp->tccps[ci];
        j2k_siz_comp *sc = &cp->comps[ci];
        tc->x0 = j2k_ceildiv(tile->x0, sc->dx);
        tc->y0 = j2k_ceildiv(tile->y0, sc->dy);
        tc->x1 = j2k_ceildiv(tile->x1, sc->dx);
        tc->y1 = j2k_ceildiv(tile->y1, sc->dy);
        tc->numres = t->numres;
        size_t area = (size_t)(tc->x1 - tc->x0) * (size_t)(tc->y1 - tc->y0);
        tc->data = j2k_alloc(c, sizeof(j2k_sample) * (area ? area : 1));
        for (int rn = 0; rn < t->numres; rn++) {
            j2k_res *res = &tc->res[rn];
            int lv = t->numres - 1 - rn;
            res->x0 = j2k_ceildivpow2(tc->x0, lv);
            res->y0 = j2k_ceildivpow2(tc->y0, lv);
            res->x1 = j2k_ceildivpow2(tc->x1, lv);
            res->y1 = j2k_ceildivpow2(tc->y1, lv);
            int pdx = t->prcw[rn], pdy = t->prch[rn];
            res->pdx = pdx;
            res->pdy = pdy;
            int px0 = j2k_floordivpow2(res->x0, pdx) << pdx;
            int py0 = j2k_floordivpow2(res->y0, pdy) << pdy;
            int64_t px1 = (int64_t)j2k_ceildivpow2(res->x1, pdx) << pdx;
            int64_t py1 = (int64_t)j2k_ceildivpow2(res->y1, pdy) << pdy;
            res->pw = res->x0 == res->x1 ? 0 : (int)((px1 - px0) >> pdx);
            res->ph = res->y0 == res->y1 ? 0 : (int)((py1 - py0) >> pdy);
            int cbgx0, cbgy0, cbgwe, cbghe;
            if (rn == 0) {
                cbgx0 = px0;
                cbgy0 = py0;
                cbgwe = pdx;
                cbghe = pdy;
                res->numbands = 1;
            } else {
                cbgx0 = j2k_ceildivpow2(px0, 1);
                cbgy0 = j2k_ceildivpow2(py0, 1);
                cbgwe = pdx - 1;
                cbghe = pdy - 1;
                res->numbands = 3;
            }
            int cbw = j2k_imin(t->cblkw, cbgwe);
            int cbh = j2k_imin(t->cblkh, cbghe);
            int nprec = res->pw * res->ph;
            for (int bn = 0; bn < res->numbands; bn++) {
                j2k_band *band = &res->bands[bn];
                int step;
                if (rn == 0) {
                    band->bandno = 0;
                    band->x0 = j2k_ceildivpow2(tc->x0, lv);
                    band->y0 = j2k_ceildivpow2(tc->y0, lv);
                    band->x1 = j2k_ceildivpow2(tc->x1, lv);
                    band->y1 = j2k_ceildivpow2(tc->y1, lv);
                    step = 0;
                } else {
                    band->bandno = bn + 1;
                    int xb = band->bandno & 1, yb = band->bandno >> 1;
                    band->x0 = band_edge(tc->x0, xb, lv);
                    band->y0 = band_edge(tc->y0, yb, lv);
                    band->x1 = band_edge(tc->x1, xb, lv);
                    band->y1 = band_edge(tc->y1, yb, lv);
                    step = 3 * (rn - 1) + bn + 1;
                }
                j2k_step *ss = &t->steps[step];
                int gain = t->qmfbid == 0 ? 0
                           : band->bandno == 0 ? 0 : band->bandno == 3 ? 2 : 1;
                int rb = cp->comps[ci].prec + gain;
                band->stepsize = (float)((1.0 + ss->mant / 2048.0) *
                                         pow(2.0, rb - ss->expn)) * 1.0f;
                band->numbps = ss->expn + t->numgbits - 1;
                if (band->x1 - band->x0 == 0 || band->y1 - band->y0 == 0)
                    continue;
                band->precs = j2k_alloc(c, sizeof(j2k_prec) *
                                               (size_t)(nprec ? nprec : 1));
                for (int pn = 0; pn < nprec; pn++) {
                    j2k_prec *pr = &band->precs[pn];
                    int gx = cbgx0 + (pn % res->pw) * (1 << cbgwe);
                    int gy = cbgy0 + (pn / res->pw) * (1 << cbghe);
                    pr->x0 = j2k_imax(gx, band->x0);
                    pr->y0 = j2k_imax(gy, band->y0);
                    pr->x1 = j2k_imin(gx + (1 << cbgwe), band->x1);
                    pr->y1 = j2k_imin(gy + (1 << cbghe), band->y1);
                    int bx0 = j2k_floordivpow2(pr->x0, cbw) << cbw;
                    int by0 = j2k_floordivpow2(pr->y0, cbh) << cbh;
                    int bx1 = j2k_ceildivpow2(pr->x1, cbw) << cbw;
                    int by1 = j2k_ceildivpow2(pr->y1, cbh) << cbh;
                    pr->cw = j2k_imax(0, (bx1 - bx0) >> cbw);
                    pr->ch = j2k_imax(0, (by1 - by0) >> cbh);
                    int ncb = pr->cw * pr->ch;
                    pr->cblks = j2k_alloc(c, sizeof(j2k_cblk) *
                                                 (size_t)(ncb ? ncb : 1));
                    for (int k = 0; k < ncb; k++) {
                        j2k_cblk *cb = &pr->cblks[k];
                        int x = bx0 + (k % pr->cw) * (1 << cbw);
                        int y = by0 + (k / pr->cw) * (1 << cbh);
                        cb->x0 = j2k_imax(x, pr->x0);
                        cb->y0 = j2k_imax(y, pr->y0);
                        cb->x1 = j2k_imin(x + (1 << cbw), pr->x1);
                        cb->y1 = j2k_imin(y + (1 << cbh), pr->y1);
                    }
                    j2k_tgt_init(c, &pr->incl, pr->cw, pr->ch);
                    j2k_tgt_init(c, &pr->imsb, pr->cw, pr->ch);
                }
            }
        }
    }
}

/* --- a tile: packets, code-blocks, transforms, into the image ----------- */

typedef struct {
    int x0, y0, w, h;
    int32_t *data;
} img_comp;

static void decode_tile(j2k_ctx *c, j2k_cp *cp, int tileno, img_comp *out) {
    j2k_tcp *tcp = &cp->tcps[tileno];
    j2k_block *mark = c->blocks;
    j2k_tile tile;
    init_tile(c, cp, tcp, tileno, &tile);
    j2k_t2_decode(c, cp, tcp, &tile, cp->ncomp);
    int32_t *blk = j2k_alloc(c, sizeof(int32_t) * 4096);
    j2k_t1_tables *lut = j2k_alloc(c, sizeof *lut);
    j2k_t1_luts(lut);
    for (int ci = 0; ci < cp->ncomp; ci++) {
        j2k_tilec *tc = &tile.comps[ci];
        j2k_tccp *t = &tcp->tccps[ci];
        size_t w = (size_t)(tc->x1 - tc->x0);
        for (int rn = 0; rn < tc->numres; rn++) {
            j2k_res *res = &tc->res[rn];
            for (int bn = 0; bn < res->numbands; bn++) {
                j2k_band *band = &res->bands[bn];
                if (band->x1 - band->x0 == 0 || band->y1 - band->y0 == 0)
                    continue;
                int ox = 0, oy = 0;
                const j2k_res *lo = &tc->res[rn ? rn - 1 : 0];
                if (band->bandno & 1) ox = lo->x1 - lo->x0;
                if (band->bandno & 2) oy = lo->y1 - lo->y0;
                float half = 0.5f * band->stepsize;
                for (int pn = 0; pn < res->pw * res->ph; pn++) {
                    j2k_prec *pr = &band->precs[pn];
                    for (int k = 0; k < pr->cw * pr->ch; k++) {
                        j2k_cblk *cb = &pr->cblks[k];
                        int cw = cb->x1 - cb->x0, chh = cb->y1 - cb->y0;
                        if (cw <= 0 || chh <= 0) continue;
                        j2k_t1_decode_cblk(c, lut, cb, band->bandno,
                                           t->roishift, t->cblksty, blk);
                        size_t x = (size_t)(cb->x0 - band->x0 + ox);
                        size_t y = (size_t)(cb->y0 - band->y0 + oy);
                        for (int j = 0; j < chh; j++) {
                            j2k_sample *dst =
                                tc->data + (y + (size_t)j) * w + x;
                            const int32_t *src = blk + (size_t)j * (size_t)cw;
                            if (t->qmfbid == 1)
                                for (int i = 0; i < cw; i++)
                                    dst[i].i = src[i] / 2;
                            else
                                for (int i = 0; i < cw; i++)
                                    dst[i].f = (float)src[i] * half;
                        }
                    }
                }
            }
        }
        if (t->qmfbid == 1)
            j2k_dwt_decode_53(c, tc);
        else
            j2k_dwt_decode_97(c, tc);
    }
    if (tcp->mct && cp->ncomp >= 3) {
        j2k_tilec *t0 = &tile.comps[0];
        size_t n = (size_t)(t0->x1 - t0->x0) * (size_t)(t0->y1 - t0->y0);
        for (int ci = 1; ci < 3; ci++) {
            j2k_tilec *tc = &tile.comps[ci];
            if ((size_t)(tc->x1 - tc->x0) * (size_t)(tc->y1 - tc->y0) != n)
                j2k_fail(c, "JPEG 2000: a component transform over "
                         "components of different sizes");
        }
        if (tcp->tccps[0].qmfbid == 1)
            j2k_mct_decode(tile.comps[0].data, tile.comps[1].data,
                           tile.comps[2].data, n);
        else
            j2k_mct_decode_real(tile.comps[0].data, tile.comps[1].data,
                                tile.comps[2].data, n);
    }
    for (int ci = 0; ci < cp->ncomp; ci++) {
        j2k_tilec *tc = &tile.comps[ci];
        j2k_siz_comp *sc = &cp->comps[ci];
        int64_t lo, hi, shift;
        if (sc->sgnd) {
            lo = -((int64_t)1 << (sc->prec - 1));
            hi = ((int64_t)1 << (sc->prec - 1)) - 1;
            shift = 0;
        } else {
            lo = 0;
            hi = ((int64_t)1 << sc->prec) - 1;
            shift = (int64_t)1 << (sc->prec - 1);
        }
        int rev = tcp->tccps[ci].qmfbid == 1;
        int w = tc->x1 - tc->x0, h = tc->y1 - tc->y0;
        img_comp *ic = &out[ci];
        for (int j = 0; j < h; j++) {
            const j2k_sample *src = tc->data + (size_t)j * (size_t)w;
            int32_t *dst = ic->data +
                           (size_t)(tc->y0 - ic->y0 + j) * (size_t)ic->w +
                           (size_t)(tc->x0 - ic->x0);
            for (int i = 0; i < w; i++) {
                int64_t v;
                if (rev) {
                    v = (int64_t)src[i].i + shift;
                } else {
                    float f = src[i].f;
                    if (f > (float)INT32_MAX) {
                        dst[i] = (int32_t)hi;
                        continue;
                    }
                    if (f < (float)INT32_MIN) {
                        dst[i] = (int32_t)lo;
                        continue;
                    }
                    v = (int64_t)lrintf(f) + shift;
                }
                dst[i] = (int32_t)(v < lo ? lo : v > hi ? hi : v);
            }
        }
    }
    j2k_release(c, mark);       /* the tile's decomposition */
    j2k_free(c, tcp->data.data);
    memset(&tcp->data, 0, sizeof tcp->data);
}

/* --- the codestream ----------------------------------------------------- */

static void copy_tcp(j2k_ctx *c, j2k_cp *cp, j2k_tcp *dst) {
    j2k_tccp *t = dst->tccps;
    *dst = cp->deflt;
    dst->tccps = t;
    memcpy(dst->tccps, cp->deflt.tccps, sizeof(j2k_tccp) * (size_t)cp->ncomp);
    if (cp->deflt.npocs) {
        dst->pocs = j2k_alloc(c, sizeof(j2k_poc) * (size_t)cp->deflt.npocs);
        memcpy(dst->pocs, cp->deflt.pocs,
               sizeof(j2k_poc) * (size_t)cp->deflt.npocs);
    }
    memset(&dst->data, 0, sizeof dst->data);
    memset(dst->ppt, 0, sizeof dst->ppt);
}

static void merge_ppm(j2k_ctx *c, j2k_cp *cp) {
    j2k_buf all = {0};
    size_t remaining = 0;
    for (int z = 0; z < 256; z++) {
        const uint8_t *p = cp->ppm[z].data;
        size_t n = cp->ppm[z].len;
        while (n) {
            if (remaining) {
                size_t k = remaining < n ? remaining : n;
                buf_append(c, &all, p, k);
                p += k;
                n -= k;
                remaining -= k;
                continue;
            }
            if (n < 4) j2k_fail(c, "JPEG 2000: a PPM cut inside its Nppm");
            remaining = ((size_t)p[0] << 24) | ((size_t)p[1] << 16) |
                        ((size_t)p[2] << 8) | p[3];
            p += 4;
            n -= 4;
        }
    }
    if (remaining) j2k_fail(c, "JPEG 2000: corrupted PPM markers");
    cp->ppm_data = all.data;
    cp->ppm_len = all.len;
}

static void decode(j2k_ctx *c, const uint8_t *data, size_t len,
                   int32_t **out, int32_t *info, int maxcomps) {
    rd r = {data, len, 0};
    j2k_cp cp;
    memset(&cp, 0, sizeof cp);
    if (get(c, &r, 2) != 0xff4f) j2k_fail(c, "JPEG 2000: no SOC marker");
    if (get(c, &r, 2) != 0xff51)
        j2k_fail(c, "JPEG 2000: the first marker after SOC is not SIZ");
    size_t siz = r.pos;
    size_t end = siz + get(c, &r, 2);
    if (end > len || end < r.pos)
        j2k_fail(c, "JPEG 2000: the SIZ segment ends early");
    get(c, &r, 2); /* Rsiz */
    cp.x1 = (int)get(c, &r, 4);
    cp.y1 = (int)get(c, &r, 4);
    cp.x0 = (int)get(c, &r, 4);
    cp.y0 = (int)get(c, &r, 4);
    cp.tdx = (int)get(c, &r, 4);
    cp.tdy = (int)get(c, &r, 4);
    cp.tx0 = (int)get(c, &r, 4);
    cp.ty0 = (int)get(c, &r, 4);
    cp.ncomp = (int)get(c, &r, 2);
    if (cp.x1 <= cp.x0 || cp.y1 <= cp.y0 || cp.x0 < 0 || cp.y0 < 0 ||
        cp.x1 < 0 || cp.y1 < 0)
        j2k_fail(c, "JPEG 2000: an empty or negative image area in SIZ");
    /* OpenCV's validateInputImageSize, before it decodes */
    if (cp.x1 - cp.x0 > (1 << 20) || cp.y1 - cp.y0 > (1 << 20) ||
        (int64_t)(cp.x1 - cp.x0) * (cp.y1 - cp.y0) > ((int64_t)1 << 30))
        j2k_fail(c, "JPEG 2000: a %d x %d image (OpenCV reads at most 2^20 "
                 "a side and 2^30 pixels)", cp.x1 - cp.x0, cp.y1 - cp.y0);
    if (cp.tdx <= 0 || cp.tdy <= 0 || cp.tx0 < 0 || cp.ty0 < 0 ||
        cp.tx0 > cp.x0 || cp.ty0 > cp.y0 ||
        (int64_t)cp.tx0 + cp.tdx <= cp.x0 || (int64_t)cp.ty0 + cp.tdy <= cp.y0)
        j2k_fail(c, "JPEG 2000: an illegal tile grid in SIZ");
    if (cp.ncomp < 1 || cp.ncomp > 16384)
        j2k_fail(c, "JPEG 2000: %d components in SIZ", cp.ncomp);
    if (cp.ncomp > maxcomps)
        j2k_fail(c, "JPEG 2000: %d components (more than %d is not ported)",
                 cp.ncomp, maxcomps);
    cp.comps = j2k_alloc(c, sizeof(j2k_siz_comp) * (size_t)cp.ncomp);
    for (int i = 0; i < cp.ncomp; i++) {
        unsigned s = get(c, &r, 1);
        cp.comps[i].prec = (int)(s & 0x7f) + 1;
        cp.comps[i].sgnd = (int)(s >> 7);
        cp.comps[i].dx = (int)get(c, &r, 1);
        cp.comps[i].dy = (int)get(c, &r, 1);
        if (cp.comps[i].dx < 1 || cp.comps[i].dy < 1)
            j2k_fail(c, "JPEG 2000: component %d sub-sampled by %dx%d", i,
                     cp.comps[i].dx, cp.comps[i].dy);
        if (cp.comps[i].prec > 31)
            j2k_fail(c, "JPEG 2000: component %d of %d bits (OpenJPEG "
                     "reads up to 31)", i, cp.comps[i].prec);
    }
    r.pos = end;
    cp.tw = j2k_ceildiv(cp.x1 - cp.tx0, cp.tdx);
    cp.th = j2k_ceildiv(cp.y1 - cp.ty0, cp.tdy);
    if ((int64_t)cp.tw * cp.th > 65535)
        j2k_fail(c, "JPEG 2000: %d x %d tiles (more than 65535)", cp.tw,
                 cp.th);
    int ntiles = cp.tw * cp.th;
    cp.deflt.tccps = j2k_alloc(c, sizeof(j2k_tccp) * (size_t)cp.ncomp);
    int have_cod = 0, have_qcd = 0;

    /* the main header */
    for (;;) {
        unsigned m = get(c, &r, 2);
        if (m == 0xff90) break;
        if (m < 0xff00)
            j2k_fail(c, "JPEG 2000: 0x%04x where a marker should be", m);
        const char *name = marker_name(m);
        if (name) j2k_fail(c, "JPEG 2000: marker %s is not ported", name);
        if (m == 0xffd9) j2k_fail(c, "JPEG 2000: EOC before any tile");
        size_t at = r.pos;
        size_t seg = at + get(c, &r, 2);
        if (seg > len || seg < r.pos)
            j2k_fail(c, "JPEG 2000: marker 0x%04x ends past the data", m);
        if (m == 0xff52) have_cod = 1;
        if (m == 0xff5c) have_qcd = 1;
        if (m == 0xff60) { /* PPM */
            /* Zppm and at least one byte of Nppm, as OpenJPEG requires */
            if (seg - r.pos < 2)
                j2k_fail(c, "JPEG 2000: a PPM of length %zu", seg - at);
            int z = (int)get(c, &r, 1);
            if (cp.ppm[z].len)
                j2k_fail(c, "JPEG 2000: Zppm %d read twice", z);
            cp.has_ppm = 1;
            buf_append(c, &cp.ppm[z], r.p + r.pos, seg - r.pos);
            r.pos = seg;
            continue;
        }
        if (m == 0xff61 || m == 0xff58 || m == 0xff93)
            j2k_fail(c, "JPEG 2000: marker 0x%04x in the main header", m);
        read_param(c, &cp, &cp.deflt, m, &r, seg, 1);
    }
    if (!have_cod) j2k_fail(c, "JPEG 2000: no COD in the main header");
    if (!have_qcd) j2k_fail(c, "JPEG 2000: no QCD in the main header");
    if (cp.has_ppm) merge_ppm(c, &cp);

    /* the image's components */
    img_comp *ic = j2k_alloc(c, sizeof(img_comp) * (size_t)cp.ncomp);
    size_t total = 0;
    for (int i = 0; i < cp.ncomp; i++) {
        ic[i].x0 = j2k_ceildiv(cp.x0, cp.comps[i].dx);
        ic[i].y0 = j2k_ceildiv(cp.y0, cp.comps[i].dy);
        ic[i].w = j2k_ceildiv(cp.x1, cp.comps[i].dx) - ic[i].x0;
        ic[i].h = j2k_ceildiv(cp.y1, cp.comps[i].dy) - ic[i].y0;
        total += (size_t)ic[i].w * (size_t)ic[i].h;
    }
    int32_t *all = calloc(total ? total : 1, sizeof(int32_t));
    if (!all) j2k_fail(c, "JPEG 2000: out of memory for %zu samples", total);
    *out = all;
    size_t off = 0;
    for (int i = 0; i < cp.ncomp; i++) {
        ic[i].data = all + off;
        off += (size_t)ic[i].w * (size_t)ic[i].h;
    }

    /* the tiles: SOT ... SOD, data, up to EOC */
    cp.tcps = j2k_alloc(c, sizeof(j2k_tcp) * (size_t)ntiles);
    for (int t = 0; t < ntiles; t++) {
        cp.tcps[t].tccps = j2k_alloc(c, sizeof(j2k_tccp) * (size_t)cp.ncomp);
        cp.tcps[t].cur_part = -1;
    }
    size_t sot = r.pos - 2;
    for (;;) {
        /* r.pos is just past the SOT marker */
        size_t lsot = get(c, &r, 2);
        if (lsot != 10) j2k_fail(c, "JPEG 2000: an SOT of length %zu", lsot);
        int isot = (int)get(c, &r, 2);
        size_t psot = get(c, &r, 4);
        int tpsot = (int)get(c, &r, 1), tnsot = (int)get(c, &r, 1);
        if (isot >= ntiles)
            j2k_fail(c, "JPEG 2000: tile %d of %d", isot, ntiles);
        j2k_tcp *tcp = &cp.tcps[isot];
        if (!tcp->seen) {
            copy_tcp(c, &cp, tcp);
            tcp->cur_part = -1;
            tcp->seen = 1;
        }
        if (tcp->decoded)
            j2k_fail(c, "JPEG 2000: a part of tile %d after its last", isot);
        if (tpsot != tcp->cur_part + 1)
            j2k_fail(c, "JPEG 2000: tile %d's part %d where part %d comes",
                     isot, tpsot, tcp->cur_part + 1);
        tcp->cur_part = tpsot;
        if (tnsot) {
            if (tpsot >= tnsot)
                j2k_fail(c, "JPEG 2000: tile-part %d of %d", tpsot, tnsot);
            tcp->nparts = tnsot;
        }
        int last_part = psot == 0;
        /* the tile-part header */
        for (;;) {
            unsigned m = get(c, &r, 2);
            if (m == 0xff93) break;
            if (m < 0xff00)
                j2k_fail(c, "JPEG 2000: 0x%04x where a marker should be", m);
            const char *name = marker_name(m);
            if (name) j2k_fail(c, "JPEG 2000: marker %s is not ported", name);
            size_t at = r.pos;
            size_t seg = at + get(c, &r, 2);
            if (seg > len || seg < r.pos)
                j2k_fail(c, "JPEG 2000: marker 0x%04x ends past the data", m);
            if (m == 0xff51 || m == 0xff60)
                j2k_fail(c, "JPEG 2000: marker 0x%04x in a tile-part header",
                         m);
            read_param(c, &cp, tcp, m, &r, seg, 0);
        }
        size_t body_end;
        if (last_part) {
            if (len < r.pos + 2)
                j2k_fail(c, "JPEG 2000: the codestream ends in tile %d", isot);
            body_end = len - 2;
        } else {
            body_end = sot + psot;
            if (body_end < r.pos)
                j2k_fail(c, "JPEG 2000: tile-part %d of tile %d is shorter "
                         "than its header", tpsot, isot);
            if (body_end > len)
                j2k_fail(c, "JPEG 2000: truncated: tile-part %d of tile %d "
                         "runs %zu bytes past the data", tpsot, isot,
                         body_end - len);
        }
        buf_append(c, &tcp->data, data + r.pos, body_end - r.pos);
        r.pos = body_end;
        if (tcp->nparts && tpsot + 1 == tcp->nparts) {
            decode_tile(c, &cp, isot, ic);
            tcp->decoded = 1;
        }
        if (last_part) {
            break;
        }
        if (r.pos + 2 > len)
            j2k_fail(c, "JPEG 2000: truncated: no marker after tile %d's "
                     "data", isot);
        unsigned m = get(c, &r, 2);
        if (m == 0xffd9) {
            break;
        }
        if (m != 0xff90)
            j2k_fail(c, "JPEG 2000: marker 0x%04x where SOT or EOC should be",
                     m);
        sot = r.pos - 2;
    }
    /* tiles whose number of parts was never given */
    for (int t = 0; t < ntiles; t++)
        if (cp.tcps[t].seen && !cp.tcps[t].decoded) {
            decode_tile(c, &cp, t, ic);
            cp.tcps[t].decoded = 1;
        }

    info[0] = cp.ncomp;
    info[1] = cp.x0;
    info[2] = cp.y0;
    info[3] = cp.x1;
    info[4] = cp.y1;
    for (int i = 0; i < cp.ncomp; i++) {
        int32_t *q = info + 5 + 8 * i;
        q[0] = cp.comps[i].prec;
        q[1] = cp.comps[i].sgnd;
        q[2] = cp.comps[i].dx;
        q[3] = cp.comps[i].dy;
        q[4] = ic[i].x0;
        q[5] = ic[i].y0;
        q[6] = ic[i].w;
        q[7] = ic[i].h;
    }
}

int yolo_j2k_decode(const uint8_t *data, size_t len, int32_t **out,
                    int32_t *info, int maxcomps, char *err, size_t errlen) {
    /* on the heap: setjmp leaves a changed local indeterminate */
    j2k_ctx *c = calloc(1, sizeof *c);
    *out = NULL;
    if (!c) {
        snprintf(err, errlen, "JPEG 2000: out of memory");
        return -1;
    }
    c->err = err;
    c->errlen = errlen;
    int rc = 0;
    if (setjmp(c->jmp)) {
        free(*out);
        *out = NULL;
        rc = -1;
    } else {
        decode(c, data, len, out, info, maxcomps);
    }
    j2k_release(c, NULL);
    free(c);
    return rc;
}
