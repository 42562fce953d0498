/* JPEG 2000 tier 2: a tile's packets -> each code-block's segments.
 *
 *   - the packet iterator of OpenJPEG 2.5 (pi.c) for the five
 *     progression orders, and for POC volumes, one iterator each in
 *     turn, every (layer, resolution, component, precinct) emitted once;
 *   - packet headers (B.10): the bit reader with its stuffing after
 *     0xFF, tag trees for inclusion and zero bit-planes, the number of
 *     passes, Lblock, and the segments that TERMALL and BYPASS cut;
 *     headers read from the body, from the tile's PPT markers or from
 *     the main header's PPM markers (one stream across the tiles, in
 *     the order they are decoded, as OpenJPEG reads it);
 *   - SOP and EPH markers skipped where present; a body that ends before
 *     its packets do: the packets past its end are empty, and a
 *     code-block segment that runs past it fails (OpenJPEG's strict mode,
 *     OpenCV's).
 *
 * Plain C11, no state between calls. */

#include <string.h>

#include "j2k.h"

/* --- bit reader (opj_bio) ---------------------------------------------- */

typedef struct {
    const uint8_t *bp, *end;
    uint32_t buf;
    int ct;
} bio;

static void bio_init(bio *b, const uint8_t *p, size_t len) {
    b->bp = p;
    b->end = p + len;
    b->buf = 0;
    b->ct = 0;
}

static void bio_bytein(bio *b) {
    b->buf = (b->buf << 8) & 0xffff;
    b->ct = b->buf == 0xff00 ? 7 : 8;
    if (b->bp < b->end) b->buf |= *b->bp++;
}

static uint32_t bio_read(bio *b, int n) {
    uint32_t v = 0;
    for (int i = n - 1; i >= 0; i--) {
        if (b->ct == 0) bio_bytein(b);
        b->ct--;
        v |= ((b->buf >> b->ct) & 1u) << i;
    }
    return v;
}

static void bio_inalign(bio *b) {
    if ((b->buf & 0xff) == 0xff) bio_bytein(b);
    b->ct = 0;
}

/* --- tag trees ----------------------------------------------------------- */

void j2k_tgt_init(j2k_ctx *c, j2k_tgt *t, int w, int h) {
    int nw[32], nh[32], lv = 0, n;
    nw[0] = w;
    nh[0] = h;
    t->nnodes = 0;
    if (w * h == 0) return;
    do {
        n = nw[lv] * nh[lv];
        nw[lv + 1] = (nw[lv] + 1) / 2;
        nh[lv + 1] = (nh[lv] + 1) / 2;
        t->nnodes += n;
        lv++;
    } while (n > 1);
    t->value = j2k_alloc(c, sizeof(int) * (size_t)t->nnodes * 3);
    t->low = t->value + t->nnodes;
    t->parent = t->low + t->nnodes;
    int base = 0;
    for (int l = 0; l + 1 < lv; l++) {
        int next = base + nw[l] * nh[l];
        for (int y = 0; y < nh[l]; y++)
            for (int x = 0; x < nw[l]; x++)
                t->parent[base + y * nw[l] + x] =
                    next + (y / 2) * nw[l + 1] + x / 2;
        base = next;
    }
    t->parent[t->nnodes - 1] = -1;
    for (int i = 0; i < t->nnodes; i++) {
        t->value[i] = 999;
        t->low[i] = 0;
    }
}

static void tgt_reset(j2k_tgt *t) {
    for (int i = 0; i < t->nnodes; i++) {
        t->value[i] = 999;
        t->low[i] = 0;
    }
}

static int tgt_decode(bio *b, j2k_tgt *t, int leaf, int threshold) {
    int stk[32], sp = 0, node = leaf;
    while (t->parent[node] >= 0) {
        stk[sp++] = node;
        node = t->parent[node];
    }
    int low = 0;
    for (;;) {
        if (low > t->low[node])
            t->low[node] = low;
        else
            low = t->low[node];
        while (low < threshold && low < t->value[node]) {
            if (bio_read(b, 1))
                t->value[node] = low;
            else
                low++;
        }
        t->low[node] = low;
        if (sp == 0) break;
        node = stk[--sp];
    }
    return t->value[node] < threshold;
}

/* --- packet iterator (pi.c) ---------------------------------------------- */

typedef struct {
    int pdx, pdy, pw, ph;
} pi_res;

typedef struct {
    int dx, dy, numres;
    pi_res res[J2K_MAXRES];
} pi_comp;

typedef struct {
    int tx0, ty0, tx1, ty1;
    int ncomp, maxres, maxprec;
    pi_comp *comps;
    uint8_t *include;
    size_t include_size;
    int step_l, step_r, step_c;
    /* the current POC volume and position */
    int prg, resno0, compno0, layno1, resno1, compno1;
    int layno, resno, compno, precno;
    int dx, dy;
    unsigned x, y;
} pi;

static int pi_take(j2k_ctx *c, pi *p) {
    size_t i = (size_t)p->layno * p->step_l + (size_t)p->resno * p->step_r +
               (size_t)p->compno * p->step_c + (size_t)p->precno;
    if (i >= p->include_size)
        j2k_fail(c, "JPEG 2000: a POC volume past the tile's packets");
    if (p->include[i]) return 0;
    p->include[i] = 1;
    return 1;
}

/* the dx, dy of OpenJPEG's position progressions over components
 * [c0, c1) */
static int pi_steps(pi *p, int c0, int c1) {
    p->dx = p->dy = 0;
    for (int ci = c0; ci < c1; ci++) {
        pi_comp *cp = &p->comps[ci];
        for (int r = 0; r < cp->numres; r++) {
            int sx = cp->res[r].pdx + cp->numres - 1 - r;
            int sy = cp->res[r].pdy + cp->numres - 1 - r;
            if (sx < 32 && (unsigned)cp->dx <= 0xffffffffu >> sx) {
                unsigned d = (unsigned)cp->dx << sx;
                if (d <= 0x7fffffffu)
                    p->dx = !p->dx ? (int)d : j2k_imin(p->dx, (int)d);
            }
            if (sy < 32 && (unsigned)cp->dy <= 0xffffffffu >> sy) {
                unsigned d = (unsigned)cp->dy << sy;
                if (d <= 0x7fffffffu)
                    p->dy = !p->dy ? (int)d : j2k_imin(p->dy, (int)d);
            }
        }
    }
    return p->dx != 0 && p->dy != 0;
}

/* the precinct of component p->compno, resolution p->resno at position
 * (p->x, p->y), or -1 where the position starts none */
static int pi_precinct(pi *p) {
    pi_comp *cp = &p->comps[p->compno];
    if (p->resno >= cp->numres) return -1;
    pi_res *r = &cp->res[p->resno];
    int levelno = cp->numres - 1 - p->resno;
    if (levelno >= 31) return -1;
    int64_t ddx = (int64_t)cp->dx << levelno, ddy = (int64_t)cp->dy << levelno;
    if (ddx > 0x7fffffff || ddy > 0x7fffffff) return -1;
    int trx0 = j2k_ceildiv(p->tx0, (int)ddx);
    int try0 = j2k_ceildiv(p->ty0, (int)ddy);
    int trx1 = j2k_ceildiv(p->tx1, (int)ddx);
    int try1 = j2k_ceildiv(p->ty1, (int)ddy);
    int rpx = r->pdx + levelno, rpy = r->pdy + levelno;
    if (rpx >= 31 || rpy >= 31) return -1;
    if (!(((uint64_t)p->y % ((uint64_t)cp->dy << rpy) == 0) ||
          (p->y == (unsigned)p->ty0 &&
           (((uint64_t)try0 << levelno) % ((uint64_t)1 << rpy)))))
        return -1;
    if (!(((uint64_t)p->x % ((uint64_t)cp->dx << rpx) == 0) ||
          (p->x == (unsigned)p->tx0 &&
           (((uint64_t)trx0 << levelno) % ((uint64_t)1 << rpx)))))
        return -1;
    if (r->pw == 0 || r->ph == 0) return -1;
    if (trx0 == trx1 || try0 == try1) return -1;
    int prci = j2k_floordivpow2(j2k_ceildiv((int)p->x, (int)ddx), r->pdx) -
               j2k_floordivpow2(trx0, r->pdx);
    int prcj = j2k_floordivpow2(j2k_ceildiv((int)p->y, (int)ddy), r->pdy) -
               j2k_floordivpow2(try0, r->pdy);
    return prci + prcj * r->pw;
}

typedef struct {
    j2k_ctx *c;
    j2k_cp *cp;
    j2k_tcp *tcp;
    j2k_tile *tile;
    const uint8_t *body, *hp;
    size_t blen, hlen;
    int separate;
} t2_state;

static void emit(t2_state *s, pi *p);

static void emit_layers(t2_state *s, pi *p, int pr) {
    if (pr < 0) return;
    p->precno = pr;
    for (p->layno = 0; p->layno < p->layno1; p->layno++)
        if (pi_take(s->c, p)) emit(s, p);
}

#define FOR_Y(p) \
    for ((p)->y = (unsigned)(p)->ty0; (p)->y < (unsigned)(p)->ty1; \
         (p)->y += (unsigned)(p)->dy - ((p)->y % (unsigned)(p)->dy))
#define FOR_X(p) \
    for ((p)->x = (unsigned)(p)->tx0; (p)->x < (unsigned)(p)->tx1; \
         (p)->x += (unsigned)(p)->dx - ((p)->x % (unsigned)(p)->dx))

/* every packet of the current volume, in its order, each emitted the
 * first time it comes (OpenJPEG's opj_pi_next_*) */
static void pi_run(t2_state *s, pi *p) {
    switch (p->prg) {
    case J2K_LRCP:
    case J2K_RLCP: {
        int lrcp = p->prg == J2K_LRCP;
        int a1 = lrcp ? p->layno1 : p->resno1;
        int b0 = lrcp ? p->resno0 : 0, b1 = lrcp ? p->resno1 : p->layno1;
        for (int a = lrcp ? 0 : p->resno0; a < a1; a++)
            for (int b = b0; b < b1; b++) {
                p->layno = lrcp ? a : b;
                p->resno = lrcp ? b : a;
                for (p->compno = p->compno0; p->compno < p->compno1;
                     p->compno++) {
                    pi_comp *cp = &p->comps[p->compno];
                    if (p->resno >= cp->numres) continue;
                    int n = cp->res[p->resno].pw * cp->res[p->resno].ph;
                    for (p->precno = 0; p->precno < n; p->precno++)
                        if (pi_take(s->c, p)) emit(s, p);
                }
            }
        return;
    }
    case J2K_RPCL:
        if (!pi_steps(p, 0, p->ncomp)) return;
        for (int r = p->resno0; r < p->resno1; r++)
            FOR_Y(p) FOR_X(p)
                for (int ci = p->compno0; ci < p->compno1; ci++) {
                    p->resno = r;
                    p->compno = ci;
                    emit_layers(s, p, pi_precinct(p));
                }
        return;
    case J2K_PCRL:
        if (!pi_steps(p, 0, p->ncomp)) return;
        FOR_Y(p) FOR_X(p)
            for (int ci = p->compno0; ci < p->compno1; ci++) {
                int rend = j2k_imin(p->resno1, p->comps[ci].numres);
                for (int r = p->resno0; r < rend; r++) {
                    p->resno = r;
                    p->compno = ci;
                    emit_layers(s, p, pi_precinct(p));
                }
            }
        return;
    case J2K_CPRL:
        for (int ci = p->compno0; ci < p->compno1; ci++) {
            if (!pi_steps(p, ci, ci + 1)) return;
            int rend = j2k_imin(p->resno1, p->comps[ci].numres);
            FOR_Y(p) FOR_X(p)
                for (int r = p->resno0; r < rend; r++) {
                    p->resno = r;
                    p->compno = ci;
                    emit_layers(s, p, pi_precinct(p));
                }
        }
        return;
    default:
        j2k_fail(s->c, "JPEG 2000: progression order %d (not 0-4)", p->prg);
    }
}

/* --- packets ------------------------------------------------------------ */

static int getnumpasses(bio *b) {
    uint32_t n;
    if (!bio_read(b, 1)) return 1;
    if (!bio_read(b, 1)) return 2;
    if ((n = bio_read(b, 2)) != 3) return (int)(3 + n);
    if ((n = bio_read(b, 5)) != 31) return (int)(6 + n);
    return (int)(37 + bio_read(b, 7));
}

static int floorlog2(int v) {
    int l = 0;
    while (v > 1) {
        v >>= 1;
        l++;
    }
    return l;
}

static j2k_seg *seg_at(j2k_ctx *c, j2k_cblk *cb, int i, int cblksty,
                       int first) {
    if (i >= cb->segcap) {
        int cap = cb->segcap ? cb->segcap * 2 : 4;
        while (cap <= i) cap *= 2;
        cb->segs = j2k_realloc(c, cb->segs, sizeof(j2k_seg) * (size_t)cap);
        memset(cb->segs + cb->segcap, 0,
               sizeof(j2k_seg) * (size_t)(cap - cb->segcap));
        cb->segcap = cap;
    }
    j2k_seg *s = &cb->segs[i];
    memset(s, 0, sizeof *s);
    if (cblksty & J2K_TERMALL)
        s->maxpasses = 1;
    else if (cblksty & J2K_LAZY)
        s->maxpasses = first ? 10
                       : (s[-1].maxpasses == 1 || s[-1].maxpasses == 10) ? 2
                                                                        : 1;
    else
        s->maxpasses = 109;
    return s;
}

static int band_empty(const j2k_band *b) {
    return b->x1 - b->x0 == 0 || b->y1 - b->y0 == 0;
}

/* one packet: its header from *hp (hlen bytes left), its body from
 * body (blen bytes left) -> the body bytes read */
static size_t decode_packet(j2k_ctx *c, j2k_tcp *tcp, j2k_tile *tile, pi *p,
                            const uint8_t **hp, size_t *hlen,
                            const uint8_t *body, size_t blen,
                            int separate) {
    j2k_res *res = &tile->comps[p->compno].res[p->resno];
    j2k_tccp *tccp = &tcp->tccps[p->compno];
    const uint8_t *cur = body;
    if (p->layno == 0) {
        for (int b = 0; b < res->numbands; b++) {
            j2k_band *band = &res->bands[b];
            if (band_empty(band)) continue;
            j2k_prec *pr = &band->precs[p->precno];
            tgt_reset(&pr->incl);
            tgt_reset(&pr->imsb);
            for (int i = 0; i < pr->cw * pr->ch; i++) {
                pr->cblks[i].numsegs = 0;
                pr->cblks[i].data.len = 0;
            }
        }
    }
    if (tcp->csty & 2) {   /* SOP */
        if (blen >= 6 && cur[0] == 0xff && cur[1] == 0x91) cur += 6;
    }
    if (!separate) {
        *hp = cur;
        *hlen = blen - (size_t)(cur - body);
    }
    const uint8_t *hstart = *hp;
    bio b;
    bio_init(&b, *hp, *hlen);
    int present = (int)bio_read(&b, 1);
    if (present) {
        for (int bi = 0; bi < res->numbands; bi++) {
            j2k_band *band = &res->bands[bi];
            if (band_empty(band)) continue;
            j2k_prec *pr = &band->precs[p->precno];
            for (int k = 0; k < pr->cw * pr->ch; k++) {
                j2k_cblk *cb = &pr->cblks[k];
                int included;
                if (!cb->numsegs)
                    included = tgt_decode(&b, &pr->incl, k, p->layno + 1);
                else
                    included = (int)bio_read(&b, 1);
                if (!included) {
                    cb->numnewpasses = 0;
                    continue;
                }
                if (!cb->numsegs) {
                    int i = 0;
                    while (!tgt_decode(&b, &pr->imsb, k, i)) i++;
                    cb->numbps = band->numbps + 1 - i;
                    cb->numlenbits = 3;
                }
                cb->numnewpasses = getnumpasses(&b);
                while (bio_read(&b, 1)) cb->numlenbits++;
                int segno = 0;
                if (!cb->numsegs) {
                    seg_at(c, cb, 0, tccp->cblksty, 1);
                } else {
                    segno = cb->numsegs - 1;
                    if (cb->segs[segno].numpasses == cb->segs[segno].maxpasses)
                        seg_at(c, cb, ++segno, tccp->cblksty, 0);
                }
                int n = cb->numnewpasses;
                do {
                    j2k_seg *s = &cb->segs[segno];
                    s->numnewpasses = j2k_imin(s->maxpasses - s->numpasses, n);
                    int bits = cb->numlenbits + floorlog2(s->numnewpasses);
                    if (bits > 32)
                        j2k_fail(c, "JPEG 2000: a segment length of %d bits",
                                 bits);
                    s->newlen = (int)bio_read(&b, bits);
                    n -= s->numnewpasses;
                    if (n > 0) seg_at(c, cb, ++segno, tccp->cblksty, 0);
                } while (n > 0);
            }
        }
    }
    bio_inalign(&b);
    const uint8_t *h = b.bp;
    if (tcp->csty & 4) {   /* EPH */
        size_t used = (size_t)(h - hstart);
        if (*hlen - used >= 2 && h[0] == 0xff && h[1] == 0x92) h += 2;
    }
    size_t hl = (size_t)(h - hstart);
    *hlen -= hl;
    *hp += hl;
    if (!separate) cur = h;
    if (!present) return (size_t)(cur - body);
    /* the body */
    size_t left = blen - (size_t)(cur - body);
    for (int bi = 0; bi < res->numbands; bi++) {
        j2k_band *band = &res->bands[bi];
        if (band_empty(band)) continue;
        j2k_prec *pr = &band->precs[p->precno];
        for (int k = 0; k < pr->cw * pr->ch; k++) {
            j2k_cblk *cb = &pr->cblks[k];
            if (!cb->numnewpasses) continue;
            int si;
            if (!cb->numsegs) {
                si = 0;
                cb->numsegs = 1;
            } else {
                si = cb->numsegs - 1;
                if (cb->segs[si].numpasses == cb->segs[si].maxpasses) {
                    si++;
                    cb->numsegs++;
                }
            }
            do {
                j2k_seg *s = &cb->segs[si];
                if ((size_t)s->newlen > left)
                    j2k_fail(c, "JPEG 2000: a code-block segment of %d bytes "
                             "runs past the tile's data (%zu bytes left)",
                             s->newlen, left);
                j2k_buf *d = &cb->data;
                if (d->len + (size_t)s->newlen > d->cap) {
                    size_t cap = d->cap ? d->cap * 2 : 256;
                    while (cap < d->len + (size_t)s->newlen) cap *= 2;
                    d->data = j2k_realloc(c, d->data, cap);
                    d->cap = cap;
                }
                if (s->newlen) memcpy(d->data + d->len, cur, (size_t)s->newlen);
                d->len += (size_t)s->newlen;
                cur += s->newlen;
                left -= (size_t)s->newlen;
                s->len += (size_t)s->newlen;
                s->numpasses += s->numnewpasses;
                cb->numnewpasses -= s->numnewpasses;
                if (cb->numnewpasses > 0) {
                    si++;
                    cb->numsegs++;
                }
            } while (cb->numnewpasses > 0);
        }
    }
    return (size_t)(cur - body);
}

static void emit(t2_state *s, pi *p) {
    if (s->cp->has_ppm) {
        s->hp = s->cp->ppm_data;
        s->hlen = s->cp->ppm_len;
    }
    size_t n = decode_packet(s->c, s->tcp, s->tile, p, &s->hp, &s->hlen,
                             s->body, s->blen, s->separate);
    if (s->cp->has_ppm) {
        s->cp->ppm_data = s->hp;
        s->cp->ppm_len = s->hlen;
    }
    s->body += n;
    s->blen -= n;
}

void j2k_t2_decode(j2k_ctx *c, j2k_cp *cp, j2k_tcp *tcp, j2k_tile *tile,
                   int ncomp) {
    pi p;
    memset(&p, 0, sizeof p);
    p.tx0 = tile->x0;
    p.ty0 = tile->y0;
    p.tx1 = tile->x1;
    p.ty1 = tile->y1;
    p.ncomp = ncomp;
    p.comps = j2k_alloc(c, sizeof(pi_comp) * (size_t)ncomp);
    for (int ci = 0; ci < ncomp; ci++) {
        pi_comp *pc = &p.comps[ci];
        j2k_tilec *tc = &tile->comps[ci];
        pc->dx = cp->comps[ci].dx;
        pc->dy = cp->comps[ci].dy;
        pc->numres = tc->numres;
        if (tc->numres > p.maxres) p.maxres = tc->numres;
        for (int r = 0; r < tc->numres; r++) {
            pc->res[r].pdx = tc->res[r].pdx;
            pc->res[r].pdy = tc->res[r].pdy;
            pc->res[r].pw = tc->res[r].pw;
            pc->res[r].ph = tc->res[r].ph;
            int n = tc->res[r].pw * tc->res[r].ph;
            if (n > p.maxprec) p.maxprec = n;
        }
    }
    p.step_c = p.maxprec;
    p.step_r = ncomp * p.step_c;
    p.step_l = p.maxres * p.step_r;
    p.include_size = (size_t)(tcp->numlayers + 1) * (size_t)p.step_l;
    p.include = j2k_alloc(c, p.include_size ? p.include_size : 1);

    t2_state s = {c, cp, tcp, tile, tcp->data.data, NULL, tcp->data.len, 0,
                  0};
    if (cp->has_ppm) {
        s.separate = 1;
    } else if (tcp->has_ppt) {
        j2k_buf ppt = {0};
        for (int z = 0; z < 256; z++) {
            j2k_buf *b = &tcp->ppt[z];
            if (!b->len) continue;
            ppt.data = j2k_realloc(c, ppt.data, ppt.len + b->len);
            memcpy(ppt.data + ppt.len, b->data, b->len);
            ppt.len += b->len;
        }
        s.separate = 1;
        s.hp = ppt.data;
        s.hlen = ppt.len;
    }
    int nvol = tcp->npocs ? tcp->npocs : 1;
    for (int v = 0; v < nvol; v++) {
        if (tcp->npocs) {
            j2k_poc *pc = &tcp->pocs[v];
            p.prg = pc->prg;
            p.resno0 = pc->resno0;
            p.compno0 = pc->compno0;
            p.layno1 = j2k_imin(pc->layno1, tcp->numlayers);
            p.resno1 = pc->resno1;
            p.compno1 = j2k_imin(pc->compno1, ncomp);
        } else {
            p.prg = tcp->prg;
            p.resno0 = p.compno0 = 0;
            p.layno1 = tcp->numlayers;
            p.resno1 = p.maxres;
            p.compno1 = ncomp;
        }
        if (p.compno0 >= ncomp)
            j2k_fail(c, "JPEG 2000: a POC from component %d (of %d)",
                     p.compno0, ncomp);
        pi_run(&s, &p);
    }
}
