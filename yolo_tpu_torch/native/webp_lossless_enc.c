/* WebP lossless (VP8L) encoder for save_image's .webp: the lossless
 * bitstream cv2.imwrite writes by default (OpenCV 5 passes no quality,
 * so libwebp encodes losslessly), the pixels exact; the bytes are this
 * encoder's own (libwebp's choices are heuristics not reproduced):
 *
 *   - the subtract-green transform, then the predictor transform on
 *     16 x 16 tiles, each tile's mode (0..13) the one whose residuals
 *     cost the fewest bits against the residual statistics of the tiles
 *     chosen before it;
 *   - LZ77 backward references found through a hash chain of pixel
 *     pairs (the left and upper neighbours tried first), distances
 *     coded through the 120-entry plane map where it holds them, and a
 *     colour cache whose size is chosen by the estimated size of the
 *     symbol streams;
 *   - one Huffman group of five canonical codes of at most 15 bits,
 *     written as simple codes (one or two 8-bit symbols) or through the
 *     code-length code (at most 7 bits) with its repeat codes 16, 17
 *     and 18; a code of one symbol is read by decoders as a zero-bit
 *     code, so that symbol costs no bits;
 *   - the tile modes as a sub-image of their own, coded alike.
 *
 * yolo_webp_encode_vp8l returns the "VP8L" chunk's payload; data/webp.py
 * wraps it in RIFF. A mode of 0..13 forces every tile's predictor (the
 * tests hold each mode so). Plain C11, no state between calls.
 */

#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "native.h"
#include "webp_tables.h"

#define NUM_LITERAL 256
#define NUM_LENGTH_CODES 24
#define NUM_DISTANCE_CODES 40
#define CODE_LENGTH_CODES 19
#define MAX_CODE_LENGTH 15
#define MAX_CL_LENGTH 7
#define MAX_LENGTH 4096
#define MAX_DISTANCE ((1 << 20) - 120)
#define TILE_BITS 4
#define HASH_BITS 18
#define CHAIN_STEPS 48
#define MIN_MATCH 3

static const uint8_t kCodeLengthCodeOrder[CODE_LENGTH_CODES] = {
    17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};

/* ------------------------------------------------------------ bit writer */

typedef struct {
    uint8_t *buf;
    size_t len, cap;
    uint64_t acc;
    int nacc;
    int failed;
} bitw;

static void put_bits(bitw *w, uint32_t v, int n) {
    if (n == 0 || w->failed) return;
    w->acc |= (uint64_t)v << w->nacc;
    w->nacc += n;
    while (w->nacc >= 8) {
        if (w->len == w->cap) {
            size_t cap = w->cap ? 2 * w->cap : 1 << 16;
            uint8_t *b = realloc(w->buf, cap);
            if (!b) {
                w->failed = 1;
                return;
            }
            w->buf = b;
            w->cap = cap;
        }
        w->buf[w->len++] = (uint8_t)w->acc;
        w->acc >>= 8;
        w->nacc -= 8;
    }
}

static void flush_bits(bitw *w) {
    if (w->nacc > 0) put_bits(w, 0, 8 - w->nacc);
}

/* ---------------------------------------------------------- Huffman codes */

typedef struct {
    int n;                   /* alphabet size */
    uint8_t *len;            /* code length of each symbol (0: unused) */
    uint16_t *code;          /* its bits, reversed for the LSB-first writer */
} hcode;

typedef struct {
    uint32_t count;
    int sym, left, right;
} node;

static int cmp_node(const void *a, const void *b) {
    const node *x = a, *y = b;
    if (x->count != y->count) return x->count < y->count ? -1 : 1;
    return x->sym - y->sym;
}

static void set_depths(const node *tree, int i, int d, uint8_t *len) {
    if (tree[i].sym >= 0) {
        len[tree[i].sym] = (uint8_t)(d ? d : 1);
        return;
    }
    set_depths(tree, tree[i].left, d + 1, len);
    set_depths(tree, tree[i].right, d + 1, len);
}

/* code lengths of at most limit bits for counts (a Huffman tree of the
 * counts, each raised to a floor that doubles until the tree is shallow
 * enough); one used symbol gets length 1, none gives all zeros.
 * Returns 0, or -1 out of memory. */
static int limited_lengths(const uint32_t *counts, int n, int limit,
                           uint8_t *len) {
    memset(len, 0, (size_t)n);
    int used = 0;
    for (int s = 0; s < n; s++) used += counts[s] != 0;
    if (used == 0) return 0;
    if (used == 1) {
        for (int s = 0; s < n; s++)
            if (counts[s]) len[s] = 1;
        return 0;
    }
    node *tree = malloc(sizeof(node) * (size_t)(2 * used));
    if (!tree) return -1;
    for (uint32_t floor_count = 1;; floor_count *= 2) {
        int k = 0;
        for (int s = 0; s < n; s++)
            if (counts[s]) {
                tree[k].count = counts[s] < floor_count ? floor_count
                                                        : counts[s];
                tree[k].sym = s;
                tree[k].left = tree[k].right = -1;
                k++;
            }
        qsort(tree, (size_t)used, sizeof(node), cmp_node);
        /* two queues: the sorted leaves, then the merged nodes in order */
        int leaf = 0, merged = used, next = used;
        for (int m = 0; m < used - 1; m++) {
            int pick[2];
            for (int j = 0; j < 2; j++) {
                if (leaf < used && (merged >= next ||
                                    tree[leaf].count <= tree[merged].count))
                    pick[j] = leaf++;
                else
                    pick[j] = merged++;
            }
            tree[next].count = tree[pick[0]].count + tree[pick[1]].count;
            tree[next].sym = -1;
            tree[next].left = pick[0];
            tree[next].right = pick[1];
            next++;
        }
        set_depths(tree, next - 1, 0, len);
        int deepest = 0;
        for (int s = 0; s < n; s++)
            if (len[s] > deepest) deepest = len[s];
        if (deepest <= limit) break;
    }
    free(tree);
    return 0;
}

/* canonical codes of the lengths, bit-reversed */
static void assign_codes(hcode *h) {
    int bl_count[MAX_CODE_LENGTH + 1] = {0}, next_code[MAX_CODE_LENGTH + 2];
    for (int s = 0; s < h->n; s++) bl_count[h->len[s]]++;
    bl_count[0] = 0;
    int code = 0;
    for (int b = 1; b <= MAX_CODE_LENGTH; b++) {
        code = (code + bl_count[b - 1]) << 1;
        next_code[b] = code;
    }
    for (int s = 0; s < h->n; s++) {
        int l = h->len[s];
        if (!l) continue;
        int c = next_code[l]++, r = 0;
        for (int b = 0; b < l; b++) r |= ((c >> b) & 1) << (l - 1 - b);
        h->code[s] = (uint16_t)r;
    }
}

static int used_symbols(const hcode *h, int *first, int *second) {
    int used = 0;
    for (int s = 0; s < h->n; s++)
        if (h->len[s]) {
            if (used == 0) *first = s;
            else if (used == 1) *second = s;
            used++;
        }
    return used;
}

static void put_symbol(bitw *w, const hcode *h, int s) {
    put_bits(w, h->code[s], h->len[s]);
}

/* the code-length tokens of lens[0..n): 0..15, 16 (repeat the previous
 * non-zero length 3..6 times), 17 (3..10 zeros), 18 (11..138 zeros) ->
 * tokens[i] = symbol | extra << 8; returns the count */
static int length_tokens(const uint8_t *lens, int n, uint32_t *tokens) {
    int k = 0, prev = 8;
    for (int i = 0; i < n;) {
        int v = lens[i], run = 1;
        while (i + run < n && lens[i + run] == v) run++;
        int left = run;
        if (v == 0) {
            while (left >= 11) {
                int r = left > 138 ? 138 : left;
                tokens[k++] = 18u | (uint32_t)(r - 11) << 8;
                left -= r;
            }
            if (left >= 3) {
                tokens[k++] = 17u | (uint32_t)(left - 3) << 8;
                left = 0;
            }
            while (left-- > 0) tokens[k++] = 0;
        } else {
            if (v != prev) {
                tokens[k++] = (uint32_t)v;
                left--;
                prev = v;
            }
            while (left >= 3) {
                int r = left > 6 ? 6 : left;
                tokens[k++] = 16u | (uint32_t)(r - 3) << 8;
                left -= r;
            }
            while (left-- > 0) tokens[k++] = (uint32_t)v;
        }
        i += run;
    }
    return k;
}

/* builds h from counts and writes it; returns 0, or -1 out of memory */
static int write_code(bitw *w, const uint32_t *counts, hcode *h) {
    if (limited_lengths(counts, h->n, MAX_CODE_LENGTH, h->len)) return -1;
    int first = 0, second = 0, used = used_symbols(h, &first, &second);
    if (used == 0) {
        h->len[0] = 1;                /* a zero-bit code of symbol 0 */
        used = 1;
        first = 0;
    }
    if (used <= 2 && first < 256 && (used == 1 || second < 256)) {
        put_bits(w, 1, 1);                            /* simple code */
        put_bits(w, (uint32_t)(used - 1), 1);
        if (first < 2) {
            put_bits(w, 0, 1);
            put_bits(w, (uint32_t)first, 1);
        } else {
            put_bits(w, 1, 1);
            put_bits(w, (uint32_t)first, 8);
        }
        if (used == 2) put_bits(w, (uint32_t)second, 8);
    } else {
        uint32_t *tokens = malloc(sizeof(uint32_t) * (size_t)h->n);
        if (!tokens) return -1;
        int nt = length_tokens(h->len, h->n, tokens);
        uint32_t cl_counts[CODE_LENGTH_CODES] = {0};
        for (int i = 0; i < nt; i++) cl_counts[tokens[i] & 0xff]++;
        uint8_t cl_len[CODE_LENGTH_CODES];
        uint16_t cl_code[CODE_LENGTH_CODES] = {0};
        if (limited_lengths(cl_counts, CODE_LENGTH_CODES, MAX_CL_LENGTH,
                            cl_len)) {
            free(tokens);
            return -1;
        }
        hcode clh = {CODE_LENGTH_CODES, cl_len, cl_code};
        assign_codes(&clh);
        int cl_used = 0, dummy = 0;
        cl_used = used_symbols(&clh, &dummy, &dummy);
        int num = CODE_LENGTH_CODES;
        while (num > 4 && cl_len[kCodeLengthCodeOrder[num - 1]] == 0) num--;
        put_bits(w, 0, 1);                            /* normal code */
        put_bits(w, (uint32_t)(num - 4), 4);
        for (int i = 0; i < num; i++)
            put_bits(w, cl_len[kCodeLengthCodeOrder[i]], 3);
        put_bits(w, 0, 1);                            /* no max_symbol */
        for (int i = 0; i < nt; i++) {
            int s = (int)(tokens[i] & 0xff), extra = (int)(tokens[i] >> 8);
            if (cl_used > 1) put_bits(w, cl_code[s], cl_len[s]);
            if (s == 16) put_bits(w, (uint32_t)extra, 2);
            else if (s == 17) put_bits(w, (uint32_t)extra, 3);
            else if (s == 18) put_bits(w, (uint32_t)extra, 7);
        }
        free(tokens);
    }
    if (used == 1) {
        h->len[first] = 0;            /* a zero-bit code: write nothing */
        return 0;
    }
    assign_codes(h);
    return 0;
}

/* ------------------------------------------------------ the symbol stream */

/* a token: a literal (the next pixel), a cache index, or a backward
 * reference */
typedef struct {
    int kind;                 /* 0 literal, 1 cache, 2 copy */
    int len, dist_code, index;
} token;

static int prefix_of(int v, int *extra_bits, int *extra_value) {
    int d = v - 1;
    if (d < 4) {
        *extra_bits = 0;
        *extra_value = 0;
        return d;
    }
    int hb = 31 - __builtin_clz((unsigned)d);
    int second = (d >> (hb - 1)) & 1;
    *extra_bits = hb - 1;
    *extra_value = d & ((1 << (hb - 1)) - 1);
    return 2 * hb + second;
}

static inline uint32_t cache_hash(uint32_t argb, int bits) {
    return (0x1e35a7bdu * argb) >> (32 - bits);
}

typedef struct {
    token *tok;
    int ntok;
} parse;

/* LZ77 over px (xsize wide), greedy: the left and upper neighbours
 * first, then a hash chain of pixel pairs.
 * plane[d] (d <= 8 * xsize + 8) is the smallest plane code of distance
 * d, 0 if none. Returns 0 or -1 out of memory. */
static int lz77(const uint32_t *px, int n, int xsize, const uint16_t *plane,
                int plane_max, parse *out) {
    int *head = malloc(sizeof(int) * (1 << HASH_BITS));
    int *chain = malloc(sizeof(int) * (size_t)(n ? n : 1));
    token *tok = malloc(sizeof(token) * (size_t)(n ? n : 1));
    if (!head || !chain || !tok) {
        free(head);
        free(chain);
        free(tok);
        return -1;
    }
    for (int i = 0; i < (1 << HASH_BITS); i++) head[i] = -1;
#define PAIR_HASH(i) \
    ((((px[i] * 0x9e3779b1u) ^ (px[(i) + 1] * 0x85ebca6bu)) >> \
      (32 - HASH_BITS)))
    int inserted = 0;
#define INSERT_UPTO(lim)                               \
    while (inserted < (lim) && inserted + 1 < n) {     \
        uint32_t hh = PAIR_HASH(inserted);             \
        chain[inserted] = head[hh];                    \
        head[hh] = inserted++;                         \
    }
    int ntok = 0;
    for (int i = 0; i < n;) {
        INSERT_UPTO(i);
        int best_len = 0, best_dist = 0;
        const int maxlen = n - i < MAX_LENGTH ? n - i : MAX_LENGTH;
        for (int c = 0; c < 2 && maxlen >= MIN_MATCH; c++) {
            int d = c == 0 ? 1 : xsize;
            if (d > i || (c == 1 && xsize == 1)) continue;
            int l = 0;
            while (l < maxlen && px[i + l] == px[i + l - d]) l++;
            if (l > best_len) {
                best_len = l;
                best_dist = d;
            }
        }
        if (i + 1 < n && best_len < maxlen) {
            int cand = head[PAIR_HASH(i)];
            for (int steps = 0; cand >= 0 && steps < CHAIN_STEPS;
                 steps++, cand = chain[cand]) {
                int d = i - cand;
                if (d > MAX_DISTANCE) break;
                if (px[cand + best_len] != px[i + best_len] ||
                    best_len >= maxlen)
                    continue;
                int l = 0;
                while (l < maxlen && px[cand + l] == px[i + l]) l++;
                if (l > best_len + 1 ||
                    (l > best_len && (d <= plane_max && plane[d]))) {
                    best_len = l;
                    best_dist = d;
                    if (l == maxlen) break;
                }
            }
        }
        if (best_len >= MIN_MATCH) {
            int dc = best_dist <= plane_max && plane[best_dist]
                         ? plane[best_dist] : best_dist + 120;
            tok[ntok++] = (token){2, best_len, dc, 0};
            i += best_len;
        } else {
            tok[ntok++] = (token){0, 1, 0, 0};
            i++;
        }
    }
#undef INSERT_UPTO
#undef PAIR_HASH
    free(head);
    free(chain);
    out->tok = tok;
    out->ntok = ntok;
    return 0;
}

/* the literals that hit a cache of `bits` bits become cache tokens (in
 * place), every pixel inserted in order; fills the five histograms */
static void apply_cache(parse *p, const uint32_t *px, int bits,
                        uint32_t *hist[5]) {
    const int ngreen = NUM_LITERAL + NUM_LENGTH_CODES + (bits ? 1 << bits : 0);
    memset(hist[0], 0, sizeof(uint32_t) * (size_t)ngreen);
    for (int k = 1; k < 4; k++) memset(hist[k], 0, sizeof(uint32_t) * 256);
    memset(hist[4], 0, sizeof(uint32_t) * NUM_DISTANCE_CODES);
    uint32_t cache[1 << 11];
    memset(cache, 0, sizeof cache);
    size_t pos = 0;
    for (int t = 0; t < p->ntok; t++) {
        token *k = &p->tok[t];
        if (k->kind == 2) {
            int eb, ev;
            hist[0][NUM_LITERAL + prefix_of(k->len, &eb, &ev)]++;
            hist[4][prefix_of(k->dist_code, &eb, &ev)]++;
            if (bits)
                for (int j = 0; j < k->len; j++)
                    cache[cache_hash(px[pos + j], bits)] = px[pos + j];
            pos += (size_t)k->len;
            continue;
        }
        uint32_t v = px[pos++];
        k->kind = 0;
        if (bits) {
            uint32_t hsh = cache_hash(v, bits);
            if (cache[hsh] == v) {
                k->kind = 1;
                k->index = (int)hsh;
            }
            cache[hsh] = v;
        }
        if (k->kind == 1) {
            hist[0][NUM_LITERAL + NUM_LENGTH_CODES + k->index]++;
        } else {
            hist[0][(v >> 8) & 0xff]++;
            hist[1][(v >> 16) & 0xff]++;
            hist[2][v & 0xff]++;
            hist[3][v >> 24]++;
        }
    }
}

static double entropy_bits(const uint32_t *h, int n) {
    double total = 0, bits = 0;
    for (int i = 0; i < n; i++) total += h[i];
    if (total == 0) return 0;
    for (int i = 0; i < n; i++)
        if (h[i]) bits -= h[i] * log2(h[i] / total);
    return bits;
}

static double stream_cost(const parse *p, uint32_t *hist[5], int bits) {
    const int ngreen = NUM_LITERAL + NUM_LENGTH_CODES + (bits ? 1 << bits : 0);
    double c = entropy_bits(hist[0], ngreen) + entropy_bits(hist[1], 256) +
               entropy_bits(hist[2], 256) + entropy_bits(hist[3], 256) +
               entropy_bits(hist[4], NUM_DISTANCE_CODES);
    for (int t = 0; t < p->ntok; t++)
        if (p->tok[t].kind == 2) {
            int eb, ev;
            prefix_of(p->tok[t].len, &eb, &ev);
            c += eb;
            prefix_of(p->tok[t].dist_code, &eb, &ev);
            c += eb;
        }
    return c + 8.0 * (ngreen / 16);   /* a rough size of the codes */
}

/* one entropy-coded image: the cache bit (and bits), at level 0 the
 * meta bit (0: one group), the five codes, the symbols. Returns 0 or -1
 * out of memory. */
static int write_image(bitw *w, const uint32_t *px, int xsize, int ysize,
                       int level0) {
    const int n = xsize * ysize;
    const int plane_max = 8 * xsize + 8;
    uint16_t *plane = calloc((size_t)plane_max + 1, sizeof(uint16_t));
    if (!plane) return -1;
    for (int c = 120; c >= 1; c--) {
        int p = kCodeToPlane[c - 1];
        int d = (p >> 4) * xsize + (8 - (p & 0xf));
        if (d < 1) d = 1;
        if (d <= plane_max) plane[d] = (uint16_t)c;
    }
    parse p = {0};
    if (lz77(px, n, xsize, plane, plane_max, &p)) {
        free(plane);
        return -1;
    }
    uint32_t *hist[5];
    const int max_green = NUM_LITERAL + NUM_LENGTH_CODES + (1 << 11);
    hist[0] = calloc((size_t)max_green, sizeof(uint32_t));
    for (int k = 1; k < 5; k++) hist[k] = calloc(256, sizeof(uint32_t));
    int ok = hist[0] && hist[1] && hist[2] && hist[3] && hist[4];
    int best_bits = 0;
    if (ok) {
        static const int tries[] = {0, 4, 6, 8, 10};
        double best = 0;
        for (int t = 0; t < 5; t++) {
            if (tries[t] && n < (1 << tries[t])) continue;
            apply_cache(&p, px, tries[t], hist);
            double c = stream_cost(&p, hist, tries[t]);
            if (t == 0 || c < best) {
                best = c;
                best_bits = tries[t];
            }
        }
        apply_cache(&p, px, best_bits, hist);
    }
    const int ngreen = NUM_LITERAL + NUM_LENGTH_CODES +
                       (best_bits ? 1 << best_bits : 0);
    static const int sizes[5] = {0, 256, 256, 256, NUM_DISTANCE_CODES};
    hcode codes[5];
    uint8_t *lens = ok ? calloc((size_t)ngreen + 4 * 256, 1) : NULL;
    uint16_t *bits16 = ok ? calloc((size_t)ngreen + 4 * 256, 2) : NULL;
    ok = ok && lens && bits16;
    if (ok) {
        if (best_bits) {
            put_bits(w, 1, 1);
            put_bits(w, (uint32_t)best_bits, 4);
        } else {
            put_bits(w, 0, 1);
        }
        if (level0) put_bits(w, 0, 1);          /* no meta Huffman image */
        size_t off = 0;
        for (int k = 0; k < 5 && ok; k++) {
            codes[k].n = k ? sizes[k] : ngreen;
            codes[k].len = lens + off;
            codes[k].code = bits16 + off;
            off += (size_t)codes[k].n;
            ok = write_code(w, hist[k], &codes[k]) == 0;
        }
    }
    if (ok) {
        size_t pos = 0;
        for (int t = 0; t < p.ntok; t++) {
            const token *k = &p.tok[t];
            if (k->kind == 2) {
                int eb, ev, s = prefix_of(k->len, &eb, &ev);
                put_symbol(w, &codes[0], NUM_LITERAL + s);
                put_bits(w, (uint32_t)ev, eb);
                s = prefix_of(k->dist_code, &eb, &ev);
                put_symbol(w, &codes[4], s);
                put_bits(w, (uint32_t)ev, eb);
                pos += (size_t)k->len;
            } else if (k->kind == 1) {
                put_symbol(w, &codes[0],
                           NUM_LITERAL + NUM_LENGTH_CODES + k->index);
                pos++;
            } else {
                uint32_t v = px[pos++];
                put_symbol(w, &codes[0], (v >> 8) & 0xff);
                put_symbol(w, &codes[1], (v >> 16) & 0xff);
                put_symbol(w, &codes[2], v & 0xff);
                put_symbol(w, &codes[3], v >> 24);
            }
        }
    }
    free(lens);
    free(bits16);
    for (int k = 0; k < 5; k++) free(hist[k]);
    free(p.tok);
    free(plane);
    return ok ? 0 : -1;
}

/* ------------------------------------------------------------ transforms */

static uint32_t average2(uint32_t a, uint32_t b) {
    return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

static uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }

static uint32_t predict(int mode, const uint32_t *row, int x, int w) {
    const uint32_t L = row[x - 1], T = row[x - w], TL = row[x - w - 1],
                   TR = row[x - w + 1];
    switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return average2(average2(L, TR), T);
    case 6: return average2(L, TL);
    case 7: return average2(L, T);
    case 8: return average2(TL, T);
    case 9: return average2(T, TR);
    case 10: return average2(average2(L, TL), average2(T, TR));
    case 11: {
        int d = 0;
        for (int s = 0; s < 32; s += 8) {
            int a = (int)(T >> s) & 0xff, b = (int)(L >> s) & 0xff,
                c = (int)(TL >> s) & 0xff;
            d += abs(b - c) - abs(a - c);
        }
        return d <= 0 ? T : L;
    }
    case 12: {
        uint32_t out = 0;
        for (int s = 0; s < 32; s += 8) {
            int v = (int)((L >> s) & 0xff) + (int)((T >> s) & 0xff) -
                    (int)((TL >> s) & 0xff);
            out |= clip255((uint32_t)v) << s;
        }
        return out;
    }
    case 13: {
        uint32_t ave = average2(L, T), out = 0;
        for (int s = 0; s < 32; s += 8) {
            int a = (int)((ave >> s) & 0xff), c = (int)((TL >> s) & 0xff);
            out |= clip255((uint32_t)(a + (a - c) / 2)) << s;
        }
        return out;
    }
    default: return 0xff000000u;
    }
}

static uint32_t sub_pixels(uint32_t a, uint32_t b) {
    uint32_t ag = 0x00ff00ffu + (a & 0xff00ff00u) - (b & 0xff00ff00u);
    uint32_t rb = 0xff00ff00u + (a & 0x00ff00ffu) - (b & 0x00ff00ffu);
    return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

/* the prediction of pixel (x, y) under a tile's mode: black at (0, 0),
 * the left pixel along row 0, the upper one down column 0 */
static uint32_t prediction(const uint32_t *px, int x, int y, int w,
                           int mode) {
    if (y == 0) return x == 0 ? 0xff000000u : px[x - 1];
    if (x == 0) return px[(size_t)y * w - w];
    return predict(mode, px + (size_t)y * w, x, w);
}

#define NLOG2_TABLE (1 << 16)

/* v * log2(v), from a table of the small values */
static double nlog2(const double *table, uint32_t v) {
    return v < NLOG2_TABLE ? table[v] : v * log2((double)v);
}

/* each tile's mode -> modes[] (every tile force_mode where it is
 * 0..13); the residuals -> res */
static void predictor_transform(const uint32_t *px, int w, int h,
                                int force_mode, uint32_t *modes,
                                uint32_t *res, const double *table) {
    const int tw = (w + (1 << TILE_BITS) - 1) >> TILE_BITS;
    const int th = (h + (1 << TILE_BITS) - 1) >> TILE_BITS;
    uint32_t acc[4][256];
    memset(acc, 0, sizeof acc);
    uint32_t acc_total = 0;
    for (int ty = 0; ty < th; ty++)
        for (int tx = 0; tx < tw; tx++) {
            const int x0 = tx << TILE_BITS, y0 = ty << TILE_BITS;
            const int x1 = x0 + (1 << TILE_BITS) < w ? x0 + (1 << TILE_BITS)
                                                    : w;
            const int y1 = y0 + (1 << TILE_BITS) < h ? y0 + (1 << TILE_BITS)
                                                    : h;
            int best_mode = force_mode;
            double best = 0;
            for (int mode = 0; mode < 14 && force_mode < 0; mode++) {
                uint32_t hist[4][256];
                memset(hist, 0, sizeof hist);
                uint32_t cnt = 0;
                for (int y = y0; y < y1; y++)
                    for (int x = x0; x < x1; x++) {
                        uint32_t r = sub_pixels(px[(size_t)y * w + x],
                                                prediction(px, x, y, w, mode));
                        for (int c = 0; c < 4; c++) hist[c][(r >> (8 * c)) &
                                                            0xff]++;
                        cnt++;
                    }
                /* bits of the tile's residuals given what came before:
                 * the entropy of (acc + tile) less that of acc */
                double bits = 0;
                const uint32_t tot = acc_total + cnt;
                for (int c = 0; c < 4; c++) {
                    double e = nlog2(table, tot) - nlog2(table, acc_total);
                    for (int v = 0; v < 256; v++)
                        if (hist[c][v])
                            e -= nlog2(table, acc[c][v] + hist[c][v]) -
                                 nlog2(table, acc[c][v]);
                    bits += e;
                }
                if (mode == 0 || bits < best) {
                    best = bits;
                    best_mode = mode;
                }
            }
            modes[(size_t)ty * tw + tx] = 0xff000000u | (uint32_t)best_mode << 8;
            for (int y = y0; y < y1; y++)
                for (int x = x0; x < x1; x++) {
                    uint32_t r = sub_pixels(px[(size_t)y * w + x],
                                            prediction(px, x, y, w,
                                                       best_mode));
                    res[(size_t)y * w + x] = r;
                    for (int c = 0; c < 4; c++) acc[c][(r >> (8 * c)) & 0xff]++;
                    acc_total++;
                }
        }
}

int yolo_webp_encode_vp8l(const uint8_t *rgb, int w, int h, int mode,
                          uint8_t **out, size_t *outlen, char *err,
                          size_t errlen) {
    if (mode < -1 || mode > 13) {
        snprintf(err, errlen, "predictor mode %d (0..13, or -1: chosen)",
                 mode);
        return -1;
    }
    if (w < 1 || h < 1 || w > 16384 || h > 16384) {
        snprintf(err, errlen, "a %dx%d image: WebP takes 1..16384 a side", w,
                 h);
        return -1;
    }
    const size_t n = (size_t)w * h;
    const int tw = (w + (1 << TILE_BITS) - 1) >> TILE_BITS;
    const int th = (h + (1 << TILE_BITS) - 1) >> TILE_BITS;
    uint32_t *px = malloc(sizeof(uint32_t) * n);
    uint32_t *res = malloc(sizeof(uint32_t) * n);
    uint32_t *modes = malloc(sizeof(uint32_t) * (size_t)tw * th);
    double *table = malloc(sizeof(double) * NLOG2_TABLE);
    bitw bw = {0};
    int rc = -1;
    if (!px || !res || !modes || !table) goto done;
    table[0] = 0;
    for (int i = 1; i < NLOG2_TABLE; i++) table[i] = i * log2((double)i);
    for (size_t i = 0; i < n; i++) {           /* ARGB, subtract green */
        uint32_t r = rgb[3 * i], g = rgb[3 * i + 1], b = rgb[3 * i + 2];
        px[i] = 0xff000000u | ((r - g) & 0xff) << 16 | g << 8 | ((b - g) & 0xff);
    }
    predictor_transform(px, w, h, mode, modes, res, table);
    put_bits(&bw, 0x2f, 8);
    put_bits(&bw, (uint32_t)(w - 1), 14);
    put_bits(&bw, (uint32_t)(h - 1), 14);
    put_bits(&bw, 0, 1);                       /* no alpha */
    put_bits(&bw, 0, 3);                       /* version */
    put_bits(&bw, 1, 1);
    put_bits(&bw, 2, 2);                       /* subtract green */
    put_bits(&bw, 1, 1);
    put_bits(&bw, 0, 2);                       /* predictor */
    put_bits(&bw, TILE_BITS - 2, 3);
    if (write_image(&bw, modes, tw, th, 0)) goto done;
    put_bits(&bw, 0, 1);                       /* no more transforms */
    if (write_image(&bw, res, w, h, 1)) goto done;
    flush_bits(&bw);
    if (bw.failed) goto done;
    *out = bw.buf;
    *outlen = bw.len;
    bw.buf = NULL;
    rc = 0;
done:
    if (rc) snprintf(err, errlen, "out of memory");
    free(bw.buf);
    free(px);
    free(res);
    free(modes);
    free(table);
    return rc;
}
