/* The byte-level codecs of TIFF strips and tiles for the host decoder
 * and writer (data/tiff.py parses and writes the file and inflates
 * Deflate data with zlib):
 *
 *   - LZW as libtiff 4's tif_lzw.c LZWDecode decodes it: MSB-first codes
 *     of 9 to 12 bits, the width growing one code early (at 511, 1023,
 *     2047), ClearCode 256, EndOfInformation 257, output cut at the
 *     chunk's size;
 *   - PackBits as tif_packbits.c decodes it: -128 skipped, runs and
 *     literals cut at the chunk's size;
 *   - LZW as libtiff 4's LZWEncode / LZWPostEncode write one strip (what
 *     cv2.imwrite's TIFF holds): a clear code first, codes found through
 *     libtiff's open-addressed hash (9001 slots, xor hashing, secondary
 *     probe by HSIZE - h), the width growing one code early, a clear
 *     code when the table fills or when the compression ratio, checked
 *     every 10000 input bytes, has not improved, the end code last.
 *
 * Each returns the bytes written, or -1 with a message in err where
 * libtiff fails too (then cv2 gives no image). Plain C11, no state
 * between calls.
 */

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "native.h"

#define NO_IMAGE "; cv2 gives no image either (libtiff fails there)"

long yolo_tiff_lzw_decode(const uint8_t *in, size_t inlen, uint8_t *out,
                          size_t outlen, char *err, size_t errlen) {
    enum { CLEAR = 256, EOI = 257, MAXBITS = 12, CSIZE = 1 << MAXBITS };
    /* each code: the code before it (-1 for a root), its last byte,
     * its length */
    static const int none = -1;
    int *prefix = malloc(sizeof(int) * CSIZE * 2);
    uint8_t *suffix = malloc(CSIZE), *first = malloc(CSIZE);
    if (!prefix || !suffix || !first) {
        free(prefix);
        free(suffix);
        free(first);
        snprintf(err, errlen, "out of memory");
        return -1;
    }
    int *length = prefix + CSIZE;
    for (int i = 0; i < 256; i++) {
        prefix[i] = none;
        suffix[i] = first[i] = (uint8_t)i;
        length[i] = 1;
    }
    size_t pos = 0, o = 0;
    uint32_t acc = 0;
    int nacc = 0, nbits = 9, free_ent = 258, old = none;
    long result = -1;
    while (o < outlen) {
        while (nacc < nbits && pos < inlen) {
            acc = acc << 8 | in[pos++];
            nacc += 8;
        }
        if (nacc < nbits) {
            snprintf(err, errlen, "corrupt: LZW data ends %zu bytes short of "
                     "its strip or tile" NO_IMAGE, outlen - o);
            goto done;
        }
        int code = (int)(acc >> (nacc - nbits)) & ((1 << nbits) - 1);
        nacc -= nbits;
        if (code == EOI) break;
        if (code == CLEAR) {
            nbits = 9;
            free_ent = 258;
            old = none;
            continue;
        }
        if (old == none) {
            if (code > 255) {
                snprintf(err, errlen, "corrupt: LZW code %d after a clear"
                         NO_IMAGE, code);
                goto done;
            }
            out[o++] = (uint8_t)code;
            old = code;
            continue;
        }
        if (code > free_ent) {
            snprintf(err, errlen, "corrupt: LZW table (code %d of %d)"
                     NO_IMAGE, code, free_ent);
            goto done;
        }
        if (free_ent < CSIZE) {        /* old + the first byte of code */
            prefix[free_ent] = old;
            first[free_ent] = first[old];
            suffix[free_ent] = code == free_ent ? first[old] : first[code];
            length[free_ent] = length[old] + 1;
            free_ent++;
            if (free_ent > (1 << nbits) - 2 && nbits < MAXBITS) nbits++;
        }
        /* write the string of code, last byte first, cut at outlen */
        int n = length[code];
        size_t end = o + (size_t)n;
        for (int c = code; c != none; c = prefix[c]) {
            --end;
            if (end < outlen) out[end] = suffix[c];
        }
        o += (size_t)n;
        old = code;
    }
    if (o < outlen) {
        snprintf(err, errlen, "corrupt: LZW data ends %zu bytes short of its "
                 "strip or tile" NO_IMAGE, outlen - o);
        goto done;
    }
    result = (long)outlen;
done:
    free(prefix);
    free(suffix);
    free(first);
    return result;
}

long yolo_tiff_packbits_decode(const uint8_t *in, size_t inlen, uint8_t *out,
                               size_t outlen, char *err, size_t errlen) {
    size_t pos = 0, o = 0;
    while (o < outlen) {
        if (pos >= inlen) {
            snprintf(err, errlen, "corrupt: PackBits data ends %zu bytes "
                     "short of its strip or tile" NO_IMAGE, outlen - o);
            return -1;
        }
        int n = (int8_t)in[pos++];
        if (n == -128) continue;
        if (n < 0) {
            size_t run = (size_t)(1 - n);
            if (pos >= inlen) {
                snprintf(err, errlen, "corrupt: PackBits run without its "
                         "byte" NO_IMAGE);
                return -1;
            }
            if (run > outlen - o) run = outlen - o;
            memset(out + o, in[pos++], run);
            o += run;
        } else {
            size_t lit = (size_t)n + 1;
            if (lit > outlen - o) lit = outlen - o;
            if (lit > inlen - pos) {
                snprintf(err, errlen, "corrupt: PackBits literal past the "
                         "data" NO_IMAGE);
                return -1;
            }
            memcpy(out + o, in + pos, lit);
            pos += (size_t)n + 1;
            o += lit;
        }
    }
    return (long)o;
}

/* libtiff's tif_lzw.c encoder constants */
enum { BITS_MIN = 9, BITS_MAX = 12, HSIZE = 9001, HSHIFT = 13 - 8,
       CHECK_GAP = 10000, CODE_CLEAR = 256, CODE_EOI = 257, CODE_FIRST = 258,
       CODE_MAX = (1 << BITS_MAX) - 1 };

typedef struct {
    uint8_t *op;
    uint64_t nextdata;
    long nextbits;
    long outcount;
} lzw_out;

static void put_code(lzw_out *o, int nbits, int c) {
    o->nextdata = (o->nextdata << nbits) | (uint64_t)c;
    o->nextbits += nbits;
    *o->op++ = (uint8_t)((o->nextdata >> (o->nextbits - 8)) & 0xff);
    o->nextbits -= 8;
    if (o->nextbits >= 8) {
        *o->op++ = (uint8_t)((o->nextdata >> (o->nextbits - 8)) & 0xff);
        o->nextbits -= 8;
    }
    o->outcount += nbits;
}

long yolo_tiff_lzw_encode(const uint8_t *in, size_t inlen, uint8_t *out,
                          size_t outcap, char *err, size_t errlen) {
    /* 12 bits a byte and a clear code every 253 codes at worst */
    if (outcap < inlen * 2 + 16) {
        snprintf(err, errlen, "LZW output buffer of %zu bytes for %zu",
                 outcap, inlen);
        return -1;
    }
    long *hash = malloc(sizeof(long) * HSIZE);
    uint16_t *hcode = malloc(sizeof(uint16_t) * HSIZE);
    if (!hash || !hcode) {
        free(hash);
        free(hcode);
        snprintf(err, errlen, "out of memory");
        return -1;
    }
    for (int i = 0; i < HSIZE; i++) hash[i] = -1;
    lzw_out o = {out, 0, 0, 0};
    long incount = 0, checkpoint = CHECK_GAP, ratio = 0;
    int free_ent = CODE_FIRST, nbits = BITS_MIN, maxcode = (1 << BITS_MIN) - 1;
    int ent = -1;
    size_t pos = 0;
    if (inlen > 0) {
        put_code(&o, nbits, CODE_CLEAR);
        ent = in[pos++];
        incount++;
    }
    while (pos < inlen) {
        int c = in[pos++];
        incount++;
        long fcode = ((long)c << BITS_MAX) + ent;
        int h = (c << HSHIFT) ^ ent;
        if (hash[h] == fcode) {
            ent = hcode[h];
            continue;
        }
        if (hash[h] >= 0) {
            int disp = h == 0 ? 1 : HSIZE - h;
            int found = 0;
            do {
                if ((h -= disp) < 0) h += HSIZE;
                if (hash[h] == fcode) {
                    ent = hcode[h];
                    found = 1;
                    break;
                }
            } while (hash[h] >= 0);
            if (found) continue;
        }
        put_code(&o, nbits, ent);
        ent = c;
        hcode[h] = (uint16_t)free_ent++;
        hash[h] = fcode;
        if (free_ent == CODE_MAX - 1) {
            for (int i = 0; i < HSIZE; i++) hash[i] = -1;
            ratio = 0;
            incount = 0;
            o.outcount = 0;
            free_ent = CODE_FIRST;
            put_code(&o, nbits, CODE_CLEAR);
            nbits = BITS_MIN;
            maxcode = (1 << BITS_MIN) - 1;
        } else if (free_ent > maxcode) {
            nbits++;
            maxcode = (1 << nbits) - 1;
        } else if (incount >= checkpoint) {
            long rat;
            checkpoint = incount + CHECK_GAP;
            if (incount > 0x007fffff) {
                rat = o.outcount >> 8;
                rat = rat == 0 ? 0x7fffffff : incount / rat;
            } else {
                rat = (incount << 8) / o.outcount;
            }
            if (rat <= ratio) {
                for (int i = 0; i < HSIZE; i++) hash[i] = -1;
                ratio = 0;
                incount = 0;
                o.outcount = 0;
                free_ent = CODE_FIRST;
                put_code(&o, nbits, CODE_CLEAR);
                nbits = BITS_MIN;
                maxcode = (1 << BITS_MIN) - 1;
            } else {
                ratio = rat;
            }
        }
    }
    if (ent != -1) {                        /* LZWPostEncode */
        put_code(&o, nbits, ent);
        free_ent++;
        if (free_ent == CODE_MAX - 1) {
            o.outcount = 0;
            put_code(&o, nbits, CODE_CLEAR);
            nbits = BITS_MIN;
        } else if (free_ent > maxcode) {
            nbits++;
        }
    }
    put_code(&o, nbits, CODE_EOI);
    if (o.nextbits > 0)
        *o.op++ = (uint8_t)((o.nextdata << (8 - o.nextbits)) & 0xff);
    free(hash);
    free(hcode);
    return (long)(o.op - out);
}
