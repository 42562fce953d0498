/* GIF's variable-length LZW for the host decoder (data/gif.py reads
 * the blocks, the colour tables and the canvas): the data of one
 * image's sub-blocks, joined, -> its colour indices, as OpenCV 5's own
 * GIF decoder (grfmt_gif.cpp, not giflib) gives them for well-formed
 * streams:
 *
 *   - codes LSB first, min_code_size + 1 bits wide after each clear
 *     code (min_code_size 2..11, else cv2 gives no image), the width
 *     growing once the next free code reaches 1 << width, to 12 bits;
 *     past 4095 the table stays full (the ``deferred clear'');
 *   - the clear code resets the table (a stream may start without one);
 *     a code past the next free one, or the next free one with no code
 *     before it, is an error, as is data that ends before the image is
 *     whole (then cv2 gives no image either);
 *   - the image is whole once n indices are out; what may follow is
 *     what encoders write there: padding of the last byte, or the end
 *     code and its padding. cv2 accepts or refuses other trailing codes
 *     by rules of its own that are not reproduced: they return -2 (the
 *     caller raises "unsupported here"), as do an end code before the
 *     image is whole with data after it and a code whose string runs
 *     past the image. An end code before the image is whole and nothing
 *     after it is data that ends early.
 *
 * Plain C11, no state between calls.
 */

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "native.h"

#define NO_IMAGE "; cv2 gives no image either"

int yolo_gif_lzw_decode(const uint8_t *data, size_t len, int min_code_size,
                        uint8_t *out, size_t n, char *err, size_t errlen) {
    enum { MAXCODES = 4096 };
    if (min_code_size < 2 || min_code_size > 11) {
        snprintf(err, errlen, "corrupt: an LZW minimum code size of %d"
                 NO_IMAGE, min_code_size);
        return -1;
    }
    int *prefix = malloc(sizeof(int) * MAXCODES * 2);
    uint8_t *suffix = malloc(MAXCODES), *first = malloc(MAXCODES);
    if (!prefix || !suffix || !first) {
        free(prefix);
        free(suffix);
        free(first);
        snprintf(err, errlen, "out of memory");
        return -1;
    }
    int *length = prefix + MAXCODES;
    const int clear = 1 << min_code_size, eoi = clear + 1;
    for (int i = 0; i < clear; i++) {
        prefix[i] = -1;
        suffix[i] = first[i] = (uint8_t)i;
        length[i] = 1;
    }
    int width = min_code_size + 1, next = eoi + 1, old = -1, result = -1;
    size_t o = 0, bitpos = 0, nbits = len * 8;
    while (o < n) {
        if (nbits - bitpos < (size_t)width) {
            snprintf(err, errlen, "corrupt: LZW data ends %zu pixels short of "
                     "the image" NO_IMAGE, n - o);
            goto done;
        }
        int code = 0;
        for (int b = 0; b < width; b++, bitpos++)
            code |= ((data[bitpos >> 3] >> (bitpos & 7)) & 1) << b;
        if (code == clear) {
            width = min_code_size + 1;
            next = eoi + 1;
            old = -1;
            continue;
        }
        if (code == eoi) {
            if (nbits - bitpos < 8) {
                snprintf(err, errlen, "corrupt: LZW data ends %zu pixels "
                         "short of the image" NO_IMAGE, n - o);
            } else {
                snprintf(err, errlen, "unsupported here: an LZW end code "
                         "%zu pixels before the image is whole, data after "
                         "it", n - o);
                result = -2;
            }
            goto done;
        }
        if (code > next || (code == next && old < 0)) {
            snprintf(err, errlen, "corrupt: LZW code %d of a table of %d"
                     NO_IMAGE, code, next);
            goto done;
        }
        if (old >= 0 && next < MAXCODES) {
            prefix[next] = old;
            first[next] = first[old];
            suffix[next] = code == next ? first[old] : first[code];
            length[next] = length[old] + 1;
            next++;
            if (next == (1 << width) && width < 12) width++;
        }
        size_t len_c = (size_t)length[code];
        if (len_c > n - o) {
            snprintf(err, errlen, "unsupported here: an LZW string runs %zu "
                     "pixels past the image", len_c - (n - o));
            result = -2;
            goto done;
        }
        size_t end = o + len_c;
        for (int c = code; c >= 0; c = prefix[c]) out[--end] = suffix[c];
        o += len_c;
        old = code;
    }
    /* what follows the last pixel: padding, or the end code and padding */
    size_t rest = nbits - bitpos;
    if (rest >= 8 && rest >= (size_t)width) {
        int code = 0;
        for (int b = 0; b < width; b++)
            code |= ((data[(bitpos + b) >> 3] >> ((bitpos + b) & 7)) & 1) << b;
        if (code == eoi) rest -= (size_t)width;
    }
    if (rest >= 8) {
        snprintf(err, errlen, "unsupported here: %zu bits of LZW data past "
                 "the image's last pixel (cv2 5 keeps or refuses them by "
                 "rules of its own)", rest);
        result = -2;
        goto done;
    }
    result = 0;
done:
    free(prefix);
    free(suffix);
    free(first);
    return result;
}
