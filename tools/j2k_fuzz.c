/* A mutation fuzzer for the port's JPEG 2000 codestream decoder
 * (yolo_tpu_torch/native/j2k*.c), to be built with the sanitizers:
 *
 *   N=yolo_tpu_torch/native
 *   gcc -O1 -g -std=c11 -D_DEFAULT_SOURCE -fsanitize=address,undefined \
 *       -fno-sanitize-recover=undefined -I$N -o j2k_fuzz tools/j2k_fuzz.c \
 *       $N/j2k.c $N/j2k_t1.c $N/j2k_t2.c $N/j2k_dwt.c -lm
 *   ./j2k_fuzz ITERS SEED FILE.j2k|FILE.jp2 ...
 *
 * For each file (a JP2's jp2c box or a raw codestream) it decodes ITERS
 * copies, each with one to four mutations: a bit flipped, a byte set to
 * a random value or to 0xFF, the data cut short, or the length of the
 * next marker segment set to 0-5. A sanitizer report stops the run; a
 * case that runs over CASE_SECONDS is written to j2k_fuzz_hang.j2k in
 * the working directory and the run exits with code 3. It prints the
 * number of cases decoded and refused. */

#include <signal.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>

#define CASE_SECONDS 5

int yolo_j2k_decode(const uint8_t *data, size_t len, int32_t **out,
                    int32_t *info, int maxcomps, char *err, size_t errlen);

static uint64_t state = 88172645463325252ull;
static const uint8_t *cur;
static size_t curlen;

static uint64_t rnd(void) {
    state ^= state << 13;
    state ^= state >> 7;
    state ^= state << 17;
    return state;
}

static void on_alarm(int sig) {
    (void)sig;
    FILE *f = fopen("j2k_fuzz_hang.j2k", "wb");
    if (f) {
        fwrite(cur, 1, curlen, f);
        fclose(f);
    }
    static const char msg[] = "a case ran over its time: j2k_fuzz_hang.j2k\n";
    if (write(2, msg, sizeof msg - 1) < 0) _exit(4);
    _exit(3);
}

static void mutate(uint8_t *m, size_t *l) {
    int k = 1 + (int)(rnd() % 4);
    for (int j = 0; j < k; j++) {
        /* a third of the mutations fall in the first 200 bytes: the
         * main header */
        size_t pos = rnd() % 3 == 0 ? rnd() % (*l < 200 ? *l : 200)
                                    : rnd() % *l;
        switch (rnd() % 5) {
        case 0: m[pos] ^= (uint8_t)(1u << (rnd() % 8)); break;
        case 1: m[pos] = (uint8_t)rnd(); break;
        case 2: *l = pos + 1; break;
        case 3: m[pos] = 0xff; break;
        default: {
            /* the next marker with a segment: its length set to 0-5 */
            size_t q = pos;
            while (q + 3 < *l && !(m[q] == 0xff && m[q + 1] >= 0x50 &&
                                   m[q + 1] != 0x93 && m[q + 1] != 0xd9))
                q++;
            if (q + 3 < *l) {
                m[q + 2] = 0;
                m[q + 3] = (uint8_t)(rnd() % 6);
            }
        }
        }
    }
}

int main(int argc, char **argv) {
    if (argc < 4) {
        fprintf(stderr, "usage: %s ITERS SEED FILE...\n", argv[0]);
        return 2;
    }
    int iters = atoi(argv[1]);
    state ^= (uint64_t)atoll(argv[2]) * 0x9e3779b97f4a7c15ull;
    signal(SIGALRM, on_alarm);
    static uint8_t buf[1 << 22];
    long ok = 0, refused = 0;
    for (int f = 3; f < argc; f++) {
        FILE *fp = fopen(argv[f], "rb");
        if (!fp) {
            perror(argv[f]);
            return 2;
        }
        size_t n = fread(buf, 1, sizeof buf, fp);
        fclose(fp);
        size_t off = 0;
        for (size_t i = 0; i + 4 < n; i++)
            if (!memcmp(buf + i, "jp2c", 4)) {
                off = i + 4;
                break;
            }
        size_t len = n - off;
        uint8_t *m = malloc(len);
        for (int it = 0; it < iters; it++) {
            size_t l = len;
            memcpy(m, buf + off, len);
            mutate(m, &l);
            cur = m;
            curlen = l;
            int32_t info[5 + 8 * 16], *out;
            char err[256];
            alarm(CASE_SECONDS);
            if (yolo_j2k_decode(m, l, &out, info, 16, err, sizeof err) == 0) {
                ok++;
                free(out);
            } else {
                refused++;
            }
            alarm(0);
        }
        free(m);
    }
    printf("decoded %ld refused %ld\n", ok, refused);
    return 0;
}
