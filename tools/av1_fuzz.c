/* A mutation fuzzer for the port's AV1 decoder (yolo_tpu_torch/native/
 * av1*.c), to be built with the sanitizers:
 *
 *   N=yolo_tpu_torch/native
 *   gcc -O1 -g -std=c11 -D_DEFAULT_SOURCE -fsanitize=address,undefined \
 *       -fno-sanitize-recover=undefined -I$N -o av1_fuzz tools/av1_fuzz.c \
 *       $N/av1_obu.c $N/av1_entropy.c $N/av1_block.c $N/av1_recon.c \
 *       $N/av1_filter.c -lm
 *   ./av1_fuzz ITERS SEED FILE.avif ...
 *
 * For each AVIF file it takes the mdat box's payload (the OBUs of the
 * files cv2 and PIL write) and decodes it once as it is, then ITERS
 * copies, each with one to four mutations: a bit flipped, a byte set to
 * a random value, the data cut short, or an OBU's size byte set to a
 * random value. A third of the mutations fall in the first 64 bytes (the
 * sequence and frame headers). A sanitizer report stops the run; a case
 * that runs over CASE_SECONDS is written to av1_fuzz_hang.obu in the
 * working directory and the run exits with code 3. It prints the number
 * of cases decoded and refused. */

#include <signal.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>

#define CASE_SECONDS 10

int yolo_av1_decode(const uint8_t *data, size_t len, uint8_t **out,
                    int32_t *info, char *err, size_t errlen);

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
    FILE *f = fopen("av1_fuzz_hang.obu", "wb");
    if (f) {
        fwrite(cur, 1, curlen, f);
        fclose(f);
    }
    static const char msg[] = "a case ran over its time: av1_fuzz_hang.obu\n";
    if (write(2, msg, sizeof msg - 1) < 0) _exit(4);
    _exit(3);
}

static void mutate(uint8_t *m, size_t *l) {
    int k = 1 + (int)(rnd() % 4);
    for (int j = 0; j < k; j++) {
        size_t pos = rnd() % 3 == 0 ? rnd() % (*l < 64 ? *l : 64)
                                    : rnd() % *l;
        switch (rnd() % 4) {
        case 0: m[pos] ^= (uint8_t)(1u << (rnd() % 8)); break;
        case 1: m[pos] = (uint8_t)rnd(); break;
        case 2: *l = pos + 1; break;
        default:
            /* the first OBU header with a size field at or after pos:
             * its first size byte */
            for (size_t q = pos; q + 1 < *l; q++) {
                if ((m[q] & 0x82) == 0x02 && ((m[q] >> 3) & 15) <= 8) {
                    m[q + 1] = (uint8_t)rnd();
                    break;
                }
            }
        }
    }
}

static int decode(const uint8_t *m, size_t l) {
    uint8_t *out;
    int32_t info[9];
    char err[256];
    cur = m;
    curlen = l;
    alarm(CASE_SECONDS);
    int rc = yolo_av1_decode(m, l, &out, info, err, sizeof err);
    alarm(0);
    if (rc == 0) free(out);
    return rc == 0;
}

int main(int argc, char **argv) {
    if (argc < 4) {
        fprintf(stderr, "usage: %s ITERS SEED FILE.avif...\n", argv[0]);
        return 2;
    }
    int iters = atoi(argv[1]);
    state ^= (uint64_t)atoll(argv[2]) * 0x9e3779b97f4a7c15ull;
    signal(SIGALRM, on_alarm);
    static uint8_t buf[1 << 23];
    long ok = 0, refused = 0;
    for (int f = 3; f < argc; f++) {
        FILE *fp = fopen(argv[f], "rb");
        if (!fp) {
            perror(argv[f]);
            return 2;
        }
        size_t n = fread(buf, 1, sizeof buf, fp);
        fclose(fp);
        size_t off = 0, end = 0;
        for (size_t i = 4; i + 4 <= n; i++) {
            if (!memcmp(buf + i, "mdat", 4)) {
                size_t size = (size_t)buf[i - 4] << 24 |
                              (size_t)buf[i - 3] << 16 |
                              (size_t)buf[i - 2] << 8 | buf[i - 1];
                off = i + 4;
                end = size >= 8 && i - 4 + size <= n ? i - 4 + size : n;
                break;
            }
        }
        if (!off || end <= off) {
            fprintf(stderr, "%s: no mdat box\n", argv[f]);
            return 2;
        }
        size_t len = end - off;
        uint8_t *m = malloc(len);
        if (decode(buf + off, len)) ok++;
        else refused++;
        for (int it = 0; it < iters; it++) {
            size_t l = len;
            memcpy(m, buf + off, len);
            mutate(m, &l);
            if (decode(m, l)) ok++;
            else refused++;
        }
        free(m);
    }
    printf("decoded %ld refused %ld\n", ok, refused);
    return 0;
}
