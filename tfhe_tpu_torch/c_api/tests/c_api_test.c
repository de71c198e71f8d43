/* C API smoke test of tfhe_tpu_torch (the analog of the reference
 * c_api_tests C programs; the checks of c_api/tests/c_api_test.c): keygen,
 * encrypt, compute, decrypt, serialize round-trip — pure C, error codes
 * checked.
 *
 *   c_api_test [device [param_set [sum_out [seed]]]]
 *
 * device: "gpu" (tfhe_tpu_init(), the default) or a torch device name for
 * tfhe_tpu_init_on() ("cuda", "cpu"); param_set: a name of PARAMS_BY_NAME
 * (default PARAM_TEST_TOY); sum_out: a file that receives the serialized
 * bytes of FheUint8(27) + FheUint8(15); seed: the keys' seed (default 42).
 * Each call's wall time goes to stderr as "op <name> <ms> ms": an
 * operation's with the decryption of its result, which waits for the
 * device (an operation may return with its last bootstrap still queued). */

#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include "tfhe_tpu.h"

#define CHECK(expr)                                                        \
    do {                                                                   \
        int _rc = (expr);                                                  \
        if (_rc != 0) {                                                    \
            fprintf(stderr, "FAIL %s -> %d: %s\n", #expr, _rc,             \
                    tfhe_tpu_last_error());                                \
            return 1;                                                      \
        }                                                                  \
    } while (0)

static double now_ms(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return ts.tv_sec * 1e3 + ts.tv_nsec / 1e6;
}

/* run expr (CHECKed), then print its wall time as "op <name> <ms> ms" */
#define TIMED(name, expr)                                                  \
    do {                                                                   \
        double _t0 = now_ms();                                             \
        CHECK(expr);                                                       \
        fprintf(stderr, "op %s %.3f ms\n", name, now_ms() - _t0);          \
    } while (0)

int main(int argc, char **argv) {
    const char *device = argc > 1 ? argv[1] : "gpu";
    const char *params = argc > 2 ? argv[2] : "PARAM_TEST_TOY";
    const char *sum_out = argc > 3 ? argv[3] : NULL;
    uint64_t seed = argc > 4 ? strtoull(argv[4], NULL, 0) : 42;

    if (strcmp(device, "gpu") == 0) {
        TIMED("init", tfhe_tpu_init());
    } else {
        TIMED("init", tfhe_tpu_init_on(device));
    }

    TfheClientKey *ck = NULL;
    TfheServerKey *sk = NULL;
    TIMED("generate_keys", tfhe_tpu_generate_keys(params, seed, &ck, &sk));
    CHECK(tfhe_tpu_set_server_key(sk));

    TfheFheUint *a = NULL, *b = NULL;
    TIMED("encrypt", tfhe_tpu_fheuint_encrypt(8, 27, ck, &a));
    CHECK(tfhe_tpu_fheuint_encrypt(8, 15, ck, &b));

    uint64_t clear = 0;

    TfheFheUint *sum = NULL;
    TIMED("add", tfhe_tpu_fheuint_add(a, b, &sum) ||
                tfhe_tpu_fheuint_decrypt(sum, ck, &clear));
    if (clear != 42) { fprintf(stderr, "add: got %llu want 42\n",
                               (unsigned long long)clear); return 1; }

    TfheFheUint *band = NULL;
    TIMED("bitand", tfhe_tpu_fheuint_bitand(a, b, &band) ||
                tfhe_tpu_fheuint_decrypt(band, ck, &clear));
    if (clear != (27 & 15)) { fprintf(stderr, "bitand: got %llu\n",
                                      (unsigned long long)clear); return 1; }

    TfheFheUint *smul = NULL;
    TIMED("scalar_mul", tfhe_tpu_fheuint_scalar_mul(a, 3, &smul) ||
                tfhe_tpu_fheuint_decrypt(smul, ck, &clear));
    if (clear != (27ull * 3) % 256) { fprintf(stderr, "smul wrong\n"); return 1; }

    /* round-2 surface: comparisons, min/max, scalar shifts, unary */
    TfheFheUint *ge = NULL, *mx = NULL, *shl = NULL, *inv = NULL;
    TIMED("ge", tfhe_tpu_fheuint_ge(a, b, &ge) ||
                tfhe_tpu_fheuint_decrypt(ge, ck, &clear));
    if (clear != 1) { fprintf(stderr, "ge wrong\n"); return 1; }
    TIMED("max", tfhe_tpu_fheuint_max(a, b, &mx) ||
                tfhe_tpu_fheuint_decrypt(mx, ck, &clear));
    if (clear != 27) { fprintf(stderr, "max wrong\n"); return 1; }
    TIMED("scalar_shl", tfhe_tpu_fheuint_scalar_shl(b, 2, &shl) ||
                tfhe_tpu_fheuint_decrypt(shl, ck, &clear));
    if (clear != (15ull << 2)) { fprintf(stderr, "shl wrong\n"); return 1; }
    TIMED("not", tfhe_tpu_fheuint_not(b, &inv) ||
                tfhe_tpu_fheuint_decrypt(inv, ck, &clear));
    if (clear != (~15ull & 0xff)) { fprintf(stderr, "not wrong\n"); return 1; }
    tfhe_tpu_fheuint_destroy(ge);
    tfhe_tpu_fheuint_destroy(mx);
    tfhe_tpu_fheuint_destroy(shl);
    tfhe_tpu_fheuint_destroy(inv);

    /* serialization round trip */
    uint8_t *buf = NULL;
    size_t len = 0;
    TIMED("serialize", tfhe_tpu_fheuint_serialize(sum, &buf, &len));
    if (sum_out) {
        FILE *f = fopen(sum_out, "wb");
        if (!f || fwrite(buf, 1, len, f) != len || fclose(f) != 0) {
            fprintf(stderr, "cannot write %s\n", sum_out);
            return 1;
        }
    }
    TfheFheUint *back = NULL;
    TIMED("deserialize", tfhe_tpu_fheuint_deserialize(buf, len, &back) ||
                tfhe_tpu_fheuint_decrypt(back, ck, &clear));
    if (clear != 42) { fprintf(stderr, "roundtrip: got %llu\n",
                               (unsigned long long)clear); return 1; }
    tfhe_tpu_buffer_destroy(buf, len);

    tfhe_tpu_fheuint_destroy(a);
    tfhe_tpu_fheuint_destroy(b);
    tfhe_tpu_fheuint_destroy(sum);
    tfhe_tpu_fheuint_destroy(band);
    tfhe_tpu_fheuint_destroy(smul);
    tfhe_tpu_fheuint_destroy(back);
    tfhe_tpu_client_key_destroy(ck);
    tfhe_tpu_server_key_destroy(sk);

    printf("c_api_test OK\n");
    return 0;
}
