/* C API of tfhe_tpu_torch, the PyTorch/CUDA port of tfhe_tpu.
 *
 * The port's own copy of c_api/tfhe_tpu.h: every declaration of that header
 * is here unchanged, so a C program written against tfhe_tpu builds against
 * the port as it is. It mirrors the reference's cbindgen-generated C API
 * surface (tfhe/src/c_api/: opaque pointers per type, one extern fn per op,
 * int return codes with 0 == success; panics caught at the boundary). The
 * runtime embeds CPython and dispatches into tfhe_tpu_torch, whose kernels
 * run on a CUDA GPU.
 *
 * One function is added: tfhe_tpu_init_on(device) chooses the device the
 * keys and ciphertexts live on ("cuda", "cuda:1", "cpu"). tfhe_tpu_init()
 * means the GPU, and fails (non-zero, with the reason in
 * tfhe_tpu_last_error()) when there is none.
 *
 * Thread-safety: calls are serialized on the embedded interpreter's GIL.
 */

#ifndef TFHE_TPU_C_API_H
#define TFHE_TPU_C_API_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct TfheClientKey TfheClientKey;
typedef struct TfheServerKey TfheServerKey;
typedef struct TfheFheUint TfheFheUint;

/* Global runtime ------------------------------------------------------- */

/* Initialize the embedded runtime. Must be called once before any other
 * function. Returns 0 on success. */
int tfhe_tpu_init(void);

/* Initialize the runtime on ``device`` (a torch device name: "cuda",
 * "cuda:1", "cpu"; NULL means the GPU, as tfhe_tpu_init()). Calling it
 * again moves later keys and deserialized ciphertexts to the new device.
 * Returns 0 on success. */
int tfhe_tpu_init_on(const char *device);

/* Tear down the runtime (optional; the OS reclaims on exit). */
int tfhe_tpu_shutdown(void);

/* Last error message (valid until the next failing call). */
const char *tfhe_tpu_last_error(void);

/* Key management -------------------------------------------------------- */

/* Generate a (client, server) keypair for the named parameter set
 * (e.g. "PARAM_TEST_TOY", "PARAM_MESSAGE_2_CARRY_2_KS_PBS"). */
int tfhe_tpu_generate_keys(const char *param_set_name, uint64_t seed,
                           TfheClientKey **client_key,
                           TfheServerKey **server_key);

/* Install the server key for subsequent homomorphic ops (the analog of
 * set_server_key / thread-local InternalServerKey dispatch). */
int tfhe_tpu_set_server_key(TfheServerKey *server_key);

void tfhe_tpu_client_key_destroy(TfheClientKey *key);
void tfhe_tpu_server_key_destroy(TfheServerKey *key);

/* FheUint (width in {8, 16, 32, 64}) ----------------------------------- */

int tfhe_tpu_fheuint_encrypt(uint32_t bit_width, uint64_t clear,
                             TfheClientKey *key, TfheFheUint **out);
int tfhe_tpu_fheuint_decrypt(TfheFheUint *ct, TfheClientKey *key,
                             uint64_t *clear_out);
int tfhe_tpu_fheuint_try_encrypt_trivial(uint32_t bit_width, uint64_t clear,
                                         TfheFheUint **out);
void tfhe_tpu_fheuint_destroy(TfheFheUint *ct);

/* binary ops (out is a fresh handle) */
int tfhe_tpu_fheuint_add(TfheFheUint *lhs, TfheFheUint *rhs, TfheFheUint **out);
int tfhe_tpu_fheuint_sub(TfheFheUint *lhs, TfheFheUint *rhs, TfheFheUint **out);
int tfhe_tpu_fheuint_mul(TfheFheUint *lhs, TfheFheUint *rhs, TfheFheUint **out);
int tfhe_tpu_fheuint_bitand(TfheFheUint *lhs, TfheFheUint *rhs, TfheFheUint **out);
int tfhe_tpu_fheuint_bitor(TfheFheUint *lhs, TfheFheUint *rhs, TfheFheUint **out);
int tfhe_tpu_fheuint_bitxor(TfheFheUint *lhs, TfheFheUint *rhs, TfheFheUint **out);
int tfhe_tpu_fheuint_eq(TfheFheUint *lhs, TfheFheUint *rhs, TfheFheUint **out);
int tfhe_tpu_fheuint_lt(TfheFheUint *lhs, TfheFheUint *rhs, TfheFheUint **out);
int tfhe_tpu_fheuint_ne(TfheFheUint *lhs, TfheFheUint *rhs, TfheFheUint **out);
int tfhe_tpu_fheuint_le(TfheFheUint *lhs, TfheFheUint *rhs, TfheFheUint **out);
int tfhe_tpu_fheuint_gt(TfheFheUint *lhs, TfheFheUint *rhs, TfheFheUint **out);
int tfhe_tpu_fheuint_ge(TfheFheUint *lhs, TfheFheUint *rhs, TfheFheUint **out);
int tfhe_tpu_fheuint_min(TfheFheUint *lhs, TfheFheUint *rhs, TfheFheUint **out);
int tfhe_tpu_fheuint_max(TfheFheUint *lhs, TfheFheUint *rhs, TfheFheUint **out);
int tfhe_tpu_fheuint_div(TfheFheUint *lhs, TfheFheUint *rhs, TfheFheUint **out);
int tfhe_tpu_fheuint_rem(TfheFheUint *lhs, TfheFheUint *rhs, TfheFheUint **out);
int tfhe_tpu_fheuint_neg(TfheFheUint *ct, TfheFheUint **out);
int tfhe_tpu_fheuint_not(TfheFheUint *ct, TfheFheUint **out);

/* scalar ops */
int tfhe_tpu_fheuint_scalar_add(TfheFheUint *lhs, uint64_t rhs, TfheFheUint **out);
int tfhe_tpu_fheuint_scalar_mul(TfheFheUint *lhs, uint64_t rhs, TfheFheUint **out);
int tfhe_tpu_fheuint_scalar_shl(TfheFheUint *lhs, uint64_t rhs, TfheFheUint **out);
int tfhe_tpu_fheuint_scalar_shr(TfheFheUint *lhs, uint64_t rhs, TfheFheUint **out);

/* serialization (caller frees *buf with tfhe_tpu_buffer_destroy) */
int tfhe_tpu_fheuint_serialize(TfheFheUint *ct, uint8_t **buf, size_t *len);
int tfhe_tpu_fheuint_deserialize(const uint8_t *buf, size_t len,
                                 TfheFheUint **out);
void tfhe_tpu_buffer_destroy(uint8_t *buf, size_t len);

#ifdef __cplusplus
}
#endif

#endif /* TFHE_TPU_C_API_H */
