// K1: the whole BNF2 (v6/v6b) blind rotation in acc32 mode, for Hopper.
//
// Replaces: tfhe_tpu/ops/pbs_kernel.py::_build_step_fn_v4.step (acc32,
// bnf2=True), i.e. _make_step_kernel_v4's one_step with the bnf2_c32 tail,
// driven step by step by blind_rotate_pallas(bnf2=True). Spec (bit for
// bit): tfhe_tpu/ops/bnf2.py::blind_rotate_bnf2(acc_round32=True) after
// the body rotation, mirrored by tfhe_tpu_torch/ops/bnf2.py::cmux_steps.
//
// The step loop is ntt_common.cuh's blind_rotate_kernel on the u32 hi-plane
// accumulator (torus value = acc * 2^32) with the qp_to_torus32 tail:
//   v1 = (r1 + 2 p1 - r0) * inv01 mod p1,
//   t32 = ((v1 * C1T) >> 28) + (r0 >> S2) + t32_bias, added to acc.
//
// Bound: int32 operations. Per step and ciphertext the kernel runs
// 2 (l*R) forward and 2 R inverse transforms of N/2 * log2(N) butterflies
// each, against ~128 KiB of key (2_2) that all ciphertexts share; the key
// stream is served from L2 when blocks walk the steps together, so the
// INT32 pipe is the roofline. The accumulator, the digit transforms and the
// MAC results stay in shared memory (80 KiB at 2_2) for all n steps.

#include "ntt_common.cuh"

namespace {

struct Bnf2Tail32 {
    using Acc = uint32_t;
    static constexpr int P = 2;
    uint32_t p[2];
    uint32_t inv01, inv01_sh, c1t, t32_bias;
    int s2;

    __device__ uint32_t operator()(const uint32_t* m) const {
        const uint32_t diff = p[1] + p[1] + m[1] - m[0];  // < 3 p1
        const uint32_t v1 = brk::shoup_mul(diff, inv01, inv01_sh, p[1]);
        const uint32_t t1 =
            (uint32_t)(((uint64_t)v1 * c1t) >> 28);  // < 2^32
        return t1 + (m[0] >> s2) + t32_bias;
    }
};

}  // namespace

// acc_in/acc_out: u32 [B, R, N]; a_ms: i32 [B, n] in [0, 2N);
// bsk: u32 [n, 2, 2, levels*R, R, N]; tables: u32 [2, 8, N].
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int blind_rotate_bnf2_acc32(
        const void* acc_in, const void* a_ms, const void* bsk,
        const void* tables, void* acc_out, int B, int n_steps, int R,
        int levels, int base_log, int log_n, unsigned p0, unsigned p1,
        unsigned inv01, unsigned inv01_sh, unsigned c1t, int s2,
        unsigned t32_bias, void* stream) {
    Bnf2Tail32 tail;
    tail.p[0] = p0;
    tail.p[1] = p1;
    tail.inv01 = inv01;
    tail.inv01_sh = inv01_sh;
    tail.c1t = c1t;
    tail.t32_bias = t32_bias;
    tail.s2 = s2;
    return brk::launch_blind_rotate(acc_in, a_ms, bsk, tables, acc_out, B,
                                    n_steps, R, levels, base_log, log_n,
                                    tail, stream);
}

// Bytes of dynamic shared memory one block of blind_rotate_bnf2_acc32
// needs; 0 when num_primes is not 2.
extern "C" unsigned long long blind_rotate_bnf2_acc32_smem(
        int num_primes, int R, int levels, int log_n) {
    if (num_primes != 2) return 0;
    return brk::blind_rotate_smem<Bnf2Tail32>(R, levels, log_n);
}
