// K3: the whole blind rotation on the exact u64 (two-plane) accumulator,
// for Hopper, with one of two recombination tails; and K3-acc32, the same
// step on the u32 hi-plane accumulator with the rounding Garner tail.
//
// Replaces: tfhe_tpu/ops/pbs_kernel.py::_build_step_fn_v4.step (pallas_call
// at :1867), i.e. _make_step_kernel_v4's one_step with
//   - the garner_c tail (:1441), two-plane: the exact P-prime CRT path
//     (boolean gates at P = 3, the shortint "crt" variant at P = 4); the
//     same function as the legacy _build_step_fn.step (:954), which differs
//     only in TPU layout. Spec: tfhe_tpu/ops/server.py::blind_rotate after
//     the body rotation, mirrored by
//     tfhe_tpu_torch/ops/server.py::cmux_steps_crt.
//   - the garner_c tail in acc32 mode (TFHE_V4_ACC=32 on the v4 CRT path,
//     :2082-2083; the rounding at :1635-1640): every increment rounded to a
//     multiple of 2^32. Spec: server.blind_rotate(acc_round32=True), the
//     port's cmux_steps_crt(acc_round32=True).
//   - the bnf2_c tail (:1484): the v6/v6b step under TFHE_V4_ACC=64. Spec:
//     tfhe_tpu/ops/bnf2.py::blind_rotate_bnf2(acc_round32=False), mirrored
//     by tfhe_tpu_torch/ops/bnf2.py::cmux_steps.
//
// The step loop is ntt_common.cuh's blind_rotate_kernel. With Acc = u64 the
// decomposer reads the hi word of the full 64-bit rot - acc, so the borrow
// out of the lo word reaches it; with Acc = u32 (acc32) the accumulator is
// the hi plane of a multiple of 2^32 and there is no lo word. At base_log *
// levels >= 32 (tfhe-rs's sets with 4 to 6 levels, or 11 x 3, all at P =
// 4) the u64 entry runs the kernel on GarnerTailDeep<4>, whose lift
// decomposes all 64 bits (Decomposer64); the acc32 and BNF2 entries take
// b l <= 31 only.
//
// Bound: int32 operations. Per step and ciphertext: P (l*R) forward and
// P R inverse transforms of N/2 * log2(N) butterflies, P R l*R Shoup MACs
// and the tail, against a step key of 2 P l R R N u32 (393 KB for the
// boolean default set) that all ciphertexts share and read from L2. The
// whole key is never staged in shared memory; the accumulator and the
// digit transforms are (the MAC rows overwrite digit rows,
// ntt_common.cuh's StepPasses, which also runs up to three transform stages
// a pass in registers): 64 KiB at the boolean default set (56 KiB with the
// u32 accumulator), 96 KiB at 2_2 with P = 4 (80 KiB), two blocks per SM.

#include "ntt_common.cuh"
#include "tails.cuh"

using brk::Bnf2Tail;
using brk::GarnerTail;
using brk::GarnerTail32;
using brk::GarnerTailDeep;

namespace {

template <class Tail>
int launch_crt(const void* acc_in, const void* a_ms, const void* bsk,
               const void* tables, void* acc_out, int B, int n_steps, int R,
               int levels, int base_log, int log_n, const unsigned* c,
               unsigned long long full_prod, void* stream) {
    Tail tail;
    brk::fill_garner(tail, c, full_prod);
    return brk::launch_blind_rotate(acc_in, a_ms, bsk, tables, acc_out, B,
                                    n_steps, R, levels, base_log, log_n,
                                    tail, stream);
}

// The Garner tail Tail<P> for a run-time prime count of 2..5: f(Tail<P>{}),
// or `otherwise` for any other count.
template <template <int> class Tail, class R, class F>
R for_primes(int num_primes, R otherwise, F f) {
    switch (num_primes) {
        case 2: return f(Tail<2>{});
        case 3: return f(Tail<3>{});
        case 4: return f(Tail<4>{});
        case 5: return f(Tail<5>{});
        default: return otherwise;
    }
}

template <template <int> class Tail>
int launch_crt_primes(const void* acc_in, const void* a_ms, const void* bsk,
                      const void* tables, void* acc_out, int B, int n_steps,
                      int R, int levels, int base_log, int log_n,
                      int num_primes, const unsigned* garner,
                      unsigned long long full_prod, void* stream) {
    return for_primes<Tail>(num_primes, (int)cudaErrorInvalidValue,
                            [&](auto t) {
        return launch_crt<decltype(t)>(acc_in, a_ms, bsk, tables, acc_out, B,
                                       n_steps, R, levels, base_log, log_n,
                                       garner, full_prod, stream);
    });
}

template <template <int> class Tail>
unsigned long long crt_smem(int num_primes, int R, int levels, int log_n) {
    return for_primes<Tail>(num_primes, 0ull, [&](auto t) {
        return (unsigned long long)brk::blind_rotate_smem<decltype(t)>(
            R, levels, log_n);
    });
}

template <template <int> class Tail>
int crt_occupancy(int num_primes, int R, int levels, int log_n, int* regs,
                  int* local_bytes) {
    return for_primes<Tail>(num_primes, 0, [&](auto t) {
        return brk::blind_rotate_occupancy<decltype(t)>(R, levels, log_n,
                                                        regs, local_bytes);
    });
}

}  // namespace

// acc_in/acc_out: u64 [B, R, N]; a_ms: i32 [B, n] in [0, 2N);
// bsk: u32 [n, 2, P, levels*R, R, N] over the first P PRIMES32;
// tables: u32 [P, 8, N]; garner: host u32[65] (see launch_crt).
// base_log * levels >= 32 (up to 63, at brk::kDeepPrimes = 4 primes) runs
// the 64-bit decomposer's instantiation (GarnerTailDeep). Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a prime count outside 2..5 or a decomposition
// outside both.
extern "C" int blind_rotate_crt(
        const void* acc_in, const void* a_ms, const void* bsk,
        const void* tables, void* acc_out, int B, int n_steps, int R,
        int levels, int base_log, int log_n, int num_primes,
        const unsigned* garner, unsigned long long full_prod, void* stream) {
    if (brk::hi_word_decomposition(base_log, levels))
        return launch_crt_primes<GarnerTail>(acc_in, a_ms, bsk, tables,
                                             acc_out, B, n_steps, R, levels,
                                             base_log, log_n, num_primes,
                                             garner, full_prod, stream);
    if (base_log < 1 || levels < 1 || base_log * levels > 63
        || num_primes != brk::kDeepPrimes)
        return (int)cudaErrorInvalidValue;
    return launch_crt<GarnerTailDeep<brk::kDeepPrimes>>(
        acc_in, a_ms, bsk, tables, acc_out, B, n_steps, R, levels, base_log,
        log_n, garner, full_prod, stream);
}

// K3-acc32. acc_in/acc_out: u32 [B, R, N], the hi plane (torus value =
// acc * 2^32); the other arguments as blind_rotate_crt's, base_log *
// levels <= 31.
extern "C" int blind_rotate_crt_acc32(
        const void* acc_in, const void* a_ms, const void* bsk,
        const void* tables, void* acc_out, int B, int n_steps, int R,
        int levels, int base_log, int log_n, int num_primes,
        const unsigned* garner, unsigned long long full_prod, void* stream) {
    if (!brk::hi_word_decomposition(base_log, levels))
        return (int)cudaErrorInvalidValue;
    return launch_crt_primes<GarnerTail32>(acc_in, a_ms, bsk, tables,
                                           acc_out, B, n_steps, R, levels,
                                           base_log, log_n, num_primes,
                                           garner, full_prod, stream);
}

// acc_in/acc_out: u64 [B, R, N]; a_ms: i32 [B, n] in [0, 2N);
// bsk: u32 [n, 2, 2, levels*R, R, N] (bnf2.bootstrap_key_to_bnf2);
// tables: u32 [2, 8, N]; base_log * levels <= 31. Returns
// cudaGetLastError() after the launch.
extern "C" int blind_rotate_bnf2_u64(
        const void* acc_in, const void* a_ms, const void* bsk,
        const void* tables, void* acc_out, int B, int n_steps, int R,
        int levels, int base_log, int log_n, unsigned p0, unsigned p1,
        unsigned inv01, unsigned inv01_sh, unsigned g0, unsigned g1, int s1,
        int s2, void* stream) {
    if (!brk::hi_word_decomposition(base_log, levels))
        return (int)cudaErrorInvalidValue;
    Bnf2Tail tail;
    tail.p[0] = p0;
    tail.p[1] = p1;
    tail.inv01 = inv01;
    tail.inv01_sh = inv01_sh;
    tail.g0 = g0;
    tail.g1 = g1;
    tail.s1 = s1;
    tail.s2 = s2;
    return brk::launch_blind_rotate(acc_in, a_ms, bsk, tables, acc_out, B,
                                    n_steps, R, levels, base_log, log_n,
                                    tail, stream);
}

// Bytes of dynamic shared memory one block of blind_rotate_crt needs at
// num_primes primes; 0 for a prime count outside 2..5.
extern "C" unsigned long long blind_rotate_crt_smem(
        int num_primes, int R, int levels, int log_n) {
    return crt_smem<GarnerTail>(num_primes, R, levels, log_n);
}

// The same for blind_rotate_crt_acc32 (its accumulator is u32).
extern "C" unsigned long long blind_rotate_crt_acc32_smem(
        int num_primes, int R, int levels, int log_n) {
    return crt_smem<GarnerTail32>(num_primes, R, levels, log_n);
}

// Bytes of dynamic shared memory one block of blind_rotate_bnf2_u64 needs;
// 0 when num_primes is not 2.
extern "C" unsigned long long blind_rotate_bnf2_u64_smem(
        int num_primes, int R, int levels, int log_n) {
    if (num_primes != 2) return 0;
    return brk::blind_rotate_smem<Bnf2Tail>(R, levels, log_n);
}

// Resident blocks per SM of each entry's kernel at num_primes primes and
// this shape, with its registers and local (spill) bytes per thread;
// negative: a CUDA error, 0 for a prime count the entry does not take.
extern "C" int blind_rotate_crt_occupancy(int num_primes, int R, int levels,
                                          int log_n, int* regs,
                                          int* local_bytes) {
    return crt_occupancy<GarnerTail>(num_primes, R, levels, log_n, regs,
                                     local_bytes);
}

extern "C" int blind_rotate_crt_acc32_occupancy(int num_primes, int R,
                                                int levels, int log_n,
                                                int* regs, int* local_bytes) {
    return crt_occupancy<GarnerTail32>(num_primes, R, levels, log_n, regs,
                                       local_bytes);
}

extern "C" int blind_rotate_bnf2_u64_occupancy(int num_primes, int R,
                                               int levels, int log_n,
                                               int* regs, int* local_bytes) {
    if (num_primes != 2) return 0;
    return brk::blind_rotate_occupancy<Bnf2Tail>(R, levels, log_n, regs,
                                                 local_bytes);
}
