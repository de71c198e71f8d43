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
// the hi plane of a multiple of 2^32 and there is no lo word.
//
// Bound: int32 operations. Per step and ciphertext: P (l*R) forward and
// P R inverse transforms of N/2 * log2(N) butterflies, P R l*R Shoup MACs
// and the tail, against a step key of 2 P l R R N u32 (393 KB for the
// boolean default set) that all ciphertexts share and read from L2. The
// whole key is never staged in shared memory; the accumulator, the digit
// transforms and the MAC results are: 88 KiB at the boolean default set
// (80 KiB with the u32 accumulator), 160 KiB at 2_2 with P = 4 (144 KiB),
// one block per SM at 2_2.

#include "ntt_common.cuh"

namespace {

constexpr int kMaxPrimes = 5;

// garner_c: Garner digits of the canonical residues, then the mixed-radix
// value v0 + p0 (v1 + p1 (v2 + ...)) mod 2^64, minus the full prime product
// when the top digit says the centered value is negative. Bit-identical to
// NegacyclicNtt.reconstruct_u64 (another exact formula for the same v_i).
// The constants and the value, shared by both Garner tails.
template <int NP>
struct GarnerDigits {
    static constexpr int P = NP;
    uint32_t p[NP];
    uint32_t inv[NP], inv_sh[NP];          // (p0...p_{i-1})^-1 mod p_i
    uint32_t pj[NP][NP], pj_sh[NP][NP];    // p_j mod p_i
    uint64_t full_prod;                    // p0 ... p_{P-1} mod 2^64

    __device__ uint64_t value(const uint32_t* m) const {
        uint32_t v[NP];
        v[0] = m[0];
        #pragma unroll
        for (int i = 1; i < NP; ++i) {
            // (v0 + p0 (v1 + ... + p_{i-2} v_{i-1})) mod p_i, lazily < 2 p_i
            uint32_t acc_g = v[i - 1];
            #pragma unroll
            for (int j = i - 2; j >= 0; --j)
                acc_g = v[j] + brk::shoup_mul(acc_g, pj[i][j], pj_sh[i][j],
                                              p[i]);
            const uint32_t diff = 3u * p[i] + m[i] - acc_g;  // < 4 p_i
            v[i] = brk::shoup_mul(diff, inv[i], inv_sh[i], p[i]);
        }
        uint64_t pos = v[NP - 1];
        #pragma unroll
        for (int i = NP - 2; i >= 0; --i) pos = pos * p[i] + v[i];
        return v[NP - 1] > (p[NP - 1] >> 1) ? pos - full_prod : pos;
    }
};

// The exact tail: the Garner value is the u64 increment.
template <int NP>
struct GarnerTail : GarnerDigits<NP> {
    using Acc = uint64_t;
    __device__ uint64_t operator()(const uint32_t* m) const {
        return this->value(m);
    }
};

// The acc32 tail (pbs_kernel.py:1635-1640): the Garner value rounded to the
// nearest multiple of 2^32, as its hi word, (v + 2^31) >> 32 mod 2^32 --
// the same as ehi + (elo >> 31).
template <int NP>
struct GarnerTail32 : GarnerDigits<NP> {
    using Acc = uint32_t;
    __device__ uint32_t operator()(const uint32_t* m) const {
        return (uint32_t)((this->value(m) + 0x80000000ull) >> 32);
    }
};

// bnf2_c: the 2-term CRT merge to x in [0, q'), then the fixed-point switch
// back to the 2^64 torus, t = (x << S1) + ((x0 G1 + x1 G0) >> S2)
// + ((x1 G1) << S1) with x = x1 2^32 + x0 (ops/bnf2.py crt2_merge +
// qp_to_torus).
struct Bnf2Tail {
    using Acc = uint64_t;
    static constexpr int P = 2;
    uint32_t p[2];
    uint32_t inv01, inv01_sh;
    uint64_t g0, g1;
    int s1, s2;

    __device__ uint64_t operator()(const uint32_t* m) const {
        const uint32_t diff = p[1] + p[1] + m[1] - m[0];  // < 3 p1
        const uint32_t v1 = brk::shoup_mul(diff, inv01, inv01_sh, p[1]);
        const uint64_t x = (uint64_t)m[0] + (uint64_t)p[0] * v1;  // < q'
        const uint64_t x0 = x & 0xFFFFFFFFull;
        const uint64_t x1 = x >> 32;
        const uint64_t s = x0 * g1 + x1 * g0;  // < 2^61
        const uint64_t d = x1 * g1;
        return (x << s1) + (s >> s2) + (d << s1);
    }
};

template <class Tail>
int launch_crt(const void* acc_in, const void* a_ms, const void* bsk,
               const void* tables, void* acc_out, int B, int n_steps, int R,
               int levels, int base_log, int log_n, const unsigned* c,
               unsigned long long full_prod, void* stream) {
    // c: p[5], inv[5], inv_sh[5], pj[5][5], pj_sh[5][5]
    // (ops/pbs_kernel.py::garner_constants)
    constexpr int NP = Tail::P;
    Tail tail;
    for (int i = 0; i < NP; ++i) {
        tail.p[i] = c[i];
        tail.inv[i] = c[kMaxPrimes + i];
        tail.inv_sh[i] = c[2 * kMaxPrimes + i];
        for (int j = 0; j < NP; ++j) {
            tail.pj[i][j] = c[3 * kMaxPrimes + i * kMaxPrimes + j];
            tail.pj_sh[i][j] =
                c[3 * kMaxPrimes + kMaxPrimes * kMaxPrimes + i * kMaxPrimes + j];
        }
    }
    tail.full_prod = full_prod;
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

}  // namespace

// acc_in/acc_out: u64 [B, R, N]; a_ms: i32 [B, n] in [0, 2N);
// bsk: u32 [n, 2, P, levels*R, R, N] over the first P PRIMES32;
// tables: u32 [P, 8, N]; garner: host u32[65] (see launch_crt).
// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a prime count outside 2..5.
extern "C" int blind_rotate_crt(
        const void* acc_in, const void* a_ms, const void* bsk,
        const void* tables, void* acc_out, int B, int n_steps, int R,
        int levels, int base_log, int log_n, int num_primes,
        const unsigned* garner, unsigned long long full_prod, void* stream) {
    return launch_crt_primes<GarnerTail>(acc_in, a_ms, bsk, tables, acc_out,
                                         B, n_steps, R, levels, base_log,
                                         log_n, num_primes, garner, full_prod,
                                         stream);
}

// K3-acc32. acc_in/acc_out: u32 [B, R, N], the hi plane (torus value =
// acc * 2^32); the other arguments as blind_rotate_crt's.
extern "C" int blind_rotate_crt_acc32(
        const void* acc_in, const void* a_ms, const void* bsk,
        const void* tables, void* acc_out, int B, int n_steps, int R,
        int levels, int base_log, int log_n, int num_primes,
        const unsigned* garner, unsigned long long full_prod, void* stream) {
    return launch_crt_primes<GarnerTail32>(acc_in, a_ms, bsk, tables,
                                           acc_out, B, n_steps, R, levels,
                                           base_log, log_n, num_primes,
                                           garner, full_prod, stream);
}

// acc_in/acc_out: u64 [B, R, N]; a_ms: i32 [B, n] in [0, 2N);
// bsk: u32 [n, 2, 2, levels*R, R, N] (bnf2.bootstrap_key_to_bnf2);
// tables: u32 [2, 8, N]. Returns cudaGetLastError() after the launch.
extern "C" int blind_rotate_bnf2_u64(
        const void* acc_in, const void* a_ms, const void* bsk,
        const void* tables, void* acc_out, int B, int n_steps, int R,
        int levels, int base_log, int log_n, unsigned p0, unsigned p1,
        unsigned inv01, unsigned inv01_sh, unsigned g0, unsigned g1, int s1,
        int s2, void* stream) {
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
