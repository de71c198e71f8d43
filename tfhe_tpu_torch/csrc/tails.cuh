// The recombination tails of the blind-rotation kernels: each turns the P
// canonical residues of a coefficient (the untwisted inverse transforms)
// into the accumulator's increment. K3 (blind_rotate_crt.cu) runs
// GarnerTail<P> (GarnerTailDeep<P> at b l >= 32), GarnerTail32<P> and
// Bnf2Tail; K1 (blind_rotate_bnf2.cu) runs Bnf2Tail32; the step probes
// (v4_probe.cu) time each one alone.
// Replaces the garner_c, bnf2_c and bnf2_c32 closures of
// tfhe_tpu/ops/pbs_kernel.py::_make_step_kernel_v4 (:1441, :1484, :1515).

#pragma once

#include "ntt_common.cuh"

namespace brk {

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
                acc_g = v[j] + shoup_mul(acc_g, pj[i][j], pj_sh[i][j],
                                              p[i]);
            const uint32_t diff = 3u * p[i] + m[i] - acc_g;  // < 4 p_i
            v[i] = shoup_mul(diff, inv[i], inv_sh[i], p[i]);
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

// GarnerTail at a shape with base_log * levels >= 32: the same tail, whose
// kernels' lifts decompose the whole u64 difference (Decomposer64). A type
// of its own, so that the b l <= 31 instantiations keep their code and
// their mangled names.
template <int NP>
struct GarnerTailDeep : GarnerTail<NP> {};

// the prime count of its instantiations: that of every set of tfhe-rs's
// universe with base_log * levels >= 32 (and of every multi-bit set), one
// instantiation a kernel to keep the build short
constexpr int kDeepPrimes = 4;

template <int NP>
struct DecomposerOf<GarnerTailDeep<NP>> {
    using type = Decomposer64;
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
        const uint32_t v1 = shoup_mul(diff, inv01, inv01_sh, p[1]);
        const uint64_t x = (uint64_t)m[0] + (uint64_t)p[0] * v1;  // < q'
        const uint64_t x0 = x & 0xFFFFFFFFull;
        const uint64_t x1 = x >> 32;
        const uint64_t s = x0 * g1 + x1 * g0;  // < 2^61
        const uint64_t d = x1 * g1;
        return (x << s1) + (s >> s2) + (d << s1);
    }
};

// bnf2_c32: round(CRT(m0, m1) * 2^32 / q') as one u32 plane
// (ops/bnf2.py qp_to_torus32):
//   v1 = (r1 + 2 p1 - r0) * inv01 mod p1,
//   t32 = ((v1 * C1T) >> 28) + (r0 >> S2) + t32_bias.
struct Bnf2Tail32 {
    using Acc = uint32_t;
    static constexpr int P = 2;
    uint32_t p[2];
    uint32_t inv01, inv01_sh, c1t, t32_bias;
    int s2;

    __device__ uint32_t operator()(const uint32_t* m) const {
        const uint32_t diff = p[1] + p[1] + m[1] - m[0];  // < 3 p1
        const uint32_t v1 = shoup_mul(diff, inv01, inv01_sh, p[1]);
        const uint32_t t1 =
            (uint32_t)(((uint64_t)v1 * c1t) >> 28);  // < 2^32
        return t1 + (m[0] >> s2) + t32_bias;
    }
};

// Fill a Garner tail's constants from the host array c[65] of
// ops/pbs_kernel.py::garner_constants: p[5], inv[5], inv_sh[5], pj[5][5],
// pj_sh[5][5] (zero-padded to kMaxPrimes primes).
template <class Tail>
void fill_garner(Tail& tail, const unsigned* c, unsigned long long full_prod) {
    for (int i = 0; i < Tail::P; ++i) {
        tail.p[i] = c[i];
        tail.inv[i] = c[kMaxPrimes + i];
        tail.inv_sh[i] = c[2 * kMaxPrimes + i];
        for (int j = 0; j < Tail::P; ++j) {
            tail.pj[i][j] = c[3 * kMaxPrimes + i * kMaxPrimes + j];
            tail.pj_sh[i][j] =
                c[3 * kMaxPrimes + kMaxPrimes * kMaxPrimes + i * kMaxPrimes + j];
        }
    }
    tail.full_prod = full_prod;
}

}  // namespace brk
