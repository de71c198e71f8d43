// Shared pieces of the blind-rotation kernels K1 (blind_rotate_bnf2.cu) and
// K3 (blind_rotate_crt.cu): the Shoup multiply, the hi-word balanced gadget
// decomposition, the plan's negacyclic NTT stages, and the whole n-step
// blind rotation as one kernel template on its recombination tail.
//
// One CMUX step, per ciphertext, on the accumulator acc[R][N] (u32 hi plane
// for K1, exact u64 for K3):
//   1. diff = acc * X^{a_i} - acc, balanced gadget decomposition from the
//      hi 32 bits of diff (_decompose_u32, tfhe_tpu/ops/pbs_kernel.py:708:
//      base_log * levels <= 31, so the state never needs the lo word; for
//      the u64 accumulator the borrow of the lo word is part of diff), each
//      signed digit lifted mod each prime (d < 0 ? d + p : d) and twisted
//      by psi^t;
//   2. forward negacyclic NTT: Gentleman-Sande stages on natural-order
//      input, DIF order out -- the order the key was transformed in
//      (NegacyclicNtt.fwd), so the key is used as stored;
//   3. Shoup MAC against the GGSW row of step i;
//   4. inverse NTT (Cooley-Tukey stages in reverse order) and untwist,
//      giving canonical residues;
//   5. the tail turns the P canonical residues of a coefficient into the
//      accumulator's increment.
// Every modular product is an exact Shoup multiply, so the residues equal
// the spec's and only the tail and the decomposition are formulas, which
// each tail reproduces as its spec writes them.
//
// Design: one block per ciphertext runs all n steps in one launch with the
// accumulator, the digit transforms and the MAC results in shared memory;
// nothing but the key and the twiddle tables is read from device memory
// inside the step loop. Simple first: exact reductions, one butterfly per
// thread per pass, a __syncthreads between NTT stages.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace brk {

constexpr int kThreads = 512;

// per prime, the [8][N] constant table (ops/pbs_kernel.py::plan_tables):
// twist, twist_sh, untwist, untwist_sh, forward stage twiddles (stage s at
// offset N - (N >> s)), their Shoup duals, inverse stage twiddles, their
// Shoup duals
enum { T_TW = 0, T_TW_SH, T_UTW, T_UTW_SH, T_FWD, T_FWD_SH, T_INV, T_INV_SH,
       T_COUNT };

__device__ __forceinline__ uint32_t shoup_mul(uint32_t a, uint32_t w,
                                              uint32_t w_sh, uint32_t p) {
    // a < 2^32, w < p < 2^31: a*w - q*p lies in [0, 2p) and fits in u32
    const uint32_t q = __umulhi(a, w_sh);
    const uint32_t r = a * w - q * p;
    return r >= p ? r - p : r;
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b,
                                            uint32_t p) {
    const uint32_t s = a + b;
    return s >= p ? s - p : s;
}

__device__ __forceinline__ uint32_t hi_word(uint32_t x) { return x; }
__device__ __forceinline__ uint32_t hi_word(uint64_t x) {
    return (uint32_t)(x >> 32);
}

// Balanced signed decomposition of a torus value from its hi 32 bits,
// level `levels` first (bit-identical to tfhe_tpu/ops/decomp.py::decompose
// for base_log * levels <= 31).
struct HiDecomposer {
    int base_log, rep, sh;
    uint32_t rep_mask;
    int32_t mod_b;

    __device__ HiDecomposer(int base_log_, int levels)
        : base_log(base_log_), rep(base_log_ * levels),
          sh(31 - base_log_ * levels),
          rep_mask((1u << (base_log_ * levels)) - 1u),
          mod_b((1 << base_log_) - 1) {}

    // the rounded, balanced initial state
    __device__ int32_t init(uint32_t hi) const {
        uint32_t res = hi >> sh;
        const uint32_t rounding = res & 1u;
        res = (res + 1u) >> 1;
        res &= rep_mask;
        const uint32_t shifted_r = rounding << (rep - 1);
        const uint32_t need_bal = (((res - 1u) | shifted_r) & res) >> (rep - 1);
        return (int32_t)(res - (need_bal << rep));
    }

    // the next digit, in [-2^(base_log-1), 2^(base_log-1)]
    __device__ int32_t next(int32_t& state) const {
        const int32_t d = state & mod_b;
        state >>= base_log;  // arithmetic
        const int32_t carry = (((d - 1) | state) & d) >> (base_log - 1);
        state += carry;
        return d - (carry << base_log);
    }
};

// Forward DIF stages over n_polys polynomials of N coefficients, laid out
// [..][P][N] (the prime of polynomial k is k % P).
template <int P>
__device__ void forward_stages(uint32_t* polys, int n_polys, int log_n,
                               const uint32_t* __restrict__ tables,
                               const uint32_t* p_of) {
    const int N = 1 << log_n;
    const int half = N >> 1;
    for (int s = 0; s < log_n; ++s) {
        const int log_h = log_n - 1 - s;
        const int h = 1 << log_h;
        const int off = N - (N >> s);
        for (int idx = threadIdx.x; idx < n_polys * half; idx += blockDim.x) {
            const int poly = idx >> (log_n - 1);
            const int bf = idx & (half - 1);
            const int pi = poly % P;
            const uint32_t p = p_of[pi];
            const int jj = bf & (h - 1);
            const int i0 = ((bf >> log_h) << (log_h + 1)) + jj;
            uint32_t* x = polys + (long long)poly * N;
            const uint32_t u0 = x[i0];
            const uint32_t u1 = x[i0 + h];
            const uint32_t* tb = tables + (long long)pi * T_COUNT * N;
            x[i0] = add_mod(u0, u1, p);
            x[i0 + h] = shoup_mul(u0 - u1 + p,
                                  __ldg(tb + T_FWD * N + off + jj),
                                  __ldg(tb + T_FWD_SH * N + off + jj), p);
        }
        __syncthreads();
    }
}

// Inverse CT stages (reverse stage order) over n_polys polynomials laid out
// [..][P][N]; the untwist is left to the caller.
template <int P>
__device__ void inverse_stages(uint32_t* polys, int n_polys, int log_n,
                               const uint32_t* __restrict__ tables,
                               const uint32_t* p_of) {
    const int N = 1 << log_n;
    const int half = N >> 1;
    for (int s = log_n - 1; s >= 0; --s) {
        const int log_h = log_n - 1 - s;
        const int h = 1 << log_h;
        const int off = N - (N >> s);
        for (int idx = threadIdx.x; idx < n_polys * half; idx += blockDim.x) {
            const int poly = idx >> (log_n - 1);
            const int bf = idx & (half - 1);
            const int pi = poly % P;
            const uint32_t p = p_of[pi];
            const int jj = bf & (h - 1);
            const int i0 = ((bf >> log_h) << (log_h + 1)) + jj;
            uint32_t* x = polys + (long long)poly * N;
            const uint32_t* tb = tables + (long long)pi * T_COUNT * N;
            const uint32_t u = x[i0];
            const uint32_t bw = shoup_mul(x[i0 + h],
                                          __ldg(tb + T_INV * N + off + jj),
                                          __ldg(tb + T_INV_SH * N + off + jj),
                                          p);
            x[i0] = add_mod(u, bw, p);
            x[i0 + h] = add_mod(u, p - bw, p);
        }
        __syncthreads();
    }
}

// All n CMUX steps of the blind rotation for one ciphertext per block.
// Tail provides: `Acc` (uint32_t or uint64_t), `P`, `p[P]` and
// `Acc operator()(const uint32_t* m)` on the P canonical residues.
//
// acc_in/acc_out: Acc [B, R, N]; a_ms: i32 [B, n] in [0, 2N);
// bsk: u32 [n, 2 (residue/shoup), P, levels*R, R, N]; tables: u32 [P, 8, N].
// Shared memory: acc [R][N] Acc, digits [levels*R][P][N] u32, MAC results
// [R][P][N] u32.
template <class Tail>
__global__ void __launch_bounds__(kThreads)
blind_rotate_kernel(const typename Tail::Acc* __restrict__ acc_in,
                    const int32_t* __restrict__ a_ms,
                    const uint32_t* __restrict__ bsk,
                    const uint32_t* __restrict__ tables,
                    typename Tail::Acc* __restrict__ acc_out,
                    int n_steps, int R, int levels, int base_log, int log_n,
                    const Tail tail) {
    using Acc = typename Tail::Acc;
    constexpr int P = Tail::P;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int N = 1 << log_n;
    const int lR = levels * R;
    Acc* acc = reinterpret_cast<Acc*>(smem_raw);                 // [R][N]
    uint32_t* dig = reinterpret_cast<uint32_t*>(acc + R * N);    // [lR][P][N]
    uint32_t* mac = dig + P * lR * N;                            // [R][P][N]
    // the primes, for the loops that index them at run time
    __shared__ uint32_t s_p[P];
    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int nt = blockDim.x;

    if (tid == 0) {
        #pragma unroll
        for (int pi = 0; pi < P; ++pi) s_p[pi] = tail.p[pi];
    }
    const Acc* acc_src = acc_in + (long long)b * R * N;
    for (int i = tid; i < R * N; i += nt) acc[i] = acc_src[i];

    const HiDecomposer dec(base_log, levels);
    const long long key_step = 2LL * P * lR * R * N;
    __syncthreads();

    for (int step = 0; step < n_steps; ++step) {
        const int a = a_ms[(long long)b * n_steps + step];  // [0, 2N)
        const uint32_t* key = bsk + step * key_step;

        // 1. rotate-subtract, decompose, lift mod p, twist
        for (int idx = tid; idx < R * N; idx += nt) {
            const int r = idx >> log_n;
            const int t = idx & (N - 1);
            int s = t - a;
            if (s < 0) s += 2 * N;
            const bool neg = s >= N;
            if (neg) s -= N;
            Acc v = acc[r * N + s];
            if (neg) v = Acc(0) - v;
            int32_t state = dec.init(hi_word(Acc(v - acc[idx])));
            for (int lev = 0; lev < levels; ++lev) {
                const int32_t digit = dec.next(state);
                const int j = lev * R + r;
                #pragma unroll
                for (int pi = 0; pi < P; ++pi) {
                    const uint32_t p = tail.p[pi];
                    const uint32_t m =
                        digit < 0 ? (uint32_t)(digit + (int32_t)p)
                                  : (uint32_t)digit;
                    const uint32_t* tb = tables + (long long)pi * T_COUNT * N;
                    dig[(j * P + pi) * N + t] = shoup_mul(
                        m, __ldg(tb + T_TW * N + t),
                        __ldg(tb + T_TW_SH * N + t), p);
                }
            }
        }
        __syncthreads();

        // 2. forward transforms of the P * lR digit polynomials
        forward_stages<P>(dig, P * lR, log_n, tables, s_p);

        // 3. Shoup MAC against the GGSW row:
        //    mac[c][pi] = sum_j dig[j][pi] * g[pi][j][c]
        for (int idx = tid; idx < P * R * N; idx += nt) {
            const int t = idx & (N - 1);
            const int rest = idx >> log_n;  // c * P + pi
            const int pi = rest % P;
            const int c = rest / P;
            const uint32_t p = s_p[pi];
            uint32_t acc_m = 0;
            for (int j = 0; j < lR; ++j) {
                const long long kres = ((long long)(pi * lR + j) * R + c) * N + t;
                const long long ksh =
                    ((long long)((P + pi) * lR + j) * R + c) * N + t;
                acc_m = add_mod(acc_m,
                                shoup_mul(dig[(j * P + pi) * N + t],
                                          __ldg(key + kres), __ldg(key + ksh),
                                          p),
                                p);
            }
            mac[idx] = acc_m;
        }
        __syncthreads();

        // 4. inverse transforms of the P * R MAC polynomials
        inverse_stages<P>(mac, P * R, log_n, tables, s_p);

        // 5. untwist to canonical residues, recombine, accumulate
        for (int idx = tid; idx < R * N; idx += nt) {
            const int c = idx >> log_n;
            const int t = idx & (N - 1);
            uint32_t m[P];
            #pragma unroll
            for (int pi = 0; pi < P; ++pi) {
                const uint32_t* tb = tables + (long long)pi * T_COUNT * N;
                m[pi] = shoup_mul(mac[(c * P + pi) * N + t],
                                  __ldg(tb + T_UTW * N + t),
                                  __ldg(tb + T_UTW_SH * N + t), tail.p[pi]);
            }
            acc[idx] += tail(m);
        }
        __syncthreads();
    }

    Acc* acc_dst = acc_out + (long long)b * R * N;
    for (int i = tid; i < R * N; i += nt) acc_dst[i] = acc[i];
}

// Bytes of dynamic shared memory blind_rotate_kernel<Tail> needs.
template <class Tail>
size_t blind_rotate_smem(int R, int levels, int log_n) {
    const size_t N = size_t(1) << log_n;
    return R * N * sizeof(typename Tail::Acc)
           + (size_t)Tail::P * (levels * R + R) * N * sizeof(uint32_t);
}

// Launch blind_rotate_kernel<Tail> on `stream`, one block per ciphertext.
// Returns cudaGetLastError() after the launch (0 = launched).
template <class Tail>
int launch_blind_rotate(const void* acc_in, const void* a_ms, const void* bsk,
                        const void* tables, void* acc_out, int B,
                        int n_steps, int R, int levels, int base_log,
                        int log_n, const Tail& tail, void* stream) {
    using Acc = typename Tail::Acc;
    const size_t smem = blind_rotate_smem<Tail>(R, levels, log_n);
    cudaError_t err = cudaFuncSetAttribute(
        blind_rotate_kernel<Tail>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    blind_rotate_kernel<Tail><<<B, kThreads, smem, (cudaStream_t)stream>>>(
        (const Acc*)acc_in, (const int32_t*)a_ms, (const uint32_t*)bsk,
        (const uint32_t*)tables, (Acc*)acc_out, n_steps, R, levels, base_log,
        log_n, tail);
    return (int)cudaGetLastError();
}

}  // namespace brk
