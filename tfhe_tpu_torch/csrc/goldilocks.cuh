// Goldilocks-prime field arithmetic and the negacyclic transforms of the
// hand-written kernels over p = 2^64 - 2^32 + 1: K4 (the v5 blind rotation,
// blind_rotate_goldilocks.cu) and K6 (the prime-modulus NTT64 blind
// rotation, blind_rotate_ntt64.cu).
//
// Every product is a native 64 x 64 -> 128-bit multiply (a * b and
// __umul64hi) reduced with 2^64 = 2^32 - 1 and 2^96 = -1 (mod p); every
// helper takes and returns canonical values (< p). The transforms run over
// a block's shared memory, one butterfly per thread per pass and a
// __syncthreads between stages: forward Gentleman-Sande stages (natural
// order in, classic DIF order out) and inverse Cooley-Tukey stages in
// reverse order (DIF in, natural out; the untwist is the caller's). The
// constant table is ops/pbs_kernel.py::goldilocks_tables, u64 [4][N]:
// twist, untwist, the forward stage twiddles (stage s at N - (N >> s)),
// the inverse ones.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint64_t kP = 0xFFFFFFFF00000001ull;
constexpr uint64_t kEps = 0xFFFFFFFFull;  // 2^64 mod p

// table rows of ops/pbs_kernel.py::goldilocks_tables, u64 [4][N]
enum { G_TW = 0, G_UTW, G_FWD, G_INV };

__device__ __forceinline__ uint64_t g_canon(uint64_t x) {
    return x >= kP ? x - kP : x;
}

__device__ __forceinline__ uint64_t g_add(uint64_t a, uint64_t b) {
    uint64_t s = a + b;
    if (s < a) s += kEps;  // a wrap: +2^64 = +EPS
    return g_canon(s);
}

__device__ __forceinline__ uint64_t g_sub(uint64_t a, uint64_t b) {
    const uint64_t d = a - b;
    return a < b ? d - kEps : d;  // -2^64 = -EPS
}

__device__ __forceinline__ uint64_t g_mul(uint64_t a, uint64_t b) {
    const uint64_t lo = a * b;
    const uint64_t hi = __umul64hi(a, b);
    // lo + 2^64 (hi_lo + 2^32 hi_hi) = lo - hi_hi + EPS hi_lo  (mod p)
    const uint64_t hi_hi = hi >> 32;
    const uint64_t hi_lo = hi & 0xFFFFFFFFull;
    uint64_t t0 = lo - hi_hi;
    if (lo < hi_hi) t0 -= kEps;
    const uint64_t t1 = (hi_lo << 32) - hi_lo;  // hi_lo * EPS < 2^64
    uint64_t t2 = t0 + t1;
    if (t2 < t1) t2 += kEps;
    return g_canon(t2);
}

// Forward DIF stages over n_polys polynomials of N u64 coefficients.
__device__ void g_forward(uint64_t* polys, int n_polys, int log_n,
                          const uint64_t* __restrict__ tables) {
    const int N = 1 << log_n;
    const int half = N >> 1;
    for (int s = 0; s < log_n; ++s) {
        const int log_h = log_n - 1 - s;
        const int h = 1 << log_h;
        const uint64_t* tw = tables + G_FWD * N + (N - (N >> s));
        for (int idx = threadIdx.x; idx < n_polys * half; idx += blockDim.x) {
            const int bf = idx & (half - 1);
            const int jj = bf & (h - 1);
            const int i0 = ((bf >> log_h) << (log_h + 1)) + jj;
            uint64_t* x = polys + (long long)(idx >> (log_n - 1)) * N;
            const uint64_t a = x[i0];
            const uint64_t b = x[i0 + h];
            x[i0] = g_add(a, b);
            x[i0 + h] = g_mul(g_sub(a, b), __ldg(tw + jj));
        }
        __syncthreads();
    }
}

// Inverse stages (reverse stage order), DIF order in, natural order out;
// the untwist is left to the caller.
__device__ void g_inverse(uint64_t* polys, int n_polys, int log_n,
                          const uint64_t* __restrict__ tables) {
    const int N = 1 << log_n;
    const int half = N >> 1;
    for (int s = log_n - 1; s >= 0; --s) {
        const int log_h = log_n - 1 - s;
        const int h = 1 << log_h;
        const uint64_t* tw = tables + G_INV * N + (N - (N >> s));
        for (int idx = threadIdx.x; idx < n_polys * half; idx += blockDim.x) {
            const int bf = idx & (half - 1);
            const int jj = bf & (h - 1);
            const int i0 = ((bf >> log_h) << (log_h + 1)) + jj;
            uint64_t* x = polys + (long long)(idx >> (log_n - 1)) * N;
            const uint64_t u = x[i0];
            const uint64_t bw = g_mul(x[i0 + h], __ldg(tw + jj));
            x[i0] = g_add(u, bw);
            x[i0 + h] = g_sub(u, bw);
        }
        __syncthreads();
    }
}

}  // namespace
