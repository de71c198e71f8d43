// The transform loops the probe kernels share (ntt_variants.cu,
// v4_probe.cu): the radix-2 stages of brk::forward_stages /
// inverse_stages over a range of stages, and the twist, with C
// ciphertexts per coefficient.
//
// Layout: n_polys polynomials of N coefficients, C ciphertexts each,
// element (polynomial k, coefficient t, ciphertext b) at (k N + t) C + b;
// the prime of polynomial k is primes[k % P]. At C = 1 and P = 1 this is
// one polynomial in natural order, the layout of the step kernels. `primes`
// is a pointer to the primes in shared memory (as the step kernels read
// them) or OnePrime, a prime held in a register.
//
// The step kernels keep their own loops in ntt_common.cuh, so that their
// SASS does not move with the probes'.

#pragma once

#include "ntt_common.cuh"

namespace probe {

struct OnePrime {
    uint32_t p;
    __device__ uint32_t operator[](int) const { return p; }
};

// forward DIF stages s0 .. s1-1, a block barrier after each
template <int P, int C, class Primes>
__device__ void fwd_stages(uint32_t* x, int n_polys, int log_n, int s0,
                           int s1, const uint32_t* __restrict__ tables,
                           Primes primes) {
    const int N = 1 << log_n;
    const int half = N >> 1;
    for (int s = s0; s < s1; ++s) {
        const int log_h = log_n - 1 - s;
        const int h = 1 << log_h;
        const int off = N - (N >> s);
        #pragma unroll 1
        for (int idx = threadIdx.x; idx < n_polys * half * C;
             idx += blockDim.x) {
            const int b = idx % C, rest = idx / C;
            const int poly = rest >> (log_n - 1);
            const int bf = rest & (half - 1);
            const int pi = poly % P;
            const uint32_t p = primes[pi];
            const int jj = bf & (h - 1);
            const int i0 = ((bf >> log_h) << (log_h + 1)) + jj;
            uint32_t* y = x + (long long)poly * N * C + b;
            const uint32_t* tb = tables + (long long)pi * brk::T_COUNT * N;
            const uint32_t u0 = y[i0 * C];
            const uint32_t u1 = y[(i0 + h) * C];
            y[i0 * C] = brk::add_mod(u0, u1, p);
            y[(i0 + h) * C] = brk::shoup_mul(
                u0 - u1 + p, __ldg(tb + brk::T_FWD * N + off + jj),
                __ldg(tb + brk::T_FWD_SH * N + off + jj), p);
        }
        __syncthreads();
    }
}

// inverse CT stages s1-1 down to s0, a block barrier after each
template <int P, int C, class Primes>
__device__ void inv_stages(uint32_t* x, int n_polys, int log_n, int s0,
                           int s1, const uint32_t* __restrict__ tables,
                           Primes primes) {
    const int N = 1 << log_n;
    const int half = N >> 1;
    for (int s = s1 - 1; s >= s0; --s) {
        const int log_h = log_n - 1 - s;
        const int h = 1 << log_h;
        const int off = N - (N >> s);
        #pragma unroll 1
        for (int idx = threadIdx.x; idx < n_polys * half * C;
             idx += blockDim.x) {
            const int b = idx % C, rest = idx / C;
            const int poly = rest >> (log_n - 1);
            const int bf = rest & (half - 1);
            const int pi = poly % P;
            const uint32_t p = primes[pi];
            const int jj = bf & (h - 1);
            const int i0 = ((bf >> log_h) << (log_h + 1)) + jj;
            uint32_t* y = x + (long long)poly * N * C + b;
            const uint32_t* tb = tables + (long long)pi * brk::T_COUNT * N;
            const uint32_t u = y[i0 * C];
            const uint32_t bw = brk::shoup_mul(
                y[(i0 + h) * C], __ldg(tb + brk::T_INV * N + off + jj),
                __ldg(tb + brk::T_INV_SH * N + off + jj), p);
            y[i0 * C] = brk::add_mod(u, bw, p);
            y[(i0 + h) * C] = brk::add_mod(u, p - bw, p);
        }
        __syncthreads();
    }
}

struct Identity {
    __device__ uint32_t operator()(uint32_t v, uint32_t) const { return v; }
};

// x <- lift(x, p) * table row `row` (its Shoup duals at row + 1) mod p, per
// element (the twist: T_TW, the untwist: T_UTW), then a block barrier
template <int P, int C, class Primes, class Lift = Identity>
__device__ void twist(uint32_t* x, int n_polys, int log_n,
                      const uint32_t* __restrict__ tables, int row,
                      Primes primes, Lift lift = Lift()) {
    const int N = 1 << log_n;
    #pragma unroll 1
    for (int i = threadIdx.x; i < n_polys * N * C; i += blockDim.x) {
        const int t = (i / C) & (N - 1);
        const int pi = (i / (C * N)) % P;
        const uint32_t p = primes[pi];
        const uint32_t* tb = tables + (long long)pi * brk::T_COUNT * N;
        x[i] = brk::shoup_mul(lift(x[i], p), __ldg(tb + row * N + t),
                              __ldg(tb + (row + 1) * N + t), p);
    }
    __syncthreads();
}

}  // namespace probe
