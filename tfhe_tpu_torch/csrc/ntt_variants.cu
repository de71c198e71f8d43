// The NTT-variant probes on Hopper: looped micro-kernels, one block per row
// of N = 2048 u32 residues resident in shared memory, each trip one
// transform (or part of one) mod one prime, with the output order of
// ntt_common.cuh's forward_stages (natural in, DIF order out), so that a
// faster variant can take the place of forward_stages / inverse_stages in
// K1 and K3.
//
// Replaces: tools/ntt_variants.py::run_case (pallas_call at :68), the
// INT32 cases of :93-222:
//   - nv_fwd<R2> / nv_inv<R2>: the twist and brk::forward_stages<1>, or
//     brk::inverse_stages<1> and the untwist: today's transform, one block
//     barrier per stage (fwd_v1, fwd_v2, inv_v1, inv_v2: one transform in
//     four TPU layouts);
//   - nv_fwd<R4> / nv_inv<R4>: radix-4, two stages per shared-memory pass
//     (half the barriers), a radix-2 pass for the odd stage;
//   - nv_fwd<REG> / nv_inv<REG>: the stages of stride < 32 in registers,
//     exchanged between lanes with __shfl_xor_sync and no block barrier;
//   - nv_first4: the first four stages (sliced4; kernel_experiments.py E5);
//   - nv_last7<R2> / nv_last7<REG>: the last seven stages, in shared memory
//     or with the five of stride < 32 in registers (rolled7,
//     subl7_with_relayout; kernel_experiments.py E3/E4);
//   - nv_transpose<Pad>: a 128 x 128 u32 tile transposed through shared
//     memory and +1, per trip (relayout_only is two trips;
//     kernel_experiments.py E1/E1b), with rows padded to 129 words or not;
//   - nv_fwd4: the forward transforms of one row mod four primes, XOR-ed
//     (fwd4_primes_v1, fwd4_primes_v2): brk::forward_stages<4>.
// Every butterfly is the exact one of forward_stages / inverse_stages
// (add_mod, shoup_mul: canonical residues), so each variant equals the
// plain transform exactly.
//
// Bound: the INT32 pipes, at the radix-2 code's instructions per butterfly
// (ops/kernel_bench.py SASS_OPS), which every variant needs at least.

#include "ntt_common.cuh"
#include "probe_stages.cuh"

namespace {

using brk::add_mod;
using brk::kThreads;
using brk::shoup_mul;
using brk::T_FWD;
using brk::T_FWD_SH;
using brk::T_INV;
using brk::T_INV_SH;
using brk::T_TW;
using brk::T_TW_SH;
using brk::T_UTW;
using brk::T_UTW_SH;

enum Variant { R2 = 0, R4 = 1, REG = 2 };
constexpr int kRegLogH = 4;  // stages of stride <= 16 run in registers
constexpr unsigned kFull = 0xFFFFFFFFu;

// radix-2 stages [s0, s1) of one polynomial, forward or inverse, a block
// barrier after each (the loops of brk::forward_stages / inverse_stages,
// probe_stages.cuh)
__device__ void fwd_r2(uint32_t* x, int log_n, int s0, int s1,
                       const uint32_t* __restrict__ tb, uint32_t p) {
    probe::fwd_stages<1, 1>(x, 1, log_n, s0, s1, tb, probe::OnePrime{p});
}

__device__ void inv_r2(uint32_t* x, int log_n, int s0, int s1,
                       const uint32_t* __restrict__ tb, uint32_t p) {
    probe::inv_stages<1, 1>(x, 1, log_n, s0, s1, tb, probe::OnePrime{p});
}

// forward stages s and s+1 in one pass: the four elements
// {j, j+h/2, j+h, j+h+h/2} of a block of 2h are closed under both stages
__device__ void fwd_r4_pass(uint32_t* x, int log_n, int s,
                            const uint32_t* __restrict__ tb, uint32_t p) {
    const int N = 1 << log_n;
    const int log_h = log_n - 1 - s;  // stage s: stride h, stage s+1: h/2
    const int h = 1 << log_h, q = h >> 1;
    const uint32_t* w0 = tb + T_FWD * N + N - (N >> s);
    const uint32_t* w0s = tb + T_FWD_SH * N + N - (N >> s);
    const uint32_t* w1 = tb + T_FWD * N + N - (N >> (s + 1));
    const uint32_t* w1s = tb + T_FWD_SH * N + N - (N >> (s + 1));
    #pragma unroll 1
    for (int u = threadIdx.x; u < N / 4; u += blockDim.x) {
        const int j = u & (q - 1);
        const int i0 = ((u >> (log_h - 1)) << (log_h + 1)) + j;
        const uint32_t a0 = x[i0], a1 = x[i0 + q], a2 = x[i0 + h],
                       a3 = x[i0 + h + q];
        const uint32_t b0 = add_mod(a0, a2, p);
        const uint32_t b2 = shoup_mul(a0 - a2 + p, __ldg(w0 + j),
                                      __ldg(w0s + j), p);
        const uint32_t b1 = add_mod(a1, a3, p);
        const uint32_t b3 = shoup_mul(a1 - a3 + p, __ldg(w0 + j + q),
                                      __ldg(w0s + j + q), p);
        const uint32_t w = __ldg(w1 + j), ws = __ldg(w1s + j);
        x[i0] = add_mod(b0, b1, p);
        x[i0 + q] = shoup_mul(b0 - b1 + p, w, ws, p);
        x[i0 + h] = add_mod(b2, b3, p);
        x[i0 + h + q] = shoup_mul(b2 - b3 + p, w, ws, p);
    }
    __syncthreads();
}

// inverse stages s+1 then s in one pass (the mirror of fwd_r4_pass)
__device__ void inv_r4_pass(uint32_t* x, int log_n, int s,
                            const uint32_t* __restrict__ tb, uint32_t p) {
    const int N = 1 << log_n;
    const int log_h = log_n - 1 - s;
    const int h = 1 << log_h, q = h >> 1;
    const uint32_t* w0 = tb + T_INV * N + N - (N >> s);
    const uint32_t* w0s = tb + T_INV_SH * N + N - (N >> s);
    const uint32_t* w1 = tb + T_INV * N + N - (N >> (s + 1));
    const uint32_t* w1s = tb + T_INV_SH * N + N - (N >> (s + 1));
    #pragma unroll 1
    for (int u = threadIdx.x; u < N / 4; u += blockDim.x) {
        const int j = u & (q - 1);
        const int i0 = ((u >> (log_h - 1)) << (log_h + 1)) + j;
        const uint32_t a0 = x[i0], a1 = x[i0 + q], a2 = x[i0 + h],
                       a3 = x[i0 + h + q];
        const uint32_t w = __ldg(w1 + j), ws = __ldg(w1s + j);
        const uint32_t c1 = shoup_mul(a1, w, ws, p);
        const uint32_t b0 = add_mod(a0, c1, p), b1 = add_mod(a0, p - c1, p);
        const uint32_t c3 = shoup_mul(a3, w, ws, p);
        const uint32_t b2 = add_mod(a2, c3, p), b3 = add_mod(a2, p - c3, p);
        const uint32_t d2 = shoup_mul(b2, __ldg(w0 + j), __ldg(w0s + j), p);
        const uint32_t d3 = shoup_mul(b3, __ldg(w0 + j + q), __ldg(w0s + j + q),
                                      p);
        x[i0] = add_mod(b0, d2, p);
        x[i0 + h] = add_mod(b0, p - d2, p);
        x[i0 + q] = add_mod(b1, d3, p);
        x[i0 + h + q] = add_mod(b1, p - d3, p);
    }
    __syncthreads();
}

// The register stages: thread (warp w, lane l) holds the elements
// (w * e + k) * 32 + l, k < e = N / blockDim; a stage of stride h <= 16
// pairs lane l with lane l ^ h of the same k. Every lane computes its own
// output: the upper one (u0 + u1) mod p as a Shoup multiply by 1, the
// lower one (u0 - u1 + p) w mod p, so the warp does not diverge.
template <int E>
__device__ void fwd_regs(uint32_t* x, int log_n, int s0,
                         const uint32_t* __restrict__ tb, uint32_t p,
                         uint32_t one_sh) {
    const int N = 1 << log_n;
    const int lane = threadIdx.x & 31;
    const int base = (threadIdx.x >> 5) * E * 32 + lane;
    uint32_t v[E];
    #pragma unroll
    for (int k = 0; k < E; ++k) v[k] = x[base + k * 32];
    for (int s = s0; s < log_n; ++s) {
        const int h = N >> (s + 1);
        const int off = N - (N >> s);
        const bool upper = (lane & h) == 0;
        const int jj = lane & (h - 1);
        const uint32_t w = upper ? 1u : __ldg(tb + T_FWD * N + off + jj);
        const uint32_t ws = upper ? one_sh : __ldg(tb + T_FWD_SH * N + off + jj);
        #pragma unroll
        for (int k = 0; k < E; ++k) {
            const uint32_t o = __shfl_xor_sync(kFull, v[k], h);
            v[k] = shoup_mul(upper ? v[k] + o : o - v[k] + p, w, ws, p);
        }
    }
    #pragma unroll
    for (int k = 0; k < E; ++k) x[base + k * 32] = v[k];
    __syncthreads();
}

// inverse stages log_n-1 down to s0 (strides 1 .. 16) in registers
template <int E>
__device__ void inv_regs(uint32_t* x, int log_n, int s0,
                         const uint32_t* __restrict__ tb, uint32_t p) {
    const int N = 1 << log_n;
    const int lane = threadIdx.x & 31;
    const int base = (threadIdx.x >> 5) * E * 32 + lane;
    uint32_t v[E];
    #pragma unroll
    for (int k = 0; k < E; ++k) v[k] = x[base + k * 32];
    for (int s = log_n - 1; s >= s0; --s) {
        const int h = N >> (s + 1);
        const int off = N - (N >> s);
        const bool upper = (lane & h) == 0;
        const int jj = lane & (h - 1);
        const uint32_t w = __ldg(tb + T_INV * N + off + jj);
        const uint32_t ws = __ldg(tb + T_INV_SH * N + off + jj);
        #pragma unroll
        for (int k = 0; k < E; ++k) {
            const uint32_t o = __shfl_xor_sync(kFull, v[k], h);
            const uint32_t bw = shoup_mul(upper ? o : v[k], w, ws, p);
            v[k] = add_mod(upper ? v[k] : o, upper ? bw : p - bw, p);
        }
    }
    #pragma unroll
    for (int k = 0; k < E; ++k) x[base + k * 32] = v[k];
    __syncthreads();
}

constexpr int kRegElems = 4;  // N / kThreads at N = 2048

// the twist (row T_TW) or untwist (T_UTW) of one polynomial
__device__ void twist(uint32_t* x, int log_n, const uint32_t* __restrict__ tb,
                      int row, uint32_t p) {
    probe::twist<1, 1>(x, 1, log_n, tb, row, probe::OnePrime{p});
}

// forward stages s0 .. log_n-1 of the chosen variant
template <int V>
__device__ void fwd_from(uint32_t* x, int log_n, int s0,
                         const uint32_t* __restrict__ tb, uint32_t p,
                         uint32_t one_sh, const uint32_t* s_p) {
    if (V == R2) {
        fwd_r2(x, log_n, s0, log_n, tb, p);
    } else if (V == R4) {
        int s = s0;
        for (; s + 1 < log_n; s += 2) fwd_r4_pass(x, log_n, s, tb, p);
        if (s < log_n) fwd_r2(x, log_n, s, log_n, tb, p);
    } else {
        const int s_reg = log_n - 1 - kRegLogH;
        fwd_r2(x, log_n, s0, s_reg, tb, p);
        fwd_regs<kRegElems>(x, log_n, s_reg > s0 ? s_reg : s0, tb, p, one_sh);
    }
}

template <int V>
__device__ void inv_to(uint32_t* x, int log_n, int s0,
                       const uint32_t* __restrict__ tb, uint32_t p) {
    if (V == R2) {
        inv_r2(x, log_n, s0, log_n, tb, p);
    } else if (V == R4) {
        int s = log_n - 2;
        if ((log_n - s0) & 1) {
            inv_r2(x, log_n, log_n - 1, log_n, tb, p);
            s = log_n - 3;
        }
        for (; s >= s0; s -= 2) inv_r4_pass(x, log_n, s, tb, p);
    } else {
        const int s_reg = log_n - 1 - kRegLogH;
        inv_regs<kRegElems>(x, log_n, s_reg > s0 ? s_reg : s0, tb, p);
        inv_r2(x, log_n, s0, s_reg, tb, p);
    }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
nv_fwd(const uint32_t* __restrict__ x_in, uint32_t* __restrict__ x_out,
       const uint32_t* __restrict__ tb, int log_n, uint32_t p,
       uint32_t one_sh, int loops) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    uint32_t* x = reinterpret_cast<uint32_t*>(smem_raw);
    __shared__ uint32_t s_p[1];
    const int N = 1 << log_n;
    const long long row = (long long)blockIdx.x * N;
    if (threadIdx.x == 0) s_p[0] = p;
    for (int t = threadIdx.x; t < N; t += blockDim.x) x[t] = x_in[row + t];
    __syncthreads();
    #pragma unroll 1
    for (int k = 0; k < loops; ++k) {
        twist(x, log_n, tb, T_TW, p);
        if (V == R2)
            brk::forward_stages<1>(x, 1, log_n, tb, s_p);
        else
            fwd_from<V>(x, log_n, 0, tb, p, one_sh, s_p);
    }
    for (int t = threadIdx.x; t < N; t += blockDim.x) x_out[row + t] = x[t];
}

template <int V>
__global__ void __launch_bounds__(kThreads)
nv_inv(const uint32_t* __restrict__ x_in, uint32_t* __restrict__ x_out,
       const uint32_t* __restrict__ tb, int log_n, uint32_t p, int loops) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    uint32_t* x = reinterpret_cast<uint32_t*>(smem_raw);
    __shared__ uint32_t s_p[1];
    const int N = 1 << log_n;
    const long long row = (long long)blockIdx.x * N;
    if (threadIdx.x == 0) s_p[0] = p;
    for (int t = threadIdx.x; t < N; t += blockDim.x) x[t] = x_in[row + t];
    __syncthreads();
    #pragma unroll 1
    for (int k = 0; k < loops; ++k) {
        if (V == R2)
            brk::inverse_stages<1>(x, 1, log_n, tb, s_p);
        else
            inv_to<V>(x, log_n, 0, tb, p);
        twist(x, log_n, tb, T_UTW, p);
    }
    for (int t = threadIdx.x; t < N; t += blockDim.x) x_out[row + t] = x[t];
}

// forward stages [s0, s1) per trip, no twist (first4: 0..4, R2; last7:
// log_n-7 .. log_n, R2 or REG)
template <int V>
__global__ void __launch_bounds__(kThreads)
nv_stages(const uint32_t* __restrict__ x_in, uint32_t* __restrict__ x_out,
          const uint32_t* __restrict__ tb, int log_n, int s0, int s1,
          uint32_t p, uint32_t one_sh, int loops) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    uint32_t* x = reinterpret_cast<uint32_t*>(smem_raw);
    const int N = 1 << log_n;
    const long long row = (long long)blockIdx.x * N;
    for (int t = threadIdx.x; t < N; t += blockDim.x) x[t] = x_in[row + t];
    __syncthreads();
    #pragma unroll 1
    for (int k = 0; k < loops; ++k) {
        if (V == R2)
            fwd_r2(x, log_n, s0, s1, tb, p);
        else
            fwd_from<REG>(x, log_n, s0, tb, p, one_sh, nullptr);
    }
    for (int t = threadIdx.x; t < N; t += blockDim.x) x_out[row + t] = x[t];
}

// tiles of 128 x 128 u32 (8 rows of 2048), one block per tile: per trip
// x <- transpose(x) + 1 through shared memory (row stride 129 words with
// Pad, 128 without)
constexpr int kTile = 128;
template <bool Pad>
__global__ void __launch_bounds__(kThreads)
nv_transpose(const uint32_t* __restrict__ x_in, uint32_t* __restrict__ x_out,
             uint32_t one, int loops) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    uint32_t* x = reinterpret_cast<uint32_t*>(smem_raw);
    constexpr int ld = Pad ? kTile + 1 : kTile;
    constexpr int E = kTile * kTile / kThreads;
    const long long base = (long long)blockIdx.x * kTile * kTile;
    uint32_t v[E];
    #pragma unroll
    for (int k = 0; k < E; ++k) {
        const int i = threadIdx.x + k * kThreads;
        v[k] = x_in[base + i];
    }
    #pragma unroll 1
    for (int t = 0; t < loops; ++t) {
        // element (r, c) of the tile goes to (c, r)
        #pragma unroll
        for (int k = 0; k < E; ++k) {
            const int i = threadIdx.x + k * kThreads;
            x[(i & (kTile - 1)) * ld + (i >> 7)] = v[k];
        }
        __syncthreads();
        #pragma unroll
        for (int k = 0; k < E; ++k) {
            const int i = threadIdx.x + k * kThreads;
            v[k] = x[(i >> 7) * ld + (i & (kTile - 1))] + one;
        }
        __syncthreads();
    }
    #pragma unroll
    for (int k = 0; k < E; ++k) {
        const int i = threadIdx.x + k * kThreads;
        x_out[base + i] = v[k];
    }
}

// per trip: y_i = forward transform of x mod prime i (twist and
// brk::forward_stages<4> over the four polynomials), x <- y0^y1^y2^y3
__global__ void __launch_bounds__(kThreads)
nv_fwd4(const uint32_t* __restrict__ x_in, uint32_t* __restrict__ x_out,
        const uint32_t* __restrict__ tables, int log_n, const uint4 primes,
        int loops) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int N = 1 << log_n;
    uint32_t* x = reinterpret_cast<uint32_t*>(smem_raw);
    uint32_t* y = x + N;  // [4][N]
    __shared__ uint32_t s_p[4];
    const long long row = (long long)blockIdx.x * N;
    if (threadIdx.x == 0) {
        s_p[0] = primes.x;
        s_p[1] = primes.y;
        s_p[2] = primes.z;
        s_p[3] = primes.w;
    }
    for (int t = threadIdx.x; t < N; t += blockDim.x) x[t] = x_in[row + t];
    __syncthreads();
    #pragma unroll 1
    for (int k = 0; k < loops; ++k) {
        #pragma unroll 1
        for (int i = threadIdx.x; i < 4 * N; i += blockDim.x) {
            const int pi = i >> log_n, t = i & (N - 1);
            const uint32_t* tb = tables + (long long)pi * brk::T_COUNT * N;
            y[i] = shoup_mul(x[t], __ldg(tb + T_TW * N + t),
                             __ldg(tb + T_TW_SH * N + t), s_p[pi]);
        }
        __syncthreads();
        brk::forward_stages<4>(y, 4, log_n, tables, s_p);
        #pragma unroll 1
        for (int t = threadIdx.x; t < N; t += blockDim.x)
            x[t] = y[t] ^ y[N + t] ^ y[2 * N + t] ^ y[3 * N + t];
        __syncthreads();
    }
    for (int t = threadIdx.x; t < N; t += blockDim.x) x_out[row + t] = x[t];
}

template <class K, class... Args>
int launch(K kernel, int blocks, size_t smem, void* stream, Args... args) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(args...);
    return (int)cudaGetLastError();
}

}  // namespace

// Each entry returns cudaGetLastError() after its launch (0 = launched) or
// cudaErrorInvalidValue for arguments the kernel does not take. x_in/x_out:
// u32 [rows, 2^log_n]; tables: u32 [8, N] of the prime (ops/pbs_kernel.py
// plan_tables); one_sh = floor(2^32 / p); variant: 0 radix-2, 1 radix-4,
// 2 register stages (log_n = 11 only: 4 elements per thread).

extern "C" int nv_transform(const void* x_in, void* x_out, const void* tables,
                            int rows, int log_n, unsigned p, unsigned one_sh,
                            int variant, int inverse, int loops,
                            void* stream) {
    if (variant == REG && log_n != 11) return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(uint32_t) << log_n;
    const uint32_t* a = (const uint32_t*)x_in;
    uint32_t* o = (uint32_t*)x_out;
    const uint32_t* tb = (const uint32_t*)tables;
    if (inverse) {
        auto k = variant == R2 ? nv_inv<R2> : variant == R4 ? nv_inv<R4>
                                                            : nv_inv<REG>;
        return launch(k, rows, smem, stream, a, o, tb, log_n, (uint32_t)p,
                      loops);
    }
    auto k = variant == R2 ? nv_fwd<R2> : variant == R4 ? nv_fwd<R4>
                                                        : nv_fwd<REG>;
    return launch(k, rows, smem, stream, a, o, tb, log_n, (uint32_t)p,
                  (uint32_t)one_sh, loops);
}

// forward stages [s0, s1) per trip: variant 0 radix-2 (any range), 2 the
// range log_n-7 .. log_n with the stages of stride <= 16 in registers
extern "C" int nv_stage_range(const void* x_in, void* x_out,
                              const void* tables, int rows, int log_n, int s0,
                              int s1, unsigned p, unsigned one_sh, int variant,
                              int loops, void* stream) {
    if (s0 < 0 || s1 > log_n || s0 >= s1
        || (variant == REG && (log_n != 11 || s1 != log_n
                               || s0 > log_n - 1 - kRegLogH)))
        return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(uint32_t) << log_n;
    auto k = variant == REG ? nv_stages<REG> : nv_stages<R2>;
    return launch(k, rows, smem, stream, (const uint32_t*)x_in,
                  (uint32_t*)x_out, (const uint32_t*)tables, log_n, s0, s1,
                  (uint32_t)p, (uint32_t)one_sh, loops);
}

// x_in/x_out: u32 [tiles, 128, 128].
extern "C" int nv_transpose128(const void* x_in, void* x_out, int tiles,
                               int pad, unsigned one, int loops,
                               void* stream) {
    const size_t smem = sizeof(uint32_t) * kTile * (pad ? kTile + 1 : kTile);
    auto k = pad ? nv_transpose<true> : nv_transpose<false>;
    return launch(k, tiles, smem, stream, (const uint32_t*)x_in,
                  (uint32_t*)x_out, (uint32_t)one, loops);
}

// tables: u32 [4, 8, N] of the four primes p[4].
extern "C" int nv_fwd4_primes(const void* x_in, void* x_out,
                              const void* tables, int rows, int log_n,
                              const unsigned* p, int loops, void* stream) {
    const size_t smem = 5 * (sizeof(uint32_t) << log_n);
    return launch(nv_fwd4, rows, smem, stream, (const uint32_t*)x_in,
                  (uint32_t*)x_out, (const uint32_t*)tables, log_n,
                  make_uint4(p[0], p[1], p[2], p[3]), loops);
}
