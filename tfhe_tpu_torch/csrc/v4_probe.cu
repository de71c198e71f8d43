// The step probes on Hopper: K1's and K3's blind-rotation step piece by
// piece, each piece a looped micro-kernel on data resident in shared
// memory, in two layouts.
//
// Replaces: tools/v4_probe.py::run_case (pallas_call at :80, the
// [Bt, G, 128] layout, cases :152-258) and run_case_g (pallas_call at
// :274, the [G, Bt, 128] layout, cases :375-445), their INT32 pieces:
//   - v4_rot: x <- hi ^ lo of X^a * (x : x ^ 1), the u64 negacyclic
//     rotation by a = x[0] & (2N - 1) of each ciphertext (v4_rot, g_rot);
//   - v4_decomp: digit 0 of the balanced decomposition of the hi word at
//     base_log 23 (g_decomp), brk::HiDecomposer;
//   - v4_lift_twist: a digit d = (x & 0x3FFFFF) - 2^21 lifted into Z_p and
//     twisted (the split of v4_fwd_with_split against v4_fwd_nosplit);
//   - v4_fwd: forward_stages over the 8 digit polynomials of K3 at P = 4
//     (v4_fwd_nosplit, v4_groups4_fwd, g_groups4_fwd, g_groups4_fwd_lanerep,
//     v3_fwd), or its first four stages (fwd_first4);
//   - v4_mac2: two Shoup terms against true duals, summed mod p (v4_mac2);
//   - v4_inv_untwist: inverse_stages over 8 polynomials and the untwist
//     (v4_inv, v3_inv, v4_tw_recombine, g_tw_recombine);
//   - v4_tail: one recombination tail of tails.cuh per coefficient on
//     m_i = (x ^ i) & mask (canonical residues), x <- the tail's value
//     (hi ^ lo for a u64 one): GarnerTail<3, 4> (g_garner_crt_1c),
//     GarnerTail32<3, 4>, Bnf2Tail, Bnf2Tail32.
//   - pass_piece: one piece of the step K1 and K3 run
//     (ntt_common.cuh's StepPasses) on the step kernels' own shared-memory
//     state (acc and the swizzled digits, loaded and stored as they lie
//     there): the lift with the first forward pass, the other forward
//     passes, the fused pass (the key streamed from global memory as in the
//     step), the inverse passes, the last inverse pass with the untwist and
//     the tail; K1's Bnf2Tail32 (P = 2) or K3's GarnerTail<4>. No JAX case
//     has them: they split the step as the pieces above split the radix-2
//     reference loop's.
// Layouts: C = 1 is K1's and K3's, one ciphertext per block with its
// polynomials contiguous (the counterpart of [Bt, G, 128]); C = 2
// interleaves two ciphertexts per block coefficient-major, element
// (coefficient t, ciphertext b) at t * C + b (the counterpart of
// [G, Bt, 128]), the layout in which one key or twiddle load serves C
// ciphertexts. C = 2 because the eight 2048-coefficient polynomials of the
// transforms take 64 KiB per ciphertext; K3's step at P = 4 (160 KiB per
// ciphertext) would not fit two. The transforms run at C = 1 twice: through
// the step kernels' own loops (brk::forward_stages / inverse_stages) and
// through the C-strided loops of probe_stages.cuh that C = 2 runs, so that
// the two layouts are compared on one code path.
//
// Every trip ends in a block barrier, as every pass of the step does.
// Bound: the INT32 pipes (instructions per pipe from the build's SASS).

#include "ntt_common.cuh"
#include "probe_stages.cuh"
#include "tails.cuh"

namespace {

using brk::add_mod;
using brk::kThreads;
using brk::shoup_mul;

// element i of the block's C ciphertexts' data, [polys][N][C], from row
// (blockIdx * C + b) of the global [B, polys * N] array
template <int C>
__device__ void load(const uint32_t* __restrict__ g, uint32_t* x, int len) {
    const long long base = (long long)blockIdx.x * C * len;
    for (int i = threadIdx.x; i < C * len; i += blockDim.x) {
        const int b = i / len, r = i - b * len;
        x[r * C + b] = g[base + i];
    }
    __syncthreads();
}

template <int C>
__device__ void store(uint32_t* __restrict__ g, const uint32_t* x, int len) {
    __syncthreads();
    const long long base = (long long)blockIdx.x * C * len;
    for (int i = threadIdx.x; i < C * len; i += blockDim.x) {
        const int b = i / len, r = i - b * len;
        g[base + i] = x[r * C + b];
    }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
rot_kernel(const uint32_t* __restrict__ x_in, uint32_t* __restrict__ x_out,
           int log_n, int loops) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int N = 1 << log_n;
    uint32_t* cur = reinterpret_cast<uint32_t*>(smem_raw);
    uint32_t* nxt = cur + N * C;
    load<C>(x_in, cur, N);
    #pragma unroll 1
    for (int k = 0; k < loops; ++k) {
        #pragma unroll 1
        for (int i = threadIdx.x; i < N * C; i += blockDim.x) {
            const int b = i % C, t = i / C;
            const int a = (int)(cur[b] & (2u * N - 1u));
            int s = t - a;
            if (s < 0) s += 2 * N;
            const bool neg = s >= N;
            if (neg) s -= N;
            const uint32_t v = cur[s * C + b];
            uint64_t w = ((uint64_t)v << 32) | (v ^ 1u);
            if (neg) w = 0ull - w;
            nxt[i] = (uint32_t)(w >> 32) ^ (uint32_t)w;
        }
        __syncthreads();
        uint32_t* tmp = cur;
        cur = nxt;
        nxt = tmp;
    }
    store<C>(x_out, cur, N);
}

template <int C>
__global__ void __launch_bounds__(kThreads)
decomp_kernel(const uint32_t* __restrict__ x_in, uint32_t* __restrict__ x_out,
              int log_n, int base_log, int loops) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int N = 1 << log_n;
    uint32_t* x = reinterpret_cast<uint32_t*>(smem_raw);
    const brk::HiDecomposer dec(base_log, 1);
    load<C>(x_in, x, N);
    #pragma unroll 1
    for (int k = 0; k < loops; ++k) {
        #pragma unroll 1
        for (int i = threadIdx.x; i < N * C; i += blockDim.x) {
            int32_t state = dec.init(x[i]);
            x[i] = (uint32_t)dec.next(state);
        }
        __syncthreads();
    }
    store<C>(x_out, x, N);
}

// a digit lifted into Z_p: d = (x & mask) - offset, d < 0 ? d + p : d
struct Lift {
    uint32_t mask;
    int32_t offset;
    __device__ uint32_t operator()(uint32_t x, uint32_t p) const {
        const int32_t d = (int32_t)(x & mask) - offset;
        return d < 0 ? (uint32_t)(d + (int32_t)p) : (uint32_t)d;
    }
};

// tb: the prime's [8, N] table (twist at row T_TW)
template <int C>
__global__ void __launch_bounds__(kThreads)
lift_twist_kernel(const uint32_t* __restrict__ x_in,
                  uint32_t* __restrict__ x_out,
                  const uint32_t* __restrict__ tb, int log_n, uint32_t p,
                  uint32_t mask, int32_t offset, int loops) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int N = 1 << log_n;
    uint32_t* x = reinterpret_cast<uint32_t*>(smem_raw);
    load<C>(x_in, x, N);
    #pragma unroll 1
    for (int k = 0; k < loops; ++k)
        probe::twist<1, C>(x, 1, log_n, tb, brk::T_TW, probe::OnePrime{p},
                           Lift{mask, offset});
    store<C>(x_out, x, N);
}

constexpr int kP = 4;      // primes of the transform pieces (K3 at 2_2)
constexpr int kPolys = 8;  // P * l * R digit (or P * R MAC) polynomials

__device__ void set_primes(uint32_t* s_p, const uint4& primes) {
    if (threadIdx.x == 0) {
        s_p[0] = primes.x;
        s_p[1] = primes.y;
        s_p[2] = primes.z;
        s_p[3] = primes.w;
    }
}

// per trip: forward stages [s0, s1) of the 8 polynomials; Brk (C = 1, all
// stages): brk::forward_stages<4>, the step kernels' own loop, else the
// probes' (probe_stages.cuh)
template <int C, bool Brk>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const uint32_t* __restrict__ x_in, uint32_t* __restrict__ x_out,
           const uint32_t* __restrict__ tables, int log_n, int s0, int s1,
           const uint4 primes, int loops) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int N = 1 << log_n;
    uint32_t* x = reinterpret_cast<uint32_t*>(smem_raw);
    __shared__ uint32_t s_p[kP];
    set_primes(s_p, primes);
    load<C>(x_in, x, kPolys * N);
    #pragma unroll 1
    for (int k = 0; k < loops; ++k) {
        if (Brk)
            brk::forward_stages<kP>(x, kPolys, log_n, tables, s_p);
        else
            probe::fwd_stages<kP, C>(x, kPolys, log_n, s0, s1, tables, s_p);
    }
    store<C>(x_out, x, kPolys * N);
}

// per trip: the inverse transforms of the 8 polynomials and the untwist
// (Brk: brk::inverse_stages<4>, else the probes' loop)
template <int C, bool Brk>
__global__ void __launch_bounds__(kThreads)
inv_untwist_kernel(const uint32_t* __restrict__ x_in,
                   uint32_t* __restrict__ x_out,
                   const uint32_t* __restrict__ tables, int log_n,
                   const uint4 primes, int loops) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int N = 1 << log_n;
    uint32_t* x = reinterpret_cast<uint32_t*>(smem_raw);
    __shared__ uint32_t s_p[kP];
    set_primes(s_p, primes);
    load<C>(x_in, x, kPolys * N);
    #pragma unroll 1
    for (int k = 0; k < loops; ++k) {
        if (Brk)
            brk::inverse_stages<kP>(x, kPolys, log_n, tables, s_p);
        else
            probe::inv_stages<kP, C>(x, kPolys, log_n, 0, log_n, tables,
                                     s_p);
        probe::twist<kP, C>(x, kPolys, log_n, tables, brk::T_UTW, s_p);
    }
    store<C>(x_out, x, kPolys * N);
}

// g: u32 [2 (residues, duals), 2 terms, N] (kernel_bench.mac_operands)
template <int C>
__global__ void __launch_bounds__(kThreads)
mac2_kernel(const uint32_t* __restrict__ x_in, uint32_t* __restrict__ x_out,
            const uint32_t* __restrict__ g, int log_n, uint32_t p,
            int loops) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int N = 1 << log_n;
    uint32_t* x = reinterpret_cast<uint32_t*>(smem_raw);
    load<C>(x_in, x, N);
    #pragma unroll 1
    for (int k = 0; k < loops; ++k) {
        #pragma unroll 1
        for (int i = threadIdx.x; i < N * C; i += blockDim.x) {
            const int t = i / C;
            const uint32_t v = x[i];
            x[i] = add_mod(shoup_mul(v, __ldg(g + t), __ldg(g + 2 * N + t), p),
                           shoup_mul(v, __ldg(g + N + t),
                                     __ldg(g + 3 * N + t), p), p);
        }
        __syncthreads();
    }
    store<C>(x_out, x, N);
}

__device__ __forceinline__ uint32_t fold(uint64_t v) {
    return (uint32_t)(v >> 32) ^ (uint32_t)v;
}
__device__ __forceinline__ uint32_t fold(uint32_t v) { return v; }

template <class Tail, int C>
__global__ void __launch_bounds__(kThreads)
tail_kernel(const uint32_t* __restrict__ x_in, uint32_t* __restrict__ x_out,
            int log_n, uint32_t mask, const Tail tail, int loops) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int N = 1 << log_n;
    uint32_t* x = reinterpret_cast<uint32_t*>(smem_raw);
    load<C>(x_in, x, N);
    #pragma unroll 1
    for (int k = 0; k < loops; ++k) {
        #pragma unroll 1
        for (int i = threadIdx.x; i < N * C; i += blockDim.x) {
            uint32_t m[Tail::P];
            #pragma unroll
            for (int j = 0; j < Tail::P; ++j) m[j] = (x[i] ^ (uint32_t)j) & mask;
            x[i] = fold(tail(m));
        }
        __syncthreads();
    }
    store<C>(x_out, x, N);
}

enum PassPiece { PC_LIFT = 0, PC_FWD, PC_FUSED, PC_INV, PC_TAIL };

// x_in/x_out: per block the words of the step's shared-memory state,
// acc [R][N] (Acc) then the swizzled digits [l R][P][N]; key: one step's
// u32 [2, P, l R, R, N]; a: i32 [B] in [0, 2N)
template <class Tail, int Pc>
__global__ void __launch_bounds__(kThreads, brk::kMinBlocks)
pass_piece_kernel(const uint32_t* __restrict__ x_in,
                  uint32_t* __restrict__ x_out,
                  const uint32_t* __restrict__ key,
                  const uint32_t* __restrict__ tables,
                  const int32_t* __restrict__ a_in, int R, int levels,
                  int base_log, int log_n,
                  const __grid_constant__ brk::PassPlan pl,
                  const __grid_constant__ Tail tail, int loops) {
    using SP = brk::StepPasses<Tail>;
    using Acc = typename Tail::Acc;
    constexpr int P = Tail::P;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int N = 1 << log_n;
    const int lR = levels * R;
    const int words = R * N * (int)(sizeof(Acc) / 4) + P * lR * N;
    uint32_t* img = reinterpret_cast<uint32_t*>(smem_raw);
    Acc* acc = reinterpret_cast<Acc*>(smem_raw);
    uint32_t* dig = reinterpret_cast<uint32_t*>(acc + R * N);
    __shared__ uint32_t s_p[P];
    if (threadIdx.x == 0) {
        #pragma unroll
        for (int pi = 0; pi < P; ++pi) s_p[pi] = tail.p[pi];
    }
    const long long row = (long long)blockIdx.x * words;
    for (int i = threadIdx.x; i < words; i += blockDim.x) img[i] = x_in[row + i];
    const int a = a_in[blockIdx.x];
    __syncthreads();
    #pragma unroll 1
    for (int k = 0; k < loops; ++k) {
        if constexpr (Pc == PC_LIFT) {
            SP::lift_pass_k(pl.fwd_k[0], acc, dig, a, R, levels, base_log,
                            log_n, tables, s_p);
        } else if constexpr (Pc == PC_FWD) {
            #pragma unroll 1
            for (int i = 1; i < pl.n_fwd; ++i)
                SP::template pass_k<false>(pl.fwd_k[i], dig, P * lR, log_n,
                                           pl.fwd_s0[i], tables, s_p);
        } else if constexpr (Pc == PC_FUSED) {
            SP::fused_pass_f(pl.fused, dig, key, R, lR, log_n, tables, s_p);
        } else if constexpr (Pc == PC_INV) {
            #pragma unroll 1
            for (int i = 0; i + 1 < pl.n_inv; ++i)
                SP::template pass_k<true>(pl.inv_k[i], dig, P * R, log_n,
                                          pl.inv_s0[i], tables, s_p);
        } else {
            SP::tail_pass_k(pl.inv_k[pl.n_inv - 1], acc, dig, R, log_n,
                            tables, s_p, tail);
        }
    }
    for (int i = threadIdx.x; i < words; i += blockDim.x)
        x_out[row + i] = img[i];
}

template <class K, class... Args>
int launch(K kernel, int blocks, size_t smem, void* stream, Args... args) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(args...);
    return (int)cudaGetLastError();
}

// blocks of B ciphertexts in layout C (1 or 2); -1 for a layout or a batch
// the probes do not take
int blocks_of(int B, int C) {
    return (C == 1 || C == 2) && B > 0 && B % C == 0 ? B / C : -1;
}

#define BAD (int)cudaErrorInvalidValue

}  // namespace

// Every entry: x_in/x_out u32 [B, polys, N] (polys = 8 for v4_fwd and
// v4_inv_untwist, else 1), C the layout (1: a ciphertext per block, 2: two
// interleaved), `loops` trips. Returns cudaGetLastError() after the launch
// (0 = launched) or cudaErrorInvalidValue for arguments it does not take.

extern "C" int v4_rot(const void* x_in, void* x_out, int B, int C, int log_n,
                      int loops, void* stream) {
    const int nb = blocks_of(B, C);
    if (nb < 0) return BAD;
    const size_t smem = 2 * C * (sizeof(uint32_t) << log_n);
    auto k = C == 1 ? rot_kernel<1> : rot_kernel<2>;
    return launch(k, nb, smem, stream, (const uint32_t*)x_in,
                  (uint32_t*)x_out, log_n, loops);
}

extern "C" int v4_decomp(const void* x_in, void* x_out, int B, int C,
                         int log_n, int base_log, int loops, void* stream) {
    const int nb = blocks_of(B, C);
    if (nb < 0 || base_log < 1 || base_log > 31) return BAD;
    const size_t smem = C * (sizeof(uint32_t) << log_n);
    auto k = C == 1 ? decomp_kernel<1> : decomp_kernel<2>;
    return launch(k, nb, smem, stream, (const uint32_t*)x_in,
                  (uint32_t*)x_out, log_n, base_log, loops);
}

// tables: the prime's u32 [8, N] (pbs_kernel.plan_tables)
extern "C" int v4_lift_twist(const void* x_in, void* x_out,
                             const void* tables, int B, int C, int log_n,
                             unsigned p, unsigned mask, int offset, int loops,
                             void* stream) {
    const int nb = blocks_of(B, C);
    if (nb < 0) return BAD;
    const size_t smem = C * (sizeof(uint32_t) << log_n);
    auto k = C == 1 ? lift_twist_kernel<1> : lift_twist_kernel<2>;
    return launch(k, nb, smem, stream, (const uint32_t*)x_in,
                  (uint32_t*)x_out, (const uint32_t*)tables, log_n,
                  (uint32_t)p, (uint32_t)mask, (int32_t)offset, loops);
}

// tables: u32 [4, 8, N] of the primes p[4]; stages [s0, s1); brk: the
// step kernels' loop (C = 1, all stages) instead of the probes'
extern "C" int v4_fwd(const void* x_in, void* x_out, const void* tables,
                      int B, int C, int log_n, int s0, int s1,
                      const unsigned* p, int brk, int loops, void* stream) {
    const int nb = blocks_of(B, C);
    if (nb < 0 || s0 < 0 || s1 > log_n || s0 >= s1
        || (brk && (C != 1 || s0 != 0 || s1 != log_n)))
        return BAD;
    const size_t smem = C * kPolys * (sizeof(uint32_t) << log_n);
    auto k = brk ? fwd_kernel<1, true>
                 : C == 1 ? fwd_kernel<1, false> : fwd_kernel<2, false>;
    return launch(k, nb, smem, stream, (const uint32_t*)x_in,
                  (uint32_t*)x_out, (const uint32_t*)tables, log_n, s0, s1,
                  make_uint4(p[0], p[1], p[2], p[3]), loops);
}

extern "C" int v4_inv_untwist(const void* x_in, void* x_out,
                              const void* tables, int B, int C, int log_n,
                              const unsigned* p, int brk, int loops,
                              void* stream) {
    const int nb = blocks_of(B, C);
    if (nb < 0 || (brk && C != 1)) return BAD;
    const size_t smem = C * kPolys * (sizeof(uint32_t) << log_n);
    auto k = brk ? inv_untwist_kernel<1, true>
                 : C == 1 ? inv_untwist_kernel<1, false>
                          : inv_untwist_kernel<2, false>;
    return launch(k, nb, smem, stream, (const uint32_t*)x_in,
                  (uint32_t*)x_out, (const uint32_t*)tables, log_n,
                  make_uint4(p[0], p[1], p[2], p[3]), loops);
}

extern "C" int v4_mac2(const void* x_in, void* x_out, const void* g, int B,
                       int C, int log_n, unsigned p, int loops,
                       void* stream) {
    const int nb = blocks_of(B, C);
    if (nb < 0) return BAD;
    const size_t smem = C * (sizeof(uint32_t) << log_n);
    auto k = C == 1 ? mac2_kernel<1> : mac2_kernel<2>;
    return launch(k, nb, smem, stream, (const uint32_t*)x_in,
                  (uint32_t*)x_out, (const uint32_t*)g, log_n, (uint32_t)p,
                  loops);
}

template <class Tail>
static int launch_tail(const void* x_in, void* x_out, int nb, int C,
                       int log_n, unsigned mask, const Tail& tail, int loops,
                       void* stream) {
    const size_t smem = C * (sizeof(uint32_t) << log_n);
    auto k = C == 1 ? tail_kernel<Tail, 1> : tail_kernel<Tail, 2>;
    return launch(k, nb, smem, stream, (const uint32_t*)x_in,
                  (uint32_t*)x_out, log_n, (uint32_t)mask, tail, loops);
}

// kind 0: GarnerTail<P>, 1: GarnerTail32<P> (P = 3 or 4; garner: host
// u32[65] of pbs_kernel.garner_constants, full_prod); 2: Bnf2Tail, 3:
// Bnf2Tail32 (P = 2; bnf: p0, p1, inv01, inv01_sh, g0, g1, s1, s2, c1t,
// t32_bias). mask: m_i = (x ^ i) & mask, below every prime.
extern "C" int v4_tail(const void* x_in, void* x_out, int B, int C,
                       int log_n, int kind, int P, unsigned mask,
                       const unsigned* garner, unsigned long long full_prod,
                       const unsigned* bnf, int loops, void* stream) {
    const int nb = blocks_of(B, C);
    if (nb < 0) return BAD;
    if (kind == 0 || kind == 1) {
        if (P != 3 && P != 4) return BAD;
        auto go = [&](auto tail) {
            brk::fill_garner(tail, garner, full_prod);
            return launch_tail(x_in, x_out, nb, C, log_n, mask, tail, loops,
                               stream);
        };
        if (kind == 0)
            return P == 3 ? go(brk::GarnerTail<3>{}) : go(brk::GarnerTail<4>{});
        return P == 3 ? go(brk::GarnerTail32<3>{}) : go(brk::GarnerTail32<4>{});
    }
    if (kind == 2) {
        brk::Bnf2Tail t;
        t.p[0] = bnf[0];
        t.p[1] = bnf[1];
        t.inv01 = bnf[2];
        t.inv01_sh = bnf[3];
        t.g0 = bnf[4];
        t.g1 = bnf[5];
        t.s1 = (int)bnf[6];
        t.s2 = (int)bnf[7];
        return launch_tail(x_in, x_out, nb, C, log_n, mask, t, loops, stream);
    }
    if (kind == 3) {
        brk::Bnf2Tail32 t;
        t.p[0] = bnf[0];
        t.p[1] = bnf[1];
        t.inv01 = bnf[2];
        t.inv01_sh = bnf[3];
        t.c1t = bnf[8];
        t.t32_bias = bnf[9];
        t.s2 = (int)bnf[7];
        return launch_tail(x_in, x_out, nb, C, log_n, mask, t, loops, stream);
    }
    return BAD;
}

template <class Tail, int Pc>
static int launch_piece(const void* x_in, void* x_out, const void* key,
                        const void* tables, const void* a, int B, int R,
                        int levels, int base_log, int log_n, const Tail& tail,
                        int loops, void* stream) {
    const size_t smem = brk::blind_rotate_smem<Tail>(R, levels, log_n);
    return launch(pass_piece_kernel<Tail, Pc>, B, smem, stream,
                  (const uint32_t*)x_in, (uint32_t*)x_out,
                  (const uint32_t*)key, (const uint32_t*)tables,
                  (const int32_t*)a, R, levels, base_log, log_n,
                  brk::make_pass_plan(log_n, R), tail, loops);
}

template <class Tail>
static int launch_piece_of(int piece, const void* x_in, void* x_out,
                           const void* key, const void* tables, const void* a,
                           int B, int R, int levels, int base_log, int log_n,
                           const Tail& tail, int loops, void* stream) {
    switch (piece) {
        case PC_LIFT: return launch_piece<Tail, PC_LIFT>(x_in, x_out, key, tables, a, B, R, levels, base_log, log_n, tail, loops, stream);
        case PC_FWD: return launch_piece<Tail, PC_FWD>(x_in, x_out, key, tables, a, B, R, levels, base_log, log_n, tail, loops, stream);
        case PC_FUSED: return launch_piece<Tail, PC_FUSED>(x_in, x_out, key, tables, a, B, R, levels, base_log, log_n, tail, loops, stream);
        case PC_INV: return launch_piece<Tail, PC_INV>(x_in, x_out, key, tables, a, B, R, levels, base_log, log_n, tail, loops, stream);
        case PC_TAIL: return launch_piece<Tail, PC_TAIL>(x_in, x_out, key, tables, a, B, R, levels, base_log, log_n, tail, loops, stream);
        default: return BAD;
    }
}

// One piece of the step (piece: 0 the lift with the first forward pass,
// 1 the other forward passes, 2 the fused pass, 3 the inverse passes but
// the last, 4 the last with the untwist and the tail) on B blocks' states
// (x_in/x_out: u32 [B, words], see pass_piece_kernel), `loops` trips.
// kind 0: K1's Bnf2Tail32 (P = 2, bnf as v4_tail's), 1: K3's
// GarnerTail<4> (garner, full_prod as v4_tail's); tables u32 [P, 8, N].
extern "C" int v4_pass_piece(const void* x_in, void* x_out, const void* key,
                             const void* tables, const void* a, int B, int R,
                             int levels, int base_log, int log_n, int piece,
                             int kind, const unsigned* garner,
                             unsigned long long full_prod,
                             const unsigned* bnf, int loops, void* stream) {
    if (B <= 0 || !brk::pass_plan_fits(R, levels, log_n)) return BAD;
    if (kind == 0) {
        brk::Bnf2Tail32 t;
        t.p[0] = bnf[0];
        t.p[1] = bnf[1];
        t.inv01 = bnf[2];
        t.inv01_sh = bnf[3];
        t.c1t = bnf[8];
        t.t32_bias = bnf[9];
        t.s2 = (int)bnf[7];
        return launch_piece_of(piece, x_in, x_out, key, tables, a, B, R,
                               levels, base_log, log_n, t, loops, stream);
    }
    if (kind == 1) {
        brk::GarnerTail<4> t;
        brk::fill_garner(t, garner, full_prod);
        return launch_piece_of(piece, x_in, x_out, key, tables, a, B, R,
                               levels, base_log, log_n, t, loops, stream);
    }
    return BAD;
}
