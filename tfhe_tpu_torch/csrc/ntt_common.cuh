// Shared pieces of the blind-rotation kernels K1 (blind_rotate_bnf2.cu) and
// K3 (blind_rotate_crt.cu): the Shoup multiply, the balanced gadget
// decompositions (of the hi word, and of the whole u64 word), the plan's
// negacyclic NTT stages, and the whole n-step blind rotation as one kernel
// template on its recombination tail.
//
// One CMUX step, per ciphertext, on the accumulator acc[R][N] (u32 hi plane
// for K1, exact u64 for K3):
//   1. diff = acc * X^{a_i} - acc, balanced gadget decomposition from the
//      hi 32 bits of diff (_decompose_u32, tfhe_tpu/ops/pbs_kernel.py:708:
//      base_log * levels <= 31, so the state never needs the lo word; for
//      the u64 accumulator the borrow of the lo word is part of diff), or,
//      on the u64 accumulator at base_log * levels >= 32, from all 64 bits
//      of diff (Decomposer64, tfhe_tpu/ops/decomp.py:46, :74), each
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
// accumulator and the digit transforms in shared memory; nothing but the
// key and the twiddle tables is read from device memory inside the step
// loop. Each shared-memory pass runs up to three NTT stages in registers
// (StepPasses below): the lift fused into the first forward pass, the MAC
// fused between the last forward and the first inverse stages (its rows
// written over the digit rows, so there is no MAC buffer), the untwist and
// the tail fused into the last inverse pass; one __syncthreads a pass,
// eight a step at 2_2 and seven at the boolean set (the radix-2 reference
// loop: one stage a pass, 25 and 21). forward_stages / inverse_stages below are that earlier loop's
// stages, kept for the probes and the kernel bench's reference
// (blind_rotate_kernel<Tail, true>); the kernel bench's transforms run the
// step's stages (fwd_regs_with / inv_regs_with) on twiddles of their own.

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
    using State = int32_t;
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

    // the initial state of an accumulator word: its hi 32 bits (the u32
    // hi plane is its own hi word)
    template <class A>
    __device__ int32_t init_word(A x) const { return init(hi_word(x)); }

    // the next digit, in [-2^(base_log-1), 2^(base_log-1)]
    __device__ int32_t next(int32_t& state) const {
        const int32_t d = state & mod_b;
        state >>= base_log;  // arithmetic
        const int32_t carry = (((d - 1) | state) & d) >> (base_log - 1);
        state += carry;
        return d - (carry << base_log);
    }
};

// The same decomposition from the whole u64 word, for base_log * levels >=
// 32, where the rounding bit (63 - b l) and the low bits of the state lie in
// the lo word: tfhe_tpu/ops/decomp.py's init_decomposer_state and decompose
// formula for formula, the state in 64 bits (any b l < 64; b l + 1 <= 37
// bits at tfhe-rs's sets).
struct Decomposer64 {
    using State = int64_t;
    int base_log, rep;
    uint64_t rep_mask;
    int64_t mod_b;

    __device__ Decomposer64(int base_log_, int levels)
        : base_log(base_log_), rep(base_log_ * levels),
          rep_mask((1ull << (base_log_ * levels)) - 1ull),
          mod_b((1ll << base_log_) - 1) {}

    // the rounded, balanced initial state of the u64 word x
    __device__ int64_t init_word(uint64_t x) const {
        uint64_t res = x >> (63 - rep);
        const uint64_t rounding = res & 1ull;
        res = (res + 1ull) >> 1;
        res &= rep_mask;
        const uint64_t shifted_r = rounding << (rep - 1);
        const uint64_t need_bal =
            (((res - 1ull) | shifted_r) & res) >> (rep - 1);
        return (int64_t)(res - (need_bal << rep));
    }

    // the next digit, in [-2^(base_log-1), 2^(base_log-1)]
    __device__ int32_t next(int64_t& state) const {
        const int64_t d = state & mod_b;
        state >>= base_log;  // arithmetic
        const int64_t carry = (((d - 1) | state) & d) >> (base_log - 1);
        state += carry;
        return (int32_t)(d - (carry << base_log));
    }
};

// Whether the hi word's decomposer takes this decomposition; the 64-bit
// one takes base_log * levels up to 63.
inline bool hi_word_decomposition(int base_log, int levels) {
    return base_log >= 1 && levels >= 1 && base_log * levels <= 31;
}

// The decomposer the lifts of a tail's kernels run: the hi word's, unless
// the tail is one of a shape with base_log * levels >= 32
// (tails.cuh's GarnerTailDeep), which takes Decomposer64. The choice is a
// type, so the b l <= 31 instantiations keep their code.
template <class Tail>
struct DecomposerOf {
    using type = HiDecomposer;
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

// ---------------------------------------------------------------------------
// The step's pass schedule: several stages per shared-memory pass
// ---------------------------------------------------------------------------
//
// A pass over stages s0 .. s0+K-1 of a polynomial gives item g < N >> K the
// 2^K positions i0 + m hl, m < 2^K (hl = N >> (s0 + K), i0 = (g / hl) *
// (hl << K) + g % hl): they are closed under those K stages, so a thread
// loads them once, runs the K stages in registers and stores them once,
// with one block barrier per pass. Stage s0 + t pairs m with m + 2^(K-1-t)
// (m with that bit clear) at stride hl 2^(K-1-t); its twiddle index is the
// lower position mod that stride, j + (m mod 2^(K-1-t)) hl with j = g % hl.
// The forward passes keep forward_stages' output (DIF order, the key's),
// the inverse ones inverse_stages' (natural order), butterfly for
// butterfly: the same exact add_mod and Shoup products on canonical
// residues, only grouped otherwise.
//
// Per step (make_pass_plan): the lift of the digits fused into the first
// forward pass; forward passes of <= 3 stages, the one before the fused
// pass of strides 4F' .. F' (F' = 2^F); then the fused pass: the last F
// forward stages (strides 2^(F-1) .. 1, 2^F consecutive positions), the MAC
// against the GGSW row and the first F inverse stages, in registers; the
// inverse passes; the last inverse pass (<= 2 stages) with the untwist,
// the tail and acc +=. The fused pass writes MAC row c over digit row c
// (c < R <= l R) at the positions its thread just read, so shared memory
// holds the accumulator and the digits and no MAC buffer.
//
// Registers: two blocks of 512 threads a SM leave 64 a thread. Passes of
// four stages (16 values a thread) or a fused pass of three stages spill
// under that cap on sm_90a (nvcc 12.9); three stages and F <= 2 do not.
//
// The digit area is swizzled (swz): bits 2-4 of a word's index are XOR-ed
// with bits 5-7, which leaves each 4-word chunk whole and each aligned
// 32-word row a permutation of itself. The passes of stride >= 32 read 32
// consecutive words a warp (any permutation of a row is conflict-free);
// the pass before the fused one reads, at one m, 4 j by 8 blocks of 32
// words (F = 2), whose block bits the swizzle spreads over the banks; the
// fused pass reads 16 bytes a thread at consecutive groups, each
// quarter-warp on 8 distinct chunks.

constexpr int kMinBlocks = 2;  // blocks per SM the registers are sized for

// The blocks a SM a step kernel at P primes is sized for: two, which gives
// 64 registers a thread; one (128 registers) at five primes, a count no
// path of the package runs, whose step does not fit 64 without spilling.
constexpr int min_blocks(int P) { return P >= 5 ? 1 : kMinBlocks; }
constexpr int kMaxPasses = 5;  // passes on either side of the fused one
constexpr int kMaxK = 3;        // stages a pass

__host__ __device__ __forceinline__ int swz(int i) {
    return i ^ (((i >> 5) & 7) << 2);
}

// F, the stages of the fused pass: its 2^F positions hold 16 / 2^F rows c
// of MAC sums in registers, so R <= 4 (2_2, boolean) runs 2, R <= 8 one.
__host__ __device__ __forceinline__ int fused_stages(int R) {
    return R <= 4 ? 2 : 1;
}

struct PassPlan {
    int fused;                                     // F
    int n_fwd, fwd_s0[kMaxPasses], fwd_k[kMaxPasses];
    int n_inv, inv_s0[kMaxPasses], inv_k[kMaxPasses];
};

// Split stages [lo, hi) into ceil((hi - lo) / 3) passes of near-equal size,
// appended in increasing (forward) or decreasing (inverse) stage order;
// constexpr, so that a kernel templated on N can plan its passes at compile
// time (the kernel bench's transforms).
__host__ __device__ constexpr void split_stages(int lo, int hi, bool down,
                                                int* n, int* s0, int* k) {
    const int len = hi - lo;
    if (len <= 0) return;
    const int cnt = (len + kMaxK - 1) / kMaxK;
    int s = down ? hi : lo;
    for (int i = 0; i < cnt; ++i) {
        const int sz = len / cnt + (i < len % cnt ? 1 : 0);
        if (down) s -= sz;
        s0[*n] = s;
        k[*n] = sz;
        ++*n;
        if (!down) s += sz;
    }
}

// The passes of one step at N = 2^log_n and R rows; log_n > fused_stages(R)
// (so that the lift has a forward pass and the tail an inverse pass).
// Forward: stages [0, a) in passes of <= 3 (the first one lifts), then the
// mid pass [a, L - F) of min(3, L - F - 1) stages, then the fused pass.
// Inverse: the mid pass, then [t, a) in passes of <= 3 and last [0, t)
// with t = min(a, 2), which untwists and runs the tail.
__host__ __device__ inline PassPlan make_pass_plan(int log_n, int R) {
    PassPlan pl{};
    pl.fused = fused_stages(R);
    const int rest = log_n - pl.fused;
    const int mid = rest - 1 < kMaxK ? rest - 1 : kMaxK;
    const int a = rest - mid;
    split_stages(0, a, false, &pl.n_fwd, pl.fwd_s0, pl.fwd_k);
    split_stages(a, rest, false, &pl.n_fwd, pl.fwd_s0, pl.fwd_k);
    split_stages(a, rest, true, &pl.n_inv, pl.inv_s0, pl.inv_k);
    const int t = a < 2 ? a : 2;
    split_stages(t, a, true, &pl.n_inv, pl.inv_s0, pl.inv_k);
    split_stages(0, t, true, &pl.n_inv, pl.inv_s0, pl.inv_k);
    return pl;
}

// the first position (within its polynomial) and j of item g of a pass of
// K stages whose last stride is hl = 2^log_hl
template <int K>
__device__ __forceinline__ int item_origin(int g, int log_hl, int* j) {
    *j = g & ((1 << log_hl) - 1);
    return ((g >> log_hl) << (log_hl + K)) + *j;
}

// The twiddle sources of fwd_regs_with / inv_regs_with: Src, the type of
// the table they read; w(src, N, jj) and w_sh(src, N, jj), stage twiddle jj
// and its Shoup dual. The step's: rows Row (T_FWD or T_INV) and Row + 1 of
// the prime's [8][N] table, with __ldg.
template <int Row>
struct GlobalTwiddles {
    using Src = uint32_t;
    static __device__ __forceinline__ uint32_t w(const uint32_t* tb, int N,
                                                 int jj) {
        return __ldg(tb + Row * N + jj);
    }
    static __device__ __forceinline__ uint32_t w_sh(const uint32_t* tb,
                                                    int N, int jj) {
        return __ldg(tb + (Row + 1) * N + jj);
    }
};

// forward stages s0 .. s0+K-1 on the 2^K registers of one item, the
// twiddles from src through Tw
template <int K, class Tw>
__device__ __forceinline__ void fwd_regs_with(
        uint32_t* v, const typename Tw::Src* __restrict__ src, int N, int s0,
        int j, int log_hl, uint32_t p) {
    #pragma unroll
    for (int t = 0; t < K; ++t) {
        const int half = 1 << (K - 1 - t);
        const int off = N - (N >> (s0 + t)) + j;
        #pragma unroll
        for (int m = 0; m < (1 << K); ++m) {
            if (m & half) continue;
            const int jj = off + ((m & (half - 1)) << log_hl);
            const uint32_t u0 = v[m], u1 = v[m + half];
            v[m] = add_mod(u0, u1, p);
            v[m + half] = shoup_mul(u0 - u1 + p, Tw::w(src, N, jj),
                                    Tw::w_sh(src, N, jj), p);
        }
    }
}

// inverse stages s0+K-1 .. s0 on the 2^K registers of one item
template <int K, class Tw>
__device__ __forceinline__ void inv_regs_with(
        uint32_t* v, const typename Tw::Src* __restrict__ src, int N, int s0,
        int j, int log_hl, uint32_t p) {
    #pragma unroll
    for (int t = K - 1; t >= 0; --t) {
        const int half = 1 << (K - 1 - t);
        const int off = N - (N >> (s0 + t)) + j;
        #pragma unroll
        for (int m = 0; m < (1 << K); ++m) {
            if (m & half) continue;
            const int jj = off + ((m & (half - 1)) << log_hl);
            const uint32_t u = v[m];
            const uint32_t bw = shoup_mul(v[m + half], Tw::w(src, N, jj),
                                          Tw::w_sh(src, N, jj), p);
            v[m] = add_mod(u, bw, p);
            v[m + half] = add_mod(u, p - bw, p);
        }
    }
}

// the same stages on the step's twiddles
template <int K>
__device__ __forceinline__ void fwd_regs(uint32_t* v,
                                         const uint32_t* __restrict__ tb,
                                         int N, int s0, int j, int log_hl,
                                         uint32_t p) {
    fwd_regs_with<K, GlobalTwiddles<T_FWD>>(v, tb, N, s0, j, log_hl, p);
}

template <int K>
__device__ __forceinline__ void inv_regs(uint32_t* v,
                                         const uint32_t* __restrict__ tb,
                                         int N, int s0, int j, int log_hl,
                                         uint32_t p) {
    inv_regs_with<K, GlobalTwiddles<T_INV>>(v, tb, N, s0, j, log_hl, p);
}

// E consecutive words from flat index `base` (a multiple of E) of the
// swizzled area x, and back; 16-byte accesses where E >= 4
template <int E>
__device__ __forceinline__ void lds_run(const uint32_t* x, int base,
                                        uint32_t* v) {
    if constexpr (E >= 4) {
        #pragma unroll
        for (int q = 0; q < E; q += 4) {
            const uint4 w = *reinterpret_cast<const uint4*>(x + swz(base + q));
            v[q] = w.x; v[q + 1] = w.y; v[q + 2] = w.z; v[q + 3] = w.w;
        }
    } else if constexpr (E == 2) {
        const uint2 w = *reinterpret_cast<const uint2*>(x + swz(base));
        v[0] = w.x; v[1] = w.y;
    } else {
        v[0] = x[swz(base)];
    }
}

template <int E>
__device__ __forceinline__ void sts_run(uint32_t* x, int base,
                                        const uint32_t* v) {
    if constexpr (E >= 4) {
        #pragma unroll
        for (int q = 0; q < E; q += 4)
            *reinterpret_cast<uint4*>(x + swz(base + q)) =
                make_uint4(v[q], v[q + 1], v[q + 2], v[q + 3]);
    } else if constexpr (E == 2) {
        *reinterpret_cast<uint2*>(x + swz(base)) = make_uint2(v[0], v[1]);
    } else {
        x[swz(base)] = v[0];
    }
}

// E consecutive words of global memory at g (16-byte aligned for E >= 4)
template <int E>
__device__ __forceinline__ void ldg_run(const uint32_t* __restrict__ g,
                                        uint32_t* v) {
    if constexpr (E >= 4) {
        #pragma unroll
        for (int q = 0; q < E; q += 4) {
            const uint4 w = __ldg(reinterpret_cast<const uint4*>(g + q));
            v[q] = w.x; v[q + 1] = w.y; v[q + 2] = w.z; v[q + 3] = w.w;
        }
    } else if constexpr (E == 2) {
        const uint2 w = __ldg(reinterpret_cast<const uint2*>(g));
        v[0] = w.x; v[1] = w.y;
    } else {
        v[0] = __ldg(g);
    }
}

// The step's pieces on the shared-memory state: acc [R][N] (Acc, plain
// layout) and the digit area dig [l R][P][N] u32 (swizzled). Each ends in
// a block barrier.
template <class Tail>
struct StepPasses {
    using Acc = typename Tail::Acc;
    static constexpr int P = Tail::P;

    // 1. the first forward pass, K stages from 0 (hl = N >> K), fused with
    //    the lift: for digit row j = lev R + r and prime pi, the rotated
    //    difference acc[r] * X^a - acc[r], its balanced digit `lev`
    //    (the tail's decomposer: HiDecomposer, as the radix-2 loop computes
    //    it, or Decomposer64), lifted mod p (d < 0 ? d + p : d) and
    //    twisted, at each position of the item
    template <int K>
    __device__ static void lift_pass(const Acc* acc, uint32_t* dig, int a,
                                     int R, int levels, int base_log,
                                     int log_n,
                                     const uint32_t* __restrict__ tables,
                                     const uint32_t* s_p) {
        using Dec = typename DecomposerOf<Tail>::type;
        const Dec dec(base_log, levels);
        const int lR = levels * R;
        const int N = 1 << log_n;
        const int log_g = log_n - K;
        const int log_hl = log_n - K;
        #pragma unroll 1
        for (int u = threadIdx.x; u < (P * lR) << log_g; u += blockDim.x) {
            const int poly = u >> log_g;
            const int g = u & ((1 << log_g) - 1);
            const int pi = poly % P;
            const int row = poly / P;
            const int r = row % R, lev = row / R;
            const uint32_t p = s_p[pi];
            const uint32_t* tb = tables + (long long)pi * T_COUNT * N;
            int j;
            const int i0 = item_origin<K>(g, log_hl, &j);
            uint32_t v[1 << K];
            #pragma unroll
            for (int m = 0; m < (1 << K); ++m) {
                const int t = i0 + (m << log_hl);
                int s = t - a;
                if (s < 0) s += 2 * N;
                const bool neg = s >= N;
                if (neg) s -= N;
                Acc x = acc[r * N + s];
                if (neg) x = Acc(0) - x;
                typename Dec::State state =
                    dec.init_word(Acc(x - acc[r * N + t]));
                int32_t digit = dec.next(state);
                #pragma unroll 1
                for (int lv = 0; lv < lev; ++lv) digit = dec.next(state);
                const uint32_t mres = digit < 0
                    ? (uint32_t)(digit + (int32_t)p) : (uint32_t)digit;
                v[m] = shoup_mul(mres, __ldg(tb + T_TW * N + t),
                                 __ldg(tb + T_TW_SH * N + t), p);
            }
            fwd_regs<K>(v, tb, N, 0, j, log_hl, p);
            const int base = poly * N + i0;
            #pragma unroll
            for (int m = 0; m < (1 << K); ++m)
                dig[swz(base + (m << log_hl))] = v[m];
        }
        __syncthreads();
    }

    // forward (Inverse = false) or inverse stages s0 .. s0+K-1 of n_polys
    // polynomials [..][P][N] of the swizzled area
    template <int K, bool Inverse>
    __device__ static void pass(uint32_t* dig, int n_polys, int log_n,
                                int s0, const uint32_t* __restrict__ tables,
                                const uint32_t* s_p) {
        const int N = 1 << log_n;
        const int log_g = log_n - K;
        const int log_hl = log_n - s0 - K;
        #pragma unroll 1
        for (int u = threadIdx.x; u < n_polys << log_g; u += blockDim.x) {
            const int poly = u >> log_g;
            const int g = u & ((1 << log_g) - 1);
            const int pi = poly % P;
            const uint32_t p = s_p[pi];
            const uint32_t* tb = tables + (long long)pi * T_COUNT * N;
            int j;
            const int base = poly * N + item_origin<K>(g, log_hl, &j);
            uint32_t v[1 << K];
            #pragma unroll
            for (int m = 0; m < (1 << K); ++m)
                v[m] = dig[swz(base + (m << log_hl))];
            if (Inverse)
                inv_regs<K>(v, tb, N, s0, j, log_hl, p);
            else
                fwd_regs<K>(v, tb, N, s0, j, log_hl, p);
            #pragma unroll
            for (int m = 0; m < (1 << K); ++m)
                dig[swz(base + (m << log_hl))] = v[m];
        }
        __syncthreads();
    }

    // the fused pass: item (pi, g) holds positions g 2^F .. g 2^F + 2^F - 1
    // of prime pi; per digit row j: the last F forward stages, then
    // mac[c] += dig[j] key[j][c] (Shoup, add_mod, j in order) for c < R;
    // then the first F inverse stages of each mac[c], written over digit
    // row c. key: the step's u32 [2, P, l R, R, N].
    template <int F>
    __device__ static void fused_pass(uint32_t* dig,
                                      const uint32_t* __restrict__ key,
                                      int R, int lR, int log_n,
                                      const uint32_t* __restrict__ tables,
                                      const uint32_t* s_p) {
        constexpr int E = 1 << F;
        constexpr int CM = 16 / E;  // rows c an item can hold
        const int N = 1 << log_n;
        const int log_g = log_n - F;
        const int s0 = log_n - F;
        #pragma unroll 1
        for (int u = threadIdx.x; u < P << log_g; u += blockDim.x) {
            const int pi = u >> log_g;
            const int t0 = (u & ((1 << log_g) - 1)) << F;
            const uint32_t p = s_p[pi];
            const uint32_t* tb = tables + (long long)pi * T_COUNT * N;
            uint32_t mac[CM][E];
            #pragma unroll
            for (int c = 0; c < CM; ++c)
                #pragma unroll
                for (int m = 0; m < E; ++m) mac[c][m] = 0;
            #pragma unroll 1
            for (int j = 0; j < lR; ++j) {
                uint32_t d[E];
                lds_run<E>(dig, (j * P + pi) * N + t0, d);
                fwd_regs<F>(d, tb, N, s0, 0, 0, p);
                const uint32_t* kr =
                    key + ((long long)(pi * lR + j) * R) * N + t0;
                const uint32_t* ks =
                    key + ((long long)((P + pi) * lR + j) * R) * N + t0;
                #pragma unroll
                for (int c = 0; c < CM; ++c) {
                    if (c >= R) break;
                    // the key in runs of up to 4 words, each used at once
                    constexpr int Q = E < 4 ? E : 4;
                    #pragma unroll
                    for (int q = 0; q < E; q += Q) {
                        uint32_t w[Q], ws[Q];
                        ldg_run<Q>(kr + (long long)c * N + q, w);
                        ldg_run<Q>(ks + (long long)c * N + q, ws);
                        #pragma unroll
                        for (int m = 0; m < Q; ++m)
                            mac[c][q + m] = add_mod(
                                mac[c][q + m],
                                shoup_mul(d[q + m], w[m], ws[m], p), p);
                    }
                }
            }
            #pragma unroll
            for (int c = 0; c < CM; ++c) {
                if (c >= R) break;
                inv_regs<F>(mac[c], tb, N, s0, 0, 0, p);
                sts_run<E>(dig, (c * P + pi) * N + t0, mac[c]);
            }
        }
        __syncthreads();
    }

    // the last inverse pass, stages K-1 .. 0 (hl = N >> K), with the
    // untwist, the tail and acc +=: item (c, g) runs the K stages and the
    // untwist of row c at its positions for every prime, and adds the tail
    // of the P residues of each position to acc[c]. Up to four primes the
    // residues stay in registers for the tail; with five they are stored
    // back over the row and the tail reads them (the thread's own words: no
    // barrier), one position at a time, which keeps its registers within
    // the two-blocks-a-SM budget.
    template <int K>
    __device__ static void tail_pass(Acc* acc, uint32_t* dig, int R,
                                     int log_n,
                                     const uint32_t* __restrict__ tables,
                                     const uint32_t* s_p, const Tail& tail) {
        constexpr int E = 1 << K;
        constexpr bool kInRegisters = P <= 4;
        const int N = 1 << log_n;
        const int log_g = log_n - K;
        const int log_hl = log_n - K;
        #pragma unroll 1
        for (int u = threadIdx.x; u < R << log_g; u += blockDim.x) {
            const int c = u >> log_g;
            const int g = u & ((1 << log_g) - 1);
            uint32_t res[kInRegisters ? P : 1][E];
            #pragma unroll (kInRegisters ? P : 1)
            for (int pi = 0; pi < P; ++pi) {
                const uint32_t p = s_p[pi];
                const uint32_t* tb = tables + (long long)pi * T_COUNT * N;
                const int base = (c * P + pi) * N + g;
                uint32_t* v = res[kInRegisters ? pi : 0];
                #pragma unroll
                for (int m = 0; m < E; ++m)
                    v[m] = dig[swz(base + (m << log_hl))];
                inv_regs<K>(v, tb, N, 0, g, log_hl, p);
                #pragma unroll
                for (int m = 0; m < E; ++m) {
                    const int t = g + (m << log_hl);
                    v[m] = shoup_mul(v[m], __ldg(tb + T_UTW * N + t),
                                     __ldg(tb + T_UTW_SH * N + t), p);
                    if constexpr (!kInRegisters)
                        dig[swz(base + (m << log_hl))] = v[m];
                }
            }
            #pragma unroll (kInRegisters ? E : 1)
            for (int m = 0; m < E; ++m) {
                const int t = g + (m << log_hl);
                uint32_t mm[P];
                #pragma unroll
                for (int pi = 0; pi < P; ++pi) {
                    if constexpr (kInRegisters)
                        mm[pi] = res[pi][m];
                    else
                        mm[pi] = dig[swz((c * P + pi) * N + t)];
                }
                acc[c * N + t] += tail(mm);
            }
        }
        __syncthreads();
    }

    // run-time K (1..3) and F (1, 2) onto the templates
    __device__ static void lift_pass_k(int k, const Acc* acc, uint32_t* dig,
                                       int a, int R, int levels,
                                       int base_log, int log_n,
                                       const uint32_t* tables,
                                       const uint32_t* s_p) {
        if (k == 1)
            lift_pass<1>(acc, dig, a, R, levels, base_log, log_n, tables, s_p);
        else if (k == 2)
            lift_pass<2>(acc, dig, a, R, levels, base_log, log_n, tables, s_p);
        else
            lift_pass<3>(acc, dig, a, R, levels, base_log, log_n, tables, s_p);
    }

    template <bool Inverse>
    __device__ static void pass_k(int k, uint32_t* dig, int n_polys,
                                  int log_n, int s0, const uint32_t* tables,
                                  const uint32_t* s_p) {
        if (k == 1)
            pass<1, Inverse>(dig, n_polys, log_n, s0, tables, s_p);
        else if (k == 2)
            pass<2, Inverse>(dig, n_polys, log_n, s0, tables, s_p);
        else
            pass<3, Inverse>(dig, n_polys, log_n, s0, tables, s_p);
    }

    __device__ static void fused_pass_f(int f, uint32_t* dig,
                                        const uint32_t* key, int R, int lR,
                                        int log_n, const uint32_t* tables,
                                        const uint32_t* s_p) {
        if (f == 1)
            fused_pass<1>(dig, key, R, lR, log_n, tables, s_p);
        else
            fused_pass<2>(dig, key, R, lR, log_n, tables, s_p);
    }

    __device__ static void tail_pass_k(int k, Acc* acc, uint32_t* dig,
                                       int R, int log_n,
                                       const uint32_t* tables,
                                       const uint32_t* s_p,
                                       const Tail& tail) {
        if (k == 1)
            tail_pass<1>(acc, dig, R, log_n, tables, s_p, tail);
        else
            tail_pass<2>(acc, dig, R, log_n, tables, s_p, tail);
    }

    // One CMUX step on the shared-memory state, pass by pass (pl:
    // make_pass_plan(log_n, R); the pass loops unrolled, so the plan is
    // read at constant offsets).
    __device__ static void step(Acc* acc, uint32_t* dig, int a,
                                const uint32_t* __restrict__ key, int R,
                                int levels, int base_log, int log_n,
                                const PassPlan& pl,
                                const uint32_t* __restrict__ tables,
                                const uint32_t* s_p, const Tail& tail) {
        const int lR = levels * R;
        lift_pass_k(pl.fwd_k[0], acc, dig, a, R, levels, base_log, log_n,
                    tables, s_p);
        #pragma unroll
        for (int i = 1; i < kMaxPasses; ++i)
            if (i < pl.n_fwd)
                pass_k<false>(pl.fwd_k[i], dig, P * lR, log_n, pl.fwd_s0[i],
                              tables, s_p);
        fused_pass_f(pl.fused, dig, key, R, lR, log_n, tables, s_p);
        #pragma unroll
        for (int i = 0; i + 1 < kMaxPasses; ++i)
            if (i + 1 < pl.n_inv)
                pass_k<true>(pl.inv_k[i], dig, P * R, log_n, pl.inv_s0[i],
                             tables, s_p);
        #pragma unroll
        for (int i = 1; i <= kMaxPasses; ++i)
            if (i == pl.n_inv)
                tail_pass_k(pl.inv_k[i - 1], acc, dig, R, log_n, tables, s_p,
                            tail);
    }
};

// blockIdx.x, read where it is used: the block's offsets are recomputed
// there instead of held in registers across the step loop
__device__ __forceinline__ int block_index() {
    int b;
    asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(b));
    return b;
}

// All n CMUX steps of the blind rotation for one ciphertext per block.
// Tail provides: `Acc` (uint32_t or uint64_t), `P`, `p[P]` and
// `Acc operator()(const uint32_t* m)` on the P canonical residues.
// Radix2: the radix-2 step loop (one stage per pass, the MAC in its own
// pass and buffer), kept only as the kernel bench's reference.
//
// acc_in/acc_out: Acc [B, R, N]; a_ms: i32 [B, n] in [0, 2N);
// bsk: u32 [n, 2 (residue/shoup), P, levels*R, R, N]; tables: u32 [P, 8, N].
// Shared memory: acc [R][N] Acc, digits [levels*R][P][N] u32 (swizzled;
// Radix2: plain, and the MAC results [R][P][N] u32 after them).
template <class Tail, bool Radix2 = false>
__global__ void __launch_bounds__(kThreads, min_blocks(Tail::P))
blind_rotate_kernel(const typename Tail::Acc* __restrict__ acc_in,
                    const int32_t* __restrict__ a_ms,
                    const uint32_t* __restrict__ bsk,
                    const uint32_t* __restrict__ tables,
                    typename Tail::Acc* __restrict__ acc_out,
                    int n_steps, int R, int levels, int base_log, int log_n,
                    long long key_step, const __grid_constant__ PassPlan pl,
                    const __grid_constant__ Tail tail) {
    using Acc = typename Tail::Acc;
    constexpr int P = Tail::P;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int N = 1 << log_n;
    const int lR = levels * R;
    Acc* acc = reinterpret_cast<Acc*>(smem_raw);                 // [R][N]
    uint32_t* dig = reinterpret_cast<uint32_t*>(acc + R * N);    // [lR][P][N]
    // the primes, for the loops that index them at run time
    __shared__ uint32_t s_p[P];
    const int tid = threadIdx.x;
    const int nt = blockDim.x;

    if (tid == 0) {
        #pragma unroll
        for (int pi = 0; pi < P; ++pi) s_p[pi] = tail.p[pi];
    }
    const Acc* acc_src = acc_in + (long long)block_index() * R * N;
    for (int i = tid; i < R * N; i += nt) acc[i] = acc_src[i];

    const HiDecomposer dec(base_log, levels);
    __syncthreads();

    for (int step = 0; step < n_steps; ++step) {
        const int a = a_ms[(long long)block_index() * n_steps + step];
        const uint32_t* key = bsk + step * key_step;
        if constexpr (!Radix2) {
            StepPasses<Tail>::step(acc, dig, a, key, R, levels, base_log,
                                   log_n, pl, tables, s_p, tail);
            continue;
        }
        uint32_t* mac = dig + P * lR * N;                        // [R][P][N]

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

    Acc* acc_dst = acc_out + (long long)block_index() * R * N;
    for (int i = tid; i < R * N; i += nt) acc_dst[i] = acc[i];
}

// Bytes of dynamic shared memory blind_rotate_kernel<Tail, Radix2> needs:
// the accumulator and the digits (Radix2: and the MAC results).
template <class Tail, bool Radix2 = false>
size_t blind_rotate_smem(int R, int levels, int log_n) {
    const size_t N = size_t(1) << log_n;
    return R * N * sizeof(typename Tail::Acc)
           + (size_t)Tail::P * (levels * R + (Radix2 ? R : 0)) * N
                 * sizeof(uint32_t);
}

// Whether make_pass_plan covers this shape: log_n > F, and the digit area
// indexed in int.
inline bool pass_plan_fits(int R, int levels, int log_n) {
    return log_n > fused_stages(R) && R >= 1 && R <= 8 && levels >= 1
           && log_n <= 16;
}

// Launch blind_rotate_kernel<Tail, Radix2> on `stream`, one block per
// ciphertext. Returns cudaGetLastError() after the launch (0 = launched),
// or cudaErrorInvalidValue for a shape the pass plan does not cover.
template <class Tail, bool Radix2 = false>
int launch_blind_rotate(const void* acc_in, const void* a_ms, const void* bsk,
                        const void* tables, void* acc_out, int B,
                        int n_steps, int R, int levels, int base_log,
                        int log_n, const Tail& tail, void* stream) {
    using Acc = typename Tail::Acc;
    if (!pass_plan_fits(R, levels, log_n)) return (int)cudaErrorInvalidValue;
    const size_t smem = blind_rotate_smem<Tail, Radix2>(R, levels, log_n);
    cudaError_t err = cudaFuncSetAttribute(
        blind_rotate_kernel<Tail, Radix2>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    blind_rotate_kernel<Tail, Radix2>
        <<<B, kThreads, smem, (cudaStream_t)stream>>>(
            (const Acc*)acc_in, (const int32_t*)a_ms, (const uint32_t*)bsk,
            (const uint32_t*)tables, (Acc*)acc_out, n_steps, R, levels,
            base_log, log_n, 2LL * Tail::P * levels * R * R << log_n,
            make_pass_plan(log_n, R), tail);
    return (int)cudaGetLastError();
}

// Resident blocks per SM of blind_rotate_kernel<Tail, Radix2> at this
// shape (cudaOccupancyMaxActiveBlocksPerMultiprocessor), with its
// registers per thread and local (spill) bytes per thread; negative: a
// CUDA error.
template <class Tail, bool Radix2 = false>
int blind_rotate_occupancy(int R, int levels, int log_n, int* regs,
                           int* local_bytes) {
    auto kernel = blind_rotate_kernel<Tail, Radix2>;
    const size_t smem = blind_rotate_smem<Tail, Radix2>(R, levels, log_n);
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return -(int)err;
    *regs = attr.numRegs;
    *local_bytes = (int)attr.localSizeBytes;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return -(int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                         kThreads, smem);
    return err == cudaSuccess ? blocks : -(int)err;
}

}  // namespace brk
