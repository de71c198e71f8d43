// K5: the whole multi-bit blind rotation on the exact u64 accumulator, for
// Hopper: all n/g group steps of one ciphertext in one block.
//
// Replaces: tfhe_tpu/ops/server.py::multi_bit_blind_rotate (:809-884), which
// tfhe_tpu runs in XLA (a lax.scan over the groups, no pallas_call). Spec:
// its torch mirror tfhe_tpu_torch/ops/server.py::multi_bit_group_steps (the
// plain version). For each group t of g mask values a_{tg+j}:
//
//   acc <- Garner(INTT(sum_r NTT(decompose(acc))_r (.) combined_r)),
//   combined = G1 + sum_{v=1}^{2^g-1} coef_v (.) GGSW_{t,v},
//   coef_v   = prod_{j in v} NTT(X^{a_{tg+j}} - 1)
//
// with G1 the trivial GGSW of 1. The new accumulator replaces the old one;
// the decomposition is of acc itself, not of a rotated difference.
//
// Everything between the decomposition and the Garner tail is exact mod
// each prime, so the kernel computes the same residues by another exact
// route and its output equals the spec's bit for bit:
//   - coef_v in closed form: NTT(X^a - 1) at point t is zeta_t^a - 1 with
//     zeta_t = psi^{e_t} (e_t odd: ops/pbs_kernel.py::multi_bit_exponents,
//     checked against the plan's transform), psi^k read from the twist row
//     of the step tables (psi^{k+N} = -psi^k); the 2^g - 1 products built
//     in registers, each from the one before it with one factor more;
//   - the combination folded into the MAC, so no combined GGSW exists:
//     mac_c = sum_lev dig_{lev,c} G1_lev
//             + sum_v coef_v (sum_j dig_j GGSW_{t,v,j,c}),
//     the inner sums Shoup products against the key's stored duals, the
//     products by coef_v (per ciphertext, no dual) Barrett reductions
//     with floor(2^64 / p); G1's only non-zero entries are the diagonal
//     gadget constants, equal at every point (checked on the host).
//
// Structure: ntt_common.cuh's pieces around a MAC pass of its own. One
// block of 512 threads per ciphertext keeps acc [R][N] u64 and the digit
// transforms [l R][P][N] u32 (swizzled) in shared memory across all n/g
// steps. Per step: the lift pass (the digits of acc, lifted, twisted, the
// first forward stages in registers), acc zeroed (it is replaced), the
// other forward passes (StepPasses::pass, up to three stages each), the
// MAC pass (one item per prime and point, its R rows written over digit
// rows 0..R-1 once every digit at that point is read, so no MAC buffer),
// the inverse passes, and StepPasses::tail_pass (the last two inverse
// stages, the untwist and GarnerTail<P>, bit-identical to reconstruct_u64,
// added to the zeroed acc). Shared memory is K3's: 96 KiB at the group-4
// set (N = 2048, l = 1), 192 KiB at the group-2 set (N = 4096), 160 KiB at
// the group-3 set (l = 2).
//
// Bound: int32 operations at wide batches; the key's bytes at batch 1. A
// step reads 2 P (2^g - 1) l R R N u32 of key (1.97 MB of residues and as
// many duals at the group-4 set; 0.9 GB a ciphertext over 230 steps), from
// L2 when many blocks share it, from HBM through one SM at batch 1.

#include "ntt_common.cuh"
#include "tails.cuh"

using brk::GarnerTail;

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxR = 5;       // GLWE dimension up to 4
constexpr int kMaxPasses = 5;  // passes on either side of the MAC pass

// The constants of the MAC: G1's gadget entries per prime and level with
// their Shoup duals, and each prime's Barrett constant floor(2^64 / p).
struct MultiBitConsts {
    uint32_t g1[brk::kMaxPrimes][kMaxLevels];
    uint32_t g1_sh[brk::kMaxPrimes][kMaxLevels];
    uint64_t mu[brk::kMaxPrimes];
};

// Forward passes [0, log_n) in passes of <= 3 stages (the first lifts);
// inverse passes [2, log_n) in passes of <= 3, then the tail pass [0, 2).
struct MbPlan {
    int n_fwd, fwd_s0[kMaxPasses], fwd_k[kMaxPasses];
    int n_inv, inv_s0[kMaxPasses], inv_k[kMaxPasses];
};

MbPlan make_mb_plan(int log_n) {
    MbPlan pl{};
    brk::split_stages(0, log_n, false, &pl.n_fwd, pl.fwd_s0, pl.fwd_k);
    const int t = log_n < 2 ? log_n : 2;
    brk::split_stages(t, log_n, true, &pl.n_inv, pl.inv_s0, pl.inv_k);
    brk::split_stages(0, t, true, &pl.n_inv, pl.inv_s0, pl.inv_k);
    return pl;
}

bool mb_plan_fits(int R, int levels, int log_n) {
    return log_n >= 3 && log_n <= 13 && R >= 1 && R <= kMaxR && levels >= 1
           && levels <= kMaxLevels;
}

// a * b mod p for a, b < p < 2^31: q = floor(a b mu / 2^64) is floor(ab/p)
// or one less, so one correction
__device__ __forceinline__ uint32_t mul_mod(uint32_t a, uint32_t b,
                                            uint32_t p, uint64_t mu) {
    const uint64_t x = (uint64_t)a * b;
    const uint64_t q = __umul64hi(x, mu);
    const uint32_t r = (uint32_t)(x - q * p);
    return r >= p ? r - p : r;
}

// The first forward pass, K stages from 0 (hl = N >> K), fused with the
// lift: for digit row j = lev R + r and prime pi, digit `lev` of acc[r]
// (HiDecomposer), lifted mod p and twisted, at each position of the item.
// StepPasses::lift_pass with acc in place of the rotated difference.
template <int P, int K>
__device__ void mb_lift_pass(const uint64_t* acc, uint32_t* dig, int R,
                             int levels, int base_log, int log_n,
                             const uint32_t* __restrict__ tables,
                             const uint32_t* s_p) {
    const brk::HiDecomposer dec(base_log, levels);
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
        const uint32_t* tb = tables + (long long)pi * brk::T_COUNT * N;
        int j;
        const int i0 = brk::item_origin<K>(g, log_hl, &j);
        uint32_t v[1 << K];
        #pragma unroll
        for (int m = 0; m < (1 << K); ++m) {
            const int t = i0 + (m << log_hl);
            int32_t state = dec.init(brk::hi_word(acc[r * N + t]));
            int32_t digit = dec.next(state);
            #pragma unroll 1
            for (int lv = 0; lv < lev; ++lv) digit = dec.next(state);
            const uint32_t mres = digit < 0
                ? (uint32_t)(digit + (int32_t)p) : (uint32_t)digit;
            v[m] = brk::shoup_mul(mres, __ldg(tb + brk::T_TW * N + t),
                                  __ldg(tb + brk::T_TW_SH * N + t), p);
        }
        brk::fwd_regs<K>(v, tb, N, 0, j, log_hl, p);
        const int base = poly * N + i0;
        #pragma unroll
        for (int m = 0; m < (1 << K); ++m)
            dig[brk::swz(base + (m << log_hl))] = v[m];
    }
    __syncthreads();
}

template <int P>
__device__ void mb_lift_pass_k(int k, const uint64_t* acc, uint32_t* dig,
                               int R, int levels, int base_log, int log_n,
                               const uint32_t* tables, const uint32_t* s_p) {
    if (k == 1)
        mb_lift_pass<P, 1>(acc, dig, R, levels, base_log, log_n, tables, s_p);
    else if (k == 2)
        mb_lift_pass<P, 2>(acc, dig, R, levels, base_log, log_n, tables, s_p);
    else
        mb_lift_pass<P, 3>(acc, dig, R, levels, base_log, log_n, tables, s_p);
}

// The MAC pass on the forward-transformed digits: item (pi, t), one point
// of one prime. coef_v from the group's mask values a[0..G), then for each
// output row c < R the sum of G1's terms and of coef_v times the row's
// Shoup MAC against subset v of the step key; the R results are written
// over digit rows 0..R-1 at point t after every digit at t is read.
// key: the step's u32 [2, P, 2^G - 1, l R, R, N]; exps: e_t, i32 [N].
template <int P, int G>
__device__ void mb_mac_pass(uint32_t* dig, const uint32_t* __restrict__ key,
                            const int* s_a, int R, int levels, int log_n,
                            const uint32_t* __restrict__ tables,
                            const int32_t* __restrict__ exps,
                            const uint32_t* s_p,
                            const uint32_t (*s_g1)[kMaxLevels],
                            const uint32_t (*s_g1_sh)[kMaxLevels],
                            const uint64_t* s_mu) {
    constexpr int NSUB = (1 << G) - 1;
    const int N = 1 << log_n;
    const int lR = levels * R;
    const long long row = (long long)R * N;        // key rows j apart
    const long long sub = (long long)lR * row;     // subsets v apart
    const long long dual = (long long)P * NSUB * sub;
    uint32_t a[G];
    #pragma unroll
    for (int j = 0; j < G; ++j) a[j] = (uint32_t)s_a[j];
    #pragma unroll 1
    for (int u = threadIdx.x; u < P << log_n; u += blockDim.x) {
        const int pi = u >> log_n;
        const int t = u & (N - 1);
        const uint32_t p = s_p[pi];
        const uint64_t mu = s_mu[pi];
        const uint32_t* tw = tables + (long long)pi * brk::T_COUNT * N
                             + brk::T_TW * N;
        // coef[v] = prod_{j in v} (zeta_t^{a_j} - 1); 2N divides 2^32, so
        // the exponent wraps correctly in u32
        const uint32_t e = (uint32_t)__ldg(exps + t);
        uint32_t coef[NSUB + 1];
        #pragma unroll
        for (int j = 0; j < G; ++j) {
            const uint32_t k = (e * a[j]) & (2u * N - 1u);
            const uint32_t w = __ldg(tw + (k & (N - 1)));  // psi^(k mod N)
            coef[1 << j] = (k >= (uint32_t)N ? p - w : w) - 1u;
        }
        #pragma unroll
        for (int v = 3; v <= NSUB; ++v)
            if (v & (v - 1))
                coef[v] = mul_mod(coef[v & (v - 1)], coef[v & -v], p, mu);
        const uint32_t* kp = key + (long long)pi * NSUB * sub + t;
        uint32_t mac[kMaxR];
        #pragma unroll
        for (int c = 0; c < kMaxR; ++c) {
            if (c >= R) break;
            uint32_t m = 0;
            #pragma unroll 1
            for (int lev = 0; lev < levels; ++lev)
                m = brk::add_mod(
                    m, brk::shoup_mul(
                           dig[brk::swz(((lev * R + c) * P + pi) * N + t)],
                           s_g1[pi][lev], s_g1_sh[pi][lev], p), p);
            #pragma unroll
            for (int v = 1; v <= NSUB; ++v) {
                const uint32_t* kv = kp + (v - 1) * sub + (long long)c * N;
                uint32_t s = 0;
                #pragma unroll 1
                for (int j = 0; j < lR; ++j)
                    s = brk::add_mod(
                        s, brk::shoup_mul(dig[brk::swz((j * P + pi) * N + t)],
                                          __ldg(kv + j * row),
                                          __ldg(kv + dual + j * row), p),
                        p);
                m = brk::add_mod(m, mul_mod(coef[v], s, p, mu), p);
            }
            mac[c] = m;
        }
        #pragma unroll
        for (int c = 0; c < kMaxR; ++c) {
            if (c >= R) break;
            dig[brk::swz((c * P + pi) * N + t)] = mac[c];
        }
    }
    __syncthreads();
}

// All n/g group steps of the multi-bit blind rotation for one ciphertext
// per block. acc_in/acc_out: u64 [B, R, N]; a_ms: i32 [B, n] in [0, 2N);
// bsk: u32 [n/g, 2, P, 2^G - 1, levels*R, R, N]; tables: u32 [P, 8, N]
// (ops/pbs_kernel.py::plan_tables); exps: i32 [N].
template <int P, int G>
__global__ void __launch_bounds__(brk::kThreads, brk::min_blocks(P))
blind_rotate_multi_bit_kernel(const uint64_t* __restrict__ acc_in,
                              const int32_t* __restrict__ a_ms,
                              const uint32_t* __restrict__ bsk,
                              const uint32_t* __restrict__ tables,
                              const int32_t* __restrict__ exps,
                              uint64_t* __restrict__ acc_out, int n_groups,
                              int R, int levels, int base_log, int log_n,
                              long long key_step,
                              const __grid_constant__ MbPlan pl,
                              const __grid_constant__ GarnerTail<P> tail,
                              const __grid_constant__ MultiBitConsts mb) {
    using Passes = brk::StepPasses<GarnerTail<P>>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int N = 1 << log_n;
    const int lR = levels * R;
    uint64_t* acc = reinterpret_cast<uint64_t*>(smem_raw);      // [R][N]
    uint32_t* dig = reinterpret_cast<uint32_t*>(acc + R * N);   // [lR][P][N]
    __shared__ uint32_t s_p[P];
    __shared__ uint32_t s_g1[P][kMaxLevels], s_g1_sh[P][kMaxLevels];
    __shared__ uint64_t s_mu[P];
    __shared__ int s_a[G];
    const int tid = threadIdx.x;
    const int nt = blockDim.x;

    if (tid == 0) {
        #pragma unroll
        for (int pi = 0; pi < P; ++pi) {
            s_p[pi] = tail.p[pi];
            s_mu[pi] = mb.mu[pi];
            #pragma unroll
            for (int lev = 0; lev < kMaxLevels; ++lev) {
                s_g1[pi][lev] = mb.g1[pi][lev];
                s_g1_sh[pi][lev] = mb.g1_sh[pi][lev];
            }
        }
    }
    const uint64_t* src = acc_in + (long long)brk::block_index() * R * N;
    for (int i = tid; i < R * N; i += nt) acc[i] = src[i];
    __syncthreads();

    const long long n_ms = (long long)n_groups * G;
    for (int step = 0; step < n_groups; ++step) {
        // read by the MAC pass, after the lift pass's barrier; the last
        // reader of the previous step's values ended before the tail
        // pass's barrier
        for (int j = tid; j < G; j += nt)
            s_a[j] = a_ms[(long long)brk::block_index() * n_ms
                          + (long long)step * G + j];
        const uint32_t* key = bsk + step * key_step;
        mb_lift_pass_k<P>(pl.fwd_k[0], acc, dig, R, levels, base_log, log_n,
                          tables, s_p);
        // the digits hold all of acc now; the tail adds the new value
        for (int i = tid; i < R * N; i += nt) acc[i] = 0;
        #pragma unroll
        for (int i = 1; i < kMaxPasses; ++i)
            if (i < pl.n_fwd)
                Passes::template pass_k<false>(pl.fwd_k[i], dig, P * lR,
                                               log_n, pl.fwd_s0[i], tables,
                                               s_p);
        mb_mac_pass<P, G>(dig, key, s_a, R, levels, log_n, tables, exps, s_p,
                          s_g1, s_g1_sh, s_mu);
        #pragma unroll
        for (int i = 0; i + 1 < kMaxPasses; ++i)
            if (i + 1 < pl.n_inv)
                Passes::template pass_k<true>(pl.inv_k[i], dig, P * R, log_n,
                                              pl.inv_s0[i], tables, s_p);
        #pragma unroll
        for (int i = 1; i <= kMaxPasses; ++i)
            if (i == pl.n_inv)
                Passes::tail_pass_k(pl.inv_k[i - 1], acc, dig, R, log_n,
                                    tables, s_p, tail);
    }

    uint64_t* dst = acc_out + (long long)brk::block_index() * R * N;
    for (int i = tid; i < R * N; i += nt) dst[i] = acc[i];
}

// The kernel is instantiated at kPrimes primes, the count of every
// multi-bit set of the reference's universe (ServerKey's num_primes_for:
// the external product's bound plus g log2 3 bits), and groupings 2..4;
// one instantiation of each shape keeps the build short.
constexpr int kPrimes = 4;

// f(kernel, tail) for the template <kPrimes, G> of a run-time grouping, or
// `otherwise` for another prime count or grouping.
template <class Ret, class F>
Ret for_shape(int num_primes, int grouping, Ret otherwise, F f) {
    if (num_primes != kPrimes) return otherwise;
    const GarnerTail<kPrimes> tail{};
    switch (grouping) {
        case 2: return f(blind_rotate_multi_bit_kernel<kPrimes, 2>, tail);
        case 3: return f(blind_rotate_multi_bit_kernel<kPrimes, 3>, tail);
        case 4: return f(blind_rotate_multi_bit_kernel<kPrimes, 4>, tail);
        default: return otherwise;
    }
}

size_t mb_smem(int num_primes, int R, int levels, int log_n) {
    const size_t N = size_t(1) << log_n;
    return R * N * sizeof(uint64_t)
           + (size_t)num_primes * levels * R * N * sizeof(uint32_t);
}

}  // namespace

// acc_in/acc_out: u64 [B, R, N]; a_ms: i32 [B, n_groups * grouping];
// bsk: u32 [n_groups, 2, P, 2^grouping - 1, levels*R, R, N] over the first
// P = kPrimes PRIMES32; tables: u32 [P, 8, N]; exps: i32 [N]; garner: host
// u32[65] (ops/pbs_kernel.py::garner_constants); g1, g1_sh: host u32[5][8]
// (G1's gadget entry of prime pi and level lev, and its dual); mu: host
// u64[5].
// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int blind_rotate_multi_bit(
        const void* acc_in, const void* a_ms, const void* bsk,
        const void* tables, const void* exps, void* acc_out, int B,
        int n_groups, int grouping, int R, int levels, int base_log,
        int log_n, int num_primes, const unsigned* garner,
        unsigned long long full_prod, const unsigned* g1,
        const unsigned* g1_sh, const unsigned long long* mu, void* stream) {
    if (!mb_plan_fits(R, levels, log_n)) return (int)cudaErrorInvalidValue;
    MultiBitConsts mb{};
    for (int pi = 0; pi < brk::kMaxPrimes; ++pi) {
        mb.mu[pi] = mu[pi];
        for (int lev = 0; lev < kMaxLevels; ++lev) {
            mb.g1[pi][lev] = g1[pi * kMaxLevels + lev];
            mb.g1_sh[pi][lev] = g1_sh[pi * kMaxLevels + lev];
        }
    }
    const size_t smem = mb_smem(num_primes, R, levels, log_n);
    const MbPlan pl = make_mb_plan(log_n);
    const long long key_step = 2LL * num_primes * ((1 << grouping) - 1)
                               * levels * R * R << log_n;
    return for_shape<int>(num_primes, grouping, (int)cudaErrorInvalidValue,
                          [&](auto kernel, auto tail) {
        brk::fill_garner(tail, garner, full_prod);
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        kernel<<<B, brk::kThreads, smem, (cudaStream_t)stream>>>(
            (const uint64_t*)acc_in, (const int32_t*)a_ms,
            (const uint32_t*)bsk, (const uint32_t*)tables,
            (const int32_t*)exps, (uint64_t*)acc_out, n_groups, R, levels,
            base_log, log_n, key_step, pl, tail, mb);
        return (int)cudaGetLastError();
    });
}

// Bytes of dynamic shared memory one block needs (acc and digits, as K3);
// 0 for a prime count the kernel does not take.
extern "C" unsigned long long blind_rotate_multi_bit_smem(
        int num_primes, int R, int levels, int log_n) {
    if (num_primes != kPrimes) return 0;
    return mb_smem(num_primes, R, levels, log_n);
}

// Resident blocks per SM of the kernel at this prime count, grouping and
// shape, with its registers and local (spill) bytes per thread; negative:
// a CUDA error, 0 for a prime count or grouping the kernel does not take.
extern "C" int blind_rotate_multi_bit_occupancy(int num_primes, int R,
                                                int levels, int log_n,
                                                int grouping, int* regs,
                                                int* local_bytes) {
    const size_t smem = mb_smem(num_primes, R, levels, log_n);
    return for_shape<int>(num_primes, grouping, 0,
                          [&](auto kernel, auto) {
        cudaFuncAttributes attr;
        cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
        if (err != cudaSuccess) return -(int)err;
        *regs = attr.numRegs;
        *local_bytes = (int)attr.localSizeBytes;
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return -(int)err;
        int blocks = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, kernel, brk::kThreads, smem);
        return err == cudaSuccess ? blocks : -(int)err;
    });
}
