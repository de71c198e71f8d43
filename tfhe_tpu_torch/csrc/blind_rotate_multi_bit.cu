// K5: the multi-bit blind rotation on the exact u64 accumulator, for
// Hopper, as two kernels a chunk of group steps -- K5a
// multi_bit_keybundle_kernel builds the steps' key bundles across the whole
// card, K5b multi_bit_accumulate_kernel runs the dependent external
// products against them, one block a ciphertext -- and the single
// kernel (blind_rotate_multi_bit_kernel, entry blind_rotate_multi_bit_r14),
// kept as the reference the pair is timed against in turns.
//
// Replaces: tfhe_tpu/ops/server.py::multi_bit_blind_rotate (:809-884), which
// tfhe_tpu runs in XLA (a lax.scan over the groups, no pallas_call). Spec:
// its torch mirror tfhe_tpu_torch/ops/server.py::multi_bit_group_steps (the
// plain version), split at the same point as here: multi_bit_keybundle_plain
// (K5a) and multi_bit_accumulate_plain (K5b). For each group t of g mask
// values a_{tg+j}:
//
//   acc <- Garner(INTT(sum_r NTT(decompose(acc))_r (.) combined_r)),
//   combined = G1 + sum_{v=1}^{2^g-1} coef_v (.) GGSW_{t,v},
//   coef_v   = prod_{j in v} NTT(X^{a_{tg+j}} - 1)
//
// with G1 the trivial GGSW of 1. The new accumulator replaces the old one;
// the decomposition is of acc itself, not of a rotated difference.
//
// Everything between the decomposition and the Garner tail is exact mod
// each prime, so the kernels compute the same residues by another exact
// route and their output equals the spec's bit for bit:
//   - coef_v in closed form: NTT(X^a - 1) at point t is zeta_t^a - 1 with
//     zeta_t = psi^{e_t} (e_t odd: ops/pbs_kernel.py::multi_bit_exponents,
//     checked against the plan's transform), psi^k read from the twist row
//     of the step tables (psi^{k+N} = -psi^k); the 2^g - 1 products built
//     in registers, each from the one before it with one factor more
//     (Barrett with floor(2^64 / p));
//   - K5a: combined (the "key bundle", P l R R N u32 a ciphertext-step) =
//     G1 + sum_v coef_v (.) GGSW_{t,v}, Shoup products against the key's
//     stored duals; G1's only non-zero entries are the diagonal gadget
//     constants, equal at every point (checked on the host);
//   - K5b: sum_j dig_j (.) combined_j, Barrett products (neither operand
//     has a dual);
//   - r14: the combination folded into the MAC, so no combined GGSW exists:
//     mac_c = sum_lev dig_{lev,c} G1_lev
//             + sum_v coef_v (sum_j dig_j GGSW_{t,v,j,c}).
//
// K5a (grid: step x prime x tile of 128 points x block of bundle rows, times
// slices of the batch; 128 threads, one point each). The combined GGSW of
// step t depends on the key and the step's g mask values only, not on the
// accumulator, so every step of a chunk is built at once, on every SM. A
// block stages its key tile (all 2^g - 1 subsets and its l R R rows at its
// 128 points, residue and dual side by side) in shared memory once, with
// 16-byte loads, then sweeps its slice of ciphertexts over it: the key
// crosses L2 once a slice, not once a ciphertext. Bound: at batch 1 the
// key's bytes (read once, spread over all SMs: 0.9 GB with duals at the
// group-4 set); at wide batches its Shoup products, P (2^g - 1) l R R N a
// ciphertext-step.
//
// K5b (one block of 512 threads a ciphertext): acc [R][N] u64 and the digit
// transforms [l R][P][N] u32 (swizzled) in shared memory across the chunk's
// steps, K3's passes (ntt_common.cuh, make_pass_plan) with r14's lift of
// acc itself: the lift pass, acc zeroed (it is replaced), the forward
// passes, the fused pass (the last F forward stages, the MAC against the
// step's bundle, the first F inverse stages), the inverse passes and the
// tail pass (the untwist and GarnerTail<P>, bit-identical to
// reconstruct_u64, added to the zeroed acc). Each step reads its 131 KB
// bundle (group-4 set) as a K3 step reads its key. Shared memory is K3's:
// 96 KiB at the group-4 set (N = 2048, l = 1), 192 KiB at the group-2 set
// (N = 4096), 160 KiB at the group-3 set (l = 2). Bound: its transforms'
// integer operations at wide batches; at batch 1 the dependent chain of
// n/g steps on one SM (the latency of a step, not a rate of the card).
//
// Chunks (ops/pbs_kernel.py::multi_bit_chunk): the bundles of C steps of
// the whole batch fit a fixed scratch budget; one K5a and one K5b launch a
// chunk, acc through global memory between chunks. At batch 1 one chunk
// (30 MB of bundles, inside L2).
//
// r14, the single-kernel design the pair replaced: one block of 512
// threads a ciphertext does all n/g steps, streaming each step's 3.9 MB of
// key (with duals) through its MAC pass.

#include "ntt_common.cuh"
#include "tails.cuh"

using brk::GarnerTail;
using brk::GarnerTailDeep;

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

// r14's and K5b's shapes: r14's MbPlan holds 5 inverse passes (log_n <= 14)
// and K5b's block holds acc and digits only up to N = 8192 (its callers
// check the shared memory).
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
// (Dec: HiDecomposer, or Decomposer64 at base_log * levels >= 32), lifted
// mod p and twisted, at each position of the item. StepPasses::lift_pass
// with acc in place of the rotated difference.
template <int P, int K, class Dec = brk::HiDecomposer>
__device__ void mb_lift_pass(const uint64_t* acc, uint32_t* dig, int R,
                             int levels, int base_log, int log_n,
                             const uint32_t* __restrict__ tables,
                             const uint32_t* s_p) {
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
        const uint32_t* tb = tables + (long long)pi * brk::T_COUNT * N;
        int j;
        const int i0 = brk::item_origin<K>(g, log_hl, &j);
        uint32_t v[1 << K];
        #pragma unroll
        for (int m = 0; m < (1 << K); ++m) {
            const int t = i0 + (m << log_hl);
            typename Dec::State state = dec.init_word(acc[r * N + t]);
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

template <int P, class Dec = brk::HiDecomposer>
__device__ void mb_lift_pass_k(int k, const uint64_t* acc, uint32_t* dig,
                               int R, int levels, int base_log, int log_n,
                               const uint32_t* tables, const uint32_t* s_p) {
    if (k == 1)
        mb_lift_pass<P, 1, Dec>(acc, dig, R, levels, base_log, log_n, tables,
                                s_p);
    else if (k == 2)
        mb_lift_pass<P, 2, Dec>(acc, dig, R, levels, base_log, log_n, tables,
                                s_p);
    else
        mb_lift_pass<P, 3, Dec>(acc, dig, R, levels, base_log, log_n, tables,
                                s_p);
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

// r14: all n/g group steps of the multi-bit blind rotation for one
// ciphertext per block. acc_in/acc_out: u64 [B, R, N]; a_ms: i32 [B, n] in
// [0, 2N); bsk: u32 [n/g, 2, P, 2^G - 1, levels*R, R, N]; tables: u32 [P, 8, N]
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

// ---------------------------------------------------------------------------
// K5a: the key bundles of a chunk of group steps
// ---------------------------------------------------------------------------

constexpr int kKbThreads = 128;          // K5a: points of a tile, one a thread
constexpr int kKbSmem = 64 * 1024;       // K5a: bytes of a staged key tile
constexpr int kKbBlocksPerSm = 8;        // K5a: blocks a SM the slices aim at
constexpr int kKbMasks = 256;            // K5a: masks staged at once

// K5a's position of twist-row entry k in shared memory: one padding word
// every N/16 entries. A warp's 32 consecutive points read psi^(e_t a mod
// N) with e_t = 2 bitrev(t) + 1, which differ by multiples of N/16; the
// padding puts those 16 words in 16 banks (N >= 512).
__device__ __forceinline__ int tw_slot(int k, int log_n) {
    const int log_s = log_n > 4 ? log_n - 4 : 0;
    return k + (k >> log_s);
}

// the index of the lowest set bit of v > 0
__host__ __device__ constexpr int low_bit(int v) {
    return v & 1 ? 0 : 1 + low_bit(v >> 1);
}

// x mod p for any u64 x: Barrett with mu = floor(2^64 / p), whose
// quotient is floor(x / p) or one less, so one correction
__device__ __forceinline__ uint32_t reduce_u64(uint64_t x, uint32_t p,
                                               uint64_t mu) {
    const uint32_t r = (uint32_t)(x - __umul64hi(x, mu) * p);
    return r >= p ? r - p : r;
}

// the Shoup dual floor(w 2^32 / p) of w < p
__device__ __forceinline__ uint32_t shoup_dual(uint32_t w, uint32_t p,
                                               uint64_t mu) {
    const uint64_t x = (uint64_t)w << 32;
    const uint64_t q = __umul64hi(x, mu);
    return (uint32_t)(x - q * p >= p ? q + 1 : q);
}

// a w mod p up to one p, in [0, 2p): Shoup's product without its
// correction (a < 2^32, w < p, w_sh its dual)
__device__ __forceinline__ uint32_t shoup_lazy(uint32_t a, uint32_t w,
                                               uint32_t w_sh, uint32_t p) {
    return a * w - __umulhi(a, w_sh) * p;
}

// K5a's constants: per prime, p, Barrett's floor(2^64 / p) and G1's gadget
// entry of each level.
struct KeyBundleConsts {
    uint32_t p[brk::kMaxPrimes];
    uint64_t mu[brk::kMaxPrimes];
    uint32_t g1[brk::kMaxPrimes][kMaxLevels];
};

// bundles[b, tt, pi, jc, n] = G1[pi, jc] + sum_v coef_v(b, t0 + tt)[pi, n]
// GGSW[t0 + tt, v, pi, jc, n] mod p_pi for the block's step tt, prime pi,
// rows jc in [r0, r0 + nr) (jc = j R + c: digit row j, output row c) and
// points [n0, n0 + tp), over ciphertexts b of the block's slice.
// a_ms: i32 [B, n_ms]; bsk: u32 [n/g, 2, P, 2^G - 1, l R, R, N]; tables:
// u32 [P, 8, N]; exps: i32 [N]; bundles: u32 [B, count, P, l R, R, N].
// Shared memory: the key tile {residue, dual} [2^G - 1][rows_pb][tp], the
// prime's twist row (tw_slot), the step's G mask values of up to kKbMasks
// ciphertexts.
template <int P, int G>
__global__ void __launch_bounds__(kKbThreads)
multi_bit_keybundle_kernel(const int32_t* __restrict__ a_ms,
                           const uint32_t* __restrict__ bsk,
                           const uint32_t* __restrict__ tables,
                           const int32_t* __restrict__ exps,
                           uint32_t* __restrict__ bundles, int B, int n_ms,
                           int t0, int count, int R, int levels, int log_n,
                           int tp, int rows_pb, int slice,
                           const __grid_constant__ KeyBundleConsts kc) {
    constexpr int NSUB = (1 << G) - 1;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int N = 1 << log_n;
    uint2* ks = reinterpret_cast<uint2*>(smem_raw);
    uint32_t* s_tw = reinterpret_cast<uint32_t*>(ks + NSUB * rows_pb * tp);
    int32_t* s_a = reinterpret_cast<int32_t*>(s_tw + tw_slot(N, log_n));
    __shared__ uint32_t s_g1[kMaxLevels];
    const int rows = levels * R * R;
    const int tiles = N / tp;
    const int nrb = (rows + rows_pb - 1) / rows_pb;
    int bx = blockIdx.x;
    const int n0 = (bx % tiles) * tp;
    bx /= tiles;
    const int r0 = (bx % nrb) * rows_pb;
    bx /= nrb;
    const int pi = bx % P;
    const int tt = bx / P;
    const int t = t0 + tt;
    const int nr = min(rows_pb, rows - r0);
    const uint32_t p = kc.p[pi];
    const uint64_t mu = kc.mu[pi];
    for (int i = threadIdx.x; i < levels; i += blockDim.x)
        s_g1[i] = kc.g1[pi][i];

    // the key tile: 16-byte loads of residues and duals, interleaved so
    // that a thread reads {w, w_sh} of its point in one 8-byte access
    const long long sub = (long long)rows * N;  // one subset of one prime
    const uint32_t* kres = bsk + (long long)t * 2 * P * NSUB * sub
                           + (long long)pi * NSUB * sub;
    const uint32_t* kdual = kres + (long long)P * NSUB * sub;
    const int q4 = tp >> 2;
    #pragma unroll 1
    for (int i = threadIdx.x; i < NSUB * nr * q4; i += blockDim.x) {
        const int q = i % q4;
        const int r = (i / q4) % nr;
        const int v = i / (q4 * nr);
        const long long off = v * sub + (long long)(r0 + r) * N + n0 + 4 * q;
        const uint4 w = __ldg(reinterpret_cast<const uint4*>(kres + off));
        const uint4 s = __ldg(reinterpret_cast<const uint4*>(kdual + off));
        uint2* d = ks + (v * rows_pb + r) * tp + 4 * q;
        d[0] = make_uint2(w.x, s.x);
        d[1] = make_uint2(w.y, s.y);
        d[2] = make_uint2(w.z, s.z);
        d[3] = make_uint2(w.w, s.w);
    }
    const uint32_t* tw = tables + (long long)pi * brk::T_COUNT * N
                         + brk::T_TW * N;
    for (int k = threadIdx.x; k < N; k += blockDim.x)
        s_tw[tw_slot(k, log_n)] = __ldg(tw + k);

    const int b_end = min(B, (int)(blockIdx.y + 1) * slice);
    #pragma unroll 1
    for (int b0 = blockIdx.y * slice; b0 < b_end; b0 += kKbMasks) {
        const int nb = min(kKbMasks, b_end - b0);
        __syncthreads();  // the tiles are staged, s_a's last readers done
        for (int i = threadIdx.x; i < nb * G; i += blockDim.x)
            s_a[i] = __ldg(a_ms + (long long)(b0 + i / G) * n_ms
                           + (long long)t * G + i % G);
        __syncthreads();
        #pragma unroll 1
        for (int nl = threadIdx.x; nl < tp; nl += blockDim.x) {
            const uint32_t e = (uint32_t)__ldg(exps + n0 + nl);
            #pragma unroll 1
            for (int bi = 0; bi < nb; ++bi) {
                const int b = b0 + bi;
                // coef[v] = prod_{j in v} (zeta^{a_j} - 1), as r14's MAC
                // pass, each product a Shoup one against the dual of its
                // factor coef[v & -v] (one of the G - 1 lowest single
                // coefficients)
                uint32_t coef[NSUB + 1], coef_sh[G];
                #pragma unroll
                for (int j = 0; j < G; ++j) {
                    const uint32_t k = (e * (uint32_t)s_a[bi * G + j])
                                       & (2u * N - 1u);
                    const uint32_t w = s_tw[tw_slot(k & (N - 1), log_n)];
                    coef[1 << j] = (k >= (uint32_t)N ? p - w : w) - 1u;
                    if (j + 1 < G)
                        coef_sh[j] = shoup_dual(coef[1 << j], p, mu);
                }
                #pragma unroll
                for (int v = 3; v <= NSUB; ++v)
                    if (v & (v - 1))
                        coef[v] = brk::shoup_mul(coef[v & (v - 1)],
                                                 coef[v & -v],
                                                 coef_sh[low_bit(v)], p);
                uint32_t* out = bundles
                                + (((long long)b * count + tt) * P + pi) * sub
                                + n0 + nl;
                #pragma unroll 1
                for (int r = 0; r < nr; ++r) {
                    const int jc = r0 + r;
                    const int j = jc / R;
                    // G1's term and 2^G - 1 products in [0, 2p): below 2^36
                    uint64_t s = j % R == jc % R ? s_g1[j / R] : 0u;
                    const uint2* kr = ks + r * tp + nl;
                    #pragma unroll
                    for (int v = 1; v <= NSUB; ++v) {
                        const uint2 w = kr[(v - 1) * rows_pb * tp];
                        s += shoup_lazy(coef[v], w.x, w.y, p);
                    }
                    out[(long long)jc * N] = reduce_u64(s, p, mu);
                }
            }
        }
    }
}

// ---------------------------------------------------------------------------
// K5b: the dependent external products against the bundles
// ---------------------------------------------------------------------------

// The fused pass of StepPasses (the last F forward stages, the MAC, the
// first F inverse stages, MAC row c written over digit row c) against the
// step's bundle u32 [P, l R, R, N], which has no Shoup duals: each product
// a Barrett reduction (mul_mod).
template <int P, int F>
__device__ void mb_fused_pass(uint32_t* dig,
                              const uint32_t* __restrict__ bundle, int R,
                              int lR, int log_n,
                              const uint32_t* __restrict__ tables,
                              const uint32_t* s_p, const uint64_t* s_mu) {
    constexpr int E = 1 << F;
    constexpr int CM = 16 / E;  // rows c an item can hold
    constexpr int Q = E < 4 ? E : 4;
    const int N = 1 << log_n;
    const int log_g = log_n - F;
    const int s0 = log_n - F;
    #pragma unroll 1
    for (int u = threadIdx.x; u < P << log_g; u += blockDim.x) {
        const int pi = u >> log_g;
        const int t0 = (u & ((1 << log_g) - 1)) << F;
        const uint32_t p = s_p[pi];
        const uint64_t mu = s_mu[pi];
        const uint32_t* tb = tables + (long long)pi * brk::T_COUNT * N;
        uint32_t mac[CM][E];
        #pragma unroll
        for (int c = 0; c < CM; ++c)
            #pragma unroll
            for (int m = 0; m < E; ++m) mac[c][m] = 0;
        #pragma unroll 1
        for (int j = 0; j < lR; ++j) {
            uint32_t d[E];
            brk::lds_run<E>(dig, (j * P + pi) * N + t0, d);
            brk::fwd_regs<F>(d, tb, N, s0, 0, 0, p);
            const uint32_t* kr =
                bundle + ((long long)(pi * lR + j) * R) * N + t0;
            #pragma unroll
            for (int c = 0; c < CM; ++c) {
                if (c >= R) break;
                #pragma unroll
                for (int q = 0; q < E; q += Q) {
                    uint32_t w[Q];
                    brk::ldg_run<Q>(kr + (long long)c * N + q, w);
                    #pragma unroll
                    for (int m = 0; m < Q; ++m)
                        mac[c][q + m] = brk::add_mod(
                            mac[c][q + m], mul_mod(d[q + m], w[m], p, mu), p);
                }
            }
        }
        #pragma unroll
        for (int c = 0; c < CM; ++c) {
            if (c >= R) break;
            brk::inv_regs<F>(mac[c], tb, N, s0, 0, 0, p);
            brk::sts_run<E>(dig, (c * P + pi) * N + t0, mac[c]);
        }
    }
    __syncthreads();
}

// The count steps of a chunk for one ciphertext per block, on Tail's
// decomposer (GarnerTail<P>: the hi word's; GarnerTailDeep<P>: the whole
// u64 word's). acc_in/acc_out: u64 [B, R, N]; bundles: u32 [B, count, P,
// l R, R, N]; tables: u32 [P, 8, N]; pl: make_pass_plan(log_n, R).
template <class Tail>
__device__ __forceinline__ void accumulate_chunk(
        const uint64_t* __restrict__ acc_in,
        const uint32_t* __restrict__ bundles,
        const uint32_t* __restrict__ tables, uint64_t* __restrict__ acc_out,
        int count, int R, int levels, int base_log, int log_n,
        const brk::PassPlan& pl, const Tail& tail,
        const KeyBundleConsts& kc) {
    constexpr int P = Tail::P;
    using Passes = brk::StepPasses<Tail>;
    using Dec = typename brk::DecomposerOf<Tail>::type;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int N = 1 << log_n;
    const int lR = levels * R;
    uint64_t* acc = reinterpret_cast<uint64_t*>(smem_raw);      // [R][N]
    uint32_t* dig = reinterpret_cast<uint32_t*>(acc + R * N);   // [lR][P][N]
    __shared__ uint32_t s_p[P];
    __shared__ uint64_t s_mu[P];
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    if (tid == 0) {
        #pragma unroll
        for (int pi = 0; pi < P; ++pi) {
            s_p[pi] = tail.p[pi];
            s_mu[pi] = kc.mu[pi];
        }
    }
    const uint64_t* src = acc_in + (long long)brk::block_index() * R * N;
    for (int i = tid; i < R * N; i += nt) acc[i] = src[i];
    __syncthreads();

    const long long bstep = (long long)P * lR * R * N;
    for (int step = 0; step < count; ++step) {
        const uint32_t* bundle =
            bundles + ((long long)brk::block_index() * count + step) * bstep;
        mb_lift_pass_k<P, Dec>(pl.fwd_k[0], acc, dig, R, levels, base_log,
                               log_n, tables, s_p);
        // the digits hold all of acc now; the tail adds the new value
        for (int i = tid; i < R * N; i += nt) acc[i] = 0;
        #pragma unroll
        for (int i = 1; i < brk::kMaxPasses; ++i)
            if (i < pl.n_fwd)
                Passes::template pass_k<false>(pl.fwd_k[i], dig, P * lR,
                                               log_n, pl.fwd_s0[i], tables,
                                               s_p);
        if (pl.fused == 1)
            mb_fused_pass<P, 1>(dig, bundle, R, lR, log_n, tables, s_p, s_mu);
        else
            mb_fused_pass<P, 2>(dig, bundle, R, lR, log_n, tables, s_p, s_mu);
        #pragma unroll
        for (int i = 0; i + 1 < brk::kMaxPasses; ++i)
            if (i + 1 < pl.n_inv)
                Passes::template pass_k<true>(pl.inv_k[i], dig, P * R, log_n,
                                              pl.inv_s0[i], tables, s_p);
        #pragma unroll
        for (int i = 1; i <= brk::kMaxPasses; ++i)
            if (i == pl.n_inv)
                Passes::tail_pass_k(pl.inv_k[i - 1], acc, dig, R, log_n,
                                    tables, s_p, tail);
    }

    uint64_t* dst = acc_out + (long long)brk::block_index() * R * N;
    for (int i = tid; i < R * N; i += nt) dst[i] = acc[i];
}

// K5b: accumulate_chunk on the hi-word decomposer (base_log * levels <= 31)
template <int P>
__global__ void __launch_bounds__(brk::kThreads, brk::min_blocks(P))
multi_bit_accumulate_kernel(const uint64_t* __restrict__ acc_in,
                            const uint32_t* __restrict__ bundles,
                            const uint32_t* __restrict__ tables,
                            uint64_t* __restrict__ acc_out, int count, int R,
                            int levels, int base_log, int log_n,
                            const __grid_constant__ brk::PassPlan pl,
                            const __grid_constant__ GarnerTail<P> tail,
                            const __grid_constant__ KeyBundleConsts kc) {
    accumulate_chunk(acc_in, bundles, tables, acc_out, count, R, levels,
                     base_log, log_n, pl, tail, kc);
}

// K5b at base_log * levels >= 32: accumulate_chunk on the 64-bit decomposer
template <int P>
__global__ void __launch_bounds__(brk::kThreads, brk::min_blocks(P))
multi_bit_accumulate_deep_kernel(const uint64_t* __restrict__ acc_in,
                                 const uint32_t* __restrict__ bundles,
                                 const uint32_t* __restrict__ tables,
                                 uint64_t* __restrict__ acc_out, int count,
                                 int R, int levels, int base_log, int log_n,
                                 const __grid_constant__ brk::PassPlan pl,
                                 const __grid_constant__
                                     GarnerTailDeep<P> tail,
                                 const __grid_constant__ KeyBundleConsts kc) {
    accumulate_chunk(acc_in, bundles, tables, acc_out, count, R, levels,
                     base_log, log_n, pl, tail, kc);
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

// f(kernel) for K5a's template <kPrimes, G> of a run-time grouping, or
// `otherwise` for another prime count or grouping.
template <class Ret, class F>
Ret for_grouping(int num_primes, int grouping, Ret otherwise, F f) {
    if (num_primes != kPrimes) return otherwise;
    switch (grouping) {
        case 2: return f(multi_bit_keybundle_kernel<kPrimes, 2>);
        case 3: return f(multi_bit_keybundle_kernel<kPrimes, 3>);
        case 4: return f(multi_bit_keybundle_kernel<kPrimes, 4>);
        default: return otherwise;
    }
}

// K5a's tile: tp points (a thread each), rows_pb bundle rows a block (all
// l R R rows when their 2^g - 1 subsets fit kKbSmem), smem bytes
struct KbTile {
    int tp, rows_pb;
    size_t smem;
};

KbTile kb_tile(int grouping, int R, int levels, int log_n) {
    const int N = 1 << log_n;
    const int nsub = (1 << grouping) - 1;
    const int rows = levels * R * R;
    KbTile k;
    k.tp = N < kKbThreads ? N : kKbThreads;
    const int fit = kKbSmem / (nsub * k.tp * (int)sizeof(uint2));
    k.rows_pb = fit >= rows ? rows : (fit < 1 ? 1 : fit);
    const int log_s = log_n > 4 ? log_n - 4 : 0;
    k.smem = (size_t)nsub * k.rows_pb * k.tp * sizeof(uint2)
             + (size_t)(N + (N >> log_s)) * sizeof(uint32_t)
             + (size_t)kKbMasks * grouping * sizeof(int32_t);
    return k;
}

// K5a's shapes: up to N = 32768. Nothing of K5a's own binds at N = 8192:
// its tile is 128 points whatever N, its grid's x counts tiles, and its
// shared memory is the key tile (<= 64 KiB), the padded twist row (N +
// N/16 words, 136 KiB at N = 32768) and the masks, 200 KiB at N = 32768;
// the bound of log_n <= 13 was K5b's and r14's (mb_plan_fits).
constexpr int kKbMaxLogN = 15;

bool kb_fits(int grouping, int R, int levels, int log_n) {
    return log_n >= 3 && log_n <= kKbMaxLogN && R >= 1 && R <= kMaxR
           && levels >= 1 && levels <= kMaxLevels
           && kb_tile(grouping, R, levels, log_n).smem <= 232448;
}

KeyBundleConsts kb_consts(const unsigned* garner, const unsigned* g1,
                          const unsigned long long* mu) {
    KeyBundleConsts kc{};
    for (int pi = 0; pi < brk::kMaxPrimes; ++pi) {
        kc.p[pi] = garner[pi];
        kc.mu[pi] = mu[pi];
        for (int lev = 0; lev < kMaxLevels; ++lev)
            kc.g1[pi][lev] = g1[pi * kMaxLevels + lev];
    }
    return kc;
}

template <class Kernel>
int occupancy_of(Kernel kernel, int threads, size_t smem, int* regs,
                 int* local_bytes) {
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
                                                         threads, smem);
    return err == cudaSuccess ? blocks : -(int)err;
}

size_t mb_smem(int num_primes, int R, int levels, int log_n) {
    const size_t N = size_t(1) << log_n;
    return R * N * sizeof(uint64_t)
           + (size_t)num_primes * levels * R * N * sizeof(uint32_t);
}

}  // namespace

// r14, the single kernel (the reference the K5 pair is timed against).
// acc_in/acc_out: u64 [B, R, N]; a_ms: i32 [B, n_groups * grouping];
// bsk: u32 [n_groups, 2, P, 2^grouping - 1, levels*R, R, N] over the first
// P = kPrimes PRIMES32; tables: u32 [P, 8, N]; exps: i32 [N]; garner: host
// u32[65] (ops/pbs_kernel.py::garner_constants); g1, g1_sh: host u32[5][8]
// (G1's gadget entry of prime pi and level lev, and its dual); mu: host
// u64[5].
// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int blind_rotate_multi_bit_r14(
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

// Bytes of dynamic shared memory one r14 block needs (acc and digits, as
// K3); 0 for a prime count the kernel does not take.
extern "C" unsigned long long blind_rotate_multi_bit_r14_smem(
        int num_primes, int R, int levels, int log_n) {
    if (num_primes != kPrimes) return 0;
    return mb_smem(num_primes, R, levels, log_n);
}

// Resident blocks per SM of r14 at this prime count, grouping and shape,
// with its registers and local (spill) bytes per thread; negative: a CUDA
// error, 0 for a prime count or grouping the kernel does not take.
extern "C" int blind_rotate_multi_bit_r14_occupancy(int num_primes, int R,
                                                int levels, int log_n,
                                                int grouping, int* regs,
                                                int* local_bytes) {
    const size_t smem = mb_smem(num_primes, R, levels, log_n);
    return for_shape<int>(num_primes, grouping, 0,
                          [&](auto kernel, auto) {
        return occupancy_of(kernel, brk::kThreads, smem, regs, local_bytes);
    });
}

// K5a: the key bundles of group steps t0 .. t0 + count - 1 for the whole
// batch. a_ms: i32 [B, n_ms]; bsk: u32 [n_groups, 2, P, 2^grouping - 1,
// levels*R, R, N] over the first P = kPrimes PRIMES32; tables: u32 [P, 8,
// N]; exps: i32 [N]; bundles: u32 [B, count, P, levels*R, R, N]; garner:
// host u32[65] (its first five entries are the primes); g1: host u32[5][8];
// mu: host u64[5]. The batch is cut into slices so that the grid holds
// about kKbBlocksPerSm blocks a SM.
// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int multi_bit_keybundle(
        const void* a_ms, const void* bsk, const void* tables,
        const void* exps, void* bundles, int B, int n_ms, int t0, int count,
        int grouping, int R, int levels, int log_n, int num_primes,
        const unsigned* garner, const unsigned* g1,
        const unsigned long long* mu, void* stream) {
    if (!kb_fits(grouping, R, levels, log_n) || B < 1 || count < 1)
        return (int)cudaErrorInvalidValue;
    const KeyBundleConsts kc = kb_consts(garner, g1, mu);
    const KbTile k = kb_tile(grouping, R, levels, log_n);
    const int rows = levels * R * R;
    const long long base = (long long)count * num_primes * ((1 << log_n) / k.tp)
                           * ((rows + k.rows_pb - 1) / k.rows_pb);
    int dev = 0, sms = 1;
    if (cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
               != cudaSuccess)
        return (int)cudaGetLastError();
    long long nsl = ((long long)kKbBlocksPerSm * sms + base - 1) / base;
    nsl = nsl < B ? nsl : B;
    nsl = nsl < 65535 ? nsl : 65535;
    const int slice = (int)((B + nsl - 1) / nsl);
    const unsigned slices = (unsigned)((B + slice - 1) / slice);
    return for_grouping<int>(num_primes, grouping, (int)cudaErrorInvalidValue,
                             [&](auto kernel) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)k.smem);
        if (err != cudaSuccess) return (int)err;
        kernel<<<dim3((unsigned)base, slices), k.tp, k.smem,
                 (cudaStream_t)stream>>>(
            (const int32_t*)a_ms, (const uint32_t*)bsk,
            (const uint32_t*)tables, (const int32_t*)exps,
            (uint32_t*)bundles, B, n_ms, t0, count, R, levels, log_n, k.tp,
            k.rows_pb, slice, kc);
        return (int)cudaGetLastError();
    });
}

// Resident blocks per SM of K5a at this shape, with its registers and local
// (spill) bytes per thread; negative: a CUDA error, 0 for a prime count or
// grouping the kernel does not take.
extern "C" int multi_bit_keybundle_occupancy(int num_primes, int R,
                                             int levels, int log_n,
                                             int grouping, int* regs,
                                             int* local_bytes) {
    const KbTile k = kb_tile(grouping, R, levels, log_n);
    return for_grouping<int>(num_primes, grouping, 0, [&](auto kernel) {
        return occupancy_of(kernel, k.tp, k.smem, regs, local_bytes);
    });
}

// Launch K5b's kernel `kernel` on its tail (GarnerTail or GarnerTailDeep
// at kPrimes).
template <class Tail, class Kernel>
int launch_accumulate(Kernel kernel, const void* acc_in, const void* bundles,
                      const void* tables, void* acc_out, int B, int count,
                      int R, int levels, int base_log, int log_n,
                      const unsigned* garner, unsigned long long full_prod,
                      const unsigned long long* mu, void* stream) {
    KeyBundleConsts kc{};  // K5b reads the Barrett constants only
    for (int pi = 0; pi < brk::kMaxPrimes; ++pi) kc.mu[pi] = mu[pi];
    Tail tail{};
    brk::fill_garner(tail, garner, full_prod);
    const size_t smem = mb_smem(Tail::P, R, levels, log_n);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<B, brk::kThreads, smem, (cudaStream_t)stream>>>(
        (const uint64_t*)acc_in, (const uint32_t*)bundles,
        (const uint32_t*)tables, (uint64_t*)acc_out, count, R, levels,
        base_log, log_n, brk::make_pass_plan(log_n, R), tail, kc);
    return (int)cudaGetLastError();
}

// K5b: count group steps against their bundles, one block a ciphertext.
// acc_in/acc_out: u64 [B, R, N]; bundles: u32 [B, count, P, levels*R, R,
// N]; tables: u32 [P, 8, N]; garner: host u32[65]; mu: host u64[5].
// base_log * levels >= 32 (up to 63) runs multi_bit_accumulate_deep_kernel
// (the 64-bit decomposer). Returns cudaGetLastError() after the launch (0 =
// launched), or cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int multi_bit_accumulate(
        const void* acc_in, const void* bundles, const void* tables,
        void* acc_out, int B, int count, int R, int levels, int base_log,
        int log_n, int num_primes, const unsigned* garner,
        unsigned long long full_prod, const unsigned long long* mu,
        void* stream) {
    if (num_primes != kPrimes || !mb_plan_fits(R, levels, log_n)
        || !brk::pass_plan_fits(R, levels, log_n) || B < 1 || count < 1
        || base_log < 1 || base_log * levels > 63)
        return (int)cudaErrorInvalidValue;
    if (brk::hi_word_decomposition(base_log, levels))
        return launch_accumulate<GarnerTail<kPrimes>>(
            multi_bit_accumulate_kernel<kPrimes>, acc_in, bundles, tables,
            acc_out, B, count, R, levels, base_log, log_n, garner, full_prod,
            mu, stream);
    return launch_accumulate<GarnerTailDeep<kPrimes>>(
        multi_bit_accumulate_deep_kernel<kPrimes>, acc_in, bundles, tables,
        acc_out, B, count, R, levels, base_log, log_n, garner, full_prod, mu,
        stream);
}

// Bytes of dynamic shared memory a K5b block needs (acc and digits, as K3);
// 0 for a prime count the kernel does not take.
extern "C" unsigned long long multi_bit_accumulate_smem(int num_primes, int R,
                                                        int levels,
                                                        int log_n) {
    if (num_primes != kPrimes) return 0;
    return mb_smem(num_primes, R, levels, log_n);
}

// Resident blocks per SM of K5b at this shape, with its registers and local
// (spill) bytes per thread; negative: a CUDA error, 0 for a prime count the
// kernel does not take.
extern "C" int multi_bit_accumulate_occupancy(int num_primes, int R,
                                              int levels, int log_n,
                                              int* regs, int* local_bytes) {
    if (num_primes != kPrimes) return 0;
    return occupancy_of(multi_bit_accumulate_kernel<kPrimes>, brk::kThreads,
                        mb_smem(num_primes, R, levels, log_n), regs,
                        local_bytes);
}
