// K7: the exact CRT blind rotation beyond one block's shared memory, for
// Hopper: every classic and multi-bit shape whose accumulator and digit
// transforms, R N 8 + 4 P l R N bytes, exceed one block's shared memory
// (232,448 B), up to N = 32768 (one u32 polynomial, 128 KiB, still fits a
// block).
//
// Replaces: tfhe_tpu/ops/pbs_kernel.py::_build_step_fn_v4.step (pallas_call
// at :1867) with the garner_c tail (:1441), two-plane, and in acc32 mode
// (TFHE_V4_ACC=32, the rounding at :1635-1640), at the shapes K3
// (blind_rotate_crt.cu) cannot hold on this card (tfhe-rs's classic 3_3
// and 4_4 sets); and the external products of the multi-bit rotation
// (tfhe_tpu/ops/server.py::multi_bit_blind_rotate, XLA, :868-884) where
// K5b (blind_rotate_multi_bit.cu) cannot hold them. Specs, unchanged: the
// plain versions of K3, K3-acc32 and K5b in ops/pbs_kernel.py
// (blind_rotate_crt_plain, blind_rotate_crt_acc32_plain,
// multi_bit_accumulate_plain).
//
// Two designs, chosen by the wrapper from the shape alone
// (ops/pbs_kernel.py::wide_route):
//
// The cluster kernel (wide_cluster_kernel<Tail, Bundle, H>; at split H = 1
// every shape whose CTA area below fits a block, which holds the 3_3 sets;
// at H = 2, below, the shapes where only a CTA of half the transforms
// fits, tfhe-rs's 4_4 sets): one thread-block cluster of
// P R CTAs a ciphertext runs all n steps of the call in one launch, with
// the accumulator and the digit transforms in the cluster's distributed
// shared memory (DSMEM) throughout. CTA rank = r P + pi owns
//   dig [max(l, R)][N] u32 (swizzled): the l forward-transformed digits of
//       accumulator row r mod p_pi, then the R MAC partials over them,
//       then row r's residues;
//   acc [S] Acc: slice pi of accumulator row r, coefficients [pi S,
//       pi S + S) (S = 2^ceil(log2(N / P)): with P not a power of two the
//       last slices are short or empty);
//   dsl [l][S] i32: the l balanced digits of that slice.
// A step, each phase closed by a cluster barrier (4 a step):
//   A. each CTA decomposes its slice: the hi word of X^a acc[r] - acc[r]
//      (classic; its rotated operand read from the slice's owner over
//      DSMEM) or of acc[r] itself (multi-bit), l digits into dsl. Once a
//      coefficient, not once a (digit, prime) as K7 global's K7a: P times
//      less chain work, and l N words of DSMEM a CTA instead of 2 N acc
//      words. The decomposer is the hi word's, or at base_log * levels >=
//      32 (u64 accumulator, P = 4: GarnerTailDeep) all 64 bits';
//   B. lift: the digits of row r read from their owners, mod p_pi, twisted,
//      fused with the first forward pass; the forward passes
//      (StepPasses<OnePrime>, as K7 global's: no key layout moves); the
//      last two forward stages fused with the MAC: for every output row c,
//      the partial sum over the CTA's l digit rows (Shoup against the
//      step's key and duals from L2, or Barrett against the ciphertext's
//      bundle), written over dig row c;
//   C. the first inverse pass sums dig row r of CTAs (pi, .) (the partials
//      pulled over DSMEM, 16 bytes a thread and row), then the inverse
//      passes and the untwist: row r's canonical residues mod p_pi;
//   D. Garner: each CTA gathers the P residues of its slice from CTAs
//      (., r) and applies tails.cuh's tail, added to the slice (classic:
//      GarnerTail, GarnerTail32) or in its place (multi-bit).
// Nothing of a step goes through device memory but the key (or bundle) and
// the constant tables: no per-step launch and no HBM round trip.
//
// The split (H = 2; N = 32768 at l = 2 and 3, N = 16384 at l = 3: a
// CTA area of 393,216 B to 557,056 B at H = 1): 2 P R = 16 CTAs a
// ciphertext, beyond the portable cluster size. CTA rank h P R + r P + pi
// holds half h of every transform of row r mod p_pi, dig [max(l, R)][N/2]:
// a DIF transform's stage 0 is its only stage that pairs the halves (t
// with t + N/2), as is the DIT inverse's last. So the lift reads both
// digits of each pair and keeps its half of stage 0 (then stages 1 .. 3
// in registers); every other pass, the MAC and the sum of the partials
// run on the half; and D gathers both halves of row r of every prime and
// runs stage 0 and the untwist there before the tail. CTA o = h P + pi of
// row r owns the pairs (t, t + N/2), t in [o S, o S + S), S =
// 2^ceil(log2(N / 4P)): each output pair is computed once. The digits of
// its 2 S positions are stored as int16 [l][2 S] (l >= 2, so b <= 15) and
// its accumulator words stay in global memory (read in A, written in D;
// the cluster barriers' release and acquire order them): 147,456 B at N =
// 32768, l = 2, 221,184 B at l = 3, 110,592 B at N = 16384, l = 3. Still
// 4 cluster barriers a step and one launch a call.
//
// The split with its levels streamed (the same entries, chosen inside them
// from the shape: where a split CTA holding all l digit transforms exceeds
// a block, N = 32768 at l = 4 to 6, tfhe-rs's sets with 4 to 6 levels;
// u64 accumulator only): the MAC is a sum over levels, so phase B runs
// level by level within the CTA, after A's barrier: lift digit lev (the
// pair reads of stage 0), forward-transform it in one half-polynomial
// buffer, fuse its last two stages with the products against key row lev
// R + r, and add them into R partial buffers that stay in shared memory.
// dig is [R + 1][N/2] (rows 0 .. R-1 the partials, as C and D read them;
// row R the transform), whatever l is: 196,608 B at N = 32768, R = 2. The
// digits stay int16 where they fit beside it (229,376 B at l = 4, b <=
// 15), else int8 (b <= 7: a balanced digit lies in [-2^(b-1), 2^(b-1)];
// 217,088 B at l = 5, 221,184 B at l = 6). Phases A, C and D, the 16 CTAs
// and the 4 cluster barriers a step are the split's; the R partials are
// read and written once a level instead of once a step.
//
// K7 global (the three-stage design, for any shape beyond all three: P R
// > 8, l = 1 at N = 32768, the acc32 entries where the split would
// stream; no set of the universe; the reference the split is timed
// against), one CMUX step on a chunk of Bc ciphertexts in three launches:
//   K7a (wide_decompose_kernel), one block a (ciphertext, digit row
//       j = lev R + r, prime): the balanced digit `lev` of the hi word (at
//       base_log * levels >= 32: of all 64 bits) of X^a acc[r] - acc[r]
//       (classic) or of acc[r] itself (multi-bit, whose bundle carries G1's
//       term), lifted mod p and twisted, then the
//       forward transform of that one polynomial in shared memory on
//       ntt_common.cuh's passes (DIF order out: the key's), written to
//       digits u32 [Bc, l R, P, N];
//   K7b (wide_mac_kernel), one block a (ciphertext, output row c, prime):
//       sum_j digits[j] key[j][c] mod p, a Shoup MAC against the stored
//       duals (classic, the step's u32 [2, P, l R, R, N]) or a Barrett MAC
//       against the ciphertext's bundle (multi-bit, u32 [P, l R, R, N]),
//       then the inverse transform and the untwist in shared memory:
//       canonical residues u32 [Bc, R, P, N];
//   K7c (wide_garner_kernel), elementwise: tails.cuh's Garner tail of the
//       P residues of each coefficient, added to acc (classic; u64, or the
//       u32 hi plane with GarnerTail32) or replacing it (multi-bit).
// Every modular product is an exact Shoup or Barrett product on canonical
// residues, so the residues equal the specs' and the output is bit-equal.
//
// Bound: int32 operations at wide batches (P (l R + R) transforms of
// N/2 log2 N butterflies a ciphertext-step, the MAC, the lift and the
// tail: K3 P=4's SASS per-pipe rule for the function). The cluster kernel
// adds 4 cluster barriers a step and its DSMEM traffic (l N + N / P words
// read a CTA-step, and the R - 1 partials and P - 1 residue words a
// coefficient); K7 global adds the digits' and residues' round trip
// through L2/HBM, (2 l R + 2 R) P N 4 bytes a ciphertext-step, and three
// launches a step.

#include "ntt_common.cuh"
#include "tails.cuh"
#include "wgmma_int8.cuh"  // the cluster pieces

using brk::GarnerTail;
using brk::GarnerTail32;
using brk::GarnerTailDeep;

namespace {

constexpr int kWideThreads = 512;  // K7a, K7b: one polynomial a block
constexpr int kGarnerThreads = 256;  // K7c
constexpr int kWideMaxLogN = 15;     // one u32 polynomial, 128 KiB

// A single prime's view of StepPasses: P = 1 makes every pass's polynomial
// index pick prime 0, so a block hands the passes its own prime's table and
// modulus.
struct OnePrime {
    using Acc = uint32_t;
    static constexpr int P = 1;
};
using Passes1 = brk::StepPasses<OnePrime>;

// The forward transform's passes, stages [0, log_n) in passes of <= 3, and
// the inverse's, stages log_n - 1 .. 0 likewise (brk::split_stages).
struct WidePlan {
    int n_fwd, fwd_s0[brk::kMaxPasses], fwd_k[brk::kMaxPasses];
    int n_inv, inv_s0[brk::kMaxPasses], inv_k[brk::kMaxPasses];
};

WidePlan make_wide_plan(int log_n) {
    WidePlan pl{};
    brk::split_stages(0, log_n, false, &pl.n_fwd, pl.fwd_s0, pl.fwd_k);
    brk::split_stages(0, log_n, true, &pl.n_inv, pl.inv_s0, pl.inv_k);
    return pl;
}

// Whether K7 takes this shape: the plan's passes (5 of 3 stages at log_n
// = 15), a polynomial within a block's shared memory, a decomposer
// (base_log * levels <= 63; for_tail picks it) and the grid's y and z.
bool wide_fits(int R, int levels, int base_log, int log_n, int P) {
    return log_n >= 3 && log_n <= kWideMaxLogN && R >= 1 && levels >= 1
           && base_log >= 1 && base_log * levels <= 63
           && levels * R < 65536 && P >= 2 && P <= brk::kMaxPrimes;
}

struct WidePrimes {
    uint32_t p[brk::kMaxPrimes];
    uint64_t mu[brk::kMaxPrimes];  // floor(2^64 / p), the Barrett MAC's
};

// a * b mod p for a, b < p < 2^31 (Barrett, one correction)
__device__ __forceinline__ uint32_t mul_mod(uint32_t a, uint32_t b,
                                            uint32_t p, uint64_t mu) {
    const uint64_t x = (uint64_t)a * b;
    const uint64_t q = __umul64hi(x, mu);
    const uint32_t r = (uint32_t)(x - q * p);
    return r >= p ? r - p : r;
}

// K7a. acc: Acc [Bc, R, N]; a_ms: i32 [Bc, n_ms] (read at column `step`
// when Rotate); digits: u32 [Bc, l R, P, N]. Grid (Bc, l R, P). Dec: the
// hi word's decomposer, or Decomposer64 at base_log * levels >= 32.
template <class Acc, bool Rotate, class Dec = brk::HiDecomposer>
__global__ void __launch_bounds__(kWideThreads)
wide_decompose_kernel(const Acc* __restrict__ acc,
                      const int32_t* __restrict__ a_ms, int n_ms, int step,
                      const uint32_t* __restrict__ tables,
                      uint32_t* __restrict__ digits, int R, int levels,
                      int base_log, int log_n, int P,
                      const __grid_constant__ WidePlan pl,
                      const __grid_constant__ WidePrimes pr) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    uint32_t* x = reinterpret_cast<uint32_t*>(smem_raw);  // [N], swizzled
    __shared__ uint32_t s_p[1];
    const int N = 1 << log_n;
    const int b = blockIdx.x, j = blockIdx.y, pi = blockIdx.z;
    const int r = j % R, lev = j / R;
    const uint32_t p = pr.p[pi];
    if (threadIdx.x == 0) s_p[0] = p;
    const uint32_t* tb = tables + (long long)pi * brk::T_COUNT * N;
    const Acc* row = acc + ((long long)b * R + r) * N;
    const int a = Rotate ? a_ms[(long long)b * n_ms + step] : 0;
    const Dec dec(base_log, levels);
    for (int t = threadIdx.x; t < N; t += blockDim.x) {
        Acc v = row[t];
        if (Rotate) {
            int s = t - a;
            if (s < 0) s += 2 * N;
            const bool neg = s >= N;
            if (neg) s -= N;
            Acc y = row[s];
            if (neg) y = Acc(0) - y;
            v = Acc(y - v);
        }
        typename Dec::State state = dec.init_word(v);
        int32_t digit = dec.next(state);
        #pragma unroll 1
        for (int lv = 0; lv < lev; ++lv) digit = dec.next(state);
        const uint32_t m =
            digit < 0 ? (uint32_t)(digit + (int32_t)p) : (uint32_t)digit;
        x[brk::swz(t)] = brk::shoup_mul(m, __ldg(tb + brk::T_TW * N + t),
                                        __ldg(tb + brk::T_TW_SH * N + t), p);
    }
    __syncthreads();
    #pragma unroll
    for (int i = 0; i < brk::kMaxPasses; ++i)
        if (i < pl.n_fwd)
            Passes1::pass_k<false>(pl.fwd_k[i], x, 1, log_n, pl.fwd_s0[i], tb,
                                   s_p);
    uint32_t* out =
        digits + (((long long)b * levels * R + j) * P + pi) * N;
    for (int t = threadIdx.x; t < N; t += blockDim.x) out[t] = x[brk::swz(t)];
}

// K7b. digits: u32 [Bc, l R, P, N]; key: classic, the step's u32 [2, P,
// l R, R, N] (residues, Shoup duals); Bundle, the chunk's bundles u32 [Bc,
// count, P, l R, R, N] read at step `tt`; res: u32 [Bc, R, P, N]. Grid
// (Bc, R, P).
template <bool Bundle>
__global__ void __launch_bounds__(kWideThreads)
wide_mac_kernel(const uint32_t* __restrict__ digits,
                const uint32_t* __restrict__ key, int count, int tt,
                const uint32_t* __restrict__ tables,
                uint32_t* __restrict__ res, int R, int lR, int log_n, int P,
                const __grid_constant__ WidePlan pl,
                const __grid_constant__ WidePrimes pr) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    uint32_t* x = reinterpret_cast<uint32_t*>(smem_raw);  // [N], swizzled
    __shared__ uint32_t s_p[1];
    const int N = 1 << log_n;
    const int b = blockIdx.x, c = blockIdx.y, pi = blockIdx.z;
    const uint32_t p = pr.p[pi];
    const uint64_t mu = pr.mu[pi];
    if (threadIdx.x == 0) s_p[0] = p;
    const uint32_t* tb = tables + (long long)pi * brk::T_COUNT * N;
    const long long dig_row = (long long)P * N;  // digit rows j apart
    const long long key_row = (long long)R * N;  // key rows j apart
    const uint32_t* dg = digits + ((long long)b * lR * P + pi) * N;
    const long long step_key = (long long)P * lR * R * N;
    const uint32_t* kr = key + ((long long)pi * lR * R + c) * N;
    if (Bundle) kr += ((long long)b * count + tt) * step_key;
    const uint32_t* ks = kr + step_key;  // the duals (classic)
    for (int t = threadIdx.x; t < N; t += blockDim.x) {
        uint32_t s = 0;
        #pragma unroll 1
        for (int j = 0; j < lR; ++j) {
            const uint32_t d = dg[j * dig_row + t];
            const uint32_t w = __ldg(kr + j * key_row + t);
            const uint32_t prod = Bundle
                ? mul_mod(d, w, p, mu)
                : brk::shoup_mul(d, w, __ldg(ks + j * key_row + t), p);
            s = brk::add_mod(s, prod, p);
        }
        x[brk::swz(t)] = s;
    }
    __syncthreads();
    #pragma unroll
    for (int i = 0; i < brk::kMaxPasses; ++i)
        if (i < pl.n_inv)
            Passes1::pass_k<true>(pl.inv_k[i], x, 1, log_n, pl.inv_s0[i], tb,
                                  s_p);
    uint32_t* out = res + (((long long)b * R + c) * P + pi) * N;
    for (int t = threadIdx.x; t < N; t += blockDim.x)
        out[t] = brk::shoup_mul(x[brk::swz(t)],
                                __ldg(tb + brk::T_UTW * N + t),
                                __ldg(tb + brk::T_UTW_SH * N + t), p);
}

// K7c. res: u32 [Bc, R, P, N]; acc: Tail::Acc [Bc, R, N], acc += tail or
// (Replace) acc = tail, at each of the `total` = Bc R N coefficients.
template <class Tail, bool Replace>
__global__ void __launch_bounds__(kGarnerThreads)
wide_garner_kernel(const uint32_t* __restrict__ res,
                   typename Tail::Acc* __restrict__ acc, long long total,
                   int log_n, const __grid_constant__ Tail tail) {
    constexpr int P = Tail::P;
    const int N = 1 << log_n;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < total; i += (long long)gridDim.x * blockDim.x) {
        const long long bc = i >> log_n;  // b R + c
        const int t = (int)(i & (N - 1));
        uint32_t m[P];
        #pragma unroll
        for (int pi = 0; pi < P; ++pi) m[pi] = res[(bc * P + pi) * N + t];
        const typename Tail::Acc v = tail(m);
        acc[i] = Replace ? v : acc[i] + v;
    }
}

size_t wide_smem(int log_n) { return sizeof(uint32_t) << log_n; }

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The three stages of `n_steps` steps on one chunk of Bc ciphertexts, acc
// updated in place. Classic (Bundle = false): step i decomposes X^{a_i}
// acc - acc and reads key + i * 2 P l R R N; multi-bit: step tt decomposes
// acc and reads the chunk's bundles at tt. Returns the first launch error.
template <class Tail, bool Bundle>
int run_wide(typename Tail::Acc* acc, const int32_t* a_ms, int n_ms,
             const uint32_t* key, const uint32_t* tables, uint32_t* digits,
             uint32_t* res, int Bc, int n_steps, int R, int levels,
             int base_log, int log_n, const Tail& tail,
             const unsigned long long* mu, cudaStream_t stream) {
    using Acc = typename Tail::Acc;
    constexpr int P = Tail::P;
    const int lR = levels * R;
    const size_t smem = wide_smem(log_n);
    auto k7a = wide_decompose_kernel<Acc, !Bundle,
                                     typename brk::DecomposerOf<Tail>::type>;
    auto k7b = wide_mac_kernel<Bundle>;
    auto k7c = wide_garner_kernel<Tail, Bundle>;
    cudaError_t err = allow_smem(k7a, smem);
    if (err == cudaSuccess) err = allow_smem(k7b, smem);
    if (err != cudaSuccess) return (int)err;
    const WidePlan pl = make_wide_plan(log_n);
    WidePrimes pr{};
    for (int pi = 0; pi < P; ++pi) {
        pr.p[pi] = tail.p[pi];
        pr.mu[pi] = mu ? mu[pi] : 0ull;
    }
    const long long total = ((long long)Bc * R) << log_n;
    long long blocks = (total + kGarnerThreads - 1) / kGarnerThreads;
    blocks = blocks < (1LL << 30) ? blocks : (1LL << 30);
    const long long key_step = 2LL * P * lR * R << log_n;
    for (int step = 0; step < n_steps; ++step) {
        k7a<<<dim3(Bc, lR, P), kWideThreads, smem, stream>>>(
            acc, a_ms, n_ms, step, tables, digits, R, levels, base_log,
            log_n, P, pl, pr);
        const uint32_t* k = Bundle ? key : key + step * key_step;
        k7b<<<dim3(Bc, R, P), kWideThreads, smem, stream>>>(
            digits, k, n_steps, step, tables, res, R, lR, log_n, P, pl, pr);
        k7c<<<(unsigned)blocks, kGarnerThreads, 0, stream>>>(
            res, acc, total, log_n, tail);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

// Tail<P> of a run-time prime count 2..5, as K3's for_primes
template <template <int> class Tail, class F>
int for_primes(int num_primes, F f) {
    switch (num_primes) {
        case 2: return f(Tail<2>{});
        case 3: return f(Tail<3>{});
        case 4: return f(Tail<4>{});
        case 5: return f(Tail<5>{});
        default: return (int)cudaErrorInvalidValue;
    }
}

// f(tail) at a run-time prime count and decomposition: Tail<P> at base_log
// * levels <= 31 (the hi word's decomposer); beyond, on the u64
// accumulator at brk::kDeepPrimes primes, GarnerTailDeep (the 64-bit
// decomposer); cudaErrorInvalidValue for any other shape (the acc32 tails
// take b l <= 31 only).
template <template <int> class Tail, class F>
int for_tail(int num_primes, int base_log, int levels, F f) {
    constexpr int P = brk::kDeepPrimes;
    if (brk::hi_word_decomposition(base_log, levels))
        return for_primes<Tail>(num_primes, f);
    if constexpr (sizeof(typename Tail<P>::Acc) == 8) {
        if (num_primes == P) return f(GarnerTailDeep<P>{});
    }
    return (int)cudaErrorInvalidValue;
}

template <template <int> class Tail>
int wide_classic(void* acc, const void* a_ms, const void* bsk,
                 const void* tables, void* digits, void* res, int Bc,
                 int n_steps, int R, int levels, int base_log, int log_n,
                 int num_primes, const unsigned* garner,
                 unsigned long long full_prod, void* stream) {
    if (!wide_fits(R, levels, base_log, log_n, num_primes) || Bc < 1
        || Bc > 0x7fffffff || n_steps < 1)
        return (int)cudaErrorInvalidValue;
    return for_tail<Tail>(num_primes, base_log, levels, [&](auto t) {
        using T = decltype(t);
        brk::fill_garner(t, garner, full_prod);
        return run_wide<T, false>(
            (typename T::Acc*)acc, (const int32_t*)a_ms, n_steps,
            (const uint32_t*)bsk, (const uint32_t*)tables,
            (uint32_t*)digits, (uint32_t*)res, Bc, n_steps, R, levels,
            base_log, log_n, t, nullptr, (cudaStream_t)stream);
    });
}

// ---------------------------------------------------------------------------
// The cluster kernel: one cluster of H P R CTAs a ciphertext, all n steps
// ---------------------------------------------------------------------------

constexpr int kClusterThreads = 512;
constexpr int kClusterMax = 8;       // the portable cluster size
constexpr int kClusterMinLogN = 8;   // slices of >= 64 (H = 2: 16 pairs)
constexpr int kClusterMaxLogN = 14;  // the plan's passes: <= 5 a side
constexpr int kSplitMaxLogN = 15;    // H = 2: a half's passes, <= 5 a side
constexpr int kClusterRowsMax = kClusterMax / 2;  // R <= 4 (P >= 2)
constexpr size_t kSmemLimit = 232448;

// log2 S. H = 1: a CTA's accumulator slice, ceil(log2(N / P)) = log_n -
// floor(log2 P); H = 2: the pairs (t, t + N/2) a CTA owns, ceil(log2(N /
// 4P)), two less
__host__ __device__ __forceinline__ int cluster_log_slice(int log_n, int P,
                                                          int H = 1) {
    int f = 0;
    while ((2 << f) <= P) ++f;
    return log_n - f - 2 * (H - 1);
}

// rows of a CTA's digit area: its l digit transforms, its R MAC partials
__host__ __device__ __forceinline__ int cluster_rows(int R, int levels) {
    return levels > R ? levels : R;
}

// H = 2: bytes of a split CTA's dynamic shared memory, dig [max(l,
// R)][N/2] u32 holding all l digit transforms, or (stream) [R + 1][N/2]:
// the R partials and one transform; and the digits of its 2 S positions
// [l][2 S], db bytes each (its acc positions stay in global memory)
__host__ __device__ __forceinline__ size_t split_area(int R, int levels,
                                                      int log_n, int P,
                                                      bool stream, int db) {
    const size_t M = size_t(1) << (log_n - 1);
    const size_t S = size_t(1) << cluster_log_slice(log_n, P, 2);
    return (stream ? R + 1 : cluster_rows(R, levels)) * M * 4
           + (size_t)levels * 2 * S * db;
}

// Whether the split streams its levels at this shape: a CTA holding all l
// digit transforms with int16 digits exceeds a block (N = 32768 at l >= 4)
__host__ __device__ __forceinline__ bool split_streams(int R, int levels,
                                                       int log_n, int P) {
    return split_area(R, levels, log_n, P, false, 2) > kSmemLimit;
}

// Bytes a digit of the split's store: 2 (int16), or 1 (int8) where the
// split streams and int16 digits do not fit beside its buffers (N = 32768
// at l >= 5)
__host__ __device__ __forceinline__ int split_digit_bytes(int R, int levels,
                                                          int log_n, int P) {
    return split_streams(R, levels, log_n, P)
                   && split_area(R, levels, log_n, P, true, 2) > kSmemLimit
               ? 1 : 2;
}

// bytes of a CTA's dynamic shared memory. H = 1: dig [max(l, R)][N] u32,
// the acc slice [S] and the slice's digits [l][S] i32; H = 2: split_area
// of the instantiation the shape takes
size_t cluster_smem(int R, int levels, int log_n, int P, int acc_bytes,
                    int H = 1) {
    const size_t N = size_t(1) << log_n;
    const size_t S = size_t(1) << cluster_log_slice(log_n, P, H);
    if (H == 2)
        return split_area(R, levels, log_n, P,
                          split_streams(R, levels, log_n, P),
                          split_digit_bytes(R, levels, log_n, P));
    return cluster_rows(R, levels) * N * 4 + S * acc_bytes
           + (size_t)levels * S * 4;
}

// Whether the cluster kernel at split H takes this shape: P R <= 8 (H P R
// CTAs a cluster; 16, beyond the portable size, at H = 2), its plan
// (passes of <= 3 stages, 5 a side), a decomposer (base_log * levels <=
// 63; for_tail picks it), a CTA area within a block's shared memory; at H
// = 2 l >= 2 and a balanced digit (|d| <= 2^(b-1)) within its store: b <=
// 15 in int16, b <= 7 in int8; the streamed split on the u64 accumulator
// at P >= 3 only (has_stream).
bool cluster_fits(int R, int levels, int base_log, int log_n, int P,
                  int acc_bytes, int H = 1) {
    return P >= 2 && P <= brk::kMaxPrimes && R >= 1 && P * R <= kClusterMax
           && levels >= (H == 2 ? 2 : 1) && base_log >= 1
           && base_log * levels <= 63 && log_n >= kClusterMinLogN
           && log_n <= (H == 2 ? kSplitMaxLogN : kClusterMaxLogN)
           && base_log <= (H == 2 ? 8 * split_digit_bytes(R, levels, log_n,
                                                          P) - 1
                                  : 63)
           && (H == 1 || (acc_bytes == 8 && P >= 3)
               || !split_streams(R, levels, log_n, P))
           && cluster_smem(R, levels, log_n, P, acc_bytes, H) <= kSmemLimit;
}

// The step's passes: forward stages [0, log_n - 2) in passes of <= 3 (the
// first one lifts), then [log_n - 2, log_n) fused with the MAC; inverse
// [log_n - 2, log_n) summing the partials, then stages log_n - 3 .. 0 in
// passes of <= 3 (the last one untwists).
WidePlan make_cluster_plan(int log_n) {
    WidePlan pl{};
    brk::split_stages(0, log_n - 2, false, &pl.n_fwd, pl.fwd_s0, pl.fwd_k);
    pl.fwd_s0[pl.n_fwd] = log_n - 2;
    pl.fwd_k[pl.n_fwd++] = 2;
    pl.inv_s0[0] = log_n - 2;
    pl.inv_k[0] = 2;
    pl.n_inv = 1;
    brk::split_stages(0, log_n - 2, true, &pl.n_inv, pl.inv_s0, pl.inv_k);
    return pl;
}

// H = 2: the lift with stages 0 .. 3 (stage 0 the only one across the
// halves), then [4, log_n - 2) in passes of <= 3 on the CTA's half, then
// the MAC's two; inverse: the sum's two, then stages log_n - 3 .. 1 in
// passes of <= 3 (stage 0 and the untwist are phase D's).
WidePlan make_split_plan(int log_n) {
    WidePlan pl{};
    pl.fwd_s0[0] = 0;
    pl.fwd_k[0] = 4;
    pl.n_fwd = 1;
    brk::split_stages(4, log_n - 2, false, &pl.n_fwd, pl.fwd_s0, pl.fwd_k);
    pl.fwd_s0[pl.n_fwd] = log_n - 2;
    pl.fwd_k[pl.n_fwd++] = 2;
    pl.inv_s0[0] = log_n - 2;
    pl.inv_k[0] = 2;
    pl.n_inv = 1;
    brk::split_stages(1, log_n - 2, true, &pl.n_inv, pl.inv_s0, pl.inv_k);
    return pl;
}

template <class Acc>
__device__ __forceinline__ Acc ld_cluster(uint32_t a);
template <>
__device__ __forceinline__ uint32_t ld_cluster<uint32_t>(uint32_t a) {
    return wg::ld_cluster_u32(a);
}
template <>
__device__ __forceinline__ uint64_t ld_cluster<uint64_t>(uint32_t a) {
    return wg::ld_cluster_u64(a);
}

// B, the lift fused with the first forward pass (stages 0 .. K-1, hl = N >>
// K, item (lev, g) at positions g + m hl): digit `lev` of position t read
// from dsl of its owner, CTA r P + (t >> log_s), lifted mod p and twisted
template <int K>
__device__ void cluster_lift(uint32_t* dig, uint32_t dsl_sa, int r, int P,
                             int levels, int log_n, int log_s,
                             const uint32_t* __restrict__ tb, uint32_t p) {
    const int N = 1 << log_n;
    const int log_hl = log_n - K;
    #pragma unroll 1
    for (int u = threadIdx.x; u < levels << log_hl; u += blockDim.x) {
        const int lev = u >> log_hl;
        const int g = u & ((1 << log_hl) - 1);
        uint32_t v[1 << K];
        #pragma unroll
        for (int m = 0; m < (1 << K); ++m) {
            const int t = g + (m << log_hl);
            const int o = t >> log_s;
            const int32_t d = (int32_t)wg::ld_cluster_u32(wg::mapa(
                dsl_sa + 4u * (uint32_t)((lev << log_s) + t - (o << log_s)),
                (uint32_t)(r * P + o)));
            const uint32_t m_res =
                d < 0 ? (uint32_t)(d + (int32_t)p) : (uint32_t)d;
            v[m] = brk::shoup_mul(m_res, __ldg(tb + brk::T_TW * N + t),
                                  __ldg(tb + brk::T_TW_SH * N + t), p);
        }
        brk::fwd_regs<K>(v, tb, N, 0, g, log_hl, p);
        const int base = lev * N + g;
        #pragma unroll
        for (int m = 0; m < (1 << K); ++m)
            dig[brk::swz(base + (m << log_hl))] = v[m];
    }
    __syncthreads();
}

// H = 2, B: the lift fused with stages 0 .. 3 on half h (hl = N >> 4,
// item (lev, g) at positions g + m hl, m < 8, and their partners g + m hl
// + N/2): both digits of each pair (t, t + N/2) read from its owner, CTA
// o / P, r, o % P (o = t >> log_s), at the pair's two slots there, lifted
// mod p and twisted; stage 0 (twiddle index t) kept for half h only: the
// sums (h = 0) or the twiddled differences (h = 1); then stages 1 .. 3,
// written to the half at g + m hl.
__device__ void split_lift(uint32_t* dig, uint32_t dsl_sa, int h, int r,
                           int P, int R, int levels, int log_n, int log_s,
                           const uint32_t* __restrict__ tb, uint32_t p) {
    constexpr int K = 4, E = 8;
    const int N = 1 << log_n;
    const int M = N >> 1;
    const int log_hl = log_n - K;
    #pragma unroll 1
    for (int u = threadIdx.x; u < levels << log_hl; u += blockDim.x) {
        const int lev = u >> log_hl;
        const int g = u & ((1 << log_hl) - 1);
        uint32_t v[E];
        #pragma unroll
        for (int m = 0; m < E; ++m) {
            const int t = g + (m << log_hl);
            const int o = t >> log_s;
            const uint32_t at = wg::mapa(
                dsl_sa + 2u * (uint32_t)((lev << (log_s + 1)) + t
                                         - (o << log_s)),
                (uint32_t)((o / P) * P * R + r * P + o % P));
            uint32_t x[2];
            #pragma unroll
            for (int k = 0; k < 2; ++k) {
                const int32_t d = wg::ld_cluster_s16(at + 2u * (k << log_s));
                const uint32_t m_res =
                    d < 0 ? (uint32_t)(d + (int32_t)p) : (uint32_t)d;
                const int tk = t + k * M;
                x[k] = brk::shoup_mul(m_res, __ldg(tb + brk::T_TW * N + tk),
                                      __ldg(tb + brk::T_TW_SH * N + tk), p);
            }
            v[m] = h == 0
                ? brk::add_mod(x[0], x[1], p)
                : brk::shoup_mul(x[0] - x[1] + p,
                                 __ldg(tb + brk::T_FWD * N + t),
                                 __ldg(tb + brk::T_FWD_SH * N + t), p);
        }
        brk::fwd_regs<3>(v, tb, N, 1, g, log_hl, p);
        const int base = (lev << (log_n - 1)) + g;
        #pragma unroll
        for (int m = 0; m < E; ++m)
            dig[brk::swz(base + (m << log_hl))] = v[m];
    }
    __syncthreads();
}

// The streamed split, B: split_lift of digit level `lev` alone, its
// digits (int16, or int8 where dw = 1) read from their owners, into the
// transform buffer, dig row R.
__device__ void stream_lift(uint32_t* dig, uint32_t dsl_sa, int h, int r,
                            int P, int R, int lev, int dw, int log_n,
                            int log_s, const uint32_t* __restrict__ tb,
                            uint32_t p) {
    constexpr int K = 4, E = 8;
    const int N = 1 << log_n;
    const int M = N >> 1;
    const int log_hl = log_n - K;
    #pragma unroll 1
    for (int g = threadIdx.x; g < 1 << log_hl; g += blockDim.x) {
        uint32_t v[E];
        #pragma unroll
        for (int m = 0; m < E; ++m) {
            const int t = g + (m << log_hl);
            const int o = t >> log_s;
            const uint32_t at = wg::mapa(
                dsl_sa + (uint32_t)(dw * ((lev << (log_s + 1)) + t
                                          - (o << log_s))),
                (uint32_t)((o / P) * P * R + r * P + o % P));
            uint32_t x[2];
            #pragma unroll
            for (int k = 0; k < 2; ++k) {
                const uint32_t a = at + (uint32_t)(dw * (k << log_s));
                const int32_t d =
                    dw == 1 ? wg::ld_cluster_s8(a) : wg::ld_cluster_s16(a);
                const uint32_t m_res =
                    d < 0 ? (uint32_t)(d + (int32_t)p) : (uint32_t)d;
                const int tk = t + k * M;
                x[k] = brk::shoup_mul(m_res, __ldg(tb + brk::T_TW * N + tk),
                                      __ldg(tb + brk::T_TW_SH * N + tk), p);
            }
            v[m] = h == 0
                ? brk::add_mod(x[0], x[1], p)
                : brk::shoup_mul(x[0] - x[1] + p,
                                 __ldg(tb + brk::T_FWD * N + t),
                                 __ldg(tb + brk::T_FWD_SH * N + t), p);
        }
        brk::fwd_regs<3>(v, tb, N, 1, g, log_hl, p);
        const int base = (R << (log_n - 1)) + g;
        #pragma unroll
        for (int m = 0; m < E; ++m)
            dig[brk::swz(base + (m << log_hl))] = v[m];
    }
    __syncthreads();
}

// H = 2: forward or inverse stages s0 .. s0+K-1 (s0 >= 1) of rows row0 ..
// row0 + rows - 1 of a CTA's half [.][N/2] (swizzled as one area: a row
// of N/2 words need not start a swizzle block). From stage 1 on a half is closed
// under the stages, and a position's twiddle index, its offset mod the
// stride, is the same in the half as in the polynomial: the items are
// StepPasses::pass's on N/2 positions, the twiddles the N-long tables'.
template <int K, bool Inverse>
__device__ void half_pass(uint32_t* x, int row0, int rows, int log_n,
                          int s0, const uint32_t* __restrict__ tb,
                          uint32_t p) {
    const int N = 1 << log_n;
    const int log_m = log_n - 1;
    const int log_g = log_m - K;
    const int log_hl = log_n - s0 - K;
    #pragma unroll 1
    for (int u = threadIdx.x; u < rows << log_g; u += blockDim.x) {
        const int row = u >> log_g;
        const int g = u & ((1 << log_g) - 1);
        int j;
        const int base =
            ((row0 + row) << log_m) + brk::item_origin<K>(g, log_hl, &j);
        uint32_t v[1 << K];
        #pragma unroll
        for (int m = 0; m < (1 << K); ++m)
            v[m] = x[brk::swz(base + (m << log_hl))];
        if (Inverse)
            brk::inv_regs<K>(v, tb, N, s0, j, log_hl, p);
        else
            brk::fwd_regs<K>(v, tb, N, s0, j, log_hl, p);
        #pragma unroll
        for (int m = 0; m < (1 << K); ++m)
            x[brk::swz(base + (m << log_hl))] = v[m];
    }
    __syncthreads();
}

template <bool Inverse>
__device__ void half_pass_k(int k, uint32_t* x, int row0, int rows,
                            int log_n, int s0,
                            const uint32_t* __restrict__ tb, uint32_t p) {
    if (k == 1)
        half_pass<1, Inverse>(x, row0, rows, log_n, s0, tb, p);
    else if (k == 2)
        half_pass<2, Inverse>(x, row0, rows, log_n, s0, tb, p);
    else
        half_pass<3, Inverse>(x, row0, rows, log_n, s0, tb, p);
}

// B, the last two forward stages fused with the MAC: item g holds
// positions 4g .. 4g + 3 of the CTA's share of a polynomial (N >> (H - 1)
// words a row); per digit level the two stages, then for every output row
// c, mac[c] += dig[lev] key[lev R + r][c] mod p; mac[c] written over dig
// row c. key: the step's residues [P][l R][R][N] (the duals P l R R N words
// on: classic) or the ciphertext's bundle (Bundle), from the CTA's first
// position on.
template <bool Bundle, int H>
__device__ void cluster_mac(uint32_t* dig, const uint32_t* __restrict__ key,
                            int pi, int r, int R, int levels, int P,
                            int log_n, const uint32_t* __restrict__ tb,
                            uint32_t p, uint64_t mu) {
    constexpr int F = 2, E = 4;
    const int N = 1 << log_n;
    const int M = N >> (H - 1);
    const int lR = levels * R;
    const int s0 = log_n - F;
    const long long duals = (long long)P * lR * R * N;
    #pragma unroll 1
    for (int g = threadIdx.x; g < M >> F; g += blockDim.x) {
        const int t0 = g << F;
        uint32_t mac[kClusterRowsMax][E];
        #pragma unroll
        for (int c = 0; c < kClusterRowsMax; ++c)
            #pragma unroll
            for (int m = 0; m < E; ++m) mac[c][m] = 0;
        #pragma unroll 1
        for (int lev = 0; lev < levels; ++lev) {
            uint32_t d[E];
            brk::lds_run<E>(dig, lev * M + t0, d);
            brk::fwd_regs<F>(d, tb, N, s0, 0, 0, p);
            const uint32_t* kr =
                key + ((long long)(pi * lR + lev * R + r) * R) * N + t0;
            #pragma unroll
            for (int c = 0; c < kClusterRowsMax; ++c) {
                if (c >= R) break;
                uint32_t w[E];
                brk::ldg_run<E>(kr + (long long)c * N, w);
                if constexpr (Bundle) {
                    #pragma unroll
                    for (int m = 0; m < E; ++m)
                        mac[c][m] = brk::add_mod(
                            mac[c][m], mul_mod(d[m], w[m], p, mu), p);
                } else {
                    uint32_t ws[E];
                    brk::ldg_run<E>(kr + duals + (long long)c * N, ws);
                    #pragma unroll
                    for (int m = 0; m < E; ++m)
                        mac[c][m] = brk::add_mod(
                            mac[c][m], brk::shoup_mul(d[m], w[m], ws[m], p),
                            p);
                }
            }
        }
        #pragma unroll
        for (int c = 0; c < kClusterRowsMax; ++c) {
            if (c >= R) break;
            brk::sts_run<E>(dig, c * M + t0, mac[c]);
        }
    }
}

// The streamed split, B: cluster_mac of digit level `lev` alone, its
// transform in dig row R: per item the two stages, then for every output
// row c its products against key row lev R + r written (lev = 0) or added
// (mod p) into the partial, dig row c. An item's positions are the same
// thread's at every level, so the partials need no barrier between
// levels; the transform buffer does (the caller's, before the next lift).
template <bool Bundle>
__device__ void stream_mac(uint32_t* dig, const uint32_t* __restrict__ key,
                           int pi, int r, int R, int levels, int lev, int P,
                           int log_n, const uint32_t* __restrict__ tb,
                           uint32_t p, uint64_t mu) {
    constexpr int F = 2, E = 4;
    const int N = 1 << log_n;
    const int M = N >> 1;
    const int lR = levels * R;
    const int s0 = log_n - F;
    const long long duals = (long long)P * lR * R * N;
    const uint32_t* kr = key + ((long long)(pi * lR + lev * R + r) * R) * N;
    #pragma unroll 1
    for (int g = threadIdx.x; g < M >> F; g += blockDim.x) {
        const int t0 = g << F;
        uint32_t d[E];
        brk::lds_run<E>(dig, R * M + t0, d);
        brk::fwd_regs<F>(d, tb, N, s0, 0, 0, p);
        #pragma unroll
        for (int c = 0; c < kClusterRowsMax; ++c) {
            if (c >= R) break;
            uint32_t w[E], s[E];
            brk::ldg_run<E>(kr + (long long)c * N + t0, w);
            if constexpr (Bundle) {
                #pragma unroll
                for (int m = 0; m < E; ++m) s[m] = mul_mod(d[m], w[m], p, mu);
            } else {
                uint32_t ws[E];
                brk::ldg_run<E>(kr + duals + (long long)c * N + t0, ws);
                #pragma unroll
                for (int m = 0; m < E; ++m)
                    s[m] = brk::shoup_mul(d[m], w[m], ws[m], p);
            }
            if (lev > 0) {
                uint32_t a[E];
                brk::lds_run<E>(dig, c * M + t0, a);
                #pragma unroll
                for (int m = 0; m < E; ++m) s[m] = brk::add_mod(a[m], s[m], p);
            }
            brk::sts_run<E>(dig, c * M + t0, s);
        }
    }
}

// C, the first inverse pass (stages log_n - 1, log_n - 2, item g at 4g ..
// 4g + 3) on row r: dig row r plus row r of every CTA (h, pi, q), q != r,
// the R partials of output row r, then the two stages
template <int H>
__device__ void cluster_sum(uint32_t* dig, uint32_t dig_sa, int h, int pi,
                            int r, int R, int P, int log_n,
                            const uint32_t* __restrict__ tb, uint32_t p) {
    constexpr int F = 2, E = 4;
    const int N = 1 << log_n;
    const int M = N >> (H - 1);
    const int s0 = log_n - F;
    #pragma unroll 1
    for (int g = threadIdx.x; g < M >> F; g += blockDim.x) {
        const int t0 = g << F;
        uint32_t v[E];
        brk::lds_run<E>(dig, r * M + t0, v);
        const uint32_t at = dig_sa + 4u * (uint32_t)brk::swz(r * M + t0);
        #pragma unroll 1
        for (int q = 0; q < R; ++q) {
            if (q == r) continue;
            const uint4 w = wg::ld_cluster_v4(wg::mapa(
                at, (uint32_t)((H == 1 ? 0 : h * P * R) + q * P + pi)));
            v[0] = brk::add_mod(v[0], w.x, p);
            v[1] = brk::add_mod(v[1], w.y, p);
            v[2] = brk::add_mod(v[2], w.z, p);
            v[3] = brk::add_mod(v[3], w.w, p);
        }
        brk::inv_regs<F>(v, tb, N, s0, 0, 0, p);
        brk::sts_run<E>(dig, r * M + t0, v);
    }
    __syncthreads();
}

// C, the last inverse pass (stages K-1 .. 0, hl = N >> K) of row x with the
// untwist: canonical residues in place
template <int K>
__device__ void cluster_untwist(uint32_t* x, int log_n,
                                const uint32_t* __restrict__ tb, uint32_t p) {
    const int N = 1 << log_n;
    const int log_hl = log_n - K;
    #pragma unroll 1
    for (int g = threadIdx.x; g < 1 << log_hl; g += blockDim.x) {
        uint32_t v[1 << K];
        #pragma unroll
        for (int m = 0; m < (1 << K); ++m)
            v[m] = x[brk::swz(g + (m << log_hl))];
        brk::inv_regs<K>(v, tb, N, 0, g, log_hl, p);
        #pragma unroll
        for (int m = 0; m < (1 << K); ++m) {
            const int t = g + (m << log_hl);
            x[brk::swz(t)] = brk::shoup_mul(v[m], __ldg(tb + brk::T_UTW * N + t),
                                            __ldg(tb + brk::T_UTW_SH * N + t),
                                            p);
        }
    }
}

// H = 2, D: Garner on the CTA's pairs (t, t + N/2), t in [base, base +
// len), two consecutive t a thread: for each prime q, row r's pre-final
// values at t from CTAs (0, q, r) and (1, q, r), the last inverse stage
// (stage 0: t + N/2 with twiddle index t) and the untwist of both
// positions mod p_q; then the tail of each position's P residues, added
// to acc in global memory (classic) or in its place (Bundle).
template <class Tail, bool Bundle>
__device__ void split_garner(typename Tail::Acc* acc, uint32_t dig_sa,
                             int r, int R, int base, int len, int log_n,
                             const uint32_t* __restrict__ tables,
                             const WidePrimes& pr, const Tail& tail) {
    using Acc = typename Tail::Acc;
    constexpr int P = Tail::P;
    const int N = 1 << log_n;
    const int M = N >> 1;
    #pragma unroll 1
    for (int i = 2 * threadIdx.x; i < len; i += 2 * blockDim.x) {
        const int t = base + i;
        const uint32_t at = dig_sa + 4u * (uint32_t)brk::swz(r * M + t);
        uint32_t y[2][P][2];  // [position t, t + N/2][prime][t, t + 1]
        #pragma unroll
        for (int q = 0; q < P; ++q) {
            const uint32_t p = pr.p[q];
            const uint32_t* tb = tables + (long long)q * brk::T_COUNT * N;
            const uint64_t x0 = wg::ld_cluster_u64(
                wg::mapa(at, (uint32_t)(r * P + q)));
            const uint64_t x1 = wg::ld_cluster_u64(
                wg::mapa(at, (uint32_t)(P * R + r * P + q)));
            #pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int te = t + e;
                const uint32_t u = (uint32_t)(x0 >> (32 * e));
                const uint32_t bw = brk::shoup_mul(
                    (uint32_t)(x1 >> (32 * e)),
                    __ldg(tb + brk::T_INV * N + te),
                    __ldg(tb + brk::T_INV_SH * N + te), p);
                y[0][q][e] = brk::shoup_mul(
                    brk::add_mod(u, bw, p), __ldg(tb + brk::T_UTW * N + te),
                    __ldg(tb + brk::T_UTW_SH * N + te), p);
                y[1][q][e] = brk::shoup_mul(
                    brk::add_mod(u, p - bw, p),
                    __ldg(tb + brk::T_UTW * N + M + te),
                    __ldg(tb + brk::T_UTW_SH * N + M + te), p);
            }
        }
        #pragma unroll
        for (int k = 0; k < 2; ++k)
            #pragma unroll
            for (int e = 0; e < 2; ++e) {
                uint32_t m[P];
                #pragma unroll
                for (int q = 0; q < P; ++q) m[q] = y[k][q][e];
                const Acc inc = tail(m);
                Acc* a = acc + k * M + t + e;
                *a = Bundle ? inc : Acc(*a + inc);
            }
    }
}

// The cluster kernel. Grid: B H P R CTAs in clusters of H P R, ciphertext
// b = blockIdx.x / (H P R), rank h P R + r P + pi. acc_in, acc_out: Acc [B,
// R, N]; classic: a_ms i32 [B, n_steps] in [0, 2N), key u32 [n_steps, 2,
// P, l R, R, N] (step i at i key_step); Bundle: key the bundles u32 [B,
// n_steps, P, l R, R, N] (ciphertext b at b key_b, step tt at tt
// key_step). The prime, its Barrett constant and the decomposer are read
// or built where used, which keeps the step loop's live registers within
// 64.
//
// H = 2 (the split): CTA (h, pi, r) holds half h, coefficients [h N/2,
// (h+1) N/2), of each transform of row r mod p_pi: a DIF transform's stage
// 0 is the only forward stage, and a DIT inverse's stage 0 the only
// inverse one, that pairs the halves. The lift reads both digits of a
// pair and keeps its half of stage 0; phase D gathers both halves of the
// pre-final values and runs stage 0 and the untwist there. CTA o = h P +
// pi of row r owns the pairs (t, t + N/2), t in [o S, o S + S): their acc
// words stay in global memory (acc_out: read in A, written in D; the
// cluster barriers order them), their digits in dsl [l][2 S] i16.
//
// Design: 1, the cluster kernel (H = 1); 2, the split (H = 2); 3, the
// split with its levels streamed (H = 2; dig [R + 1][N/2], the digits
// int16 or, where split_digit_bytes says, int8, read by one lift of a
// run-time width: a lift instantiated for each width spilled). Its CTA
// takes more than half an SM's shared memory, so it runs one CTA an SM
// and takes that SM's registers (128 a thread): at 64 it spills.
template <class Tail, bool Bundle, int Design>
__global__ void __launch_bounds__(kClusterThreads,
                                  Design == 3 ? 1 : brk::min_blocks(Tail::P))
wide_cluster_kernel(const typename Tail::Acc* __restrict__ acc_in,
                    typename Tail::Acc* __restrict__ acc_out,
                    const int32_t* __restrict__ a_ms,
                    const uint32_t* __restrict__ key, long long key_b,
                    long long key_step, int n_steps,
                    const uint32_t* __restrict__ tables, int R, int levels,
                    int base_log, int log_n,
                    const __grid_constant__ WidePlan pl,
                    const __grid_constant__ WidePrimes pr,
                    const __grid_constant__ Tail tail) {
    using Acc = typename Tail::Acc;
    constexpr int P = Tail::P;
    constexpr int H = Design == 1 ? 1 : 2;
    constexpr bool Stream = Design == 3;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __shared__ uint32_t s_p[1];
    __shared__ uint64_t s_mu[1];
    const int N = 1 << log_n;
    const int M = N >> (H - 1);  // a CTA's share of a polynomial
    const int log_s = cluster_log_slice(log_n, P, H);
    const int S = 1 << log_s;
    const int rows = Stream ? R + 1 : cluster_rows(R, levels);
    uint32_t* dig = reinterpret_cast<uint32_t*>(smem_raw);
    Acc* acc = reinterpret_cast<Acc*>(dig + rows * M);
    int32_t* dsl = reinterpret_cast<int32_t*>(acc + S);
    int16_t* dsl16 = reinterpret_cast<int16_t*>(dig + rows * M);
    int8_t* dsl8 = reinterpret_cast<int8_t*>(dsl16);
    const bool d8 =
        Stream && split_digit_bytes(R, levels, log_n, P) == 1;
    const int rank = (int)wg::cluster_rank();
    const int pi = rank % P;
    const int r = H == 1 ? rank / P : (rank / P) % R;
    const int h = H == 1 ? 0 : rank / (P * R);
    const long long b = blockIdx.x / (H * P * R);
    if (threadIdx.x == 0) {
        s_p[0] = pr.p[pi];
        s_mu[0] = pr.mu[pi];
    }
    const uint32_t* tb = tables + (long long)pi * brk::T_COUNT * N;
    const int base = (h * P + pi) << log_s;  // my slice: [base, base + len)
    const int len = M - base < S ? (M - base > 0 ? M - base : 0) : S;
    const long long row = (b * R + r) * N + base;
    Acc* accg = acc_out + (b * R + r) * N;  // H = 2: row r in global memory
    if constexpr (H == 1) {
        for (int u = threadIdx.x; u < len; u += blockDim.x)
            acc[u] = acc_in[row + u];
    } else {
        for (int u = threadIdx.x; u < len; u += blockDim.x) {
            accg[base + u] = acc_in[row + u];
            accg[M + base + u] = acc_in[row + M + u];
        }
    }
    const uint32_t acc_sa = wg::smem_u32(acc), dsl_sa = wg::smem_u32(dsl),
                   dig_sa = wg::smem_u32(dig);
    // every CTA of the cluster runs before any DSMEM access
    wg::cluster_sync<false>();

    #pragma unroll 1
    for (int step = 0; step < n_steps; ++step) {
        // A. the digits of my slice (H = 2: of my pairs' 2 S positions,
        // position k N/2 + base + i at slot k S + i)
        {
            const int a = Bundle ? 0 : a_ms[b * n_steps + step];
            const typename brk::DecomposerOf<Tail>::type dec(base_log,
                                                             levels);
            const int lim = H == 1 ? len : 2 << log_s;
            #pragma unroll 1
            for (int u = threadIdx.x; u < lim; u += blockDim.x) {
                const int i = H == 1 ? u : u & (S - 1);
                if (H == 2 && i >= len) continue;
                const int t = H == 1 ? base + u
                                     : ((u >> log_s) * M) + base + i;
                Acc v = H == 1 ? acc[u] : accg[t];
                if (!Bundle) {
                    int s = t - a;
                    if (s < 0) s += 2 * N;
                    const bool neg = s >= N;
                    if (neg) s -= N;
                    Acc y;
                    if constexpr (H == 1) {
                        const int o = s >> log_s;
                        y = ld_cluster<Acc>(wg::mapa(
                            acc_sa
                                + (uint32_t)(sizeof(Acc) * (s - (o << log_s))),
                            (uint32_t)(r * P + o)));
                    } else {
                        y = accg[s];
                    }
                    if (neg) y = Acc(0) - y;
                    v = Acc(y - v);
                }
                auto state = dec.init_word(v);
                #pragma unroll 1
                for (int lev = 0; lev < levels; ++lev) {
                    if constexpr (H == 1) {
                        dsl[(lev << log_s) + u] = dec.next(state);
                    } else if constexpr (Stream) {
                        const int32_t d = dec.next(state);
                        if (d8)
                            dsl8[(lev << (log_s + 1)) + u] = (int8_t)d;
                        else
                            dsl16[(lev << (log_s + 1)) + u] = (int16_t)d;
                    } else {
                        dsl16[(lev << (log_s + 1)) + u] =
                            (int16_t)dec.next(state);
                    }
                }
            }
        }
        wg::cluster_sync<false>();

        // B. lift, forward passes, MAC (the first of the passes over the
        // 6..12 stages below the MAC's holds 3 stages at every log_n of the
        // envelope; the last inverse pass 2 or 3)
        if constexpr (H == 1) {
            cluster_lift<3>(dig, dsl_sa, r, P, levels, log_n, log_s, tb,
                            s_p[0]);
            #pragma unroll
            for (int i = 1; i + 1 < brk::kMaxPasses; ++i)
                if (i + 1 < pl.n_fwd)
                    Passes1::pass_k<false>(pl.fwd_k[i], dig, levels, log_n,
                                           pl.fwd_s0[i], tb, s_p);
        } else if constexpr (Stream) {
            // a level at a time through the transform buffer, dig row R,
            // into the R partials, dig rows 0 .. R-1
            const uint32_t* kb = key + b * key_b + step * key_step + h * M;
            #pragma unroll 1
            for (int lev = 0; lev < levels; ++lev) {
                stream_lift(dig, wg::smem_u32(dsl16), h, r, P, R, lev,
                            d8 ? 1 : 2, log_n, log_s, tb, s_p[0]);
                #pragma unroll
                for (int i = 1; i + 1 < brk::kMaxPasses; ++i)
                    if (i + 1 < pl.n_fwd)
                        half_pass_k<false>(pl.fwd_k[i], dig, R, 1, log_n,
                                           pl.fwd_s0[i], tb, s_p[0]);
                stream_mac<Bundle>(dig, kb, pi, r, R, levels, lev, P, log_n,
                                   tb, s_p[0], s_mu[0]);
                __syncthreads();
            }
        } else {
            split_lift(dig, wg::smem_u32(dsl16), h, r, P, R, levels, log_n,
                       log_s, tb, s_p[0]);
            #pragma unroll
            for (int i = 1; i + 1 < brk::kMaxPasses; ++i)
                if (i + 1 < pl.n_fwd)
                    half_pass_k<false>(pl.fwd_k[i], dig, 0, levels, log_n,
                                       pl.fwd_s0[i], tb, s_p[0]);
        }
        if constexpr (!Stream)
            cluster_mac<Bundle, H>(dig,
                                   key + b * key_b + step * key_step + h * M,
                                   pi, r, R, levels, P, log_n, tb, s_p[0],
                                   s_mu[0]);
        wg::cluster_sync<false>();

        // C. the partials summed, the inverse passes, the untwist (H = 2:
        // down to stage 1)
        cluster_sum<H>(dig, dig_sa, h, pi, r, R, P, log_n, tb, s_p[0]);
        if constexpr (H == 1) {
            uint32_t* x = dig + r * N;
            #pragma unroll
            for (int i = 1; i + 1 < brk::kMaxPasses; ++i)
                if (i + 1 < pl.n_inv)
                    Passes1::pass_k<true>(pl.inv_k[i], x, 1, log_n,
                                          pl.inv_s0[i], tb, s_p);
            if (pl.inv_k[pl.n_inv - 1] == 2)
                cluster_untwist<2>(x, log_n, tb, s_p[0]);
            else
                cluster_untwist<3>(x, log_n, tb, s_p[0]);
        } else {
            #pragma unroll
            for (int i = 1; i < brk::kMaxPasses; ++i)
                if (i < pl.n_inv)
                    half_pass_k<true>(pl.inv_k[i], dig, r, 1, log_n,
                                      pl.inv_s0[i], tb, s_p[0]);
        }
        wg::cluster_sync<false>();

        // D. Garner: my slice's residues from CTAs (., r), 4 coefficients a
        // thread (H = 2: split_garner)
        if constexpr (H == 1) {
            #pragma unroll 1
            for (int u = 4 * threadIdx.x; u < len; u += 4 * blockDim.x) {
                const uint32_t at =
                    dig_sa + 4u * (uint32_t)brk::swz(r * N + base + u);
                uint32_t m4[P][4];
                #pragma unroll
                for (int q = 0; q < P; ++q) {
                    const uint4 w =
                        wg::ld_cluster_v4(wg::mapa(at, (uint32_t)(r * P + q)));
                    m4[q][0] = w.x; m4[q][1] = w.y; m4[q][2] = w.z; m4[q][3] = w.w;
                }
                #pragma unroll
                for (int e = 0; e < 4; ++e) {
                    uint32_t m[P];
                    #pragma unroll
                    for (int q = 0; q < P; ++q) m[q] = m4[q][e];
                    const Acc inc = tail(m);
                    acc[u + e] = Bundle ? inc : Acc(acc[u + e] + inc);
                }
            }
        } else {
            split_garner<Tail, Bundle>(accg, dig_sa, r, R, base, len, log_n,
                                       tables, pr, tail);
        }
        wg::cluster_sync<false>();
    }
    if constexpr (H == 1)
        for (int u = threadIdx.x; u < len; u += blockDim.x)
            acc_out[row + u] = acc[u];
}

// Whether the streamed split is instantiated for this tail and entry: on
// the u64 accumulator at 3 or more primes (cluster_fits refuses the acc32
// entries and 2 primes where the split streams: 2 primes cannot hold an
// N = 32768 product), and for the multi-bit entry at its 4 primes only
// (the wrapper's MB_PRIMES)
template <class Tail, bool Bundle>
constexpr bool has_stream() {
    return sizeof(typename Tail::Acc) == 8 && Tail::P >= 3
           && (!Bundle || Tail::P == brk::kDeepPrimes);
}

// The cluster kernel's instantiation at split H and this shape: H = 1;
// at H = 2 the split, or, where a CTA holding all l digit transforms
// exceeds a block (split_streams), the split with its levels streamed.
template <class Tail, bool Bundle, int H>
auto cluster_kernel_for(int R, int levels, int log_n) {
    if constexpr (H == 2 && has_stream<Tail, Bundle>()) {
        if (split_streams(R, levels, log_n, Tail::P))
            return wide_cluster_kernel<Tail, Bundle, 3>;
    }
    return wide_cluster_kernel<Tail, Bundle, H>;
}

// Launch the cluster kernel at split H on B ciphertexts: grid B H P R,
// clusters of H P R (16 at H = 2 at the universe's shapes: beyond the
// portable 8, allowed on the kernel first). Returns the launch's error (0
// = launched), or cudaErrorInvalidValue for a shape it does not take.
template <class Tail, bool Bundle, int H>
int launch_cluster(const typename Tail::Acc* acc_in,
                   typename Tail::Acc* acc_out, const int32_t* a_ms,
                   const uint32_t* key, long long key_b, long long key_step,
                   const uint32_t* tables, int B, int n_steps, int R,
                   int levels, int base_log, int log_n, const Tail& tail,
                   const unsigned long long* mu, cudaStream_t stream) {
    using Acc = typename Tail::Acc;
    constexpr int P = Tail::P;
    if (!cluster_fits(R, levels, base_log, log_n, P, (int)sizeof(Acc), H)
        || (H == 2 && !has_stream<Tail, Bundle>()
            && split_streams(R, levels, log_n, P))
        || B < 1 || (long long)B * H * P * R > 0x7fffffffLL || n_steps < 1)
        return (int)cudaErrorInvalidValue;
    auto kernel = cluster_kernel_for<Tail, Bundle, H>(R, levels, log_n);
    const size_t smem =
        cluster_smem(R, levels, log_n, P, (int)sizeof(Acc), H);
    cudaError_t err = allow_smem(kernel, smem);
    if (err == cudaSuccess && H * P * R > kClusterMax)
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    WidePrimes pr{};
    for (int i = 0; i < P; ++i) {
        pr.p[i] = tail.p[i];
        pr.mu[i] = mu ? mu[i] : 0ull;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(B * H * P * R));
    cfg.blockDim = dim3(kClusterThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = H * P * R;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, acc_in, acc_out, a_ms, key, key_b,
                             key_step, n_steps, tables, R, levels, base_log,
                             log_n,
                             H == 1 ? make_cluster_plan(log_n)
                                    : make_split_plan(log_n),
                             pr, tail);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

template <template <int> class Tail, int H>
int cluster_classic(const void* acc_in, void* acc_out, const void* a_ms,
                    const void* bsk, const void* tables, int B, int n_steps,
                    int R, int levels, int base_log, int log_n,
                    int num_primes, const unsigned* garner,
                    unsigned long long full_prod, void* stream) {
    return for_tail<Tail>(num_primes, base_log, levels, [&](auto t) {
        using T = decltype(t);
        using Acc = typename T::Acc;
        brk::fill_garner(t, garner, full_prod);
        const long long key_step = 2LL * T::P * levels * R * R << log_n;
        return launch_cluster<T, false, H>(
            (const Acc*)acc_in, (Acc*)acc_out, (const int32_t*)a_ms,
            (const uint32_t*)bsk, 0, key_step, (const uint32_t*)tables, B,
            n_steps, R, levels, base_log, log_n, t, nullptr,
            (cudaStream_t)stream);
    });
}

template <int H>
int cluster_multi_bit(const void* acc_in, void* acc_out, const void* bundles,
                      const void* tables, int B, int count, int R, int levels,
                      int base_log, int log_n, int num_primes,
                      const unsigned* garner, unsigned long long full_prod,
                      const unsigned long long* mu, void* stream) {
    return for_tail<GarnerTail>(num_primes, base_log, levels, [&](auto t) {
        using T = decltype(t);
        brk::fill_garner(t, garner, full_prod);
        const long long key_step = (long long)T::P * levels * R * R << log_n;
        return launch_cluster<T, true, H>(
            (const uint64_t*)acc_in, (uint64_t*)acc_out, nullptr,
            (const uint32_t*)bundles, count * key_step, key_step,
            (const uint32_t*)tables, B, count, R, levels, base_log, log_n, t,
            mu, (cudaStream_t)stream);
    });
}

// The classic u64 cluster kernel at split H and this shape (at H = 2 the
// instantiation the shape takes, cluster_kernel_for): out[0..5] =
// registers and local (spill) bytes a thread, dynamic shared memory,
// cluster size, resident CTAs per SM and clusters resident on the card
// (cudaOccupancyMaxActiveClusters). Returns 0, a negative CUDA error, or 1
// for a shape it does not take.
template <int H>
int cluster_occupancy(int num_primes, int R, int levels, int log_n,
                      int* out) {
    if (!cluster_fits(R, levels, 1, log_n, num_primes, 8, H)) return 1;
    return for_primes<GarnerTail>(num_primes, [&](auto t) {
        using T = decltype(t);
        auto kernel = cluster_kernel_for<T, false, H>(R, levels, log_n);
        const size_t smem = cluster_smem(R, levels, log_n, T::P, 8, H);
        const int ctas = H * T::P * R;
        cudaFuncAttributes attr;
        cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
        if (err != cudaSuccess) return -(int)err;
        out[0] = attr.numRegs;
        out[1] = (int)attr.localSizeBytes;
        out[2] = (int)smem;
        out[3] = ctas;
        err = allow_smem(kernel, smem);
        if (err == cudaSuccess && ctas > kClusterMax)
            err = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (err != cudaSuccess) return -(int)err;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &out[4], kernel, kClusterThreads, smem);
        if (err != cudaSuccess) return -(int)err;
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3((unsigned)(ctas * 64));
        cfg.blockDim = dim3(kClusterThreads);
        cfg.dynamicSmemBytes = smem;
        cudaLaunchAttribute a;
        a.id = cudaLaunchAttributeClusterDimension;
        a.val.clusterDim.x = ctas;
        a.val.clusterDim.y = 1;
        a.val.clusterDim.z = 1;
        cfg.attrs = &a;
        cfg.numAttrs = 1;
        err = cudaOccupancyMaxActiveClusters(&out[5], kernel, &cfg);
        return err == cudaSuccess ? 0 : -(int)err;
    });
}

}  // namespace

// K7, classic, on the u64 accumulator (GarnerTail<P>): all n_steps CMUX
// steps of one chunk of Bc ciphertexts, acc updated in place.
// acc: u64 [Bc, R, N]; a_ms: i32 [Bc, n_steps] in [0, 2N); bsk: u32
// [n_steps, 2, P, levels*R, R, N] over the first P PRIMES32 (K3's scan
// layout); tables: u32 [P, 8, N] (ops/pbs_kernel.py::plan_tables);
// digits: u32 scratch [Bc, levels*R, P, N]; res: u32 scratch [Bc, R, P,
// N]; garner: host u32[65] (ops/pbs_kernel.py::garner_constants).
// Returns the first cudaGetLastError() of the 3 n_steps launches (0 =
// launched), or cudaErrorInvalidValue for a shape K7 does not take.
extern "C" int blind_rotate_wide(
        void* acc, const void* a_ms, const void* bsk, const void* tables,
        void* digits, void* res, int Bc, int n_steps, int R, int levels,
        int base_log, int log_n, int num_primes, const unsigned* garner,
        unsigned long long full_prod, void* stream) {
    return wide_classic<GarnerTail>(acc, a_ms, bsk, tables, digits, res, Bc,
                                    n_steps, R, levels, base_log, log_n,
                                    num_primes, garner, full_prod, stream);
}

// K7, classic, acc32 (GarnerTail32<P>, TFHE_V4_ACC=32): acc is the u32 hi
// plane [Bc, R, N] (torus value = acc * 2^32); the rest as
// blind_rotate_wide's.
extern "C" int blind_rotate_wide_acc32(
        void* acc, const void* a_ms, const void* bsk, const void* tables,
        void* digits, void* res, int Bc, int n_steps, int R, int levels,
        int base_log, int log_n, int num_primes, const unsigned* garner,
        unsigned long long full_prod, void* stream) {
    return wide_classic<GarnerTail32>(acc, a_ms, bsk, tables, digits, res,
                                      Bc, n_steps, R, levels, base_log,
                                      log_n, num_primes, garner, full_prod,
                                      stream);
}

// K7, multi-bit (K5b's function): the `count` group steps of one chunk of
// Bc ciphertexts against their key bundles, each step's Garner value
// replacing acc. acc: u64 [Bc, R, N]; bundles: u32 [Bc, count, P,
// levels*R, R, N] (K5a's output); mu: host u64[5], floor(2^64 / p); the
// rest as blind_rotate_wide's.
extern "C" int multi_bit_accumulate_wide(
        void* acc, const void* bundles, const void* tables, void* digits,
        void* res, int Bc, int count, int R, int levels, int base_log,
        int log_n, int num_primes, const unsigned* garner,
        unsigned long long full_prod, const unsigned long long* mu,
        void* stream) {
    if (!wide_fits(R, levels, base_log, log_n, num_primes) || Bc < 1
        || count < 1)
        return (int)cudaErrorInvalidValue;
    return for_tail<GarnerTail>(num_primes, base_log, levels, [&](auto t) {
        using T = decltype(t);
        brk::fill_garner(t, garner, full_prod);
        return run_wide<T, true>(
            (uint64_t*)acc, nullptr, 0, (const uint32_t*)bundles,
            (const uint32_t*)tables, (uint32_t*)digits, (uint32_t*)res, Bc,
            count, R, levels, base_log, log_n, t, mu, (cudaStream_t)stream);
    });
}

// Resident blocks per SM of K7a (stage 0), K7b (1) or K7c (2) at this
// shape (u64 Garner tail at num_primes), with its registers and local
// (spill) bytes per thread; negative: a CUDA error, 0 for a shape K7 does
// not take.
extern "C" int blind_rotate_wide_occupancy(int num_primes, int R, int levels,
                                           int log_n, int stage, int* regs,
                                           int* local_bytes) {
    if (!wide_fits(R, levels, 1, log_n, num_primes)) return 0;
    auto occ = [&](auto kernel, int threads, size_t smem) {
        cudaFuncAttributes attr;
        cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
        if (err != cudaSuccess) return -(int)err;
        *regs = attr.numRegs;
        *local_bytes = (int)attr.localSizeBytes;
        err = allow_smem(kernel, smem);
        if (err != cudaSuccess) return -(int)err;
        int blocks = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                             threads, smem);
        return err == cudaSuccess ? blocks : -(int)err;
    };
    const size_t smem = wide_smem(log_n);
    if (stage == 0)
        return occ(wide_decompose_kernel<uint64_t, true>, kWideThreads, smem);
    if (stage == 1) return occ(wide_mac_kernel<false>, kWideThreads, smem);
    return for_primes<GarnerTail>(num_primes, [&](auto t) {
        return occ(wide_garner_kernel<decltype(t), false>, kGarnerThreads,
                   (size_t)0);
    });
}

// K7, the cluster kernel (wide_cluster_kernel), classic, on the u64
// accumulator (GarnerTail<P>): all n_steps CMUX steps of B ciphertexts in
// one launch, a cluster of P R CTAs a ciphertext. acc_in, acc_out: u64
// [B, R, N]; a_ms, bsk, tables, garner as blind_rotate_wide's. Returns the
// launch's error (0 = launched), or cudaErrorInvalidValue for a shape the
// cluster kernel does not take (blind_rotate_wide_cluster_smem: 0).
extern "C" int blind_rotate_wide_cluster(
        const void* acc_in, void* acc_out, const void* a_ms, const void* bsk,
        const void* tables, int B, int n_steps, int R, int levels,
        int base_log, int log_n, int num_primes, const unsigned* garner,
        unsigned long long full_prod, void* stream) {
    return cluster_classic<GarnerTail, 1>(
        acc_in, acc_out, a_ms, bsk, tables, B, n_steps, R, levels, base_log,
        log_n, num_primes, garner, full_prod, stream);
}

// The cluster kernel, classic, acc32 (GarnerTail32<P>): acc_in, acc_out
// the u32 hi plane [B, R, N]; the rest as blind_rotate_wide_cluster's.
extern "C" int blind_rotate_wide_cluster_acc32(
        const void* acc_in, void* acc_out, const void* a_ms, const void* bsk,
        const void* tables, int B, int n_steps, int R, int levels,
        int base_log, int log_n, int num_primes, const unsigned* garner,
        unsigned long long full_prod, void* stream) {
    return cluster_classic<GarnerTail32, 1>(
        acc_in, acc_out, a_ms, bsk, tables, B, n_steps, R, levels, base_log,
        log_n, num_primes, garner, full_prod, stream);
}

// The cluster kernel, multi-bit (K5b's function): the `count` group steps
// of B ciphertexts against their bundles u32 [B, count, P, levels*R, R, N],
// each step's Garner value replacing acc; mu: host u64[5], floor(2^64 /
// p); the rest as blind_rotate_wide_cluster's.
extern "C" int multi_bit_accumulate_wide_cluster(
        const void* acc_in, void* acc_out, const void* bundles,
        const void* tables, int B, int count, int R, int levels, int base_log,
        int log_n, int num_primes, const unsigned* garner,
        unsigned long long full_prod, const unsigned long long* mu,
        void* stream) {
    return cluster_multi_bit<1>(acc_in, acc_out, bundles, tables, B, count,
                                R, levels, base_log, log_n, num_primes,
                                garner, full_prod, mu, stream);
}

// The split cluster kernel (wide_cluster_kernel at H = 2): a cluster of
// 2 P R CTAs a ciphertext, each holding half of every transform, for the
// shapes one CTA of the cluster kernel cannot hold (N = 32768; N = 16384
// at l = 3), its levels streamed where a CTA holding all l digit
// transforms exceeds a block (N = 32768 at l >= 4; not the _acc32 entry).
// Arguments as blind_rotate_wide_cluster's, its _acc32 and
// multi_bit_accumulate_wide_cluster's; acc_out must not alias acc_in (it
// holds the accumulator between steps).
extern "C" int blind_rotate_wide_split(
        const void* acc_in, void* acc_out, const void* a_ms, const void* bsk,
        const void* tables, int B, int n_steps, int R, int levels,
        int base_log, int log_n, int num_primes, const unsigned* garner,
        unsigned long long full_prod, void* stream) {
    return cluster_classic<GarnerTail, 2>(
        acc_in, acc_out, a_ms, bsk, tables, B, n_steps, R, levels, base_log,
        log_n, num_primes, garner, full_prod, stream);
}

extern "C" int blind_rotate_wide_split_acc32(
        const void* acc_in, void* acc_out, const void* a_ms, const void* bsk,
        const void* tables, int B, int n_steps, int R, int levels,
        int base_log, int log_n, int num_primes, const unsigned* garner,
        unsigned long long full_prod, void* stream) {
    return cluster_classic<GarnerTail32, 2>(
        acc_in, acc_out, a_ms, bsk, tables, B, n_steps, R, levels, base_log,
        log_n, num_primes, garner, full_prod, stream);
}

extern "C" int multi_bit_accumulate_wide_split(
        const void* acc_in, void* acc_out, const void* bundles,
        const void* tables, int B, int count, int R, int levels, int base_log,
        int log_n, int num_primes, const unsigned* garner,
        unsigned long long full_prod, const unsigned long long* mu,
        void* stream) {
    return cluster_multi_bit<2>(acc_in, acc_out, bundles, tables, B, count,
                                R, levels, base_log, log_n, num_primes,
                                garner, full_prod, mu, stream);
}

// Dynamic shared memory of one CTA of the cluster kernel (split 1 or 2;
// at 2, of the instantiation the shape takes) at this shape (acc bytes 8,
// 4 for the acc32 entries), 0 for a shape it does not take (base_log 1:
// any decomposer the shape admits).
extern "C" unsigned long long blind_rotate_wide_cluster_smem(
        int P, int R, int levels, int log_n) {
    return cluster_fits(R, levels, 1, log_n, P, 8)
               ? cluster_smem(R, levels, log_n, P, 8) : 0;
}
extern "C" unsigned long long blind_rotate_wide_cluster_acc32_smem(
        int P, int R, int levels, int log_n) {
    return cluster_fits(R, levels, 1, log_n, P, 4)
               ? cluster_smem(R, levels, log_n, P, 4) : 0;
}
extern "C" unsigned long long multi_bit_accumulate_wide_cluster_smem(
        int P, int R, int levels, int log_n) {
    return blind_rotate_wide_cluster_smem(P, R, levels, log_n);
}
extern "C" unsigned long long blind_rotate_wide_split_smem(
        int P, int R, int levels, int log_n) {
    return cluster_fits(R, levels, 1, log_n, P, 8, 2)
               ? cluster_smem(R, levels, log_n, P, 8, 2) : 0;
}
extern "C" unsigned long long blind_rotate_wide_split_acc32_smem(
        int P, int R, int levels, int log_n) {
    return cluster_fits(R, levels, 1, log_n, P, 4, 2)
               ? cluster_smem(R, levels, log_n, P, 4, 2) : 0;
}
extern "C" unsigned long long multi_bit_accumulate_wide_split_smem(
        int P, int R, int levels, int log_n) {
    return blind_rotate_wide_split_smem(P, R, levels, log_n);
}

// The classic u64 cluster kernel at this shape (split 1, or 2 for the
// _split_ entry): out[0..5] = registers and local (spill) bytes a thread,
// dynamic shared memory, cluster size, resident CTAs per SM and clusters
// resident on the card (cudaOccupancyMaxActiveClusters). Returns 0, a
// negative CUDA error, or 1 for a shape it does not take.
extern "C" int blind_rotate_wide_cluster_occupancy(int num_primes, int R,
                                                   int levels, int log_n,
                                                   int* out) {
    return cluster_occupancy<1>(num_primes, R, levels, log_n, out);
}
extern "C" int blind_rotate_wide_split_occupancy(int num_primes, int R,
                                                 int levels, int log_n,
                                                 int* out) {
    return cluster_occupancy<2>(num_primes, R, levels, log_n, out);
}
