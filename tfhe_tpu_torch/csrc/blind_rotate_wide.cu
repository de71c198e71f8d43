// K7: the exact CRT blind rotation with its accumulator and digits in global
// memory, for Hopper: every classic and multi-bit shape whose accumulator
// and digit transforms, R N 8 + 4 P l R N bytes, exceed one block's shared
// memory (232,448 B), up to N = 32768 (one u32 polynomial, 128 KiB, still
// fits a block).
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
// One CMUX step on a chunk of Bc ciphertexts is three launches:
//   K7a (wide_decompose_kernel), one block a (ciphertext, digit row
//       j = lev R + r, prime): the balanced digit `lev` of the hi word of
//       X^a acc[r] - acc[r] (classic) or of acc[r] itself (multi-bit, whose
//       bundle carries G1's term), lifted mod p and twisted, then the
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
// tail), as K3; the design adds the digits' and residues' round trip
// through L2/HBM, (2 l R + 2 R) P N 4 bytes a ciphertext-step, and three
// launches a step. It is the simple design: a persistent cooperative kernel
// in place of the three launches, and K7c fused into the next step's K7a,
// are later work.

#include "ntt_common.cuh"
#include "tails.cuh"

using brk::GarnerTail;
using brk::GarnerTail32;

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
// = 15), a polynomial within a block's shared memory, the hi-word
// decomposer (base_log * levels <= 31) and the grid's y and z.
bool wide_fits(int R, int levels, int base_log, int log_n, int P) {
    return log_n >= 3 && log_n <= kWideMaxLogN && R >= 1 && levels >= 1
           && base_log >= 1 && base_log * levels <= 31
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
// when Rotate); digits: u32 [Bc, l R, P, N]. Grid (Bc, l R, P).
template <class Acc, bool Rotate>
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
    const brk::HiDecomposer dec(base_log, levels);
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
        int32_t state = dec.init(brk::hi_word(v));
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
    auto k7a = wide_decompose_kernel<Acc, !Bundle>;
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

template <template <int> class Tail>
int wide_classic(void* acc, const void* a_ms, const void* bsk,
                 const void* tables, void* digits, void* res, int Bc,
                 int n_steps, int R, int levels, int base_log, int log_n,
                 int num_primes, const unsigned* garner,
                 unsigned long long full_prod, void* stream) {
    if (!wide_fits(R, levels, base_log, log_n, num_primes) || Bc < 1
        || Bc > 0x7fffffff || n_steps < 1)
        return (int)cudaErrorInvalidValue;
    return for_primes<Tail>(num_primes, [&](auto t) {
        using T = decltype(t);
        brk::fill_garner(t, garner, full_prod);
        return run_wide<T, false>(
            (typename T::Acc*)acc, (const int32_t*)a_ms, n_steps,
            (const uint32_t*)bsk, (const uint32_t*)tables,
            (uint32_t*)digits, (uint32_t*)res, Bc, n_steps, R, levels,
            base_log, log_n, t, nullptr, (cudaStream_t)stream);
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
    return for_primes<GarnerTail>(num_primes, [&](auto t) {
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
