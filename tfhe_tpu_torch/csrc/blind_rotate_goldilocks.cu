// K4: the whole v5 blind rotation over the Goldilocks prime
// p = 2^64 - 2^32 + 1, for Hopper: all n CMUX steps of one ciphertext in one
// block, the u64 accumulator in shared memory.
//
// Replaces: tfhe_tpu/ops/pbs_kernel_g.py::_build_step_fn_g.step (pallas_call
// at :667; kernel _make_step_kernel_g, :550-632), driven by
// blind_rotate_goldilocks_pallas (:699-762). Spec: the jnp oracle
// tfhe_tpu/ops/goldilocks.py::blind_rotate_goldilocks, mirrored by
// tfhe_tpu_torch/ops/goldilocks.py::cmux_steps (the plain version). Its
// contract (goldilocks.py:363-365) is the whole of what is copied: the
// NTT-domain math is exact mod p, the inverse output is canonical, and the
// switch back to the torus is exactly x + (x >> 32). The TPU kernel's
// transposed [G, Bt, 128] tiles, int8-MXU limb DFTs, (hi, lo) u32 pair
// arithmetic, shift-stage group twiddles and unroll knobs are not ported:
// here every product is a native 64 x 64 -> 128-bit multiply (a * b and
// __umul64hi) reduced with 2^64 = 2^32 - 1 and 2^96 = -1 (mod p), and every
// value is kept canonical, so each step's output equals the spec's bit for
// bit.
//
// One CMUX step, per ciphertext, on acc[R][N] (u64):
//   1. diff = acc * X^{a_i} - acc (u64, so the lo word's borrow reaches the
//      hi word), balanced decomposition from the hi 32 bits (brk::
//      HiDecomposer: base_log * levels <= 31), each signed digit lifted
//      into Z_p (d < 0 ? p + d : d) and twisted by psi^t;
//   2. forward negacyclic NTT, Gentleman-Sande stages, natural order in,
//      DIF (bit-reversed) order out;
//   3. MAC against the key of step i, mod p;
//   4. inverse NTT (Cooley-Tukey stages in reverse order), untwist by
//      psi^-t / N, canonical;
//   5. acc += x + (x >> 32).
//
// Frequency order: the stored key (goldilocks.bootstrap_key_to_goldilocks,
// the JAX package's bsk_scan_g) is in the v5 (group, lane) order. The MAC is
// pointwise, so the wrapper permutes the key once, at key preparation, into
// the DIF order this kernel's transform produces (ops/pbs_kernel.py::
// goldilocks_kernel_key, cached on the ServerKey), and merges the (hi, lo)
// planes into u64: u64 [n, l*R, R, N].
//
// Design, simple first: one block per ciphertext runs all n steps in one
// launch. Shared memory holds the accumulator (R N), the l R digit
// transforms (l R N) and the R MAC results (R N), all u64: 96 KiB at 2_2
// (two blocks per SM), 60 KiB at 1_1. The key streams from L2/HBM with
// __ldg (64 KiB per step at 2_2, shared by every ciphertext). One butterfly
// per thread per pass, a __syncthreads between stages. The whole-loop
// template of ntt_common.cuh is written on u32 Shoup primes; a field policy
// for it would not stay readable, so this loop stands beside it and shares
// its decomposer and block size.
//
// Bound: integer instructions per pipe (ops/kernel_bench.py::SASS_OPS
// holds them, counted from this kernel's SASS). The key
// is read once per ciphertext-step from L2, but counted once in the byte
// bound.

#include "ntt_common.cuh"

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

// acc_in/acc_out: u64 [B, R, N]; a_ms: i32 [B, n] in [0, 2N);
// bsk: u64 [n, levels*R, R, N] canonical, DIF order; tables: u64 [4, N].
__global__ void __launch_bounds__(brk::kThreads)
blind_rotate_goldilocks_kernel(const uint64_t* __restrict__ acc_in,
                               const int32_t* __restrict__ a_ms,
                               const uint64_t* __restrict__ bsk,
                               const uint64_t* __restrict__ tables,
                               uint64_t* __restrict__ acc_out, int n_steps,
                               int R, int levels, int base_log, int log_n) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int N = 1 << log_n;
    const int lR = levels * R;
    uint64_t* acc = reinterpret_cast<uint64_t*>(smem_raw);  // [R][N]
    uint64_t* dig = acc + R * N;                             // [lR][N]
    uint64_t* mac = dig + lR * N;                            // [R][N]
    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int nt = blockDim.x;

    const uint64_t* acc_src = acc_in + (long long)b * R * N;
    for (int i = tid; i < R * N; i += nt) acc[i] = acc_src[i];

    const brk::HiDecomposer dec(base_log, levels);
    const long long key_step = (long long)lR * R * N;
    __syncthreads();

    for (int step = 0; step < n_steps; ++step) {
        const int a = a_ms[(long long)b * n_steps + step];  // [0, 2N)
        const uint64_t* key = bsk + step * key_step;

        // 1. rotate-subtract, decompose, lift into Z_p, twist
        for (int idx = tid; idx < R * N; idx += nt) {
            const int r = idx >> log_n;
            const int t = idx & (N - 1);
            int s = t - a;
            if (s < 0) s += 2 * N;
            const bool neg = s >= N;
            if (neg) s -= N;
            uint64_t v = acc[r * N + s];
            if (neg) v = 0ull - v;
            int32_t state = dec.init(brk::hi_word(v - acc[idx]));
            const uint64_t tw = __ldg(tables + G_TW * N + t);
            for (int lev = 0; lev < levels; ++lev) {
                const int32_t d = dec.next(state);
                const uint64_t m = d < 0 ? kP - (uint64_t)(-(int64_t)d)
                                         : (uint64_t)d;
                dig[(lev * R + r) * N + t] = g_mul(m, tw);
            }
        }
        __syncthreads();

        // 2. forward transforms of the lR digit polynomials
        g_forward(dig, lR, log_n, tables);

        // 3. MAC: mac[c] = sum_j dig[j] * key[j][c]  (mod p)
        for (int idx = tid; idx < R * N; idx += nt) {
            const int c = idx >> log_n;
            const int t = idx & (N - 1);
            uint64_t sum = 0;
            for (int j = 0; j < lR; ++j)
                sum = g_add(sum, g_mul(dig[j * N + t],
                                       __ldg(key + ((long long)j * R + c) * N
                                             + t)));
            mac[idx] = sum;
        }
        __syncthreads();

        // 4. inverse transforms of the R MAC polynomials
        g_inverse(mac, R, log_n, tables);

        // 5. untwist (canonical), switch back, accumulate mod 2^64
        for (int idx = tid; idx < R * N; idx += nt) {
            const int t = idx & (N - 1);
            const uint64_t x = g_mul(mac[idx], __ldg(tables + G_UTW * N + t));
            acc[idx] += x + (x >> 32);
        }
        __syncthreads();
    }

    uint64_t* acc_dst = acc_out + (long long)b * R * N;
    for (int i = tid; i < R * N; i += nt) acc_dst[i] = acc[i];
}

size_t smem_bytes(int R, int levels, int log_n) {
    return (size_t)(R + levels * R + R) * ((size_t)1 << log_n)
           * sizeof(uint64_t);
}

}  // namespace

// acc_in/acc_out: u64 [B, R, N]; a_ms: i32 [B, n] in [0, 2N);
// bsk: u64 [n, levels*R, R, N] (canonical, DIF order); tables: u64 [4, N].
// One block per ciphertext. Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int blind_rotate_goldilocks(
        const void* acc_in, const void* a_ms, const void* bsk,
        const void* tables, void* acc_out, int B, int n_steps, int R,
        int levels, int base_log, int log_n, void* stream) {
    const size_t smem = smem_bytes(R, levels, log_n);
    cudaError_t err = cudaFuncSetAttribute(
        blind_rotate_goldilocks_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    blind_rotate_goldilocks_kernel<<<B, brk::kThreads, smem,
                                     (cudaStream_t)stream>>>(
        (const uint64_t*)acc_in, (const int32_t*)a_ms, (const uint64_t*)bsk,
        (const uint64_t*)tables, (uint64_t*)acc_out, n_steps, R, levels,
        base_log, log_n);
    return (int)cudaGetLastError();
}

// Bytes of dynamic shared memory one block of blind_rotate_goldilocks needs
// (the <entry>_smem signature of the other step kernels); 0 unless
// num_primes is 1.
extern "C" unsigned long long blind_rotate_goldilocks_smem(
        int num_primes, int R, int levels, int log_n) {
    if (num_primes != 1) return 0;
    return smem_bytes(R, levels, log_n);
}
