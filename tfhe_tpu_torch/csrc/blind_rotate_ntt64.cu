// K6: the whole blind rotation of the prime-modulus NTT64 PBS, for Hopper:
// ciphertexts mod q = p = 2^64 - 2^32 + 1 (the Goldilocks prime), all n
// CMUX steps of one ciphertext in one block, the accumulator in shared
// memory.
//
// Replaces: no pallas_call. tfhe_tpu runs this rotation in XLA
// (tfhe_tpu/ops/ntt64_pbs.py::blind_rotate_ntt64, :296-335: a lax.fori_loop
// over the steps). Spec: its loop, mirrored by
// tfhe_tpu_torch/ops/ntt64_pbs.py::cmux_steps_q (the plain version). Every
// value is canonical mod q and every operation exact, so each step's
// output equals the spec's bit for bit.
//
// This is K4's loop (blind_rotate_goldilocks.cu) on the same field, the
// same transforms (goldilocks.cuh) and the same key order (classic DIF:
// ntt64_pbs.bootstrap_key_to_ntt64 is the forward transform as it is), with
// five differences, all because the ciphertexts themselves live mod q:
//   1. the rotate-subtract is mod q: a wrapped coefficient becomes q - v
//      (0 stays 0) and the difference is g_sub;
//   2. the decomposer is the non-native one (decomposer.rs:310-548, the
//      spec's decompose_nonnative): the sign split around ceil(q/2), one
//      rounded shift of the absolute value at bit 64 - b*l into a 64-bit
//      state, balanced digits with arithmetic shifts, the sign applied to
//      each digit; any b*l < 64 (K4's hi-word decomposer needs <= 31);
//   3. the digits are lifted into Z_q (d < 0 ? q + d : d) and twisted, then
//      the forward transform, the MAC against the step's key and the
//      inverse transform run as K4's;
//   4. the accumulate is acc = g_add(acc, x) (K4: acc += x + (x >> 32));
//   5. the key needs no torus_to_field: it is already in Z_q.
//
// One CMUX step, per ciphertext, on acc[R][N] (canonical u64):
//   1. diff = acc * X^{a_i} - acc (mod q), decomposed, each digit lifted
//      and twisted by psi^t into dig[level][r][t];
//   2. forward negacyclic NTT of the l R digit polynomials;
//   3. MAC against the key of step i, mod q, into mac[R][N];
//   4. inverse NTT of the R MAC polynomials;
//   5. untwist by psi^-t / N, acc = g_add(acc, x).
// a_i is the switched mask element in [0, 2N]; 2N acts as 0.
//
// Design, simple first (as K4): one block of 512 threads per ciphertext
// runs all n steps in one launch; shared memory holds the accumulator (R
// N), the l R digit transforms (l R N) and the R MAC results (R N), all
// u64: 96 KiB at the reference's doc recipe (k = 1, N = 2048, l = 1), two
// blocks per SM. The key streams from L2/HBM with __ldg, shared by every
// ciphertext.

#include <cstdint>
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int kThreads = 512;  // as K4's (ntt_common.cuh brk::kThreads)
constexpr uint64_t kHalfCeil = (kP >> 1) + 1;  // ceil(q / 2)

// SignedDecomposerNonNative at q = p (q_bits = 64): init gives the state
// (< 2^(b*l)) and the sign; next gives the balanced digits smallest scale
// first (the GGSW level order), before the sign is applied.
struct NonNativeDecomposer {
    int base_log;
    int shift;  // 64 - b*l - 1: the rounded shift less its deciding bit
    int64_t mask;

    __device__ NonNativeDecomposer(int base_log_, int levels)
        : base_log(base_log_), shift(64 - base_log_ * levels - 1),
          mask((int64_t)((1ull << base_log_) - 1)) {}

    __device__ __forceinline__ int64_t init(uint64_t v, bool& neg) const {
        neg = v >= kHalfCeil;
        const uint64_t abs_v = neg ? kP - v : v;  // < 2^63
        return (int64_t)(((abs_v >> shift) + 1) >> 1);
    }

    __device__ __forceinline__ int64_t next(int64_t& state) const {
        const int64_t res = state & mask;
        state >>= base_log;  // arithmetic
        const int64_t carry = (((res - 1) | state) & res) >> (base_log - 1);
        state += carry;
        return res - (carry << base_log);
    }
};

// acc_in/acc_out: u64 [B, R, N] canonical mod q; a_ms: i32 [B, n] in
// [0, 2N]; bsk: u64 [n, levels*R, R, N] canonical, DIF order; tables: u64
// [4, N].
__global__ void __launch_bounds__(kThreads)
blind_rotate_ntt64_kernel(const uint64_t* __restrict__ acc_in,
                          const int32_t* __restrict__ a_ms,
                          const uint64_t* __restrict__ bsk,
                          const uint64_t* __restrict__ tables,
                          uint64_t* __restrict__ acc_out, int n_steps, int R,
                          int levels, int base_log, int log_n) {
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

    const NonNativeDecomposer dec(base_log, levels);
    const long long key_step = (long long)lR * R * N;
    __syncthreads();

    for (int step = 0; step < n_steps; ++step) {
        const int a = a_ms[(long long)b * n_steps + step];  // [0, 2N]
        const uint64_t* key = bsk + step * key_step;

        // 1. rotate-subtract mod q, decompose, lift into Z_q, twist
        for (int idx = tid; idx < R * N; idx += nt) {
            const int r = idx >> log_n;
            const int t = idx & (N - 1);
            int s = t - a;
            if (s < 0) s += 2 * N;
            const bool wrap = s >= N;
            if (wrap) s -= N;
            uint64_t v = acc[r * N + s];
            if (wrap && v != 0) v = kP - v;
            bool neg;
            int64_t state = dec.init(g_sub(v, acc[idx]), neg);
            const uint64_t tw = __ldg(tables + G_TW * N + t);
            for (int lev = 0; lev < levels; ++lev) {
                int64_t d = dec.next(state);
                if (neg) d = -d;
                const uint64_t m = d < 0 ? kP - (uint64_t)(-d) : (uint64_t)d;
                dig[(lev * R + r) * N + t] = g_mul(m, tw);
            }
        }
        __syncthreads();

        // 2. forward transforms of the lR digit polynomials
        g_forward(dig, lR, log_n, tables);

        // 3. MAC: mac[c] = sum_j dig[j] * key[j][c]  (mod q)
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

        // 5. untwist (canonical), accumulate mod q
        for (int idx = tid; idx < R * N; idx += nt) {
            const int t = idx & (N - 1);
            const uint64_t x = g_mul(mac[idx], __ldg(tables + G_UTW * N + t));
            acc[idx] = g_add(acc[idx], x);
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

// acc_in/acc_out: u64 [B, R, N] canonical mod q; a_ms: i32 [B, n] in
// [0, 2N]; bsk: u64 [n, levels*R, R, N] (canonical, DIF order); tables:
// u64 [4, N]. One block per ciphertext. Returns cudaGetLastError() after
// the launch (0 = launched).
extern "C" int blind_rotate_ntt64(const void* acc_in, const void* a_ms,
                                  const void* bsk, const void* tables,
                                  void* acc_out, int B, int n_steps, int R,
                                  int levels, int base_log, int log_n,
                                  void* stream) {
    const size_t smem = smem_bytes(R, levels, log_n);
    cudaError_t err = cudaFuncSetAttribute(
        blind_rotate_ntt64_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    blind_rotate_ntt64_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
        (const uint64_t*)acc_in, (const int32_t*)a_ms, (const uint64_t*)bsk,
        (const uint64_t*)tables, (uint64_t*)acc_out, n_steps, R, levels,
        base_log, log_n);
    return (int)cudaGetLastError();
}

// Bytes of dynamic shared memory one block of blind_rotate_ntt64 needs (the
// <entry>_smem signature of the other step kernels); 0 unless num_primes
// is 1.
extern "C" unsigned long long blind_rotate_ntt64_smem(int num_primes, int R,
                                                     int levels, int log_n) {
    if (num_primes != 1) return 0;
    return smem_bytes(R, levels, log_n);
}

// Resident blocks per SM at the shared memory of (R, levels, log_n), and
// the kernel's registers and local (spill) bytes per thread.
extern "C" int blind_rotate_ntt64_occupancy(int R, int levels, int log_n,
                                            int* regs, int* local) {
    cudaFuncAttributes attr;
    if (cudaFuncGetAttributes(&attr, blind_rotate_ntt64_kernel)
        != cudaSuccess)
        return -1;
    *regs = attr.numRegs;
    *local = (int)attr.localSizeBytes;
    const size_t smem = smem_bytes(R, levels, log_n);
    if (cudaFuncSetAttribute(blind_rotate_ntt64_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem) != cudaSuccess)
        return -1;
    int blocks = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, blind_rotate_ntt64_kernel, kThreads, smem)
        != cudaSuccess)
        return -1;
    return blocks;
}
