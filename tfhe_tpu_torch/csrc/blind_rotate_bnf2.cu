// K1: the whole BNF2 (v6/v6b) blind rotation in acc32 mode, for Hopper.
//
// Replaces: tfhe_tpu/ops/pbs_kernel.py::_build_step_fn_v4.step (acc32,
// bnf2=True), i.e. _make_step_kernel_v4's one_step with the bnf2_c32 tail,
// driven step by step by blind_rotate_pallas(bnf2=True). Spec (bit for
// bit): tfhe_tpu/ops/bnf2.py::blind_rotate_bnf2(acc_round32=True) after
// the body rotation, mirrored by tfhe_tpu_torch/ops/bnf2.py::cmux_steps.
//
// One CMUX step, per ciphertext, on the u32 hi-plane accumulator acc[R][N]
// (torus value = acc * 2^32):
//   1. diff = acc * X^{a_i} - acc (u32 wrap), balanced gadget decomposition
//      from the hi limb (_decompose_u32: sh = 31 - base_log*levels), each
//      digit lifted mod p0 and p1 and twisted by psi^t;
//   2. forward negacyclic NTT, Gentleman-Sande stages on natural-order
//      input, DIF order out: the order bootstrap_key_to_bnf2 stores the key
//      in, so the key is used as prepared;
//   3. Shoup MAC against the GGSW row of step i (residue + Shoup planes);
//   4. inverse NTT (Cooley-Tukey stages in reverse order) and untwist,
//      giving canonical residues;
//   5. qp_to_torus32: v1 = (r1 + 2 p1 - r0) * inv01 mod p1,
//      t32 = ((v1 * C1T) >> 28) + (r0 >> S2) + t32_bias, added to acc.
// Every modular product is an exact Shoup multiply, so the residues, and
// hence the tail's input, equal the spec's; only the tail's rounding and
// the decomposition are formulas, and they are reproduced as written.
//
// Bound: int32 operations. Per step and ciphertext the kernel runs
// 2 (l*R) forward and 2 R inverse transforms of N/2 * log2(N) butterflies
// each, against ~128 KiB of key (2_2) that all ciphertexts share; the key
// stream is served from L2 when blocks walk the steps together, so the
// INT32 pipe is the roofline. Design: one block per ciphertext runs all n
// steps in one launch with the accumulator, the digit transforms and the
// MAC results in shared memory (80 KiB at 2_2): nothing but the key and
// the twiddle tables is read from device memory inside the step loop, and
// no accumulator round-trips through HBM between steps. Simple first:
// exact reductions, one butterfly per thread per pass, a __syncthreads
// between NTT stages; sharing key loads across ciphertexts, TMA and
// register-resident radix-4 stages are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
// per prime, the [8][N] constant table: twist, twist_sh, untwist,
// untwist_sh, forward stage twiddles (stage s at offset N - (N >> s)),
// their Shoup duals, inverse stage twiddles, their Shoup duals
enum { T_TW = 0, T_TW_SH, T_UTW, T_UTW_SH, T_FWD, T_FWD_SH, T_INV, T_INV_SH,
       T_COUNT };

__device__ __forceinline__ uint32_t shoup_mul(uint32_t a, uint32_t w,
                                              uint32_t w_sh, uint32_t p) {
    // a < 2^32, w < p < 2^31: a*w - q*p lies in [0, 2p) and fits in u32
    const uint32_t q = __umulhi(a, w_sh);
    const uint32_t r = a * w - q * p;
    return r >= p ? r - p : r;
}

struct Flavor {
    uint32_t p[2];
    uint32_t inv01, inv01_sh, c1t, t32_bias;
    int s2;
};

__global__ void __launch_bounds__(kThreads)
blind_rotate_bnf2_acc32_kernel(const uint32_t* __restrict__ acc_in,
                               const int32_t* __restrict__ a_ms,
                               const uint32_t* __restrict__ bsk,
                               const uint32_t* __restrict__ tables,
                               uint32_t* __restrict__ acc_out,
                               int n_steps, int R, int levels, int base_log,
                               int log_n, Flavor fl) {
    extern __shared__ uint32_t smem[];
    const int N = 1 << log_n;
    const int half = N >> 1;
    const int lR = levels * R;
    uint32_t* acc = smem;                 // [R][N]
    uint32_t* dig = acc + R * N;          // [lR][2][N]
    uint32_t* mac = dig + 2 * lR * N;     // [R][2][N]
    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int nt = blockDim.x;

    const uint32_t* acc_src = acc_in + (long long)b * R * N;
    for (int i = tid; i < R * N; i += nt) acc[i] = acc_src[i];

    const int rep = base_log * levels;           // <= 31
    const int sh = 31 - rep;                     // hi-limb shift
    const uint32_t rep_mask = (rep == 32) ? 0xFFFFFFFFu : ((1u << rep) - 1u);
    const int32_t mod_b = (1 << base_log) - 1;
    const long long key_step = 4LL * lR * R * N;
    __syncthreads();

    for (int step = 0; step < n_steps; ++step) {
        const int a = a_ms[(long long)b * n_steps + step];  // [0, 2N)
        const uint32_t* key = bsk + step * key_step;

        // 1. rotate-subtract, decompose, lift mod p, twist
        for (int idx = tid; idx < R * N; idx += nt) {
            const int r = idx >> log_n;
            const int t = idx & (N - 1);
            int s = t - a;
            if (s < 0) s += 2 * N;
            const bool neg = s >= N;
            if (neg) s -= N;
            uint32_t v = acc[r * N + s];
            if (neg) v = 0u - v;
            const uint32_t dhi = v - acc[idx];
            uint32_t res = dhi >> sh;
            const uint32_t rounding = res & 1u;
            res = (res + 1u) >> 1;
            res &= rep_mask;
            const uint32_t shifted_r = rounding << (rep - 1);
            const uint32_t need_bal =
                (((res - 1u) | shifted_r) & res) >> (rep - 1);
            int32_t state = (int32_t)(res - (need_bal << rep));
            for (int lev = 0; lev < levels; ++lev) {
                const int32_t d = state & mod_b;
                state >>= base_log;  // arithmetic
                const int32_t carry =
                    (((d - 1) | state) & d) >> (base_log - 1);
                state += carry;
                const int32_t digit = d - (carry << base_log);
                const int j = lev * R + r;
                #pragma unroll
                for (int pi = 0; pi < 2; ++pi) {
                    const uint32_t p = fl.p[pi];
                    int32_t m = digit % (int32_t)p;
                    if (m < 0) m += (int32_t)p;
                    const uint32_t* tb = tables + (long long)pi * T_COUNT * N;
                    dig[(j * 2 + pi) * N + t] = shoup_mul(
                        (uint32_t)m, __ldg(tb + T_TW * N + t),
                        __ldg(tb + T_TW_SH * N + t), p);
                }
            }
        }
        __syncthreads();

        // 2. forward DIF stages over the 2*lR digit polynomials
        for (int s = 0; s < log_n; ++s) {
            const int log_h = log_n - 1 - s;
            const int h = 1 << log_h;
            const int off = N - (N >> s);
            for (int idx = tid; idx < 2 * lR * half; idx += nt) {
                const int poly = idx >> (log_n - 1);
                const int bf = idx & (half - 1);
                const int pi = poly & 1;
                const uint32_t p = fl.p[pi];
                const int jj = bf & (h - 1);
                const int i0 = ((bf >> log_h) << (log_h + 1)) + jj;
                uint32_t* x = dig + poly * N;
                const uint32_t u0 = x[i0];
                const uint32_t u1 = x[i0 + h];
                const uint32_t* tb = tables + (long long)pi * T_COUNT * N;
                uint32_t u = u0 + u1;
                if (u >= p) u -= p;
                x[i0] = u;
                x[i0 + h] = shoup_mul(u0 - u1 + p,
                                      __ldg(tb + T_FWD * N + off + jj),
                                      __ldg(tb + T_FWD_SH * N + off + jj), p);
            }
            __syncthreads();
        }

        // 3. Shoup MAC against the GGSW row: mac[c][pi] = sum_j dig[j][pi] * g
        for (int idx = tid; idx < 2 * R * N; idx += nt) {
            const int t = idx & (N - 1);
            const int pi = (idx >> log_n) & 1;
            const int c = idx >> (log_n + 1);
            const uint32_t p = fl.p[pi];
            uint32_t acc_m = 0;
            for (int j = 0; j < lR; ++j) {
                const long long kres = ((long long)(pi * lR + j) * R + c) * N + t;
                const long long ksh = ((long long)((2 + pi) * lR + j) * R + c) * N + t;
                acc_m += shoup_mul(dig[(j * 2 + pi) * N + t], __ldg(key + kres),
                                   __ldg(key + ksh), p);
                if (acc_m >= p) acc_m -= p;
            }
            mac[idx] = acc_m;  // idx == (c * 2 + pi) * N + t
        }
        __syncthreads();

        // 4. inverse CT stages (reverse order) over the 2*R MAC polynomials
        for (int s = log_n - 1; s >= 0; --s) {
            const int log_h = log_n - 1 - s;
            const int h = 1 << log_h;
            const int off = N - (N >> s);
            for (int idx = tid; idx < 2 * R * half; idx += nt) {
                const int poly = idx >> (log_n - 1);
                const int bf = idx & (half - 1);
                const int pi = poly & 1;
                const uint32_t p = fl.p[pi];
                const int jj = bf & (h - 1);
                const int i0 = ((bf >> log_h) << (log_h + 1)) + jj;
                uint32_t* x = mac + poly * N;
                const uint32_t* tb = tables + (long long)pi * T_COUNT * N;
                const uint32_t u = x[i0];
                const uint32_t bw = shoup_mul(x[i0 + h],
                                              __ldg(tb + T_INV * N + off + jj),
                                              __ldg(tb + T_INV_SH * N + off + jj),
                                              p);
                uint32_t lo = u + bw;
                if (lo >= p) lo -= p;
                uint32_t hi = u - bw + p;
                if (hi >= p) hi -= p;
                x[i0] = lo;
                x[i0 + h] = hi;
            }
            __syncthreads();
        }

        // 5. untwist to canonical residues, qp_to_torus32, accumulate
        for (int idx = tid; idx < R * N; idx += nt) {
            const int c = idx >> log_n;
            const int t = idx & (N - 1);
            const uint32_t* tb0 = tables;
            const uint32_t* tb1 = tables + (long long)T_COUNT * N;
            const uint32_t r0 = shoup_mul(mac[(c * 2) * N + t],
                                          __ldg(tb0 + T_UTW * N + t),
                                          __ldg(tb0 + T_UTW_SH * N + t),
                                          fl.p[0]);
            const uint32_t r1 = shoup_mul(mac[(c * 2 + 1) * N + t],
                                          __ldg(tb1 + T_UTW * N + t),
                                          __ldg(tb1 + T_UTW_SH * N + t),
                                          fl.p[1]);
            const uint32_t diff = fl.p[1] + fl.p[1] + r1 - r0;  // < 3 p1
            const uint32_t v1 = shoup_mul(diff, fl.inv01, fl.inv01_sh,
                                          fl.p[1]);
            const uint32_t t1 =
                (uint32_t)(((uint64_t)v1 * fl.c1t) >> 28);  // < 2^32
            acc[idx] += t1 + (r0 >> fl.s2) + fl.t32_bias;
        }
        __syncthreads();
    }

    uint32_t* acc_dst = acc_out + (long long)b * R * N;
    for (int i = tid; i < R * N; i += nt) acc_dst[i] = acc[i];
}

}  // namespace

// acc_in/acc_out: u32 [B, R, N]; a_ms: i32 [B, n] in [0, 2N);
// bsk: u32 [n, 2, 2, levels*R, R, N]; tables: u32 [2, 8, N].
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int blind_rotate_bnf2_acc32(
        const void* acc_in, const void* a_ms, const void* bsk,
        const void* tables, void* acc_out, int B, int n_steps, int R,
        int levels, int base_log, int log_n, unsigned p0, unsigned p1,
        unsigned inv01, unsigned inv01_sh, unsigned c1t, int s2,
        unsigned t32_bias, void* stream) {
    const int N = 1 << log_n;
    const size_t smem = (size_t)(R + 2 * levels * R + 2 * R) * N
                        * sizeof(uint32_t);
    cudaError_t err = cudaFuncSetAttribute(
        blind_rotate_bnf2_acc32_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    Flavor fl;
    fl.p[0] = p0;
    fl.p[1] = p1;
    fl.inv01 = inv01;
    fl.inv01_sh = inv01_sh;
    fl.c1t = c1t;
    fl.t32_bias = t32_bias;
    fl.s2 = s2;
    blind_rotate_bnf2_acc32_kernel<<<B, kThreads, smem,
                                     (cudaStream_t)stream>>>(
        (const uint32_t*)acc_in, (const int32_t*)a_ms, (const uint32_t*)bsk,
        (const uint32_t*)tables, (uint32_t*)acc_out, n_steps, R, levels,
        base_log, log_n, fl);
    return (int)cudaGetLastError();
}
