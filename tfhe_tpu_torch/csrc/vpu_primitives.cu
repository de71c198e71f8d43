// The VPU-primitive probes on Hopper: looped micro-kernels that time one
// 32-bit operation, or one shared-memory butterfly stage, per element.
//
// Replaces: tools/vpu_primitives.py
//   - run_case (pallas_call at :54): a run-time trip count of one vector op
//     on a resident [8, 2048] u32 tile, the 19 cases of :79-157. Here
//     vpu_loop<Op>: each thread holds kElems independent u32 elements in
//     registers (throughput, not latency: kElems chains in flight per
//     thread, 256 threads per block, the grid over every SM) and applies
//     Op to each of them once per trip; the JAX cases by name and formula,
//     and three Hopper rows (mul_wide, shoup_ntt_common, add_mod).
//   - run_case3d (pallas_call at :170): leading-axis butterflies on
//     [16 groups, 16 rows, 128] (:193-216). JAX's x[g, b, l] is coefficient
//     g*128 + l of row b, so a group stage is a butterfly stage of a row of
//     N = 2048 at stride N/2 (and N/4, N/8, N/16 for four stages). Here
//     smem_stages: one block per row resident in shared memory, each trip
//     `n_stages` stages of (u + v, u - v) from stride 2^log_h0 down, with a
//     block barrier (or, where one warp owns both halves of every pair it
//     touches, strides <= 32, only __syncwarp) after each; regs_addsub keeps
//     its elements in registers (addsub_only).
//
// Bound: the issue rate of the INT32 pipes (ALU: IADD3, LOP3, SHF, ISETP,
// SEL...; FMA: IMAD in all its forms); the loop bodies' instructions per
// pipe are read from the build's SASS (sass_loops). The constants (W, WSH,
// P0, masks, shift counts) are kernel arguments, so nvcc cannot fold an
// idempotent or fixed-point body (and, shift, where_ge) out of the loop.

#include <cstdint>
#include <cuda_runtime.h>

#include "ntt_common.cuh"

namespace {

constexpr int kElems = 8;      // independent elements per thread
constexpr int kVpuThreads = 256;
constexpr int kRowThreads = 256;

// Every constant of the cases (tools/vpu_primitives.py:30-32, :101-104).
struct Consts {
    uint32_t w, wsh, p, p2;          // W, WSH, P0, 2 P0
    uint32_t mask16, sh16, one;      // 0xFFFF, 16, 1
    uint32_t w16, w16sh, p16, p16x2; // W16, W16SH, P16, 2 P16
    uint32_t w_hi, w_lo;             // W >> 16, W & 0xFFFF
    float f1, f15;                   // 1.0, 1.5
};

__device__ __forceinline__ uint32_t condsub(uint32_t x, uint32_t c) {
    return x >= c ? x - c : x;  // jnp.where(x >= c, x - c, x), unsigned
}

// pk._shoup with the exact high word: (a w) mod p, lazily < 2p
__device__ __forceinline__ uint32_t shoup_lazy(uint32_t a, const Consts& c) {
    const uint32_t q = __umulhi(a, c.wsh);
    return a * c.w - q * c.p;
}

__device__ __forceinline__ uint32_t shoup16(uint32_t x, const Consts& c) {
    const uint32_t a = x & c.mask16;
    const uint32_t q = (a * c.w16sh) >> c.sh16;
    return a * c.w16 - q * c.p16;
}

// _mul_hi_approx (tools/vpu_primitives.py:137-145): drops the carries of
// the low halves on purpose
__device__ __forceinline__ uint32_t mulhi_approx(uint32_t a, uint32_t b,
                                                 const Consts& c) {
    const uint32_t ah = a >> c.sh16, al = a & c.mask16;
    const uint32_t bh = b >> c.sh16, bl = b & c.mask16;
    return ah * bh + ((al * bh) >> c.sh16) + ((ah * bl) >> c.sh16);
}

__device__ __forceinline__ uint32_t shoup_approx(uint32_t a,
                                                 const Consts& c) {
    const uint32_t q = mulhi_approx(a, c.wsh, c);
    return condsub(a * c.w - q * c.p, c.p2);
}

// hi ^ lo of the 32 x 32 -> 64-bit product, as one mul.wide.u32 (nvcc
// otherwise recomputes the low word with a second IMAD)
__device__ __forceinline__ uint32_t mul_wide_fold(uint32_t x, uint32_t w) {
    uint64_t t;
    asm("mul.wide.u32 %0, %1, %2;" : "=l"(t) : "r"(x), "r"(w));
    return (uint32_t)(t >> 32) ^ (uint32_t)t;
}

#define VPU_OP(NAME, EXPR)                                                   \
    struct NAME {                                                            \
        __device__ __forceinline__ static uint32_t f(uint32_t x,             \
                                                     const Consts& c) {     \
            return EXPR;                                                     \
        }                                                                    \
    };

VPU_OP(OpAdd, x + x)
VPU_OP(OpMulU32, x * x)
VPU_OP(OpMulU32Const, x * c.w)
VPU_OP(OpShift, x >> c.sh16)
VPU_OP(OpAnd, x & c.mask16)
VPU_OP(OpWhereGe, condsub(x, c.p))
VPU_OP(OpMulHi, __umulhi(x, x | c.one))
VPU_OP(OpShoup, shoup_lazy(x, c))
VPU_OP(OpShoupCondsub, condsub(shoup_lazy(x, c), c.p))
VPU_OP(OpButterflyMix, condsub(x + x, c.p2) ^ shoup_lazy(x, c))
// u32 -> i32 -> f32, + 1.0, f32 -> i32 -> u32. The f32 -> i32 conversion
// saturates (F2I: 2^31 and above give 0x7FFFFFFF), as XLA's convert does
// in interpret mode on the CPU; the plain version clamps before it converts.
VPU_OP(OpToF32Roundtrip,
       (uint32_t)__float2int_rz(__int2float_rn((int32_t)x) + c.f1))
VPU_OP(OpMullo16Vals, (x & c.mask16) * c.w16)
VPU_OP(OpShoup16, shoup16(x, c))
VPU_OP(OpShoup16Condsub, condsub(shoup16(x, c), c.p16x2))
// values below 2^16 * 1.5: the f32 product is exact, truncated to u32
VPU_OP(OpMulF32, (uint32_t)__float2uint_rz(__uint2float_rn(x & c.mask16)
                                           * c.f15))
// _mulhi_4mullo(x, W >> 16, W & 0xFFFF) (tools/vpu_primitives.py:123-134)
VPU_OP(OpMulhi4Mullo,
       (x >> c.sh16) * c.w_hi
           + (((x >> c.sh16) * c.w_lo + (x & c.mask16) * c.w_hi
               + (((x & c.mask16) * c.w_lo) >> c.sh16)) >> c.sh16))
VPU_OP(OpMulhiApprox, mulhi_approx(x, x | c.one, c))
VPU_OP(OpShoupApprox2p, shoup_approx(x, c))
VPU_OP(OpShoupApproxCanon, condsub(shoup_approx(x, c), c.p))
// Hopper rows: the 32 x 32 -> 64-bit product (IMAD.WIDE.U32), folded as
// hi ^ lo; the step kernels' own Shoup multiply and modular add
VPU_OP(OpMulWide, mul_wide_fold(x, c.w))
VPU_OP(OpShoupNttCommon, brk::shoup_mul(x, c.w, c.wsh, c.p))
VPU_OP(OpAddMod, brk::add_mod(x, c.w, c.p))

#undef VPU_OP

__device__ __forceinline__ unsigned smid() {
    unsigned id;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
    return id;
}

// n u32 elements, kElems per thread, strided by the block so that a warp's
// loads are coalesced; `loops` trips of Op on each element. With clk,
// thread 0 of each block writes the SM clock (clock64) when its loop
// starts and ends, and its SM's id: clk[3 b], clk[3 b + 1], clk[3 b + 2].
template <class Op>
__global__ void __launch_bounds__(kVpuThreads)
vpu_loop(const uint32_t* __restrict__ x_in, uint32_t* __restrict__ x_out,
         int loops, Consts c, long long* __restrict__ clk) {
    const long long base = (long long)blockIdx.x * kVpuThreads * kElems
                           + threadIdx.x;
    uint32_t v[kElems];
    #pragma unroll
    for (int e = 0; e < kElems; ++e) v[e] = x_in[base + e * kVpuThreads];
    const bool timed = clk != nullptr && threadIdx.x == 0;
    const long long t0 = timed ? clock64() : 0;
    #pragma unroll 1
    for (int k = 0; k < loops; ++k) {
        #pragma unroll
        for (int e = 0; e < kElems; ++e) v[e] = Op::f(v[e], c);
    }
    if (timed) {
        clk[3 * blockIdx.x] = t0;
        clk[3 * blockIdx.x + 1] = clock64();
        clk[3 * blockIdx.x + 2] = smid();
    }
    #pragma unroll
    for (int e = 0; e < kElems; ++e) x_out[base + e * kVpuThreads] = v[e];
}

// rows of N u32, one block per row in shared memory: `loops` trips of
// n_stages butterfly stages (u + v, u - v) at strides 2^log_h0, 2^(log_h0-1),
// ..., each followed by a block barrier (WarpOnly: __syncwarp).
template <bool WarpOnly>
__global__ void __launch_bounds__(kRowThreads)
smem_stages(const uint32_t* __restrict__ x_in, uint32_t* __restrict__ x_out,
            int log_n, int log_h0, int n_stages, int loops) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    uint32_t* x = reinterpret_cast<uint32_t*>(smem_raw);
    const int N = 1 << log_n;
    const int half = N >> 1;
    const long long row = (long long)blockIdx.x * N;
    for (int t = threadIdx.x; t < N; t += blockDim.x) x[t] = x_in[row + t];
    __syncthreads();
    #pragma unroll 1
    for (int k = 0; k < loops; ++k) {
        #pragma unroll 1
        for (int s = 0; s < n_stages; ++s) {
            const int log_h = log_h0 - s;
            const int h = 1 << log_h;
            #pragma unroll 1
            for (int bf = threadIdx.x; bf < half; bf += blockDim.x) {
                const int i0 = ((bf >> log_h) << (log_h + 1)) + (bf & (h - 1));
                const uint32_t u = x[i0];
                const uint32_t v = x[i0 + h];
                x[i0] = u + v;
                x[i0 + h] = u - v;
            }
            if (WarpOnly)
                __syncwarp();
            else
                __syncthreads();
        }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < N; t += blockDim.x) x_out[row + t] = x[t];
}

// addsub_only: x <- (x + x) - (x >> sh), in registers (kElems per thread)
__global__ void __launch_bounds__(kVpuThreads)
regs_addsub(const uint32_t* __restrict__ x_in, uint32_t* __restrict__ x_out,
            int sh, int loops) {
    const long long base = (long long)blockIdx.x * kVpuThreads * kElems
                           + threadIdx.x;
    uint32_t v[kElems];
    #pragma unroll
    for (int e = 0; e < kElems; ++e) v[e] = x_in[base + e * kVpuThreads];
    #pragma unroll 1
    for (int k = 0; k < loops; ++k) {
        #pragma unroll
        for (int e = 0; e < kElems; ++e) v[e] = (v[e] + v[e]) - (v[e] >> sh);
    }
    #pragma unroll
    for (int e = 0; e < kElems; ++e) x_out[base + e * kVpuThreads] = v[e];
}

using VpuKernel = void (*)(const uint32_t*, uint32_t*, int, Consts,
                          long long*);

// the cases in the order of vpu_case_names (ops named as the JAX cases)
const VpuKernel kVpuCases[] = {
    vpu_loop<OpAdd>, vpu_loop<OpMulU32>, vpu_loop<OpMulU32Const>,
    vpu_loop<OpShift>, vpu_loop<OpAnd>, vpu_loop<OpWhereGe>,
    vpu_loop<OpMulHi>, vpu_loop<OpShoup>, vpu_loop<OpShoupCondsub>,
    vpu_loop<OpButterflyMix>, vpu_loop<OpToF32Roundtrip>,
    vpu_loop<OpMullo16Vals>, vpu_loop<OpShoup16>, vpu_loop<OpShoup16Condsub>,
    vpu_loop<OpMulF32>, vpu_loop<OpMulhi4Mullo>, vpu_loop<OpMulhiApprox>,
    vpu_loop<OpShoupApprox2p>, vpu_loop<OpShoupApproxCanon>,
    vpu_loop<OpMulWide>, vpu_loop<OpShoupNttCommon>, vpu_loop<OpAddMod>,
};
constexpr int kNumVpuCases = sizeof(kVpuCases) / sizeof(kVpuCases[0]);

}  // namespace

extern "C" int vpu_num_cases() { return kNumVpuCases; }

// x_in/x_out: u32 [n], n a multiple of 256 * kElems; u: the u32 constants
// of Consts in order (13), f1, f15 the float ones; clk: null, or i64
// [n / (256 * kElems), 3] for each block's loop start and end clock and
// SM. Returns
// cudaGetLastError() after the launch (0 = launched), cudaErrorInvalidValue
// for an unknown case or a bad n.
extern "C" int vpu_case(int which, const void* x_in, void* x_out, long long n,
                        int loops, const unsigned* u, float f1, float f15,
                        void* clk, void* stream) {
    const long long per_block = (long long)kVpuThreads * kElems;
    if (which < 0 || which >= kNumVpuCases || n <= 0 || n % per_block)
        return (int)cudaErrorInvalidValue;
    Consts c{u[0], u[1], u[2], u[3], u[4], u[5], u[6], u[7], u[8], u[9],
             u[10], u[11], u[12], f1, f15};
    kVpuCases[which]<<<(unsigned)(n / per_block), kVpuThreads, 0,
                       (cudaStream_t)stream>>>(
        (const uint32_t*)x_in, (uint32_t*)x_out, loops, c, (long long*)clk);
    return (int)cudaGetLastError();
}

// x_in/x_out: u32 [rows, 2^log_n]; strides 2^log_h0 down over n_stages
// stages; warp_only: __syncwarp after each stage instead of a block
// barrier (the caller keeps every stride <= 32, where one warp owns both
// halves of every pair it touches).
extern "C" int vpu_smem_stages(const void* x_in, void* x_out, int rows,
                               int log_n, int log_h0, int n_stages,
                               int warp_only, int loops, void* stream) {
    if (log_h0 - n_stages + 1 < 0 || log_h0 >= log_n || n_stages < 1
        || (warp_only && log_h0 > 5))
        return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(uint32_t) << log_n;
    auto kernel = warp_only ? smem_stages<true> : smem_stages<false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<rows, kRowThreads, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)x_in, (uint32_t*)x_out, log_n, log_h0, n_stages,
        loops);
    return (int)cudaGetLastError();
}

// x_in/x_out: u32 [n], n a multiple of 256 * kElems.
extern "C" int vpu_regs_addsub(const void* x_in, void* x_out, long long n,
                               int sh, int loops, void* stream) {
    const long long per_block = (long long)kVpuThreads * kElems;
    if (n <= 0 || n % per_block) return (int)cudaErrorInvalidValue;
    regs_addsub<<<(unsigned)(n / per_block), kVpuThreads, 0,
                  (cudaStream_t)stream>>>((const uint32_t*)x_in,
                                          (uint32_t*)x_out, sh, loops);
    return (int)cudaGetLastError();
}
