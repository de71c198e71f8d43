// The tensor-core transforms of the probes on Hopper: looped kernels on
// mma.sync (mma_int8.cuh), one polynomial of N = 2048 u32 per block,
// resident in shared memory, a run-time trip count. The polynomial is
// [16, 128]: row r holds coefficients 128 r .. 128 r + 127, which is the
// JAX block layout of one polynomial (v3) and the [G, Bt, 128] layout of
// one ciphertext (v4: group g = row).
//
// Replaces, by the function the JAX package computes today (several JAX
// probe cases are stale: see ROADMAP.md Queue C):
//   - V3_FWD: _fwd_ntt_v3 (tfhe_tpu/ops/pbs_kernel.py:552): the twist, the
//     four stages of stride >= 128 (probe_stages.cuh: exact butterflies,
//     equal mod p to the JAX lazy ones, and the condsub below makes both
//     canonical), condsub, the offset limb split, the merged
//     [16, 512] @ [512, 512] small DFT, the pair fold and recombination
//     of _mxu_small_dft (:522): < 2p out. Cases fwd_v3_mxu
//     (tools/ntt_variants.py:171), fwd_v3_base / fwd_v3c
//     (tools/ntt_v3c_experiments.py:370-371), v3_fwd (tools/v4_probe.py:181);
//   - V3_INV: _inv_ntt_v3b (:589): condsub, the small DFT with the inverse
//     matrix, the four inverse stages and the untwist, canonical out
//     (exact stages after a condsub of the DFT's < 2p output: equal to the
//     JAX lazy ones after its final condsub). inv_v3_mxu,
//     inv_v3b_block_stages, inv_v3b_base, inv_v3c, inv_v3c_rolls, v3_inv;
//   - SPLIT4: _split4_i8, x <- limb 0 + limb 1 + x (split4_only);
//   - MM4: the balanced split of condsub(x, p), its product with the four
//     [512, 128] limb matrices (one [512, 512] product, column blocks
//     summed), + x (mm4_only); MM1: the same with the offset split
//     (mm1_only); MM1 with 2 or 4 copies of the rows, every MAC issued,
//     the sums of ntt_v3c_experiments.py:283-302 (mm1_rows256/512);
//   - V4_FOLD: x as int8, x3 along k, @ fwd_w8 [384, 512], the pair
//     fold, V0 ^ V1 (v4_matmul_fold, g_matmul_fold: v4_probe.py:255, :377);
//   - V4_SPLIT4: limb 0 of the offset split of condsub(x, p), + x
//     (v4_split4, :257);
//   - V4_INV_MMR: condsub, the offset split, @ inv_w8 [512, 512], the pair
//     fold, the exact _mul_hi for q0 and the approx _shoup for r1, the
//     bias and condsubs (v4_inv_matmul_recombine, :258);
//   - V4_FWD / V4_FWD_NOSPLIT: _fwd_ntt_v4 (:1227, lazy=False) on the
//     digit limbs of v4_fwd (:114-118) or x as int8 x3 (v4_fwd_nosplit,
//     :121-125): the lane DFT [16, 384] @ [384, 512], the twiddle scale,
//     the four group DIF stages; < 2p in v4 point order;
//   - V4_INV: _inv_ntt_v4 (:1285, lazy=False, the approx Barrett fold):
//     the group stages, the inverse twiddle, the offset split,
//     @ inv_w8 [512, 512], the recombination; canonical.
// Every reduction is the JAX formula (approx _shoup, _condsub_wide,
// _mul_hi as __umulhi), so each equals its plain version exactly.
//
// Design: the int8 table (192 or 256 KiB) does not fit beside the data in
// the share of shared memory a block gets, so its B fragments are read
// from the wrapper's column-major copy through L2: the whole table a
// polynomial-trip (the row's l2_bytes). Each of the 16 warps owns lanes
// 8w .. 8w + 7 of the four column blocks, so a thread holds U_0 .. U_3 of
// one (row, lane) and the pair fold and recombination run in registers.
// Bound: the int8 tensor cores, or L2 (one table read a polynomial), or
// the INT32 glue (the stages, splits and reductions).

#include "mma_int8.cuh"
#include "ntt_common.cuh"
#include "probe_stages.cuh"

namespace {

using mma8::condsub;
using mma8::shoup_approx;

enum Op { V3_FWD = 0, V3_INV, SPLIT4, MM4, MM1, V4_FOLD, V4_SPLIT4,
          V4_INV_MMR, V4_FWD, V4_FWD_NOSPLIT, V4_INV };

constexpr int kThreads = 512;
constexpr int kLogN = 11, kN = 1 << kLogN;
constexpr int kRows = kN / 128;  // 16: G of the v4 layout
constexpr int kLogG = 4;
constexpr int kLda = 512 + 16;   // A's padded row, bytes

struct MxuArgs {
    const uint32_t* x_in;
    uint32_t* x_out;
    const int8_t* bt;      // the product's table, column-major [512][K]
    const uint32_t* bias;  // [128]: the bias row (v3) or inv_bias (v4)
    const uint32_t* plan;  // v3: the prime's [8][N] plan tables
    const uint32_t* tw;    // v4: tw [5][G][128] or tw_inv [2][G][128]
    const uint32_t* gw;    // v4: gw_fwd or gw_inv [log_g][2][G][128]
    uint32_t p, one_sh, c16, c16_sh;
    int loops, sink;
};

__host__ __device__ constexpr int k_of(int op) {
    return op == V4_FOLD || op == V4_FWD || op == V4_FWD_NOSPLIT ? 384 : 512;
}

// _mxu_small_dft's recombination (pbs_kernel.py:538-546) of one element
__device__ __forceinline__ uint32_t recombine_v3(const int (&u)[4], int c,
                                                 const MxuArgs& a) {
    const uint32_t v0 = mma8::pair_fold(u[0], u[1]);
    const uint32_t v1 = mma8::pair_fold(u[2], u[3]);
    const uint32_t q0 = __umulhi(v0, a.one_sh);
    const uint32_t r0 = v0 - q0 * a.p;
    const uint32_t r1 = shoup_approx(v1, a.c16, a.c16_sh, a.p);
    uint32_t s = condsub(r0 + r1, 2 * a.p);
    s = s + __ldg(a.bias + c);
    return condsub(s, 2 * a.p);
}

// the group stages of _fwd_tail_v4 / _inv_ntt_v4 on x [16][128]
template <bool Inverse>
__device__ void group_stages(uint32_t* x, const MxuArgs& a) {
    const uint32_t p2 = 2 * a.p;
    for (int i = 0; i < kLogG; ++i) {
        const int st = Inverse ? kLogG - 1 - i : i;
        const int m = kRows >> st, h = m >> 1;
        const uint32_t* w = a.gw + (st * 2) * kN;
        const uint32_t* wsh = w + kN;
        #pragma unroll 1
        for (int idx = threadIdx.x; idx < kN / 2; idx += blockDim.x) {
            const int c = idx & 127, bf = idx >> 7;
            const int g0 = (bf / h) * m + (bf % h), g1 = g0 + h;
            const uint32_t u = x[g0 * 128 + c], v = x[g1 * 128 + c];
            const int t = g1 * 128 + c;
            if (!Inverse) {
                x[g0 * 128 + c] = condsub(u + v, p2);
                x[t] = shoup_approx(u + p2 - v, __ldg(w + t), __ldg(wsh + t),
                                    a.p);
            } else {
                const uint32_t bw = shoup_approx(v, __ldg(w + t),
                                                 __ldg(wsh + t), a.p);
                x[g0 * 128 + c] = condsub(u + bw, p2);
                x[t] = condsub(u + p2 - bw, p2);
            }
        }
        __syncthreads();
    }
}

// A (the product's int8 rows) from x, per the op's split
template <int Op>
__device__ void build_a(int8_t* A, const uint32_t* x, const MxuArgs& a) {
    #pragma unroll 1
    for (int i = threadIdx.x; i < kN; i += blockDim.x) {
        int8_t* row = A + (i >> 7) * kLda + (i & 127);
        const uint32_t v = x[i];
        if (Op == V4_FOLD || Op == V4_FWD_NOSPLIT) {
            row[0] = (int8_t)(v & 0xFF);  // read 3 times along k
        } else if (Op == V4_FWD) {
            // v4_fwd: d = (x & 0x3FFFFF) - 2^21, u = d + in_offset (2^22)
            const int u = (int)(v & 0x3FFFFFu) - (1 << 21) + (1 << 22);
            #pragma unroll
            for (int j = 0; j < 3; ++j) row[128 * j] = mma8::offset_limb(u, j);
        } else if (Op == MM4) {
            int8_t d[4];
            mma8::split4_balanced((int)condsub(v, a.p), d);
            #pragma unroll
            for (int j = 0; j < 4; ++j) row[128 * j] = d[j];
        } else {  // the offset split of a canonical value
            const int u = (int)condsub(v, a.p);
            #pragma unroll
            for (int j = 0; j < 4; ++j) row[128 * j] = mma8::offset_limb(u, j);
        }
    }
    __syncthreads();
}

// the product and its epilogue: x[r][c] <- f(U_0 .. U_3 of (r, c))
template <int Op, int MT>
__device__ void product(uint32_t* x, const int8_t* A, const MxuArgs& a,
                        uint32_t& junk) {
    const int c0 = 8 * (threadIdx.x >> 5);
    int U[MT][4][4];
    mma8::product_4blocks<MT>(U, A, kLda, [](int) { return 0; },
                              Op == V4_FOLD || Op == V4_FWD_NOSPLIT ? 127 : -1,
                              a.bt, k_of(Op), c0);
    const uint32_t p2 = 2 * a.p;
    #pragma unroll
    for (int e = 0; e < 4; ++e) {
        const int r = mma8::frag_row(e), c = mma8::frag_col(c0, e);
        const int g = r;  // the v4 group
        const int u[4] = {U[0][0][e], U[0][1][e], U[0][2][e], U[0][3][e]};
        uint32_t out;
        if (Op == V3_FWD || Op == V3_INV) {
            out = recombine_v3(u, c, a);
            if (Op == V3_INV) out = condsub(out, a.p);
        } else if (Op == MM4 || Op == MM1) {
            int acc;
            if constexpr (MT == 1) {
                acc = u[0] + u[1] + u[2] + u[3];
            } else if constexpr (MT == 2) {  // U[:128, :128] + U[128:, :128] + ...
                acc = U[0][0][e] + U[1][0][e] + U[0][1][e] + U[1][3][e];
                junk ^= U[0][2][e] ^ U[0][3][e] ^ U[1][1][e] ^ U[1][2][e];
            } else {
                acc = U[0][0][e] + U[1][0][e] + U[2][1][e] + U[3][3][e];
                #pragma unroll
                for (int mt = 0; mt < MT; ++mt)
                    #pragma unroll
                    for (int j = 0; j < 4; ++j)
                        if (!(j == 0 && mt < 2) && !(j == 1 && mt == 2)
                            && !(j == 3 && mt == 3))
                            junk ^= U[mt][j][e];
            }
            out = (uint32_t)acc + x[r * 128 + c];
        } else if (Op == V4_FOLD) {
            out = mma8::pair_fold(u[0], u[1]) ^ mma8::pair_fold(u[2], u[3]);
        } else if (Op == V4_INV_MMR || Op == V4_INV) {
            const uint32_t v0 = mma8::pair_fold(u[0], u[1]);
            const uint32_t v1 = mma8::pair_fold(u[2], u[3]);
            uint32_t r0;
            if (Op == V4_INV_MMR) {  // the exact _mul_hi, as the case has it
                r0 = v0 - __umulhi(v0, a.one_sh) * a.p;
            } else {  // _inv_ntt_v4's approx Barrett fold
                r0 = mma8::condsub_wide(
                    v0 - mma8::mulhi_approx(v0, a.one_sh) * a.p, p2);
            }
            const uint32_t r1 = shoup_approx(v1, a.c16, a.c16_sh, a.p);
            uint32_t s = condsub(r0 + r1, p2);
            s = condsub(s + __ldg(a.bias + c), p2);
            out = condsub(s, a.p);
        } else {  // V4_FWD, V4_FWD_NOSPLIT: _fwd_tail_v4's twiddle scale
            const uint32_t v0 = mma8::pair_fold(u[0], u[1]);
            const uint32_t v1 = mma8::pair_fold(u[2], u[3]);
            const uint32_t* tw = a.tw + g * 128 + c;
            uint32_t s = shoup_approx(v0, __ldg(tw), __ldg(tw + kN), a.p);
            s = s + shoup_approx(v1, __ldg(tw + 2 * kN), __ldg(tw + 3 * kN),
                                 a.p);
            s = condsub(s, p2);
            out = condsub(s + __ldg(tw + 4 * kN), p2);
        }
        x[r * 128 + c] = out;
    }
    __syncthreads();
}

// two blocks an SM (64 registers a thread) but at 4 row copies (64
// accumulators a thread)
template <int Op, int MT>
__global__ void __launch_bounds__(kThreads, MT > 2 ? 1 : 2)
ntt_mxu_kernel(MxuArgs a) {
    __shared__ __align__(16) uint32_t x[kN];
    __shared__ __align__(16) int8_t A[kRows * kLda];
    const long long base = (long long)blockIdx.x * kN;
    const probe::OnePrime prime{a.p};
    uint32_t junk = 0;
    for (int i = threadIdx.x; i < kN; i += blockDim.x) x[i] = a.x_in[base + i];
    __syncthreads();
    #pragma unroll 1
    for (int t = 0; t < a.loops; ++t) {
        if (Op == V3_FWD) {
            probe::twist<1, 1>(x, 1, kLogN, a.plan, brk::T_TW, prime);
            probe::fwd_stages<1, 1>(x, 1, kLogN, 0, kLogN - 7, a.plan, prime);
        } else if (Op == V4_INV) {
            group_stages<true>(x, a);
            #pragma unroll 1
            for (int i = threadIdx.x; i < kN; i += blockDim.x)
                x[i] = condsub(shoup_approx(x[i], __ldg(a.tw + i),
                                            __ldg(a.tw + kN + i), a.p), a.p);
            __syncthreads();
        }
        if (Op == SPLIT4 || Op == V4_SPLIT4) {
            #pragma unroll 1
            for (int i = threadIdx.x; i < kN; i += blockDim.x) {
                const uint32_t v = x[i];
                if (Op == SPLIT4) {
                    int8_t d[4];
                    mma8::split4_balanced((int)v, d);
                    x[i] = (uint32_t)(int)d[0] + (uint32_t)(int)d[1] + v;
                } else {
                    x[i] = v + (uint32_t)(int)mma8::offset_limb(
                                   (int)condsub(v, a.p), 0);
                }
            }
            __syncthreads();
        } else {
            build_a<Op>(A, x, a);
            product<Op, MT>(x, A, a, junk);
        }
        if (Op == V3_INV) {
            probe::inv_stages<1, 1>(x, 1, kLogN, 0, kLogN - 7, a.plan, prime);
            probe::twist<1, 1>(x, 1, kLogN, a.plan, brk::T_UTW, prime);
        } else if (Op == V4_FWD || Op == V4_FWD_NOSPLIT) {
            group_stages<false>(x, a);
        }
    }
    for (int i = threadIdx.x; i < kN; i += blockDim.x) a.x_out[base + i] = x[i];
    if (a.sink) a.x_out[base + threadIdx.x] = junk;
}

template <int Op, int MT = 1>
int launch(int blocks, void* stream, const MxuArgs& a) {
    ntt_mxu_kernel<Op, MT><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

// x_in/x_out: u32 [polys, 2048]; bt: int8 [512][K] (the table transposed:
// K = 384 for the v4 forward products, else 512); bias: u32 [128]; plan:
// u32 [8][2048] (v3 ops); tw, gw: the v4 twiddles (v4 ops); copies: the
// rows' copies of MM1 (1, 2 or 4); sink must be 0.
extern "C" int ntt_mxu(const void* x_in, void* x_out, const void* bt,
                       const void* bias, const void* plan, const void* tw,
                       const void* gw, int polys, int op, int copies,
                       unsigned p, unsigned one_sh, unsigned c16,
                       unsigned c16_sh, int loops, int sink, void* stream) {
    const MxuArgs a{(const uint32_t*)x_in, (uint32_t*)x_out,
                    (const int8_t*)bt, (const uint32_t*)bias,
                    (const uint32_t*)plan, (const uint32_t*)tw,
                    (const uint32_t*)gw, (uint32_t)p, (uint32_t)one_sh,
                    (uint32_t)c16, (uint32_t)c16_sh, loops, sink};
    if (copies != 1 && (op != MM1 || (copies != 2 && copies != 4)))
        return (int)cudaErrorInvalidValue;
    switch (op) {
        case V3_FWD: return launch<V3_FWD>(polys, stream, a);
        case V3_INV: return launch<V3_INV>(polys, stream, a);
        case SPLIT4: return launch<SPLIT4>(polys, stream, a);
        case MM4: return launch<MM4>(polys, stream, a);
        case MM1:
            if (copies == 2) return launch<MM1, 2>(polys, stream, a);
            if (copies == 4) return launch<MM1, 4>(polys, stream, a);
            return launch<MM1>(polys, stream, a);
        case V4_FOLD: return launch<V4_FOLD>(polys, stream, a);
        case V4_SPLIT4: return launch<V4_SPLIT4>(polys, stream, a);
        case V4_INV_MMR: return launch<V4_INV_MMR>(polys, stream, a);
        case V4_FWD: return launch<V4_FWD>(polys, stream, a);
        case V4_FWD_NOSPLIT: return launch<V4_FWD_NOSPLIT>(polys, stream, a);
        case V4_INV: return launch<V4_INV>(polys, stream, a);
    }
    return (int)cudaErrorInvalidValue;
}
