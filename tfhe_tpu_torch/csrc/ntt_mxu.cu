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
// Design (every op with a product: ntt_mxu_kernel, on wgmma; wgmma_int8.cuh):
// the int8 table (192 or 256 KiB) does not fit beside the data in a
// block's 227 KB, so a cluster of two CTAs holds it: rank h keeps the
// K-major slice of column blocks 2h and 2h + 1 (96 or 128 KiB), the pair
// the pair fold joins, laid out swizzled by the wrapper and copied once per
// launch by the TMA under an mbarrier: the table is read from device
// memory once per CTA, not once per polynomial-trip (the kept design, not
// the fallback ring). Each CTA owns two
// polynomials (8 KiB each in shared memory); the cluster's four are one
// m64 row tile: rows 16 (2h + p) + r. Per trip each CTA runs its stages,
// splits its polynomials into int8 limbs and writes those rows of A (one
// K-block per limb) into both CTAs (distributed shared memory); a cluster
// barrier; one warpgroup multiplies the tile by the CTA's slice (m64n256k32
// s8 -> s32: U_2h and U_2h+1 of a (row, lane) in one thread) and folds the
// pair into this CTA's term of the recombination (r0 or r1, the twiddled
// half, V0 or V1, or MM's partial sum); a polynomial's owner keeps its
// term, the other CTA sends its own to the owner's receive buffer (only
// folded values cross); a second cluster barrier, the owner combines the
// two terms and runs the remaining stages. Within a trip every stage
// waits on the product before or after it, so the INT32 work does not run
// beside the tensor cores here (the other CTAs of the card do). Bound: the
// int8 tensor cores or the INT32 glue (the stages, splits and reductions).
// ntt_mxu_kernel_sync is the first, mma.sync design, kept for the two ops
// without a product (SPLIT4, V4_SPLIT4) and as every other op's reference
// (ntt_mxu_sync): one polynomial a block, B fragments read from the
// wrapper's column-major copy through L2, the whole table a
// polynomial-trip. Each of the 16 warps owns lanes 8w .. 8w + 7 of the
// four column blocks, so a thread holds U_0 .. U_3 of one (row, lane) and
// the pair fold and recombination run in registers.

#include "mma_int8.cuh"
#include "ntt_common.cuh"
#include "probe_stages.cuh"
#include "wgmma_int8.cuh"

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
ntt_mxu_kernel_sync(MxuArgs a) {
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
    ntt_mxu_kernel_sync<Op, MT><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the wgmma design (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int kCluster = 2;    // CTAs a cluster: one pair of column blocks each
constexpr int kWgThreads = 256;
constexpr int kPolys = 2;      // polynomials a CTA
constexpr int kMRows = kCluster * kPolys * kRows;  // 64: the cluster's m64 tile
constexpr int kNp = 256;       // columns of U a CTA (its pair)

// int8 limbs (K-blocks of A) the split writes; the x-as-int8 products
// read their one K-block 3 times along k
__host__ __device__ constexpr int limbs_of(int op) {
    return op == V4_FOLD || op == V4_FWD_NOSPLIT ? 1 : op == V4_FWD ? 3 : 4;
}
__host__ __device__ constexpr bool is_mm(int op) {
    return op == MM4 || op == MM1;
}

// dynamic shared memory of ntt_mxu_kernel<op>: A (the cluster's 64 rows),
// the CTA's table slice, its polynomials and the receive buffer, the
// mbarrier, room to align to 1024 bytes
__host__ __device__ constexpr int wg_smem(int op) {
    return limbs_of(op) * kMRows * 128 + k_of(op) * kNp
           + 2 * kPolys * kN * 4 + 16 + 1024;
}

// MM1's sums over (copy, column block) (ntt_v3c_experiments.py:283-302;
// copies 1: every block of the one copy)
__device__ __forceinline__ bool picked(int copies, int copy, int j) {
    if (copies == 2)
        return (copy == 0 && j < 2) || (copy == 1 && (j == 0 || j == 3));
    if (copies == 4)
        return (j == 0 && copy < 2) || (copy == 2 && j == 1)
               || (copy == 3 && j == 3);
    return true;
}

// this CTA's term of element (row r, lane c) from its pair's U_lo, U_hi
// (rank 0: column blocks 0, 1; rank 1: 2, 3)
template <int Op>
__device__ __forceinline__ uint32_t term(int lo, int hi, uint32_t rank,
                                         int r, int c, const MxuArgs& a) {
    const uint32_t v = mma8::pair_fold(lo, hi);
    if (Op == V4_FOLD) return v;
    if (Op == V4_FWD || Op == V4_FWD_NOSPLIT) {
        const uint32_t* tw = a.tw + r * 128 + c + 2 * rank * kN;
        return shoup_approx(v, __ldg(tw), __ldg(tw + kN), a.p);
    }
    if (rank == 1) return shoup_approx(v, a.c16, a.c16_sh, a.p);
    if (Op == V4_INV)  // _inv_ntt_v4's approx Barrett fold
        return mma8::condsub_wide(v - mma8::mulhi_approx(v, a.one_sh) * a.p,
                                  2 * a.p);
    return v - __umulhi(v, a.one_sh) * a.p;  // the exact _mul_hi
}

// element (r, c)'s output from the two CTAs' terms (for MM: t0 + t1 + x)
template <int Op>
__device__ __forceinline__ uint32_t combine(uint32_t t0, uint32_t t1, int r,
                                            int c, const MxuArgs& a) {
    const uint32_t p2 = 2 * a.p;
    if (is_mm(Op)) return t0 + t1;
    if (Op == V4_FOLD) return t0 ^ t1;
    uint32_t s = condsub(t0 + t1, p2);
    if (Op == V4_FWD || Op == V4_FWD_NOSPLIT)
        return condsub(s + __ldg(a.tw + 4 * kN + r * 128 + c), p2);
    if (Op == V3_FWD || Op == V3_INV) {
        s = condsub(s + __ldg(a.bias + c), p2);
        return Op == V3_INV ? condsub(s, a.p) : s;
    }
    s = condsub(s + __ldg(a.bias + c), p2);
    return condsub(s, a.p);
}

template <int Op, int Copies>
__global__ void __cluster_dims__(kCluster, 1, 1)
__launch_bounds__(kWgThreads, 1) ntt_mxu_kernel(MxuArgs a) {
    extern __shared__ __align__(1024) unsigned char wg_smem_raw[];
    constexpr int K = k_of(Op), NL = limbs_of(Op);
    const uint32_t raw = wg::smem_u32(wg_smem_raw);
    const uint32_t A = (raw + 1023) & ~1023u;
    const uint32_t Wt = A + NL * kMRows * 128;
    const uint32_t Xa = Wt + K * kNp, Ra = Xa + kPolys * kN * 4;
    const uint32_t bar = Ra + kPolys * kN * 4;
    uint32_t* x = reinterpret_cast<uint32_t*>(wg_smem_raw + (Xa - raw));
    const uint32_t* R = x + kPolys * kN;
    const uint32_t rank = wg::cluster_rank(), peer = rank ^ 1;
    const probe::OnePrime prime{a.p};
    wg::load_init(bar);
    if (threadIdx.x == 0) {
        wg::load_expect(bar, K * kNp);
        wg::load_copy(Wt, a.bt + rank * K * kNp, K * kNp, bar);
    }
    const long long base = (long long)blockIdx.x * kPolys * kN;
    for (int i = threadIdx.x; i < kPolys * kN; i += blockDim.x)
        x[i] = a.x_in[base + i];
    int acc[128];
    #pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0;
    uint32_t junk = 0;
    wg::load_wait(bar);
    wg::cluster_sync<false>();  // x whole; every CTA of the cluster runs before any DSMEM access
    #pragma unroll 1
    for (int t = 0; t < a.loops; ++t) {
        if (Op == V3_FWD) {
            probe::twist<1, 1>(x, kPolys, kLogN, a.plan, brk::T_TW, prime);
            probe::fwd_stages<1, 1>(x, kPolys, kLogN, 0, kLogN - 7, a.plan,
                                    prime);
        } else if (Op == V4_INV) {
            for (int p = 0; p < kPolys; ++p) group_stages<true>(x + p * kN, a);
            #pragma unroll 1
            for (int i = threadIdx.x; i < kPolys * kN; i += blockDim.x) {
                const int e = i & (kN - 1);
                x[i] = condsub(shoup_approx(x[i], __ldg(a.tw + e),
                                            __ldg(a.tw + kN + e), a.p), a.p);
            }
            __syncthreads();
        }
        // A: this CTA's rows 16 (2 rank + p) + r, K-block j = limb j, in
        // both CTAs; thread: (polynomial p, row r, 16 lanes from 16 cc)
        {
            const int p = threadIdx.x >> 7, r = (threadIdx.x >> 3) & 15;
            const int cc = threadIdx.x & 7;
            const uint32_t* src = x + p * kN + r * 128 + 16 * cc;
            uint32_t w[NL][4];
            #pragma unroll
            for (int j = 0; j < NL; ++j)
                #pragma unroll
                for (int q = 0; q < 4; ++q) w[j][q] = 0;
            #pragma unroll
            for (int e = 0; e < 16; ++e) {
                const uint32_t v = src[e];
                int8_t d[4];
                if (Op == V4_FOLD || Op == V4_FWD_NOSPLIT) {
                    d[0] = (int8_t)(v & 0xFF);
                } else if (Op == V4_FWD) {
                    // v4_fwd: (x & 0x3FFFFF) - 2^21 + in_offset (2^22)
                    const int u = (int)(v & 0x3FFFFFu) - (1 << 21) + (1 << 22);
                    #pragma unroll
                    for (int j = 0; j < 3; ++j) d[j] = mma8::offset_limb(u, j);
                } else if (Op == MM4) {
                    mma8::split4_balanced((int)condsub(v, a.p), d);
                } else {
                    const int u = (int)condsub(v, a.p);
                    #pragma unroll
                    for (int j = 0; j < 4; ++j) d[j] = mma8::offset_limb(u, j);
                }
                #pragma unroll
                for (int j = 0; j < NL; ++j)
                    w[j][e >> 2] |= (uint32_t)(uint8_t)d[j] << (8 * (e & 3));
            }
            const int row = kRows * (kPolys * rank + p) + r;
            const uint32_t off = wg::swz(row * 128 + 16 * cc);
            #pragma unroll
            for (int j = 0; j < NL; ++j)
                #pragma unroll
                for (int dst = 0; dst < kCluster; ++dst)
                    wg::st_cluster(wg::mapa(A + j * kMRows * 128 + off, dst),
                                   make_uint4(w[j][0], w[j][1], w[j][2],
                                              w[j][3]));
        }
        wg::cluster_sync<true>();
        // the first warpgroup: A [64, K] @ this CTA's [K, 256] (Copies
        // times: MM1's repeated rows, every MAC issued), then per (row,
        // lane) this CTA's term; warp w holds polynomial w of the tile
        if (threadIdx.x < 128) {
            const int slot = threadIdx.x >> 5, pl = slot & 1;
            const bool own = (slot >> 1) == (int)rank;
            uint32_t part[64];
            #pragma unroll
            for (int i = 0; i < 64; ++i) part[i] = 0;
            #pragma unroll 1
            for (int copy = 0; copy < Copies; ++copy) {
                wg::fence();
                #pragma unroll 1
                for (int kb = 0; kb < K / 128; ++kb) {
                    const uint32_t akb = NL == 1 ? 0 : kb;
                    #pragma unroll
                    for (int k = 0; k < 4; ++k)
                        wg::mma_n256(acc,
                                     wg::desc(A + akb * kMRows * 128 + 32 * k),
                                     wg::desc(Wt + kb * kNp * 128 + 32 * k),
                                     kb | k);
                }
                wg::commit();
                wg::wait_all();
                wg::fence_acc(acc);
                if (is_mm(Op)) {
                    const bool pl_ = picked(Copies, copy, 2 * rank);
                    const bool ph_ = picked(Copies, copy, 2 * rank + 1);
                    #pragma unroll
                    for (int i = 0; i < 64; ++i) {
                        const uint32_t lo = acc[i], hi = acc[i + 64];
                        part[i] += (pl_ ? lo : 0u) + (ph_ ? hi : 0u);
                        junk ^= (pl_ ? 0u : lo) ^ (ph_ ? 0u : hi);
                    }
                }
            }
            const uint32_t dst = wg::mapa(Ra + 4 * pl * kN, peer);
            #pragma unroll
            for (int i = 0; i < 64; i += 2) {
                const int r = wg::acc_row(i) & 15, c = wg::acc_col(i);
                uint32_t v0, v1;
                if (is_mm(Op)) {
                    v0 = part[i];
                    v1 = part[i + 1];
                } else {
                    v0 = term<Op>(acc[i], acc[i + 64], rank, r, c, a);
                    v1 = term<Op>(acc[i + 1], acc[i + 65], rank, r, c + 1, a);
                }
                uint32_t* o = x + pl * kN + r * 128 + c;
                if (own) {
                    o[0] = is_mm(Op) ? v0 + o[0] : v0;
                    o[1] = is_mm(Op) ? v1 + o[1] : v1;
                } else {
                    wg::st_cluster(dst + 4 * (r * 128 + c), v0, v1);
                }
            }
        }
        wg::cluster_sync<false>();
        #pragma unroll 1
        for (int i = threadIdx.x; i < kPolys * kN; i += blockDim.x) {
            const int r = (i >> 7) & 15, c = i & 127;
            x[i] = rank == 0 ? combine<Op>(x[i], R[i], r, c, a)
                             : combine<Op>(R[i], x[i], r, c, a);
        }
        __syncthreads();
        if (Op == V3_INV) {
            probe::inv_stages<1, 1>(x, kPolys, kLogN, 0, kLogN - 7, a.plan,
                                    prime);
            probe::twist<1, 1>(x, kPolys, kLogN, a.plan, brk::T_UTW, prime);
        } else if (Op == V4_FWD || Op == V4_FWD_NOSPLIT) {
            for (int p = 0; p < kPolys; ++p) group_stages<false>(x + p * kN, a);
        }
    }
    for (int i = threadIdx.x; i < kPolys * kN; i += blockDim.x)
        a.x_out[base + i] = x[i];
    if (a.sink) a.x_out[base + threadIdx.x] = junk;
}

template <int Op, int Copies = 1>
int launch_wg(int blocks, void* stream, const MxuArgs& a) {
    const auto kernel = ntt_mxu_kernel<Op, Copies>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, wg_smem(Op));
    if (err != cudaSuccess) return (int)err;
    kernel<<<blocks, kWgThreads, wg_smem(Op), (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

template <int Op, int Copies = 1>
int occupancy(int* out) {
    const auto kernel = ntt_mxu_kernel<Op, Copies>;
    const int smem = wg_smem(Op);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes fa;
    if ((err = cudaFuncGetAttributes(&fa, kernel)) != cudaSuccess)
        return (int)err;
    out[0] = fa.numRegs;
    out[1] = (int)fa.localSizeBytes;
    out[2] = smem;
    out[3] = kCluster;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &out[4], kernel, kWgThreads, smem)) != cudaSuccess)
        return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(264);
    cfg.blockDim = dim3(kWgThreads);
    cfg.dynamicSmemBytes = smem;
    return (int)cudaOccupancyMaxActiveClusters(&out[5], kernel, &cfg);
}

}  // namespace

// ntt_mxu_sync (every op, the mma.sync kernel): x_in/x_out: u32 [polys, 2048];
// bt: int8 [512][K] (the table transposed:
// K = 384 for the v4 forward products, else 512); bias: u32 [128]; plan:
// u32 [8][2048] (v3 ops); tw, gw: the v4 twiddles (v4 ops); copies: the
// rows' copies of MM1 (1, 2 or 4); sink must be 0.
extern "C" int ntt_mxu_sync(const void* x_in, void* x_out, const void* bt,
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

// ntt_mxu (the ops with a product, on wgmma, ntt_mxu_kernel): the
// arguments of ntt_mxu_sync, but bt is the table's cluster image, int8
// [2][K][256], rank h's slice the K-major swizzled columns 256 h .. 256 h
// + 255 (tools/_wgmma.py), and polys a multiple of 4 (two CTAs of two).
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
    if (polys % (kCluster * kPolys) || (copies != 1 && op != MM1))
        return (int)cudaErrorInvalidValue;
    const int blocks = polys / kPolys;
    switch (op) {
        case V3_FWD: return launch_wg<V3_FWD>(blocks, stream, a);
        case V3_INV: return launch_wg<V3_INV>(blocks, stream, a);
        case MM4: return launch_wg<MM4>(blocks, stream, a);
        case MM1:
            if (copies == 2) return launch_wg<MM1, 2>(blocks, stream, a);
            if (copies == 4) return launch_wg<MM1, 4>(blocks, stream, a);
            if (copies == 1) return launch_wg<MM1>(blocks, stream, a);
            break;
        case V4_FOLD: return launch_wg<V4_FOLD>(blocks, stream, a);
        case V4_INV_MMR: return launch_wg<V4_INV_MMR>(blocks, stream, a);
        case V4_FWD: return launch_wg<V4_FWD>(blocks, stream, a);
        case V4_FWD_NOSPLIT: return launch_wg<V4_FWD_NOSPLIT>(blocks, stream, a);
        case V4_INV: return launch_wg<V4_INV>(blocks, stream, a);
    }
    return (int)cudaErrorInvalidValue;
}

// ntt_mxu_kernel<op, copies>' registers, local bytes a thread, dynamic
// shared memory, cluster size, resident blocks per SM and clusters on the
// card into out[0..5]; 0 or the CUDA error
extern "C" int ntt_mxu_occupancy(int op, int copies, int* out) {
    switch (op) {
        case V3_FWD: return occupancy<V3_FWD>(out);
        case V3_INV: return occupancy<V3_INV>(out);
        case MM4: return occupancy<MM4>(out);
        case MM1:
            if (copies == 2) return occupancy<MM1, 2>(out);
            if (copies == 4) return occupancy<MM1, 4>(out);
            return occupancy<MM1>(out);
        case V4_FOLD: return occupancy<V4_FOLD>(out);
        case V4_INV_MMR: return occupancy<V4_INV_MMR>(out);
        case V4_FWD: return occupancy<V4_FWD>(out);
        case V4_FWD_NOSPLIT: return occupancy<V4_FWD_NOSPLIT>(out);
        case V4_INV: return occupancy<V4_INV>(out);
    }
    return (int)cudaErrorInvalidValue;
}
