// The int8 tensor-core probes on Hopper: looped kernels on mma.sync
// (mma_int8.cuh), one block per [8, 2048] u32 tile resident in shared
// memory, a run-time trip count.
//
// Replaces: tools/mxu_probe.py::run_case (pallas_call at :60), each case by
// its JAX name and formula (Op):
//   - MM512: L = the tile as [128, 128], low bytes as int8 (two's
//     complement), [L L L L] @ W512 [512, 512] -> int32 U, then fold:
//     V = U[:, :128] + (U[:, 128:256] << 8) as u32, x ^= 3 V_flat[:2048]
//     on every row of the tile (matmul_512x512);
//   - MM384: [L L L] @ W384 [384, 512], the same fold (matmul_384x512);
//   - MM256R: [[L L L]; [L L L]] (256 rows) @ W384, U[:128] folded
//     (matmul_256r_384x512);
//   - SHOUP8 / SHOUP16: 8 or 16 chained _shoup(x, W, WSH, P0) in the JAX
//     package's default approx mode (shoup_x8, shoup_x16);
//   - MIX: U of MM512 from x, y = 8 Shoups of x, x <- fold(y, U)
//     (mix_matmul512_shoupx8); MIX2: U of MM512 and U2 of MM384, y = 16
//     Shoups, x <- fold(fold(y, U), U2) (mix_2matmul_shoupx16).
// L is the one 16 KiB tile addressed 4 or 3 times along k, not a copy.
// Every MAC the JAX case counts is issued, though the fold reads only
// rows 0..15 and columns 0..255 of U: the rest is XOR-ed into a value
// stored only under a flag the wrapper keeps 0.
// And tools/kernel_experiments.py::run_matmul (pallas_call at :108, E2):
//   - e2_kernel: acc += L [128, 512] @ W [512, 128] per trip, L and W^T
//     resident in shared memory (135 KiB: one block per SM), the int32
//     accumulator wrapping, one block per SM, each with its own L.
//
// Design (the product cases MM512, MM384, MM256R, MIX, MIX2:
// mxu_probe_kernel, on wgmma; wgmma_int8.cuh): W512 and W384 (256 and 192
// KiB) do not fit beside a tile in a block's 227 KB, so they are held by a
// thread-block cluster: of two CTAs, each the K-major slice of a pair of
// column blocks (W^T[256 r .. 256 r + 255][K], 128 / 96 KiB), or, for
// MIX2, whose two slices would not fit so, of four, each one block (64 +
// 48 KiB). The wrapper lays the slices out swizzled, and each CTA copies
// its own once per launch by the TMA under an mbarrier: the tables are
// read from device memory once per CTA, not once per trip (the kept
// design, not the fallback ring). A CTA's tile lives in registers (32
// words a thread), so that MIX2 fits. Per trip each CTA writes its tile's
// L (one 16 KiB K-block, addressed 4 or 3 times along k by the
// descriptors: not a copy) into every CTA of the cluster (distributed
// shared memory), a cluster barrier, and each of the four warpgroups runs
// two (MM256R: four) m64n128k32 units, a row tile of the cluster's L
// times a 128-column block of the CTA's slice. The fold reads rows 0..15
// of column blocks 0 and 1 of each U: their holder sends those (16 x 128
// s32 each) to the tile's CTA, a second cluster barrier, and each CTA
// folds its tile. Every other product is XOR-ed into junk. The Shoup chain
// of MIX and MIX2 runs on the tile's registers, a part per unit,
// staggered across the warpgroups (odd ones before their products, even
// ones after) so that one warpgroup's Shoups run while another's products
// hold the tensor cores. Bound: the int8 tensor cores (dense peak) or, for
// the mixed cases, the INT32 pipes. A cluster of 4 runs on 120 of the 132
// SMs (30 clusters fit), a cluster of 2 on all.
// mxu_probe_kernel_sync is the first, mma.sync design, kept for the shoup
// cases, which have no product, and as the product cases' reference
// (mxu_probe_sync): B fragments read from the column-major copy through L2
// (ldg), each pass of 32 rows (two row tiles: 32 accumulators a thread, two
// blocks of 512 threads per SM, so one block's matmul can run beside the
// other's Shoups) reading the whole table: 1 MiB of L2 reads a tile-trip
// for MM512 (four passes). E2 reads only shared memory: its row is
// mma.sync's ceiling on this card.

#include <type_traits>
#include <utility>

#include "mma_int8.cuh"
#include "wgmma_int8.cuh"

namespace {

using mma8::pair_fold;

enum Op { MM512 = 0, MM384, MM256R, SHOUP8, SHOUP16, MIX, MIX2 };

constexpr int kThreads = 512;
constexpr int kTile = 128;            // the tile as [128, 128]
constexpr int kWords = kTile * kTile;  // 16384 u32: [8, 2048]
constexpr int kLda = kTile + 16;       // L's padded row, bytes
constexpr int kMT = 2;                 // row tiles of a pass
constexpr int kFoldRows = 16;          // rows of U the fold reads (2048 / 128)

struct ProbeArgs {
    const uint32_t* x_in;
    uint32_t* x_out;
    const int8_t* w512t;  // W512^T [512][512]
    const int8_t* w384t;  // W384^T [512][384]
    uint32_t p, w, wsh;
    int loops, sink;
};

__host__ __device__ constexpr bool has_mm512(int op) {
    return op == MM512 || op == MIX || op == MIX2;
}
__host__ __device__ constexpr bool has_mm384(int op) {
    return op == MM384 || op == MM256R || op == MIX2;
}
__host__ __device__ constexpr int shoups(int op) {
    return op == SHOUP8 || op == MIX ? 8 : op == SHOUP16 || op == MIX2 ? 16
                                                                          : 0;
}

// V[r][c] = U0 + (U1 << 8) (wrapping, as u32) of rows r < 16 of
// [L ...] (rows rows, each row r reading L[r & 127]) @ W[K, 512]; every
// other product XOR-ed into junk
__device__ void product_fold(uint32_t* V, const int8_t* L,
                             const int8_t* __restrict__ Wt, int K, int rows,
                             uint32_t& junk) {
    const int c0 = 8 * (threadIdx.x >> 5);
    #pragma unroll 1
    for (int m0 = 0; m0 < rows / 16; m0 += kMT) {
        int U[kMT][4][4];
        mma8::product_4blocks<kMT>(
            U, L, kLda, [&](int mt) { return ((m0 + mt) * 16) & (kTile - 1); },
            kTile - 1, Wt, K, c0);
        #pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
            #pragma unroll
            for (int e = 0; e < 4; ++e) {
                if (m0 + mt == 0) {
                    V[mma8::frag_row(e) * kTile + mma8::frag_col(c0, e)] =
                        (uint32_t)U[mt][0][e] + ((uint32_t)U[mt][1][e] << 8);
                } else {
                    junk ^= (uint32_t)U[mt][0][e] ^ (uint32_t)U[mt][1][e];
                }
                junk ^= (uint32_t)U[mt][2][e] ^ (uint32_t)U[mt][3][e];
            }
    }
}

template <int Op>
__global__ void __launch_bounds__(kThreads, 2)
mxu_probe_kernel_sync(ProbeArgs a) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    uint32_t* x = reinterpret_cast<uint32_t*>(smem_raw);  // [16384]
    uint32_t* V = x + kWords;                             // [2][16][128]
    int8_t* L = reinterpret_cast<int8_t*>(V + 2 * kFoldRows * kTile);
    const long long base = (long long)blockIdx.x * kWords;
    uint32_t junk = 0;
    for (int i = threadIdx.x; i < kWords; i += blockDim.x)
        x[i] = a.x_in[base + i];
    __syncthreads();
    #pragma unroll 1
    for (int t = 0; t < a.loops; ++t) {
        if (has_mm512(Op) || has_mm384(Op)) {
            // L[r][c] = low byte of element (r, c) of x as [128, 128]
            for (int i = threadIdx.x; i < kWords; i += blockDim.x)
                L[(i >> 7) * kLda + (i & (kTile - 1))] = (int8_t)(x[i] & 0xFF);
            __syncthreads();
            if (has_mm512(Op))
                product_fold(V, L, a.w512t, 512, kTile, junk);
            if (has_mm384(Op))
                product_fold(V + (Op == MIX2 ? kFoldRows * kTile : 0), L,
                             a.w384t, 384, Op == MM256R ? 2 * kTile : kTile,
                             junk);
            __syncthreads();
        }
        #pragma unroll 1
        for (int i = threadIdx.x; i < kWords; i += blockDim.x) {
            uint32_t v = x[i];
            #pragma unroll
            for (int k = 0; k < shoups(Op); ++k)
                v = mma8::shoup_approx(v, a.w, a.wsh, a.p);
            if (Op != SHOUP8 && Op != SHOUP16)
                v ^= V[i & 2047] * 3u;
            if (Op == MIX2) v ^= V[kFoldRows * kTile + (i & 2047)] * 3u;
            x[i] = v;
        }
        __syncthreads();
    }
    for (int i = threadIdx.x; i < kWords; i += blockDim.x)
        a.x_out[base + i] = x[i];
    if (a.sink) a.x_out[base + threadIdx.x] = junk;
}

// ---------------------------------------------------------------------------
// the wgmma design (see the note at the top)
// ---------------------------------------------------------------------------

// CTAs a cluster: 2 (a pair of column blocks each) where the slices fit
// beside the cluster's L, MIX2's two tables need 4 (one block each)
__host__ __device__ constexpr int cluster_of(int op) {
    return op == MIX2 ? 4 : 2;
}
constexpr int kLBytes = kTile * kTile;    // L as [128][128 B]: one K-block
constexpr int kRecv = 2 * kFoldRows * kTile;  // u32 [2][16][128] a product
constexpr int kXChunks = kWords / 16 / kThreads;  // 2 chunks of 16 words a thread

__host__ __device__ constexpr int products(int op) {
    return (int)has_mm512(op) + (int)has_mm384(op);
}
__host__ __device__ constexpr int rowtiles384(int op) {
    return op == MM256R ? 4 : 2;  // m64 tiles of a tile's rows
}

// dynamic shared memory of mxu_probe_kernel<op>: L of the cluster's
// tiles, the CTA's table slices (512 / C columns), the fold's receive
// buffers, the mbarrier, and room to align the base to 1024 bytes
__host__ __device__ constexpr int wg_smem(int op) {
    return cluster_of(op) * kLBytes
           + ((has_mm512(op) ? 512 : 0) + (has_mm384(op) ? 384 : 0))
                 * (512 / cluster_of(op))
           + products(op) * kRecv * 4 + 16 + 1024;
}

// f(std::integral_constant<int, j>) for j = 0 .. N - 1, unrolled
template <class F, int... J>
__device__ __forceinline__ void unroll_(F&& f,
                                        std::integer_sequence<int, J...>) {
    (f(std::integral_constant<int, J>{}), ...);
}
template <int N, class F>
__device__ __forceinline__ void unroll(F&& f) {
    unroll_(f, std::make_integer_sequence<int, N>{});
}

struct WgSmem {
    uint32_t L, w512, w384, recv, bar;  // shared::cta addresses
};

// unit j of this warpgroup w's products: u = w + 4 j, an m64 row tile mt
// = u / H of the cluster's tiles (R a tile) times column block half q = u
// % H of this CTA's slice (H = 4 / C blocks of 128 columns): rows 64 (h &
// 1) .. of tile t = mt / R's L (the cluster's tile at rank t; h = mt % R)
// @ columns 128 q .. of the slice (K rows): issue, commit, wait; then
// rows 0..15 (h == 0, the warpgroup's first warp) of column blocks 0 and
// 1 (block H rank + q) go to tile t's CTA as recv[prod][block], the rest
// into junk. The Shoups of part Part of the tile's registers run on the
// INT32 pipes while another warpgroup's products hold the tensor cores:
// odd warpgroups before their products, even ones after (inside one
// warpgroup the compiler places them after the wait, where the
// accumulators are free)
template <int C, int K, int R, int NS, int Parts, int Part>
__device__ __forceinline__ void row_tile(
    uint32_t (&x)[32], const WgSmem& s, uint32_t w_slice, int j, int prod,
    uint32_t rank, const ProbeArgs& a, uint32_t& junk) {
    constexpr int H = 4 / C;
    const int wgi = wg::warpgroup();
    const int u = wgi + 4 * j, q = u % H, mt = u / H;
    const int t = mt / R, h = mt % R, block = H * rank + q;
    const uint32_t a0 = s.L + t * kLBytes + (h & 1) * 64 * 128;
    const uint32_t b0 = w_slice + q * 128 * 128;
    const auto shoups = [&] {  // two chains at a time
        #pragma unroll
        for (int v = 0; v < 32; v += 2)
            if (v / (32 / Parts) == Part) {
                wg::pin(x[v], x[v + 1]);
                #pragma unroll
                for (int i = 0; i < NS; ++i) {
                    x[v] = mma8::shoup_approx(x[v], a.w, a.wsh, a.p);
                    x[v + 1] = mma8::shoup_approx(x[v + 1], a.w, a.wsh, a.p);
                }
                wg::pin(x[v], x[v + 1]);
            }
    };
    const auto product = [&] {
        // the accumulators live from here to the epilogue only, so that
        // the fold and the L rows do not hold their 64 registers
        int acc[64];
        #pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0;
        wg::fence();
        #pragma unroll 1
        for (int kb = 0; kb < K / 128; ++kb) {
            #pragma unroll
            for (int k = 0; k < 4; ++k)
                wg::mma_n128(acc, wg::desc(a0 + 32 * k),
                             wg::desc(b0 + kb * (512 / C) * 128 + 32 * k),
                             kb | k);
        }
        wg::commit();
        wg::wait_all();
        wg::fence_acc(acc);
        if (h == 0 && ((threadIdx.x >> 5) & 3) == 0 && block < 2) {
            const uint32_t dst = wg::mapa(
                s.recv + 4 * (prod * kRecv + block * kFoldRows * kTile), t);
            #pragma unroll
            for (int i = 0; i < 64; i += 2)
                wg::st_cluster(
                    dst + 4 * (wg::acc_row(i) * kTile + wg::acc_col(i)),
                    (uint32_t)acc[i], (uint32_t)acc[i + 1]);
        } else {
            #pragma unroll
            for (int i = 0; i < 64; ++i) junk ^= (uint32_t)acc[i];
        }
    };
    if constexpr (NS == 0) {
        product();
    } else {
        // one copy of each piece of code, run in the warpgroup's order
        #pragma unroll 1
        for (int step = 0; step < 2; ++step) {
            if (step == ((wgi & 1) ? 0 : 1))
                shoups();
            else
                product();
        }
    }
}

// launched in clusters of cluster_of(Op) CTAs (launch_wg)
template <int Op>
__global__ void __launch_bounds__(kThreads, 1)
mxu_probe_kernel(ProbeArgs a) {
    extern __shared__ __align__(1024) unsigned char wg_smem_raw[];
    constexpr bool M5 = has_mm512(Op), M3 = has_mm384(Op);
    constexpr int C = cluster_of(Op), Nc = 512 / C;  // columns a CTA
    constexpr int R3 = rowtiles384(Op);
    constexpr int Parts = (M5 ? 2 : 0) + (M3 ? R3 : 0);  // units a warpgroup
    const uint32_t raw = wg::smem_u32(wg_smem_raw);
    WgSmem s;
    s.L = (raw + 1023) & ~1023u;
    s.w512 = s.L + C * kLBytes;
    s.w384 = s.w512 + (M5 ? 512 * Nc : 0);
    s.recv = s.w384 + (M3 ? 384 * Nc : 0);
    s.bar = s.recv + products(Op) * kRecv * 4;
    const uint32_t rank = wg::cluster_rank();
    wg::load_init(s.bar);
    if (threadIdx.x == 0) {
        wg::load_expect(s.bar, (M5 ? 512 * Nc : 0) + (M3 ? 384 * Nc : 0));
        if (M5) wg::load_copy(s.w512, a.w512t + rank * 512 * Nc, 512 * Nc,
                              s.bar);
        if (M3) wg::load_copy(s.w384, a.w384t + rank * 384 * Nc, 384 * Nc,
                              s.bar);
    }
    // the tile in registers: chunks q = threadIdx.x + 512 c of 16 words
    // (row q / 8 of the tile as [128, 128], columns 16 (q % 8) ..)
    const long long base = (long long)blockIdx.x * kWords;
    uint32_t x[32];
    #pragma unroll
    for (int c = 0; c < kXChunks; ++c) {
        const uint4* src = reinterpret_cast<const uint4*>(
            a.x_in + base + 16 * (threadIdx.x + kThreads * c));
        #pragma unroll
        for (int j = 0; j < 4; ++j) {
            const uint4 v = src[j];
            x[16 * c + 4 * j] = v.x; x[16 * c + 4 * j + 1] = v.y;
            x[16 * c + 4 * j + 2] = v.z; x[16 * c + 4 * j + 3] = v.w;
        }
    }
    uint32_t junk = 0;
    wg::load_wait(s.bar);
    wg::cluster_sync<false>();  // every CTA of the cluster runs before any DSMEM access
    #pragma unroll 1
    for (int trip = 0; trip < a.loops; ++trip) {
        // L of this tile (low bytes, as int8) into slot `rank` of every CTA
        #pragma unroll
        for (int c = 0; c < kXChunks; ++c) {
            const int q = threadIdx.x + kThreads * c, row = q >> 3;
            uint32_t w4[4];
            #pragma unroll
            for (int j = 0; j < 4; ++j)
                w4[j] = (x[16 * c + 4 * j] & 0xFF)
                        | (x[16 * c + 4 * j + 1] & 0xFF) << 8
                        | (x[16 * c + 4 * j + 2] & 0xFF) << 16
                        | (x[16 * c + 4 * j + 3] & 0xFF) << 24;
            const uint32_t off = s.L + rank * kLBytes
                                 + wg::swz(row * 128 + 16 * (q & 7));
            #pragma unroll
            for (int d = 0; d < C; ++d)
                wg::st_cluster(wg::mapa(off, d),
                               make_uint4(w4[0], w4[1], w4[2], w4[3]));
        }
        wg::cluster_sync<true>();
        // the products: warpgroup w takes units w, w + 4, .. (C tiles x 2
        // row tiles, MM256R's 384 product 4, x 4 / C column halves: 2 or
        // 4 a warpgroup), unrolled at compile time so that each one's part
        // of the Shoups is a constant
        if constexpr (M5)
            unroll<2>([&](auto j) {
                constexpr int J = decltype(j)::value;
                row_tile<C, 512, 2, shoups(Op), Parts, J>(
                    x, s, s.w512, J, 0, rank, a, junk);
            });
        if constexpr (M3)
            unroll<R3>([&](auto j) {
                constexpr int J = decltype(j)::value;
                row_tile<C, 384, R3, M5 ? shoups(Op) : 0, Parts,
                         (M5 ? 2 : 0) + J>(x, s, s.w384, J, M5 ? 1 : 0,
                                           rank, a, junk);
            });
        wg::cluster_sync<false>();
        // the fold: x ^= 3 V[i & 2047], V = u0 + (u1 << 8), per product
        const uint32_t* recv = reinterpret_cast<const uint32_t*>(
            wg_smem_raw + (s.recv - raw));
        #pragma unroll
        for (int c = 0; c < kXChunks; ++c) {
            const int q = threadIdx.x + kThreads * c;
            const int vi = ((q >> 3) & (kFoldRows - 1)) * kTile + 16 * (q & 7);
            #pragma unroll
            for (int pr = 0; pr < products(Op); ++pr) {
                #pragma unroll
                for (int e = 0; e < 16; ++e) {
                    const uint32_t* u = recv + pr * kRecv + vi + e;
                    x[16 * c + e] ^= (u[0] + (u[kFoldRows * kTile] << 8)) * 3u;
                }
            }
        }
    }
    #pragma unroll
    for (int c = 0; c < kXChunks; ++c) {
        uint4* dst = reinterpret_cast<uint4*>(
            a.x_out + base + 16 * (threadIdx.x + kThreads * c));
        #pragma unroll
        for (int j = 0; j < 4; ++j)
            dst[j] = make_uint4(x[16 * c + 4 * j], x[16 * c + 4 * j + 1],
                                x[16 * c + 4 * j + 2], x[16 * c + 4 * j + 3]);
    }
    if (a.sink) a.x_out[base + threadIdx.x] = junk;
}

// E2: acc += L @ W per trip. 256 threads, 8 warps of 64 rows x 32
// columns (4 x 4 tiles, 64 accumulators a thread); L [128][512] and W^T
// [128][512] in shared memory, rows padded by 16 bytes
constexpr int kE2Threads = 256;
constexpr int kE2K = 512, kE2Ld = kE2K + 16;

__global__ void __launch_bounds__(kE2Threads, 1)
e2_kernel(const int8_t* __restrict__ l_in, const int8_t* __restrict__ wt,
          int* __restrict__ out, int loops) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    int8_t* L = reinterpret_cast<int8_t*>(smem_raw);  // [128][528]
    int8_t* Wt = L + kTile * kE2Ld;                    // [128][528]
    const long long lbase = (long long)blockIdx.x * kTile * kE2K;
    for (int i = threadIdx.x; i < kTile * kE2K / 4; i += blockDim.x) {
        const int r = (4 * i) / kE2K, k = (4 * i) % kE2K;
        *reinterpret_cast<uint32_t*>(L + r * kE2Ld + k) =
            reinterpret_cast<const uint32_t*>(l_in + lbase)[i];
        *reinterpret_cast<uint32_t*>(Wt + r * kE2Ld + k) =
            reinterpret_cast<const uint32_t*>(wt)[i];
    }
    __syncthreads();
    const int warp = threadIdx.x >> 5;
    const int r0 = (warp & 1) * 64, n0 = (warp >> 1) * 32;
    int acc[4][4][4];
    #pragma unroll
    for (int m = 0; m < 4; ++m)
        #pragma unroll
        for (int n = 0; n < 4; ++n)
            #pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][n][e] = 0;
    #pragma unroll 1
    for (int t = 0; t < loops; ++t) {
        #pragma unroll 1
        for (int k0 = 0; k0 < kE2K; k0 += 32) {
            uint32_t av[4][4], b[4][2];
            #pragma unroll
            for (int m = 0; m < 4; ++m)
                mma8::load_a(av[m], L, kE2Ld, r0 + 16 * m, k0);
            #pragma unroll
            for (int n = 0; n < 4; ++n)
                mma8::load_b<false>(b[n][0], b[n][1], Wt, kE2Ld, n0 + 8 * n,
                                    k0);
            #pragma unroll
            for (int m = 0; m < 4; ++m)
                #pragma unroll
                for (int n = 0; n < 4; ++n)
                    mma8::mma(acc[m][n], av[m], b[n][0], b[n][1]);
        }
    }
    int* o = out + (long long)blockIdx.x * kTile * kTile;
    #pragma unroll
    for (int m = 0; m < 4; ++m)
        #pragma unroll
        for (int n = 0; n < 4; ++n)
            #pragma unroll
            for (int e = 0; e < 4; ++e)
                o[(r0 + 16 * m + mma8::frag_row(e)) * kTile
                  + mma8::frag_col(n0 + 8 * n, e)] = acc[m][n][e];
}

template <class K, class... Args>
int launch(K kernel, int blocks, int threads, size_t smem, void* stream,
           Args... args) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(args...);
    return (int)cudaGetLastError();
}

}  // namespace

// Each entry returns cudaGetLastError() after its launch (0 = launched) or
// cudaErrorInvalidValue for arguments the kernel does not take.
// mxu_probe_sync (every op, the mma.sync kernel): x_in/x_out: u32 [tiles, 8,
// 2048]; w512t, w384t: int8 W512^T [512][512] and W384^T [512][384]; op:
// the Op above; sink must be 0.
extern "C" int mxu_probe_sync(const void* x_in, void* x_out, const void* w512t,
                         const void* w384t, int tiles, int op, unsigned p,
                         unsigned w, unsigned wsh, int loops, int sink,
                         void* stream) {
    const ProbeArgs a{(const uint32_t*)x_in, (uint32_t*)x_out,
                      (const int8_t*)w512t, (const int8_t*)w384t,
                      (uint32_t)p, (uint32_t)w, (uint32_t)wsh, loops, sink};
    const size_t smem = sizeof(uint32_t) * (kWords + 2 * kFoldRows * kTile)
                        + kTile * kLda;
    switch (op) {
        case MM512: return launch(mxu_probe_kernel_sync<MM512>, tiles, kThreads, smem, stream, a);
        case MM384: return launch(mxu_probe_kernel_sync<MM384>, tiles, kThreads, smem, stream, a);
        case MM256R: return launch(mxu_probe_kernel_sync<MM256R>, tiles, kThreads, smem, stream, a);
        case SHOUP8: return launch(mxu_probe_kernel_sync<SHOUP8>, tiles, kThreads, smem, stream, a);
        case SHOUP16: return launch(mxu_probe_kernel_sync<SHOUP16>, tiles, kThreads, smem, stream, a);
        case MIX: return launch(mxu_probe_kernel_sync<MIX>, tiles, kThreads, smem, stream, a);
        case MIX2: return launch(mxu_probe_kernel_sync<MIX2>, tiles, kThreads, smem, stream, a);
    }
    return (int)cudaErrorInvalidValue;
}

// l_in: int8 [blocks, 128, 512]; wt: int8 W^T [128][512]; out: int32
// [blocks, 128, 128], acc after `loops` trips from 0.
extern "C" int mxu_e2(const void* l_in, const void* wt, void* out,
                      int blocks, int loops, void* stream) {
    const size_t smem = 2 * kTile * kE2Ld;
    return launch(e2_kernel, blocks, kE2Threads, smem, stream,
                  (const int8_t*)l_in, (const int8_t*)wt, (int*)out, loops);
}

// mxu_probe (the product ops MM512 .. MIX2 on wgmma, mxu_probe_kernel):
// w512i, w384i: the tables' cluster images at the op's cluster size C
// (cluster_of), int8 [C][512][512 / C] and [C][384][512 / C], rank r's
// slice the K-major swizzled W^T[512 r / C ..][K] (tools/_wgmma.py);
// tiles a multiple of C.
namespace {

template <int Op>
cudaLaunchConfig_t wg_config(int tiles, void* stream,
                             cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(tiles);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = wg_smem(Op);
    cfg.stream = (cudaStream_t)stream;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = cluster_of(Op);
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

template <int Op>
int launch_wg(int tiles, void* stream, const ProbeArgs& a) {
    if (tiles % cluster_of(Op)) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        mxu_probe_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        wg_smem(Op));
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = wg_config<Op>(tiles, stream, &attr);
    err = cudaLaunchKernelEx(&cfg, mxu_probe_kernel<Op>, a);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// registers, local bytes a thread, dynamic shared memory, cluster size,
// resident blocks per SM and clusters on the card into out[0..5]
template <int Op>
int occupancy(int* out) {
    const int smem = wg_smem(Op);
    cudaError_t err = cudaFuncSetAttribute(
        mxu_probe_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes fa;
    if ((err = cudaFuncGetAttributes(&fa, mxu_probe_kernel<Op>))
        != cudaSuccess)
        return (int)err;
    out[0] = fa.numRegs;
    out[1] = (int)fa.localSizeBytes;
    out[2] = smem;
    out[3] = cluster_of(Op);
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &out[4], mxu_probe_kernel<Op>, kThreads, smem)) != cudaSuccess)
        return (int)err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = wg_config<Op>(528, nullptr, &attr);
    return (int)cudaOccupancyMaxActiveClusters(&out[5], mxu_probe_kernel<Op>,
                                               &cfg);
}

}  // namespace

extern "C" int mxu_probe(const void* x_in, void* x_out, const void* w512i,
                         const void* w384i, int tiles, int op, unsigned p,
                         unsigned w, unsigned wsh, int loops, int sink,
                         void* stream) {
    const ProbeArgs a{(const uint32_t*)x_in, (uint32_t*)x_out,
                      (const int8_t*)w512i, (const int8_t*)w384i,
                      (uint32_t)p, (uint32_t)w, (uint32_t)wsh, loops, sink};
    switch (op) {
        case MM512: return launch_wg<MM512>(tiles, stream, a);
        case MM384: return launch_wg<MM384>(tiles, stream, a);
        case MM256R: return launch_wg<MM256R>(tiles, stream, a);
        case MIX: return launch_wg<MIX>(tiles, stream, a);
        case MIX2: return launch_wg<MIX2>(tiles, stream, a);
    }
    return (int)cudaErrorInvalidValue;
}

// mxu_probe_kernel<op>'s registers, local bytes a thread, dynamic shared
// memory, cluster size, resident blocks per SM and clusters on the card
// into out[0..5]; 0 or the CUDA error
extern "C" int mxu_probe_occupancy(int op, int* out) {
    switch (op) {
        case MM512: return occupancy<MM512>(out);
        case MM384: return occupancy<MM384>(out);
        case MM256R: return occupancy<MM256R>(out);
        case MIX: return occupancy<MIX>(out);
        case MIX2: return occupancy<MIX2>(out);
    }
    return (int)cudaErrorInvalidValue;
}
