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
// Design: W512 and W384 (256 and 192 KiB) do not fit beside the tile in a
// block's 227 KB, so B fragments are read from the column-major copy
// through L2 (ldg), each pass of 32 rows (two row tiles: 32 accumulators a
// thread, two blocks of 512 threads per SM, so one block's matmul can run
// beside the other's Shoups) reading the whole table: 1 MiB of L2 reads a
// tile-trip for MM512 (four passes). Bound: the int8 tensor cores (dense
// peak), or L2; the rows give both. E2 reads only shared memory: its row is
// mma.sync's ceiling on this card.

#include "mma_int8.cuh"

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
mxu_probe_kernel(ProbeArgs a) {
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
// x_in/x_out: u32 [tiles, 8, 2048]; w512t, w384t: int8 W512^T [512][512]
// and W384^T [512][384]; op: the Op above; sink must be 0.
extern "C" int mxu_probe(const void* x_in, void* x_out, const void* w512t,
                         const void* w384t, int tiles, int op, unsigned p,
                         unsigned w, unsigned wsh, int loops, int sink,
                         void* stream) {
    const ProbeArgs a{(const uint32_t*)x_in, (uint32_t*)x_out,
                      (const int8_t*)w512t, (const int8_t*)w384t,
                      (uint32_t)p, (uint32_t)w, (uint32_t)wsh, loops, sink};
    const size_t smem = sizeof(uint32_t) * (kWords + 2 * kFoldRows * kTile)
                        + kTile * kLda;
    switch (op) {
        case MM512: return launch(mxu_probe_kernel<MM512>, tiles, kThreads, smem, stream, a);
        case MM384: return launch(mxu_probe_kernel<MM384>, tiles, kThreads, smem, stream, a);
        case MM256R: return launch(mxu_probe_kernel<MM256R>, tiles, kThreads, smem, stream, a);
        case SHOUP8: return launch(mxu_probe_kernel<SHOUP8>, tiles, kThreads, smem, stream, a);
        case SHOUP16: return launch(mxu_probe_kernel<SHOUP16>, tiles, kThreads, smem, stream, a);
        case MIX: return launch(mxu_probe_kernel<MIX>, tiles, kThreads, smem, stream, a);
        case MIX2: return launch(mxu_probe_kernel<MIX2>, tiles, kThreads, smem, stream, a);
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
