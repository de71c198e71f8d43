// K2: body rotation of the LUT accumulator, for Hopper, in the two output
// modes of the TPU kernel.
//
// Replaces: tfhe_tpu/ops/pbs_kernel.py::_build_body_rot_fn_v4 (the Pallas
// prologue of blind_rotate_pallas, its pallas_call at :1930), whose spec is
// monomial_div(lut, body) followed, in acc32 mode, by the acc32 rounding r32
// (tfhe_tpu/ops/bnf2.py:329-333):
//
//   body_rotate_acc32: out[b][r][t] = hi32(round32(lut[b][r] * X^{-body[b]})[t])
//   body_rotate_u64:   out[b][r][t] = (lut[b][r] * X^{-body[b]})[t]  (exact u64,
//                      the two-plane accumulator of K3)
//
// The rotation runs on the exact u64 coefficient and the acc32 fold comes
// after it: folding first would differ on negated coefficients (rounding -x
// is not the negation of rounding x at the half-way point).
//
// Bound: bytes. Each output word is written once and each LUT word read
// once (a LUT shared by the batch, [R, N], once for the whole call): at
// 2_2, B = 2048, 33.56 MB with the shared LUT, 100.7 MB with one LUT a
// ciphertext.
//
// body_rotate_acc32, the design for the H100. The sign of a rotated
// coefficient depends only on its source index, so the fold moves into a
// table of 2N u32 words a LUT row, built from the exact u64 words:
//
//   T[s] = fold(lut[s]),  T[N + s] = fold(0 - lut[s])        (s < N)
//   out[t] = T[(t - d) mod 2N],  d = (2N - body) mod 2N
//
// bit-exact with rotate-then-fold, the negation taken before the fold. The
// kernel is then a store stream out of a table at a per-ciphertext offset,
// each thread writing 4 output words with one 16-byte streaming store:
//
// - the table mode (a shared LUT, a batch that fills the card): one
//   1024-thread block an SM builds the R tables in shared memory (8RN
//   bytes, 32 KB at R = 2, N = 2048; four 16-byte loads in flight a
//   thread), then the grid walks the output with a grid stride, a chunk's
//   4 words taken from two aligned 16-byte shared-memory loads and a select
//   by (t - d) mod 4 (conflict-free; a warp stores 512 contiguous bytes);
// - the gather mode (a LUT a ciphertext, [B, R, N], the integer layer's
//   stacked LUTs; a batch too small to fill the card; tables beyond shared
//   memory; a LUT off 16-byte alignment): one thread a chunk, its 4 words
//   gathered from the LUT through L1 and folded, no table, no barrier (on
//   a LUT a ciphertext each row's table would be read once: a table built
//   in shared memory behind a barrier buys nothing there).
//
// body is read as int64, the modulus switch's output, so the wrapper
// launches nothing besides the kernel. N is a power of two, at least 4.
//
// body_rotate_u64, and body_rotate_acc32_r1 (the first design of the acc32
// mode, kept as the reference the redesign is timed against; no user path
// launches it): one 256-thread block a (ciphertext, row); threads walk the
// N output words with unit stride, each gathering and folding its own u64
// word (4- or 8-byte stores), with body as int32.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTableThreads = 1024;  // the table mode: one block an SM
constexpr int kGatherThreads = 256;
constexpr size_t kSmemLimit = 232448;  // a Hopper block's shared memory

__device__ __forceinline__ uint32_t fold32(uint64_t v) {
    return (uint32_t)((v + (1ull << 31)) >> 32);
}

struct FoldAcc32 {
    using Out = uint32_t;
    __device__ uint32_t operator()(uint64_t v) const { return fold32(v); }
};

struct ExactU64 {
    using Out = uint64_t;
    __device__ uint64_t operator()(uint64_t v) const { return v; }
};

template <class Fold>
__global__ void body_rotate_kernel(const uint64_t* __restrict__ lut,
                                   long long lut_batch_stride,
                                   const int32_t* __restrict__ body,
                                   typename Fold::Out* __restrict__ out,
                                   int R, int N) {
    const int r = blockIdx.x;
    const int b = blockIdx.y;
    const uint64_t* src = lut + (long long)b * lut_batch_stride
                          + (long long)r * N;
    typename Fold::Out* dst = out + ((long long)b * R + r) * N;
    const int two_n = 2 * N;
    // monomial_div by body == monomial_mul by d = (2N - body) mod 2N
    const int d = (two_n - body[b]) % two_n;
    for (int t = threadIdx.x; t < N; t += blockDim.x) {
        int s = t - d;
        if (s < 0) s += two_n;
        const bool neg = s >= N;
        if (neg) s -= N;
        uint64_t v = src[s];
        if (neg) v = 0ull - v;
        dst[t] = Fold()(v);
    }
}

// The tables T (2N words each) of the R rows of lut (N u64 words each,
// 16-byte aligned), by the whole block: each thread reads two words with
// one 16-byte load, four loads in flight before the folds.
__device__ __forceinline__ void build_tables(uint32_t* T,
                                             const uint64_t* __restrict__ lut,
                                             int R, int log_n) {
    const int half = 1 << (log_n - 1);  // 16-byte loads a row
    const int pairs = R * half;
    const int lane = threadIdx.x, stride = blockDim.x;
    const ulonglong2* src = reinterpret_cast<const ulonglong2*>(lut);
    uint2* T2 = reinterpret_cast<uint2*>(T);
    for (int i0 = lane; i0 < pairs; i0 += 4 * stride) {
        ulonglong2 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
            if (i0 + u * stride < pairs) v[u] = src[i0 + u * stride];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int i = i0 + u * stride;
            if (i >= pairs) break;
            const int pos = i + (i & ~(half - 1));  // row r: 2r half + j
            T2[pos] = make_uint2(fold32(v[u].x), fold32(v[u].y));
            T2[pos + half] = make_uint2(fold32(0ull - v[u].x),
                                        fold32(0ull - v[u].y));
        }
    }
}

// Table words p .. p + 3 (mod 2N), p of any alignment; T4 holds the 2N
// words as N/2 16-byte chunks (chunk_mask = N/2 - 1).
__device__ __forceinline__ uint4 window4(const uint4* T4, int p,
                                         int chunk_mask) {
    const int c = p >> 2;
    const uint4 x = T4[c];
    const int a = p & 3;
    if (a == 0) return x;
    const uint4 y = T4[(c + 1) & chunk_mask];
    if (a == 1) return make_uint4(x.y, x.z, x.w, y.x);
    if (a == 2) return make_uint4(x.z, x.w, y.x, y.y);
    return make_uint4(x.w, y.x, y.y, y.z);
}

// The table mode: lut [R, N] shared by the batch. Every block builds the
// R tables once, then the grid walks the 16-byte output chunks with a grid
// stride (a grid iteration writes one contiguous span, as a fill does),
// each thread prefetching the body of its next chunk's row, so the loop
// waits on no global load: two shared-memory loads and a streaming store
// a chunk.
__global__ void __launch_bounds__(kTableThreads)
body_rotate_table_kernel(const uint64_t* __restrict__ lut,
                         const long long* __restrict__ body,
                         uint4* __restrict__ out, int B, int R, int log_n) {
    extern __shared__ uint4 smem[];
    uint32_t* T = reinterpret_cast<uint32_t*>(smem);
    const int N = 1 << log_n, two_n = 2 * N, log_cpr = log_n - 2;
    const long long total = (long long)B * R << log_cpr;
    const long long step = (long long)gridDim.x * blockDim.x;
    long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    long long next = g < total ? body[(int)(g >> log_cpr) / R] : 0;
    build_tables(T, lut, R, log_n);
    __syncthreads();
    const uint4* T4 = reinterpret_cast<const uint4*>(T);
    for (; g < total; g += step) {
        const int row = (int)(g >> log_cpr);
        const int d = (int)((two_n - next) & (two_n - 1));
        if (g + step < total) next = body[(int)((g + step) >> log_cpr) / R];
        const int c = (int)g & ((1 << log_cpr) - 1);
        __stcs(out + g, window4(T4 + (row % R) * (N >> 1),
                                (4 * c - d) & (two_n - 1), N / 2 - 1));
    }
}

// The gather mode: one thread a 16-byte output chunk, no table; lut
// [R, N] (lut_batch_stride 0) or [B, R, N].
__global__ void __launch_bounds__(kGatherThreads)
body_rotate_gather_kernel(const uint64_t* __restrict__ lut,
                          long long lut_batch_stride,
                          const long long* __restrict__ body,
                          uint4* __restrict__ out, int B, int R, int log_n) {
    const int N = 1 << log_n, two_n = 2 * N;
    const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= (long long)B * R * (N >> 2)) return;
    const int row = (int)(g >> (log_n - 2)), c = (int)(g & ((N >> 2) - 1));
    const int b = row / R, r = row - b * R;
    const uint64_t* src = lut + b * lut_batch_stride + (long long)r * N;
    const int p = 4 * c - (int)((two_n - body[b]) & (two_n - 1));
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const int s = (p + k) & (two_n - 1);
        const uint64_t v = src[s & (N - 1)];
        w[k] = fold32((s & N) ? 0ull - v : v);
    }
    __stcs(out + g, make_uint4(w[0], w[1], w[2], w[3]));
}

template <class Fold>
int launch(const void* lut, long long lut_batch_stride, const void* body,
           void* out, int B, int R, int N, void* stream) {
    dim3 grid(R, B);
    body_rotate_kernel<Fold><<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)lut, lut_batch_stride, (const int32_t*)body,
        (typename Fold::Out*)out, R, N);
    return (int)cudaGetLastError();
}

}  // namespace

// lut: u64 [B, R, N] (lut_batch_stride = R*N) or [R, N] shared by the
// batch (lut_batch_stride = 0); body: i64 [B] (taken mod 2N); out: u32
// [B, R, N], 16-byte aligned; N a power of two >= 4. Returns
// cudaGetLastError() after the launch.
extern "C" int body_rotate_acc32(const void* lut, long long lut_batch_stride,
                                 const void* body, void* out, int B, int R,
                                 int N, void* stream) {
    if (B < 1 || R < 1 || N < 4 || (N & (N - 1)) != 0
        || ((uintptr_t)out & 15) != 0)
        return (int)cudaErrorInvalidValue;
    int log_n = 2;
    while ((1 << log_n) < N) ++log_n;
    int dev = 0, sms = 1;
    if (cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
               != cudaSuccess)
        return (int)cudaGetLastError();
    const long long chunks = (long long)B * R * (N / 4);
    const size_t smem = (size_t)R * 2 * N * sizeof(uint32_t);  // the tables
    cudaStream_t s = (cudaStream_t)stream;
    if (lut_batch_stride == 0 && chunks > 2048LL * sms && smem <= kSmemLimit
        && ((uintptr_t)lut & 15) == 0) {
        cudaError_t err = cudaFuncSetAttribute(
            body_rotate_table_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        body_rotate_table_kernel<<<sms, kTableThreads, smem, s>>>(
            (const uint64_t*)lut, (const long long*)body, (uint4*)out, B, R,
            log_n);
        return (int)cudaGetLastError();
    }
    const long long blocks = (chunks + kGatherThreads - 1) / kGatherThreads;
    body_rotate_gather_kernel<<<(unsigned)blocks, kGatherThreads, 0, s>>>(
        (const uint64_t*)lut, lut_batch_stride, (const long long*)body,
        (uint4*)out, B, R, log_n);
    return (int)cudaGetLastError();
}

// The first design of body_rotate_acc32, the reference it is timed
// against: as body_rotate_acc32, with body: i32 [B] in [0, 2N) and any N.
extern "C" int body_rotate_acc32_r1(const void* lut,
                                    long long lut_batch_stride,
                                    const void* body, void* out, int B,
                                    int R, int N, void* stream) {
    return launch<FoldAcc32>(lut, lut_batch_stride, body, out, B, R, N,
                             stream);
}

// As body_rotate_acc32_r1, with out: u64 [B, R, N].
extern "C" int body_rotate_u64(const void* lut, long long lut_batch_stride,
                               const void* body, void* out, int B, int R,
                               int N, void* stream) {
    return launch<ExactU64>(lut, lut_batch_stride, body, out, B, R, N,
                            stream);
}
