// The per-kernel micro-benchmarks: looped micro-kernels, each running a
// run-time trip count of one primitive of the blind-rotation step on a tile
// resident in shared memory, built from the same ntt_common.cuh device
// functions as K1 and K3, so that each times what the step kernels run.
//
// Replaces: tfhe_tpu/ops/kernel_bench.py::_looped_pallas (pallas_call at
// :91) with its four bodies:
//   - kb_ntt: k negacyclic transforms of a row mod one prime, forward (the
//     twist, then forward_stages) or inverse (inverse_stages, then the
//     untwist); bench_ntt, :114-123;
//   - kb_mac: x <- sum_j x * g_j mod p over `terms` rows of g, each a Shoup
//     multiply against a true dual, summed with add_mod as the step's MAC
//     sums; bench_pointwise_mac, :152-160;
//   - kb_rotate: x <- x * X^{a_row} on u64 rows, the step's negacyclic
//     rotate (double-buffered: a rotation reads every element); bench_rotate,
//     :183-192;
//   - kb_decompose: hi <- hi + the sum of the balanced digits of (hi, lo)
//     (HiDecomposer), lo kept; bench_decompose, :211-222.
//
// One block of brk::kThreads threads per row, as the step kernels run one
// ciphertext per block. The trip count is a kernel argument, so nvcc cannot
// fold the loop; each pass ends in a __syncthreads as the step's passes do.
//
// Bound: the INT32 pipes (the per-pipe instruction counts of each loop body
// are read from the SASS the build leaves beside the library); the rows are
// read once and written once.

#include "ntt_common.cuh"

namespace {

using brk::kThreads;

// rows of N u32, one block per row: k forward or inverse transforms
template <bool Inverse>
__global__ void __launch_bounds__(kThreads)
kb_ntt_kernel(const uint32_t* __restrict__ x_in, uint32_t* __restrict__ x_out,
              const uint32_t* __restrict__ tables, int log_n, uint32_t p,
              int loops) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    uint32_t* x = reinterpret_cast<uint32_t*>(smem_raw);
    __shared__ uint32_t s_p[1];
    const int N = 1 << log_n;
    const long long row = (long long)blockIdx.x * N;
    if (threadIdx.x == 0) s_p[0] = p;
    for (int t = threadIdx.x; t < N; t += blockDim.x) x[t] = x_in[row + t];
    __syncthreads();
    const int tw = Inverse ? brk::T_UTW : brk::T_TW;
    for (int k = 0; k < loops; ++k) {
        if (Inverse) brk::inverse_stages<1>(x, 1, log_n, tables, s_p);
        for (int t = threadIdx.x; t < N; t += blockDim.x)
            x[t] = brk::shoup_mul(x[t], __ldg(tables + tw * N + t),
                                  __ldg(tables + (tw + 1) * N + t), p);
        __syncthreads();
        if (!Inverse) brk::forward_stages<1>(x, 1, log_n, tables, s_p);
    }
    for (int t = threadIdx.x; t < N; t += blockDim.x) x_out[row + t] = x[t];
}

// rows of N u32: k Shoup MACs against g [2 (residue, dual)][terms][N]
__global__ void __launch_bounds__(kThreads)
kb_mac_kernel(const uint32_t* __restrict__ x_in, uint32_t* __restrict__ x_out,
              const uint32_t* __restrict__ g, int terms, int log_n,
              uint32_t p, int loops) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    uint32_t* x = reinterpret_cast<uint32_t*>(smem_raw);
    const int N = 1 << log_n;
    const long long row = (long long)blockIdx.x * N;
    const uint32_t* g_sh = g + (long long)terms * N;
    for (int t = threadIdx.x; t < N; t += blockDim.x) x[t] = x_in[row + t];
    __syncthreads();
    for (int k = 0; k < loops; ++k) {
        for (int t = threadIdx.x; t < N; t += blockDim.x) {
            uint32_t acc_m = 0;
            for (int j = 0; j < terms; ++j)
                acc_m = brk::add_mod(
                    acc_m, brk::shoup_mul(x[t], __ldg(g + j * N + t),
                                          __ldg(g_sh + j * N + t), p), p);
            x[t] = acc_m;
        }
        __syncthreads();
    }
    for (int t = threadIdx.x; t < N; t += blockDim.x) x_out[row + t] = x[t];
}

// rows of N u64: k negacyclic rotations by X^{a[row]}, a in [0, 2N)
__global__ void __launch_bounds__(kThreads)
kb_rotate_kernel(const uint64_t* __restrict__ x_in,
                 uint64_t* __restrict__ x_out, const int32_t* __restrict__ a_in,
                 int log_n, int loops) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    uint64_t* cur = reinterpret_cast<uint64_t*>(smem_raw);
    const int N = 1 << log_n;
    uint64_t* nxt = cur + N;
    const long long row = (long long)blockIdx.x * N;
    const int a = a_in[blockIdx.x];
    for (int t = threadIdx.x; t < N; t += blockDim.x) cur[t] = x_in[row + t];
    __syncthreads();
    for (int k = 0; k < loops; ++k) {
        for (int t = threadIdx.x; t < N; t += blockDim.x) {
            int s = t - a;
            if (s < 0) s += 2 * N;
            const bool neg = s >= N;
            if (neg) s -= N;
            const uint64_t v = cur[s];
            nxt[t] = neg ? uint64_t(0) - v : v;
        }
        __syncthreads();
        uint64_t* tmp = cur;
        cur = nxt;
        nxt = tmp;
    }
    for (int t = threadIdx.x; t < N; t += blockDim.x) x_out[row + t] = cur[t];
}

// rows of N u64: k times hi <- hi + sum of the digits, lo kept
__global__ void __launch_bounds__(kThreads)
kb_decompose_kernel(const uint64_t* __restrict__ x_in,
                    uint64_t* __restrict__ x_out, int base_log, int levels,
                    int log_n, int loops) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    uint32_t* hi = reinterpret_cast<uint32_t*>(smem_raw);
    const int N = 1 << log_n;
    const long long row = (long long)blockIdx.x * N;
    const brk::HiDecomposer dec(base_log, levels);
    for (int t = threadIdx.x; t < N; t += blockDim.x)
        hi[t] = (uint32_t)(x_in[row + t] >> 32);
    __syncthreads();
    for (int k = 0; k < loops; ++k) {
        for (int t = threadIdx.x; t < N; t += blockDim.x) {
            int32_t state = dec.init(hi[t]);
            int32_t sum = 0;
            for (int lev = 0; lev < levels; ++lev) sum += dec.next(state);
            hi[t] += (uint32_t)sum;
        }
        __syncthreads();
    }
    for (int t = threadIdx.x; t < N; t += blockDim.x)
        x_out[row + t] = ((uint64_t)hi[t] << 32)
                         | (x_in[row + t] & 0xFFFFFFFFull);
}

// Launch `kernel` with one block of kThreads threads per row and `smem`
// bytes of dynamic shared memory on `stream`; cudaGetLastError() after it.
template <class... KArgs, class... Args>
int launch(void (*kernel)(KArgs...), int rows, size_t smem, void* stream,
           Args... args) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<rows, kThreads, smem, (cudaStream_t)stream>>>(
        static_cast<KArgs>(args)...);
    return (int)cudaGetLastError();
}

}  // namespace

// Each entry launches one block of brk::kThreads threads per row on
// `stream` and returns cudaGetLastError() after the launch (0 = launched).

// x_in/x_out: u32 [rows, N] residues mod p; tables: u32 [8, N]
// (ops/pbs_kernel.py::plan_tables of a one-prime plan).
extern "C" int kb_ntt(const void* x_in, void* x_out, const void* tables,
                      int rows, int log_n, unsigned p, int loops, int inverse,
                      void* stream) {
    const size_t smem = sizeof(uint32_t) << log_n;
    return launch(inverse ? kb_ntt_kernel<true> : kb_ntt_kernel<false>, rows,
                  smem, stream, x_in, x_out, tables, log_n, p, loops);
}

// x_in/x_out: u32 [rows, N]; g: u32 [2, terms, N] (residues < p, their
// Shoup duals floor(g * 2^32 / p)).
extern "C" int kb_mac(const void* x_in, void* x_out, const void* g, int rows,
                      int terms, int log_n, unsigned p, int loops,
                      void* stream) {
    return launch(kb_mac_kernel, rows, sizeof(uint32_t) << log_n, stream,
                  x_in, x_out, g, terms, log_n, p, loops);
}

// x_in/x_out: u64 [rows, N]; a: i32 [rows] in [0, 2N).
extern "C" int kb_rotate(const void* x_in, void* x_out, const void* a,
                         int rows, int log_n, int loops, void* stream) {
    return launch(kb_rotate_kernel, rows, 2 * sizeof(uint64_t) << log_n,
                  stream, x_in, x_out, a, log_n, loops);
}

// x_in/x_out: u64 [rows, N]; base_log * levels <= 31.
extern "C" int kb_decompose(const void* x_in, void* x_out, int rows,
                            int base_log, int levels, int log_n, int loops,
                            void* stream) {
    return launch(kb_decompose_kernel, rows, sizeof(uint32_t) << log_n,
                  stream, x_in, x_out, base_log, levels, log_n, loops);
}
