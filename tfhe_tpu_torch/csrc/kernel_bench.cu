// The per-kernel micro-benchmarks: looped micro-kernels, each running a
// run-time trip count of one primitive of the blind-rotation step over the
// bench's rows, each built as the card's ceiling for that primitive: the
// step's own pieces where the step has them (the transforms), and the
// primitive alone, with nothing the step does not need, where the step
// fuses it into a pass (the MAC, the rotation, the decomposition). Every
// trip does the primitive's whole work on every element: no trip is folded
// into another, and what a trip reads (a row's rotation a_row) is read
// again each trip, as the step reads a_i each step.
//
// Replaces: tfhe_tpu/ops/kernel_bench.py::_looped_pallas (pallas_call at
// :91) with its four bodies:
//   - kb_ntt: k negacyclic transforms of a row mod one prime, forward (the
//     twist, then the DIF stages) or inverse (the inverse stages, then the
//     untwist); bench_ntt, :114-123. Bound: the INT32 pipes (12 Shoup
//     butterflies a thread-item), then the load/store pipe: each pass reads
//     and writes the row in shared memory, each butterfly reads a twiddle
//     and its dual. Design: the step's passes, built from the step's own
//     pieces (ntt_common.cuh: split_stages' plan, item_origin, the
//     swizzled row swz, lds_run / sts_run, and the stages of
//     fwd_regs_with<K> / inv_regs_with<K>, the functions the step's
//     fwd_regs / inv_regs call): passes of up to 3 stages in registers,
//     the twist fused into the first forward pass and the untwist into the
//     last inverse pass, one block barrier a pass: 4 passes a trip at N =
//     2048 (the radix-2 loop ran 11 stage barriers and a twist pass). The
//     kernel is a template on log2 N and its plan is split_stages' at
//     compile time, so every pass's strides, twiddle offsets and swizzled
//     addresses are constants. The stages read their twiddles through
//     StagedTwiddles where the step's read GlobalTwiddles (__ldg): the
//     direction's tables staged once a block in shared memory as 8-byte
//     (value, dual) pairs, 1.17-1.20x the same passes on __ldg (timed in
//     turns, PERF.md). The step's SASS is the same as with its stages
//     written out (compared function by function on the card). Block shape: 256 threads a
//     row (one 8-element item a thread in a 3-stage pass), one row a block,
//     48 registers; 128 threads a row, 512 (half of them idle in a 3-stage
//     pass) and two rows a block ran 1-8 % slower (PERF.md).
//   - kb_mac: x <- sum_j x * g_j mod p over `terms` rows of g, each a Shoup
//     multiply against a true dual, summed from 0 with add_mod as the
//     step's fused pass sums; bench_pointwise_mac, :152-160. Elementwise:
//     bound by the INT32 pipes alone, the FMA pipe's IMAD.HI first. Design:
//     a thread holds 8 elements of x, the rows' 8 words and their duals in
//     registers for all trips (16-byte loads at entry, stores at exit): no
//     shared memory, no barrier, no load inside the trip loop.
//   - kb_rotate: x <- x * X^{a_row} on u64 rows, the step's negacyclic
//     rotate; bench_rotate, :183-192. A trip permutes the row, so one
//     shared-memory round trip a trip stays: 16 B an element a trip at
//     128 B a clock an SM is 1.14x the INT32 bound of its index and
//     negation arithmetic, so shared memory bounds it. Design: the row
//     double-buffered, one barrier a trip; a template on log2 N, each of a
//     thread's N / 512 words a constant offset, loaded before any is
//     stored; lane-consecutive 8-byte words, the index and the negation as
//     selects (no branch). 16-byte pairs (a 16-byte load for an even
//     a_row, two 8-byte or a shuffle for an odd one) ran 1.1-1.9x slower
//     in turns. a_row is read from shared memory each trip, as the step
//     reads a_i: held in a register, nvcc computes the indices once for all
//     trips.
//   - kb_decompose: hi <- hi + the sum of the balanced digits of (hi, lo)
//     (HiDecomposer), lo kept; bench_decompose, :211-222. Elementwise,
//     bound by the INT32 pipes. Design: a thread holds 8 (hi, lo) pairs in
//     registers for all trips (16-byte loads and stores), no shared
//     memory, no barrier; the level loop runs over the 8 states at once.
// And the reference step kernels of the bench's step rows: K1 and K3 at
// P = 4 on the radix-2 step loop (blind_rotate_kernel<Tail, true>: one
// stage a pass, the MAC in a pass and buffer of its own), timed in turns
// with the step kernels themselves (fused_step_v6_r2, fused_step_r2). No
// entry point of the package runs them.
//
// Bound of every micro-kernel: the INT32 pipes at the work floor of the
// radix-2 loop (ops/kernel_bench.py SASS_OPS, read from that loop's SASS);
// the rows are read once and written once.

#include <utility>

#include "ntt_common.cuh"
#include "tails.cuh"

namespace {

constexpr int kNttThreads = 256;  // kb_ntt: a row a block
constexpr int kRotThreads = 512;  // kb_rotate: a row a block
constexpr int kMaxLogN = 12;      // kb_ntt, kb_rotate: N up to 4096
constexpr int kEw = 8;            // elements a thread: kb_mac, kb_decompose
constexpr int kEwThreads = 256;
constexpr int kMaxTerms = 4;      // kb_mac's rows g

// ---------------------------------------------------------------------------
// kb_ntt
// ---------------------------------------------------------------------------

// The passes of one transform at N = 2^L, in the order they run: stages
// [0, L) split as the step splits them (brk::split_stages: ceil(L / 3)
// passes of near-equal size, larger first), the forward ones from stage 0
// up, the inverse ones from stage L - 1 down
struct NttPlan {
    int n = 0, s0[brk::kMaxPasses] = {}, k[brk::kMaxPasses] = {};
};

__host__ __device__ constexpr NttPlan ntt_plan(int L, bool inverse) {
    NttPlan pl{};
    brk::split_stages(0, L, inverse, &pl.n, pl.s0, pl.k);
    return pl;
}

// The direction's twiddles staged in shared memory: twiddle jj and its
// Shoup dual as one 8-byte pair
struct StagedTwiddles {
    using Src = uint2;
    static __device__ __forceinline__ uint32_t w(const uint2* tw2, int,
                                                 int jj) {
        return tw2[jj].x;
    }
    static __device__ __forceinline__ uint32_t w_sh(const uint2* tw2, int,
                                                    int jj) {
        return tw2[jj].y;
    }
};

// One pass over the swizzled row x: forward stages S0 .. S0+K-1 (Inverse:
// inverse stages S0+K-1 .. S0), item g = r * kNttThreads + lane at a time,
// its 2^K positions i0 + m hl in registers, the stage twiddles from tw2;
// Twist: the twist (tt2) before the forward stages, or the untwist after
// the inverse ones. Ends in a block barrier.
template <int L, int S0, int K, bool Inverse, bool Twist>
__device__ __forceinline__ void ntt_pass(uint32_t* x, int lane,
                                         const uint2* tw2, const uint2* tt2,
                                         uint32_t p) {
    constexpr int N = 1 << L;
    constexpr int E = 1 << K;
    constexpr int LOG_HL = L - S0 - K;
    constexpr int ITEMS = N >> K;
    constexpr int ROUNDS = (ITEMS + kNttThreads - 1) / kNttThreads;
    #pragma unroll 1
    for (int r = 0; r < ROUNDS; ++r) {
        const int g = r * kNttThreads + lane;
        if (ITEMS % kNttThreads != 0 && g >= ITEMS) break;
        int j;
        const int i0 = brk::item_origin<K>(g, LOG_HL, &j);
        uint32_t v[E];
        if constexpr (LOG_HL == 0) {
            brk::lds_run<E>(x, i0, v);  // 2^K consecutive words
        } else {
            #pragma unroll
            for (int m = 0; m < E; ++m) v[m] = x[brk::swz(i0 + (m << LOG_HL))];
        }
        if constexpr (Twist && !Inverse) {
            #pragma unroll
            for (int m = 0; m < E; ++m) {
                const uint2 w = tt2[i0 + (m << LOG_HL)];
                v[m] = brk::shoup_mul(v[m], w.x, w.y, p);
            }
        }
        if constexpr (Inverse)
            brk::inv_regs_with<K, StagedTwiddles>(v, tw2, N, S0, j, LOG_HL, p);
        else
            brk::fwd_regs_with<K, StagedTwiddles>(v, tw2, N, S0, j, LOG_HL, p);
        if constexpr (Twist && Inverse) {
            #pragma unroll
            for (int m = 0; m < E; ++m) {
                const uint2 w = tt2[i0 + (m << LOG_HL)];
                v[m] = brk::shoup_mul(v[m], w.x, w.y, p);
            }
        }
        if constexpr (LOG_HL == 0) {
            brk::sts_run<E>(x, i0, v);
        } else {
            #pragma unroll
            for (int m = 0; m < E; ++m) x[brk::swz(i0 + (m << LOG_HL))] = v[m];
        }
    }
    __syncthreads();
}

// one transform: passes I .. of ntt_plan(L, Inverse), the first forward
// pass twisting, the last inverse pass untwisting
template <int L, bool Inverse, int I = 0>
__device__ __forceinline__ void ntt_trip(uint32_t* x, int lane,
                                         const uint2* tw2, const uint2* tt2,
                                         uint32_t p) {
    constexpr NttPlan PL = ntt_plan(L, Inverse);
    if constexpr (I < PL.n) {
        ntt_pass<L, PL.s0[I], PL.k[I], Inverse,
                 (Inverse ? I == PL.n - 1 : I == 0)>(x, lane, tw2, tt2, p);
        ntt_trip<L, Inverse, I + 1>(x, lane, tw2, tt2, p);
    }
}

// rows of N = 2^L u32, a row a block of kNttThreads threads: k forward or
// inverse transforms of each row, resident in shared memory (swizzled)
// from the first trip to the last, beside the direction's tables staged
// once a block as (value, Shoup dual) pairs
template <bool Inverse, int L>
__global__ void __launch_bounds__(kNttThreads, 4)
kb_ntt_kernel(const uint32_t* __restrict__ x_in, uint32_t* __restrict__ x_out,
              const uint32_t* __restrict__ tables, uint32_t p, int loops) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    constexpr int N = 1 << L;
    const int lane = threadIdx.x;
    uint32_t* x = reinterpret_cast<uint32_t*>(smem_raw);
    // after the row: the stage twiddles (tw2, stage s at N - (N >> s)) and
    // the twist or untwist (tt2)
    uint2* tw2 = reinterpret_cast<uint2*>(smem_raw + N * 4);
    uint2* tt2 = tw2 + N;
    const int st = Inverse ? brk::T_INV : brk::T_FWD;
    const int tt = Inverse ? brk::T_UTW : brk::T_TW;
    for (int t = lane; t < N; t += kNttThreads) {
        tw2[t] = make_uint2(tables[st * N + t], tables[(st + 1) * N + t]);
        tt2[t] = make_uint2(tables[tt * N + t], tables[(tt + 1) * N + t]);
    }
    const long long base = (long long)blockIdx.x * N;
    if constexpr (N >= 4) {
        for (int c = lane; c < N / 4; c += kNttThreads)
            *reinterpret_cast<uint4*>(x + brk::swz(4 * c)) =
                __ldg(reinterpret_cast<const uint4*>(x_in + base) + c);
    } else {
        for (int t = lane; t < N; t += kNttThreads) x[t] = x_in[base + t];
    }
    __syncthreads();
    #pragma unroll 1
    for (int k = 0; k < loops; ++k) ntt_trip<L, Inverse>(x, lane, tw2, tt2, p);
    if constexpr (N >= 4) {
        for (int c = lane; c < N / 4; c += kNttThreads)
            reinterpret_cast<uint4*>(x_out + base)[c] =
                *reinterpret_cast<const uint4*>(x + brk::swz(4 * c));
    } else {
        for (int t = lane; t < N; t += kNttThreads) x_out[base + t] = x[t];
    }
}

using NttKernel = void (*)(const uint32_t*, uint32_t*, const uint32_t*,
                           uint32_t, int);

// the instantiation at log2 N = log_n (1 .. kMaxLogN), or nullptr
template <bool Inverse, int... I>
NttKernel ntt_kernel_at(int log_n, std::integer_sequence<int, I...>) {
    static const NttKernel table[] = {kb_ntt_kernel<Inverse, I + 1>...};
    return log_n >= 1 && log_n <= kMaxLogN ? table[log_n - 1] : nullptr;
}

NttKernel ntt_kernel(bool inverse, int log_n) {
    using Seq = std::make_integer_sequence<int, kMaxLogN>;
    return inverse ? ntt_kernel_at<true>(log_n, Seq{})
                   : ntt_kernel_at<false>(log_n, Seq{});
}

// ---------------------------------------------------------------------------
// kb_mac, kb_decompose: elementwise, in registers
// ---------------------------------------------------------------------------

// kEw u32 words at g (16-byte aligned) and back
__device__ __forceinline__ void ld8(const uint32_t* __restrict__ g,
                                    uint32_t* v) {
    brk::ldg_run<kEw>(g, v);
}

__device__ __forceinline__ void st8(uint32_t* g, const uint32_t* v) {
    #pragma unroll
    for (int q = 0; q < kEw; q += 4)
        *reinterpret_cast<uint4*>(g + q) =
            make_uint4(v[q], v[q + 1], v[q + 2], v[q + 3]);
}

// `total` u32 elements in rows of N = 2^log_n: k Shoup MACs against g
// [2 (residue, dual)][TERMS][N]; a thread owns elements e0 .. e0 + 7 (one
// row's, 16-byte aligned, when N >= 8)
template <int TERMS>
__global__ void __launch_bounds__(kEwThreads, TERMS <= 2 ? 4 : 2)
kb_mac_kernel(const uint32_t* __restrict__ x_in, uint32_t* __restrict__ x_out,
              const uint32_t* __restrict__ g, long long total, int log_n,
              uint32_t p, int loops) {
    const long long e0 =
        ((long long)blockIdx.x * kEwThreads + threadIdx.x) * kEw;
    if (e0 >= total) return;
    const int N = 1 << log_n;
    const uint32_t* g_sh = g + (long long)TERMS * N;
    const bool vec = N >= kEw;
    uint32_t x[kEw], w[TERMS][kEw], ws[TERMS][kEw];
    if (vec) {
        const int t0 = (int)(e0 & (N - 1));
        ld8(x_in + e0, x);
        #pragma unroll
        for (int j = 0; j < TERMS; ++j) {
            ld8(g + j * N + t0, w[j]);
            ld8(g_sh + j * N + t0, ws[j]);
        }
    } else {
        #pragma unroll
        for (int e = 0; e < kEw; ++e) {
            const int t = (int)((e0 + e) & (N - 1));
            x[e] = e0 + e < total ? x_in[e0 + e] : 0u;
            #pragma unroll
            for (int j = 0; j < TERMS; ++j) {
                w[j][e] = g[j * N + t];
                ws[j][e] = g_sh[j * N + t];
            }
        }
    }
    #pragma unroll 1
    for (int k = 0; k < loops; ++k) {
        #pragma unroll
        for (int e = 0; e < kEw; ++e) {
            uint32_t acc = 0;
            #pragma unroll
            for (int j = 0; j < TERMS; ++j)
                acc = brk::add_mod(
                    acc, brk::shoup_mul(x[e], w[j][e], ws[j][e], p), p);
            x[e] = acc;
        }
    }
    if (vec) {
        st8(x_out + e0, x);
    } else {
        #pragma unroll
        for (int e = 0; e < kEw; ++e)
            if (e0 + e < total) x_out[e0 + e] = x[e];
    }
}

using MacKernel = void (*)(const uint32_t*, uint32_t*, const uint32_t*,
                           long long, int, uint32_t, int);

template <int... I>
MacKernel mac_kernel_at(int terms, std::integer_sequence<int, I...>) {
    static const MacKernel table[] = {kb_mac_kernel<I + 1>...};
    return terms >= 1 && terms <= kMaxTerms ? table[terms - 1] : nullptr;
}

// `total` u64 elements: k times hi <- hi + the sum of the digits, lo kept;
// a thread owns elements e0 .. e0 + 7 (four 16-byte words)
__global__ void __launch_bounds__(kEwThreads, 4)
kb_decompose_kernel(const uint64_t* __restrict__ x_in,
                    uint64_t* __restrict__ x_out, long long total,
                    int base_log, int levels, int loops) {
    const long long e0 =
        ((long long)blockIdx.x * kEwThreads + threadIdx.x) * kEw;
    if (e0 >= total) return;
    const bool full = e0 + kEw <= total;
    uint32_t hi[kEw], lo[kEw];
    if (full) {
        #pragma unroll
        for (int q = 0; q < kEw / 2; ++q) {
            const uint4 w =
                __ldg(reinterpret_cast<const uint4*>(x_in + e0) + q);
            lo[2 * q] = w.x;
            hi[2 * q] = w.y;
            lo[2 * q + 1] = w.z;
            hi[2 * q + 1] = w.w;
        }
    } else {
        #pragma unroll
        for (int e = 0; e < kEw; ++e) {
            const uint64_t v = e0 + e < total ? x_in[e0 + e] : 0ull;
            lo[e] = (uint32_t)v;
            hi[e] = (uint32_t)(v >> 32);
        }
    }
    const brk::HiDecomposer dec(base_log, levels);
    #pragma unroll 1
    for (int k = 0; k < loops; ++k) {
        int32_t state[kEw], sum[kEw];
        #pragma unroll
        for (int e = 0; e < kEw; ++e) {
            state[e] = dec.init(hi[e]);
            sum[e] = dec.next(state[e]);
        }
        #pragma unroll 1
        for (int lev = 1; lev < levels; ++lev) {
            #pragma unroll
            for (int e = 0; e < kEw; ++e) sum[e] += dec.next(state[e]);
        }
        #pragma unroll
        for (int e = 0; e < kEw; ++e) hi[e] += (uint32_t)sum[e];
    }
    if (full) {
        #pragma unroll
        for (int q = 0; q < kEw / 2; ++q)
            reinterpret_cast<uint4*>(x_out + e0)[q] =
                make_uint4(lo[2 * q], hi[2 * q], lo[2 * q + 1],
                           hi[2 * q + 1]);
    } else {
        #pragma unroll
        for (int e = 0; e < kEw; ++e)
            if (e0 + e < total)
                x_out[e0 + e] = ((uint64_t)hi[e] << 32) | lo[e];
    }
}

// ---------------------------------------------------------------------------
// kb_rotate
// ---------------------------------------------------------------------------

// rows of N = 2^L u64, a row a block of kRotThreads threads: k negacyclic
// rotations by X^{a[row]}, a in [0, 2N); the row double-buffered in shared
// memory, thread i moving words i + j kRotThreads (lane-consecutive 8-byte
// accesses), its PER sources loaded before any is stored; a_row read from
// shared memory each trip, as the step reads a_i each step, so that the
// index arithmetic runs every trip (branch-free: selects)
template <int L>
__global__ void __launch_bounds__(kRotThreads, 4)
kb_rotate_kernel(const uint64_t* __restrict__ x_in,
                 uint64_t* __restrict__ x_out, const int32_t* __restrict__ a_in,
                 int loops) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    constexpr int N = 1 << L;
    constexpr int PER = (N + kRotThreads - 1) / kRotThreads;
    uint64_t* cur = reinterpret_cast<uint64_t*>(smem_raw);
    uint64_t* nxt = cur + N;
    __shared__ int s_a;
    const long long base = (long long)blockIdx.x * N;
    if (threadIdx.x == 0) s_a = a_in[blockIdx.x];
    for (int q = threadIdx.x; q < N / 2; q += kRotThreads)
        reinterpret_cast<ulonglong2*>(cur)[q] =
            __ldg(reinterpret_cast<const ulonglong2*>(x_in + base) + q);
    __syncthreads();
    #pragma unroll 1
    for (int k = 0; k < loops; ++k) {
        const int a = *reinterpret_cast<volatile int*>(&s_a);
        uint64_t v[PER];
        bool neg[PER];
        #pragma unroll
        for (int i = 0; i < PER; ++i) {
            const int t = threadIdx.x + i * kRotThreads;
            int s = t - a;
            s += s < 0 ? 2 * N : 0;
            neg[i] = s >= N;
            s -= neg[i] ? N : 0;
            if (N % kRotThreads == 0 || t < N) v[i] = cur[s];
        }
        #pragma unroll
        for (int i = 0; i < PER; ++i) {
            const int t = threadIdx.x + i * kRotThreads;
            if (N % kRotThreads == 0 || t < N)
                nxt[t] = neg[i] ? 0ull - v[i] : v[i];
        }
        __syncthreads();
        uint64_t* tmp = cur;
        cur = nxt;
        nxt = tmp;
    }
    for (int q = threadIdx.x; q < N / 2; q += kRotThreads)
        reinterpret_cast<ulonglong2*>(x_out + base)[q] =
            reinterpret_cast<const ulonglong2*>(cur)[q];
}

using RotateKernel = void (*)(const uint64_t*, uint64_t*, const int32_t*,
                              int);

template <int... I>
RotateKernel rotate_kernel_at(int log_n, std::integer_sequence<int, I...>) {
    static const RotateKernel table[] = {kb_rotate_kernel<I + 1>...};
    return log_n >= 1 && log_n <= kMaxLogN ? table[log_n - 1] : nullptr;
}

RotateKernel rotate_kernel(int log_n) {
    return rotate_kernel_at(log_n,
                            std::make_integer_sequence<int, kMaxLogN>{});
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// Launch `kernel` as `blocks` blocks of `threads` threads with `smem` bytes
// of dynamic shared memory on `stream`; cudaGetLastError() after it.
template <class... KArgs, class... Args>
int launch(void (*kernel)(KArgs...), long long blocks, int threads,
           size_t smem, void* stream, Args... args) {
    if (blocks < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
        static_cast<KArgs>(args)...);
    return (int)cudaGetLastError();
}

// blocks of kEwThreads threads, kEw elements a thread, over `total`
long long ew_blocks(long long total) {
    const long long per_block = (long long)kEwThreads * kEw;
    return (total + per_block - 1) / per_block;
}

// the row, and the two staged tables of (value, dual) pairs
size_t ntt_smem(int log_n) {
    return (sizeof(uint32_t) + 2 * sizeof(uint2)) << log_n;
}
size_t rotate_smem(int log_n) { return 2 * sizeof(uint64_t) << log_n; }

// Resident blocks per SM of `kernel` at `threads` threads and `smem` bytes
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), its registers and local
// (spill) bytes a thread; negative: a CUDA error.
template <class... KArgs>
int occupancy(void (*kernel)(KArgs...), int threads, size_t smem, int* regs,
              int* local_bytes) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return -(int)err;
    *regs = attr.numRegs;
    *local_bytes = (int)attr.localSizeBytes;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return -(int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                         threads, smem);
    return err == cudaSuccess ? blocks : -(int)err;
}

}  // namespace

// Each entry launches its kernel on `stream` and returns
// cudaGetLastError() after the launch (0 = launched). Every pointer is
// 16-byte aligned.

// x_in/x_out: u32 [rows, N] residues mod p, N = 2^log_n, log_n in 1..12;
// tables: u32 [8, N] (ops/pbs_kernel.py::plan_tables of a one-prime plan).
extern "C" int kb_ntt(const void* x_in, void* x_out, const void* tables,
                      int rows, int log_n, unsigned p, int loops, int inverse,
                      void* stream) {
    const NttKernel kernel = ntt_kernel(inverse != 0, log_n);
    if (kernel == nullptr) return (int)cudaErrorInvalidValue;
    return launch(kernel, rows, kNttThreads, ntt_smem(log_n), stream, x_in,
                  x_out, tables, p, loops);
}

// x_in/x_out: u32 [rows, N]; g: u32 [2, terms, N] (residues < p, their
// Shoup duals floor(g * 2^32 / p)), terms in 1..4.
extern "C" int kb_mac(const void* x_in, void* x_out, const void* g, int rows,
                      int terms, int log_n, unsigned p, int loops,
                      void* stream) {
    const MacKernel kernel =
        mac_kernel_at(terms, std::make_integer_sequence<int, kMaxTerms>{});
    if (kernel == nullptr) return (int)cudaErrorInvalidValue;
    const long long total = (long long)rows << log_n;
    return launch(kernel, ew_blocks(total), kEwThreads, 0, stream, x_in,
                  x_out, g, total, log_n, p, loops);
}

// x_in/x_out: u64 [rows, N]; a: i32 [rows] in [0, 2N).
extern "C" int kb_rotate(const void* x_in, void* x_out, const void* a,
                         int rows, int log_n, int loops, void* stream) {
    const RotateKernel kernel = rotate_kernel(log_n);
    if (kernel == nullptr) return (int)cudaErrorInvalidValue;
    return launch(kernel, rows, kRotThreads, rotate_smem(log_n), stream,
                  x_in, x_out, a, loops);
}

// x_in/x_out: u64 [rows, N]; base_log * levels <= 31.
extern "C" int kb_decompose(const void* x_in, void* x_out, int rows,
                            int base_log, int levels, int log_n, int loops,
                            void* stream) {
    const long long total = (long long)rows << log_n;
    return launch(kb_decompose_kernel, ew_blocks(total), kEwThreads, 0,
                  stream, x_in, x_out, total, base_log, levels, loops);
}

// Resident blocks per SM of micro-kernel `which` (0 kb_ntt forward, 1
// inverse, 2 kb_mac at 2 terms, 3 kb_rotate, 4 kb_decompose) at N =
// 2^log_n, its threads a block, registers and local (spill) bytes a
// thread; negative: a CUDA error or an unknown kernel.
extern "C" int kb_occupancy(int which, int log_n, int* threads, int* regs,
                            int* local_bytes) {
    switch (which) {
    case 0:
    case 1: {
        const NttKernel kernel = ntt_kernel(which == 1, log_n);
        if (kernel == nullptr) return -(int)cudaErrorInvalidValue;
        *threads = kNttThreads;
        return occupancy(kernel, kNttThreads, ntt_smem(log_n), regs,
                         local_bytes);
    }
    case 2:
        *threads = kEwThreads;
        return occupancy(kb_mac_kernel<2>, kEwThreads, 0, regs, local_bytes);
    case 3: {
        const RotateKernel kernel = rotate_kernel(log_n);
        if (kernel == nullptr) return -(int)cudaErrorInvalidValue;
        *threads = kRotThreads;
        return occupancy(kernel, kRotThreads, rotate_smem(log_n), regs,
                         local_bytes);
    }
    case 4:
        *threads = kEwThreads;
        return occupancy(kb_decompose_kernel, kEwThreads, 0, regs,
                         local_bytes);
    default:
        return -(int)cudaErrorInvalidValue;
    }
}

// The reference step loops. Arguments and result as the entries
// blind_rotate_bnf2_acc32 (blind_rotate_bnf2.cu) and blind_rotate_crt
// (blind_rotate_crt.cu; here num_primes must be 4); *_smem: their bytes of
// dynamic shared memory (0 for another prime count).
extern "C" int kb_step_bnf2_acc32_r2(
        const void* acc_in, const void* a_ms, const void* bsk,
        const void* tables, void* acc_out, int B, int n_steps, int R,
        int levels, int base_log, int log_n, unsigned p0, unsigned p1,
        unsigned inv01, unsigned inv01_sh, unsigned c1t, int s2,
        unsigned t32_bias, void* stream) {
    brk::Bnf2Tail32 tail;
    tail.p[0] = p0;
    tail.p[1] = p1;
    tail.inv01 = inv01;
    tail.inv01_sh = inv01_sh;
    tail.c1t = c1t;
    tail.t32_bias = t32_bias;
    tail.s2 = s2;
    return brk::launch_blind_rotate<brk::Bnf2Tail32, true>(
        acc_in, a_ms, bsk, tables, acc_out, B, n_steps, R, levels, base_log,
        log_n, tail, stream);
}

extern "C" unsigned long long kb_step_bnf2_acc32_r2_smem(
        int num_primes, int R, int levels, int log_n) {
    if (num_primes != 2) return 0;
    return brk::blind_rotate_smem<brk::Bnf2Tail32, true>(R, levels, log_n);
}

extern "C" int kb_step_crt_r2(
        const void* acc_in, const void* a_ms, const void* bsk,
        const void* tables, void* acc_out, int B, int n_steps, int R,
        int levels, int base_log, int log_n, int num_primes,
        const unsigned* garner, unsigned long long full_prod, void* stream) {
    if (num_primes != 4) return (int)cudaErrorInvalidValue;
    brk::GarnerTail<4> tail;
    brk::fill_garner(tail, garner, full_prod);
    return brk::launch_blind_rotate<brk::GarnerTail<4>, true>(
        acc_in, a_ms, bsk, tables, acc_out, B, n_steps, R, levels, base_log,
        log_n, tail, stream);
}

extern "C" unsigned long long kb_step_crt_r2_smem(int num_primes, int R,
                                                  int levels, int log_n) {
    if (num_primes != 4) return 0;
    return brk::blind_rotate_smem<brk::GarnerTail<4>, true>(R, levels,
                                                            log_n);
}
