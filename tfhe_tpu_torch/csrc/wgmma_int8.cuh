// The Hopper int8 tensor-core building block of the MXU probes
// (mxu_probe.cu, ntt_mxu.cu): warpgroup wgmma.mma_async int8 products
// with both operands in shared memory, their descriptors and fragments,
// and the thread-block-cluster pieces that keep a table resident (a bulk
// copy under an mbarrier, distributed shared memory, cluster barriers).
// tools/_wgmma.py mirrors every address formula here on the CPU, and
// tests/test_torch_wgmma_layout.py holds the mirror to the plain versions.
//
// Operands. For 8-bit types both A (M x K) and B (N x K) are K-major: a
// tile of R rows is stored as K / 128 K-blocks of R rows x 128 bytes (a
// K-block at byte kb * R * 128), each in the 128-byte swizzle: byte (row,
// k) of a K-block at row * 128 + (((k >> 4) ^ (row & 7)) << 4) + (k & 15),
// which is the linear offset o with o ^= (o >> 3) & 0x70, on a 1024-byte
// aligned base. B is the wrapper's column-major copy of the table ([n][K])
// laid out so, per cluster rank, on the host; A is written by the threads.
//
// Descriptor (64 bits): start address >> 4 in bits 0-13, the leading byte
// offset (unused by a swizzled K-major operand: 1) in 16-29, the stride
// byte offset between 8-row groups (1024 >> 4) in 32-45, base offset 0,
// swizzle mode 1 (128 bytes) in 62-63. The k-step s (32 bytes of K) of a
// K-block starts at its base + 32 s: the hardware applies the swizzle to
// the address bits, as the threads and the host did.
//
// Accumulator of m64nN s32 (N / 2 registers a thread; thread t of the
// warpgroup, warp w = t / 32, lane l): d[i] is row 16 w + l / 4 + 8 ((i >> 1)
// & 1), column 8 (i >> 2) + 2 (l & 3) + (i & 1). No .satfinite: the s32
// sum wraps, as the TPU's int32 accumulation does.
//
// The wgmma asm is volatile and every accumulator is read afterwards (a
// fold, or a value stored under a flag the wrapper keeps 0), so every MAC
// a case counts is issued; the build's SASS counts them (IGMMA, the MACs
// of its shape: tools/_harness.py mma_drift).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace wg {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// the 128-byte swizzle of a byte offset from a 1024-byte aligned base
__host__ __device__ __forceinline__ uint32_t swz(uint32_t o) {
    return o ^ ((o >> 3) & 0x70u);
}

// byte (row, k) of a K-major tile of `rows` rows
__host__ __device__ __forceinline__ uint32_t kmajor(int row, int k, int rows) {
    return (uint32_t)(k >> 7) * rows * 128
           + swz((uint32_t)row * 128 + (k & 127));
}

__device__ __forceinline__ uint64_t desc(uint32_t saddr) {
    return (uint64_t)((saddr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16)
           | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ int acc_row(int i) {
    return 16 * ((threadIdx.x & 127) >> 5) + ((threadIdx.x & 31) >> 2)
           + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i) {
    return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}

// this thread's warpgroup, read afresh where it is used (a value the
// compiler would otherwise keep in a register across the trip loop)
__device__ __forceinline__ int warpgroup() {
    uint32_t t;
    asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(t));
    return (int)(t >> 7);
}

__device__ __forceinline__ void fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep a and b in registers here: work on them may not move across this
// point (it bounds how many chains the compiler interleaves)
__device__ __forceinline__ void pin(uint32_t& a, uint32_t& b) {
    asm volatile("" : "+r"(a), "+r"(b));
}

// pin the accumulators here: the compiler may not read them before the
// wait
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
    #pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D (+)= A @ B^T of one k-step: A 64 x 32 bytes at descriptor da, B N x
// 32 bytes at db; scale_d = 0 overwrites D
__device__ __forceinline__ void mma_n128(int (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n}\n"
        :
          "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void mma_n256(int (&d)[128], uint64_t da,
                                         uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p;\n}\n"
        :
          "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
          "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
          "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
          "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
          "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
          "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
        : "l"(da), "l"(db), "r"(scale_d));
}

// ---------------------------------------------------------------------------
// clusters, distributed shared memory, bulk copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
    return r;
}

// the address of shared::cta address `a` in CTA `rank` of the cluster
__device__ __forceinline__ uint32_t mapa(uint32_t a, uint32_t rank) {
    uint32_t r;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(r) : "r"(a), "r"(rank));
    return r;
}

__device__ __forceinline__ void st_cluster(uint32_t a, uint4 v) {
    asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\n"
                 :: "r"(a), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
                 : "memory");
}
__device__ __forceinline__ void st_cluster(uint32_t a, uint32_t x,
                                           uint32_t y) {
    asm volatile("st.shared::cluster.v2.u32 [%0], {%1, %2};\n"
                 :: "r"(a), "r"(x), "r"(y) : "memory");
}

// loads from shared::cluster address a (mapa's): a word, a u64, 16 bytes,
// and a signed half-word or byte, sign-extended
__device__ __forceinline__ uint32_t ld_cluster_u32(uint32_t a) {
    uint32_t v;
    asm volatile("ld.shared::cluster.u32 %0, [%1];\n" : "=r"(v) : "r"(a));
    return v;
}
__device__ __forceinline__ int32_t ld_cluster_s16(uint32_t a) {
    int32_t v;
    asm volatile("ld.shared::cluster.s16 %0, [%1];\n" : "=r"(v) : "r"(a));
    return v;
}
__device__ __forceinline__ int32_t ld_cluster_s8(uint32_t a) {
    int32_t v;
    asm volatile("ld.shared::cluster.s8 %0, [%1];\n" : "=r"(v) : "r"(a));
    return v;
}
__device__ __forceinline__ uint64_t ld_cluster_u64(uint32_t a) {
    uint64_t v;
    asm volatile("ld.shared::cluster.u64 %0, [%1];\n" : "=l"(v) : "r"(a));
    return v;
}
__device__ __forceinline__ uint4 ld_cluster_v4(uint32_t a) {
    uint4 v;
    asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(a));
    return v;
}

// every thread of the cluster: writes before it (shared memory of any CTA
// of the cluster) are seen after it by every thread and, with Async, by
// the async proxy (wgmma) too
template <bool Async>
__device__ __forceinline__ void cluster_sync() {
    if (Async) asm volatile("fence.proxy.async.shared::cluster;\n" ::: "memory");
    asm volatile("barrier.cluster.arrive.release.aligned;\n"
                 "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// a table slice copied once into shared memory by the TMA (bulk copies,
// not tensor maps: the host laid the slice out already swizzled):
// load_init (every thread: one thread initialises the mbarrier at `bar`
// for one arrival), then one thread calls load_expect with the bytes of
// all its copies and load_copy per copy, and every thread load_wait
__device__ __forceinline__ void load_init(uint32_t bar) {
    if (threadIdx.x == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                     "fence.mbarrier_init.release.cluster;\n"
                     :: "r"(bar) : "memory");
    }
    __syncthreads();
}
__device__ __forceinline__ void load_expect(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}
// bytes [src, src + bytes) of device memory to dst, in bulk copies of at
// most 32 KiB (16-byte aligned, a multiple of 16 bytes)
__device__ __forceinline__ void load_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
    const char* s = static_cast<const char*>(src);
    for (uint32_t o = 0; o < bytes; o += 32768) {
        const uint32_t n = bytes - o < 32768 ? bytes - o : 32768;
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];\n"
            :: "r"(dst + o), "l"(s + o), "r"(n), "r"(bar) : "memory");
    }
}
// (a copy that never completes traps after ~2^22 polls instead of hanging)
__device__ __forceinline__ void load_wait(uint32_t bar) {
    uint32_t done = 0;
    for (uint32_t i = 0; !done; ++i) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar) : "memory");
        if (i == (1u << 22)) __trap();
    }
}

}  // namespace wg
