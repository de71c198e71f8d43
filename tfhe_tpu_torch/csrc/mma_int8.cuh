// The int8 tensor-core tile routine of the MXU probes (mxu_probe.cu,
// ntt_mxu.cu): warp-level mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32
// products, and the limb splits and the pair fold of the JAX package's
// int8 small DFTs, formula for formula.
//
// Fragments of one m16n8k32 product (lane = 4 g + t):
//   A, 16 x 32 row-major: a0 = row g, k 4t..4t+3; a1 = row g + 8; a2, a3
//      the same rows at k + 16;
//   B, 32 x 8 column-major: b0 = column g, k 4t..4t+3; b1 at k + 16;
//   D, 16 x 8 s32: d0, d1 = row g, columns 2t, 2t + 1; d2, d3 = row g + 8.
// A is read from shared memory (row stride a multiple of 16 bytes, padded
// by 16 so that the eight rows of a load fall in distinct banks); B from a
// column-major copy of the constant table ([n][k], k contiguous), which
// the wrapper makes once per table, straight from device memory through
// L2 (ldg) or from shared memory. The accumulator is s32 and wraps (no
// .satfinite), as the TPU's int32 accumulation does.
//
// The asm is volatile, and a product no output reads is kept live by the
// caller (a store under a flag the wrapper keeps 0), so that every MAC a
// case counts is issued; the build's SASS counts them (tools/_harness.py
// mma_drift).
//
// wgmma and TMA are not used: this is the simple route, and the rows say
// that they measure mma.sync.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace mma8 {

__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// the A fragment of rows r0 .. r0+15, columns k0 .. k0+31 of a row-major
// int8 matrix in shared memory with row stride lda bytes
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const int8_t* A,
                                       int lda, int r0, int k0) {
    const int8_t* q = A + (r0 + lane_g()) * lda + k0 + 4 * lane_t();
    a[0] = *reinterpret_cast<const uint32_t*>(q);
    a[1] = *reinterpret_cast<const uint32_t*>(q + 8 * lda);
    a[2] = *reinterpret_cast<const uint32_t*>(q + 16);
    a[3] = *reinterpret_cast<const uint32_t*>(q + 8 * lda + 16);
}

// the B fragment of columns n0 .. n0+7, k0 .. k0+31 of a column-major
// table Bt[n][k] (row stride ldb bytes), from device memory (Global) or
// shared memory
template <bool Global>
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1,
                                       const int8_t* Bt, int ldb, int n0,
                                       int k0) {
    const int8_t* q = Bt + (long long)(n0 + lane_g()) * ldb + k0
                      + 4 * lane_t();
    if (Global) {
        b0 = __ldg(reinterpret_cast<const unsigned*>(q));
        b1 = __ldg(reinterpret_cast<const unsigned*>(q + 16));
    } else {
        b0 = *reinterpret_cast<const uint32_t*>(q);
        b1 = *reinterpret_cast<const uint32_t*>(q + 16);
    }
}

// U[mt][j] += A(rows arow(mt) ..) @ B[:, 128 j + c0 ..]: MT row tiles of
// 16 against the four column blocks j = 0..3 of a [K, 512] table at lanes
// c0 .. c0+7 of each block, so that each thread holds U_0 .. U_3 of the
// same (row, lane), as the pair fold needs them. A's column k is read at
// k & kmask (127: one 128-wide tile repeated along k, as the JAX cases
// concatenate it). The k loop is kept rolled: its body holds 4 MT mma.
template <int MT, class ARow>
__device__ __forceinline__ void product_4blocks(
    int (&U)[MT][4][4], const int8_t* A, int lda, ARow arow, int kmask,
    const int8_t* __restrict__ Bt, int K, int c0) {
    #pragma unroll
    for (int mt = 0; mt < MT; ++mt)
        #pragma unroll
        for (int j = 0; j < 4; ++j)
            #pragma unroll
            for (int e = 0; e < 4; ++e) U[mt][j][e] = 0;
    #pragma unroll 1
    for (int k0 = 0; k0 < K; k0 += 32) {
        uint32_t b[4][2];
        #pragma unroll
        for (int j = 0; j < 4; ++j)
            load_b<true>(b[j][0], b[j][1], Bt, K, 128 * j + c0, k0);
        #pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
            uint32_t a[4];
            load_a(a, A, lda, arow(mt), k0 & kmask);
            #pragma unroll
            for (int j = 0; j < 4; ++j) mma(U[mt][j], a, b[j][0], b[j][1]);
        }
    }
}

// the row and lane of accumulator element e of a thread's fragment
__device__ __forceinline__ int frag_row(int e) {
    return lane_g() + 8 * (e >> 1);
}
__device__ __forceinline__ int frag_col(int c0, int e) {
    return c0 + 2 * lane_t() + (e & 1);
}

// _pair_fold_u (tfhe_tpu/ops/pbs_kernel.py:1219): V = U_lo + (U_hi << 8)
// in int32 (the shift unsigned: a left shift of a negative int is
// undefined before C++20), then + 2^31 as u32
__device__ __forceinline__ uint32_t pair_fold(int lo, int hi) {
    return (uint32_t)lo + ((uint32_t)hi << 8) + 0x80000000u;
}

// _split4_i8 (pbs_kernel.py:492): balanced base-256 limbs of an int32
// (limbs 0-2 in [-128, 127], limb 3 the rest, cast to int8)
__device__ __forceinline__ void split4_balanced(int v, int8_t (&d)[4]) {
    #pragma unroll
    for (int j = 0; j < 3; ++j) {
        int l = v & 0xFF;
        l = l > 127 ? l - 256 : l;
        d[j] = (int8_t)l;
        v = (v - l) >> 8;
    }
    d[3] = (int8_t)v;
}

// _split4_i8_offset (pbs_kernel.py:506) and _split_digits_i8 (:1209):
// limb j = ((u >> 8j) & 255) - 128
__device__ __forceinline__ int8_t offset_limb(int u, int j) {
    return (int8_t)(((u >> (8 * j)) & 0xFF) - 128);
}

// _condsub (pbs_kernel.py:131): x - c when x >= c (unsigned)
__device__ __forceinline__ uint32_t condsub(uint32_t x, uint32_t c) {
    return x >= c ? x - c : x;
}

// _mul_hi_approx (pbs_kernel.py:89): the 16-bit limb product without the
// low half's carries, at most 2 below the high word
__device__ __forceinline__ uint32_t mulhi_approx(uint32_t a, uint32_t b) {
    const uint32_t ah = a >> 16, al = a & 0xFFFFu;
    const uint32_t bh = b >> 16, bl = b & 0xFFFFu;
    return ah * bh + ((al * bh) >> 16) + ((ah * bl) >> 16);
}

// _condsub_wide (pbs_kernel.py:113): x - c, plus c back when it wrapped
__device__ __forceinline__ uint32_t condsub_wide(uint32_t x, uint32_t c) {
    const uint32_t m = x - c;
    return m + (m >> 31) * c;
}

// _shoup in the default approx mode (pbs_kernel.py:122): < 2p for any a
__device__ __forceinline__ uint32_t shoup_approx(uint32_t a, uint32_t w,
                                                 uint32_t wsh, uint32_t p) {
    const uint32_t q = mulhi_approx(a, wsh);
    return condsub_wide(a * w - q * p, p + p);
}

}  // namespace mma8
