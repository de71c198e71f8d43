// K2: body rotation of the LUT accumulator with the acc32 fold, for Hopper.
//
// Replaces: tfhe_tpu/ops/pbs_kernel.py::_build_body_rot_fn_v4 (the Pallas
// prologue of blind_rotate_pallas, acc32 mode), whose spec is
// monomial_div(lut, body) followed by the acc32 rounding r32
// (tfhe_tpu/ops/bnf2.py:329-333).
//
// out[b][r][t] = hi32(round32(lut[b][r] * X^{-body[b]})[t])
//
// The rotation runs on the exact u64 coefficient and the fold comes after
// it: folding first would differ on negated coefficients (rounding -x is
// not the negation of rounding x at the half-way point).
//
// Bound: bytes. Each output u32 needs one u64 read (a shared LUT is read
// once per block and stays in L1/L2), so the kernel is a gather-copy at
// HBM rate. Design: one block per (ciphertext, row); threads walk the N
// output coefficients with unit stride, so the u32 stores are coalesced and
// the u64 reads are coalesced except at the single wrap point.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void body_rotate_acc32_kernel(const uint64_t* __restrict__ lut,
                                         long long lut_batch_stride,
                                         const int32_t* __restrict__ body,
                                         uint32_t* __restrict__ out,
                                         int R, int N) {
    const int r = blockIdx.x;
    const int b = blockIdx.y;
    const uint64_t* src = lut + (long long)b * lut_batch_stride
                          + (long long)r * N;
    uint32_t* dst = out + ((long long)b * R + r) * N;
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
        dst[t] = (uint32_t)((v + (1ull << 31)) >> 32);
    }
}

}  // namespace

// lut: u64 [B, R, N] (lut_batch_stride = R*N) or [R, N] shared by the
// batch (lut_batch_stride = 0); body: i32 [B] in [0, 2N); out: u32 [B, R, N].
extern "C" int body_rotate_acc32(const void* lut, long long lut_batch_stride,
                                 const void* body, void* out, int B, int R,
                                 int N, void* stream) {
    dim3 grid(R, B);
    body_rotate_acc32_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)lut, lut_batch_stride, (const int32_t*)body,
        (uint32_t*)out, R, N);
    return (int)cudaGetLastError();
}
