// K2: body rotation of the LUT accumulator, for Hopper, in the two output
// modes of the TPU kernel.
//
// Replaces: tfhe_tpu/ops/pbs_kernel.py::_build_body_rot_fn_v4 (the Pallas
// prologue of blind_rotate_pallas), whose spec is monomial_div(lut, body)
// followed, in acc32 mode, by the acc32 rounding r32
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
// Bound: bytes. Each output word needs one u64 read (a shared LUT is read
// once per block and stays in L1/L2), so the kernel is a gather-copy at
// HBM rate. Design: one block per (ciphertext, row); threads walk the N
// output coefficients with unit stride, so the stores are coalesced and the
// u64 reads are coalesced except at the single wrap point.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct FoldAcc32 {
    using Out = uint32_t;
    __device__ uint32_t operator()(uint64_t v) const {
        return (uint32_t)((v + (1ull << 31)) >> 32);
    }
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
// batch (lut_batch_stride = 0); body: i32 [B] in [0, 2N); out: u32
// [B, R, N]. Returns cudaGetLastError() after the launch.
extern "C" int body_rotate_acc32(const void* lut, long long lut_batch_stride,
                                 const void* body, void* out, int B, int R,
                                 int N, void* stream) {
    return launch<FoldAcc32>(lut, lut_batch_stride, body, out, B, R, N,
                             stream);
}

// As body_rotate_acc32, with out: u64 [B, R, N].
extern "C" int body_rotate_u64(const void* lut, long long lut_batch_stride,
                               const void* body, void* out, int B, int R,
                               int N, void* stream) {
    return launch<ExactU64>(lut, lut_batch_stride, body, out, B, R, N,
                            stream);
}
