// K2: FP8-mode NestedFP GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/nestedfp8_matmul.py ::
// nestedfp8_matmul: out (M,N) f32 = (x_q (M,K) e4m3 @ upper (K,N) read as
// e4m3) * x_scale * 2^-8. `upper` IS the e4m3 encoding of w * 2^8, so the
// kernel reads one byte a weight and has no pointer to `lower` at all.
// x_scale is one scalar (per-tensor, stride 0) or one factor a row
// (per-token, stride 1: the serving engine's batch-invariant scheme); both
// are folded into the epilogue as (acc * s) * 2^-8, where the JAX package
// applied per-token scales outside the kernel as (acc * 1 * 2^-8) * s —
// the same value, since multiplying by 2^-8 is exact for normal values.
//
// What bounds it on an H100: at decode the 1-byte weight stream (K*N bytes
// over 3.35 TB/s, half of K1's); at prefill the tensor-core rate.
//
// What the design does about it: the body of fp8_mma_gemm.cuh, shared
// with K7 — a TMA ring that keeps 6-16 k tiles of the weights in flight
// at decode, a transposing load of the (K,N) upper plane, mma.sync e4m3
// with exact products and f32 sums, one k order in every tile config and
// no split-K, so a row's result does not depend on the batch — with its
// RowScale epilogue, which reads a row's scale once per fragment row.
// Its tile configs are K7's, by M (by_m), plus one for decode at wide N
// (by_m_n: DecodeWide at M <= 16 and N > 4224, one wave of 128-column
// blocks where Decode16 would run several waves).
// x_q is read in place by TMA (rows past M arrive as zeros, never read).
// The engine quantizes x per token with one launch of quant_per_token.cu
// in front of this kernel.
//
// Which body runs (the shape rule, decided here before any launch, never
// by catching a failure): the mma body needs K % 16 == 0, N % 16 == 0 and
// both upper and x_q 16-byte aligned (x_q may be a view into a larger
// buffer). Any other shape takes gemm_tile.cuh's kNested8 body, the WMMA
// tiling that was K2's first body.
#include "fp8_mma_gemm.cuh"

namespace {

bool k2_mma_body(const void* x_q, const void* upper, int N, int K) {
  return nfp_f8::mma_body(N, K, upper) && nfp::aligned(x_q, 16);
}

}  // namespace

extern "C" int nestedfp8_matmul(const void* x_q, const void* upper,
                                const void* scale, int scale_stride,
                                void* out, int M, int N, int K,
                                void* stream) {
  const float* sc = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaGetLastError();
  if (!k2_mma_body(x_q, upper, N, K))
    return nfp::launch_gemm<nfp::Op::kNested8>(x_q, upper, nullptr, sc,
                                               scale_stride, o, M, N, K, s);
  const uint8_t* xq = static_cast<const uint8_t*>(x_q);
  const uint8_t* u = static_cast<const uint8_t*>(upper);
  return (int)nfp_f8::by_m_n(M, N, [&](auto c) {
    return nfp_f8::launch_mma<decltype(c), nfp_f8::RowScale>(
        xq, u, sc, scale_stride, o, M, N, K, s);
  });
}

// Dynamic shared memory (bytes) of the body that the entry above picks
// for (M, N, K) and these operands: 0 for the gemm_tile.cuh body, whose
// tiles are static shared memory.
extern "C" int nestedfp8_matmul_smem(const void* x_q, const void* upper,
                                     int M, int N, int K) {
  if (!k2_mma_body(x_q, upper, N, K)) return 0;
  return nfp_f8::by_m_n(M, N, [](auto c) { return decltype(c)::kSmem; });
}
