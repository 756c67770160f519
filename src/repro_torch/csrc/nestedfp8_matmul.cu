// K2: FP8-mode NestedFP GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/nestedfp8_matmul.py ::
// nestedfp8_matmul: out (M,N) f32 = (x_q (M,K) e4m3 @ upper (K,N) read as
// e4m3) * x_scale * 2^-8. `upper` IS the e4m3 encoding of w * 2^8, so the
// kernel reads one byte a weight and has no pointer to `lower` at all.
// x_scale is one scalar (per-tensor) or one factor a row (per-token, the
// serving engine's batch-invariant scheme); both are folded into the
// epilogue, where the JAX package applied per-token scales outside the
// kernel — the scale is a linear factor on the accumulator.
//
// What bounds it on an H100: at decode the 1-byte weight stream (K*N bytes
// over 3.35 TB/s, half of K1's); at prefill the tensor-core rate.
//
// What the design does about it: only the upper plane is streamed; e4m3
// operands are widened to f16 in registers (exact: every e4m3 value is an
// f16 value) and fed to f16 tensor-core MMA with f32 accumulate, so each
// product is exact. Native fp8 wgmma wants K-major operands; the (K,N)
// plane layout is kept here so the bytes match the JAX package unchanged.
#include "gemm_tile.cuh"

extern "C" int nestedfp8_matmul(const void* x_q, const void* upper,
                                const void* scale, int scale_stride,
                                void* out, int M, int N, int K,
                                void* stream) {
  return nfp::launch_gemm<nfp::Op::kNested8>(
      x_q, upper, nullptr, static_cast<const float*>(scale), scale_stride,
      static_cast<float*>(out), M, N, K, static_cast<cudaStream_t>(stream));
}
