// K7: FP8-mode NestedFP GEMM with the activation quantized inside the
// kernel, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/nestedfp8_matmul.py ::
// nestedfp8_matmul_fused_quant: x (M,K) f16/bf16/f32, upper (K,N) u8 read
// as e4m3, amax (1,) f32 the per-tensor absmax of x (taken outside, as the
// JAX wrapper expects) -> out (M,N) f32 =
//   (e4m3(clip(x * 448/amax)) @ upper) * (amax/448) * 2^-8.
// It is the paper's per-tensor FP8 scheme without the quantized copy of x
// that the unfused pair (quantize, then K2) writes to device memory and
// reads back.
//
// What bounds it on an H100: at decode the 1-byte weight stream, as K2;
// at prefill the tensor-core rate.
//
// What the design does about it: K2's tiling (gemm_tile.cuh) with one
// change on the A side — the x chunk is loaded in its own type and
// quantized to e4m3 in registers between the global load and the
// shared-memory store, so each x byte is read once and no e4m3 copy of x
// exists. The K order is K2's (16-wide steps from k = 0, no split-K), so a
// row's result does not depend on the other rows given the same amax.
#include "gemm_tile.cuh"

extern "C" int nestedfp8_matmul_fused_quant(const void* x, int x_type,
                                            const void* upper,
                                            const void* amax, void* out,
                                            int M, int N, int K,
                                            void* stream) {
  const float* a = static_cast<const float*>(amax);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_type) {   // 0: f32, 1: f16, 2: bf16
    case 0:
      return nfp::launch_gemm<nfp::Op::kQuantF32>(x, upper, nullptr, a, 0, o,
                                                  M, N, K, s);
    case 1:
      return nfp::launch_gemm<nfp::Op::kQuantF16>(x, upper, nullptr, a, 0, o,
                                                  M, N, K, s);
    case 2:
      return nfp::launch_gemm<nfp::Op::kQuantBF16>(x, upper, nullptr, a, 0,
                                                   o, M, N, K, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
