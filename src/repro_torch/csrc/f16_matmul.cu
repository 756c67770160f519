// K3: plain f16 GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/f16_matmul.py :: f16_matmul:
// out (M,N) f32 = x (M,K) f16 @ w (K,N) f16. It serves NestedFP's exception
// tensors (some |w| > 1.75, kept in f16 and run in f16 in both modes) and
// is the baseline of the paper's kernel-overhead comparison (Fig. 7).
//
// What bounds it on an H100: the 2-byte weight stream at decode, the f16
// tensor-core rate at prefill — the same as K1.
//
// What the design does about it: the identical tiling and K order as K1
// (gemm_tile.cuh) minus the rebuild, so K1's time minus this kernel's time
// is the cost of reconstruction alone.
#include "gemm_tile.cuh"

extern "C" int f16_matmul(const void* x, const void* w, void* out, int M,
                          int N, int K, void* stream) {
  return nfp::launch_gemm<nfp::Op::kF16>(
      x, w, nullptr, nullptr, 0, static_cast<float*>(out), M, N, K,
      static_cast<cudaStream_t>(stream));
}
