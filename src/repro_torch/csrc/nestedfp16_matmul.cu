// K1: FP16-mode NestedFP GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/nestedfp16_matmul.py ::
// nestedfp16_matmul: out (M,N) f32 = x (M,K) f16 @ W, where W (K,N) f16 is
// rebuilt inside the kernel from the two byte planes `upper` and `lower`
// with the branch-free formula of repro.core.nestedfp.decode, bit for bit.
//
// What bounds it on an H100: at decode (M = 8 slots) the weight stream,
// 2 bytes a weight (the same bytes as a plain f16 GEMM: the paper's
// zero-amplification property) — about 2*K*N bytes over 3.35 TB/s. At a
// prefill chunk (M ~ 256-1024) the f16 tensor-core rate.
//
// What the design does about it: the planes are read in place (no
// rebuilt copy of W ever reaches device memory); the rebuild is integer
// work in registers between the global load and the shared-memory store,
// overlapped with the previous tile's MMAs; decode-sized M takes narrow
// tiles so that more blocks stream the weights. See gemm_tile.cuh.
#include "gemm_tile.cuh"

extern "C" int nestedfp16_matmul(const void* x, const void* upper,
                                 const void* lower, void* out, int M, int N,
                                 int K, void* stream) {
  return nfp::launch_gemm<nfp::Op::kNested16>(
      x, upper, lower, nullptr, 0, static_cast<float*>(out), M, N, K,
      static_cast<cudaStream_t>(stream));
}
