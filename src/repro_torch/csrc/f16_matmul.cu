// K3: plain f16 GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/f16_matmul.py :: f16_matmul:
// out (M,N) f32 = x (M,K) f16 @ w (K,N) f16. It serves NestedFP's exception
// tensors (some |w| > 1.75, kept in f16 and run in f16 in both modes) and
// is the baseline of the paper's kernel-overhead comparison (Fig. 7).
//
// What bounds it on an H100: the 2-byte weight stream at decode, the f16
// tensor-core rate at prefill, the same as K1.
//
// What the design does about it: K1's TMA + wgmma body (wgmma_gemm.cuh)
// with the same tile configs and k order, minus the rebuild: each f16 W
// tile goes by TMA straight into the 128B-swizzled MN-major operand. The
// two kernels differ only in the producer's work, so K1's time over this
// kernel's is the cost of reconstruction (PERF.md §6 gives the ratio at
// M = 8, 256 and 8192).
#include "wgmma_gemm.cuh"

extern "C" int f16_matmul(const void* x, const void* w, void* out, int M,
                          int N, int K, void* stream) {
  return nfp_wg::run<false>(x, w, nullptr, static_cast<float*>(out), M, N,
                            K, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory (bytes) of the body the entry above picks: 0 for
// gemm_tile.cuh's (static tiles).
extern "C" int f16_matmul_smem(const void* x, const void* w, int M, int N,
                               int K) {
  return nfp_wg::smem<false>(x, w, nullptr, M, N, K);
}
