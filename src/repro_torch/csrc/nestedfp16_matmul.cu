// K1: FP16-mode NestedFP GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/nestedfp16_matmul.py ::
// nestedfp16_matmul: out (M,N) f32 = x (M,K) f16 @ W, where W (K,N) f16 is
// rebuilt inside the kernel from the two byte planes `upper` and `lower`
// with the branch-free formula of repro.core.nestedfp.decode, bit for bit.
//
// What bounds it on an H100: at decode (M = 8 slots) the weight stream,
// 2 bytes a weight (the same bytes as a plain f16 GEMM: the paper's
// zero-amplification property), 2*K*N bytes over 3.35 TB/s; at prefill
// (M = 8192) the f16 tensor-core rate, 2*M*K*N at 989 TFLOP/s.
//
// What the design does about it (wgmma_gemm.cuh): the planes come in by
// TMA (no rebuilt copy of W reaches device memory); producer warpgroups
// rebuild f16 in shared memory, in place, four weights per 32-bit word (a
// guarded per-byte subtract, a shift and two byte permutes) into the
// MN-major operand that wgmma reads with its transpose bit, while the
// consumer warpgroups run wgmma m64nNk16 on earlier stages; x is wgmma's
// N side, 8 rows at decode and 256 at prefill. K3 (f16_matmul.cu) is the
// same body with W loaded by TMA instead of rebuilt, so K1's time over
// K3's is the cost of the rebuild. Measured pace (PERF.md §6, H100 at
// 700 W): a llama3.1-8b layer's seven GEMMs ~1.4x torch.matmul at
// M = 8192 and ~1.15x at M = 8 (device time). Shapes outside the TMA rule
// take gemm_tile.cuh.
#include "wgmma_gemm.cuh"

extern "C" int nestedfp16_matmul(const void* x, const void* upper,
                                 const void* lower, void* out, int M, int N,
                                 int K, void* stream) {
  return nfp_wg::run<true>(x, upper, lower, static_cast<float*>(out), M, N,
                           K, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory (bytes) of the body the entry above picks: 0 for
// gemm_tile.cuh's (static tiles).
extern "C" int nestedfp16_matmul_smem(const void* x, const void* upper,
                                      const void* lower, int M, int N,
                                      int K) {
  return nfp_wg::smem<true>(x, upper, lower, M, N, K);
}
