// TMA tile loads, mbarriers and the 128-byte swizzle for Hopper (sm_90a),
// shared by the TMA-fed GEMMs: K1 and K3 (wgmma_gemm.cuh) and K7
// (nestedfp8_matmul_fused_quant.cu).
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nfp {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Byte offset of (row, 16-byte chunk) in a 128B-swizzled buffer of
// 128-byte rows: the chunk index is XORed with row % 8 (TMA's 128-byte
// swizzle, CuTe's Swizzle<3,4,3>); the buffer is 1024-byte aligned.
__device__ __forceinline__ uint32_t sw128_offset(int row, int chunk) {
  return (uint32_t)(row * 128 + ((chunk ^ (row & 7)) << 4));
}

// TMA tile loads into shared memory, completing on an mbarrier; elements
// outside the tensor arrive as zeros (and count as bytes)
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry
// point query (no link against libcuda)
inline PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// A 2-D tensor map over a row-major (rows, cols) array of `elem` bytes an
// element, boxes of box_rows x box_cols; false if the driver refuses it
inline bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, int elem,
                      const void* base, uint64_t rows, uint64_t cols,
                      uint32_t box_rows, uint32_t box_cols,
                      CUtensorMapSwizzle swizzle) {
  auto encode = encode_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dim[2] = {cols, rows};
  const cuuint64_t stride[1] = {cols * elem};
  const cuuint32_t box[2] = {box_cols, box_rows}, one[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dim, stride, box, one,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace nfp
