// K4: single-query GQA decode attention over the paged byte-planar
// ("NestedKV") KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/planar_decode_attention.py ::
// paged_planar_decode_attention: q (B,H,D) f32; planes k_hi, k_lo, v_hi,
// v_lo (NB,BS,Hkv,D) u8; tables (B,MB) i32; lens (B,) i32; window (<= 0 is
// global) -> (B,H,D) f32. FP16 mode joins hi|lo into the exact f16 K/V;
// FP8 mode reads only the hi planes, as e5m2 (half the bytes).
//
// What bounds it on an H100: the KV bytes, sum(len) * Hkv * D * 2 planes-
// pairs (2 B a value in FP16 mode, 1 B in FP8) over 3.35 TB/s; the
// arithmetic is a few f32 FLOPs per byte.
//
// What the design does about it: the body is decode_attention.cuh's, one
// block per (batch row, kv head), one table block of BS keys a tile; it
// walks the row's block table and reads the pool in place at row
// table[j]*BS + t (the TPU wrapper transposed the whole pool on every
// call).
#include "decode_attention.cuh"

namespace {

__global__ void __launch_bounds__(nfp_decode::kThreads)
paged_planar_decode_kernel(const float* __restrict__ q,
                           const uint8_t* __restrict__ k_hi,
                           const uint8_t* __restrict__ k_lo,
                           const uint8_t* __restrict__ v_hi,
                           const uint8_t* __restrict__ v_lo,
                           const int* __restrict__ tables,
                           const int* __restrict__ lens,
                           float* __restrict__ out, int H, int Hkv, int D,
                           int BS, int MB, int window, int fp8,
                           float q_scale) {
  const int b = blockIdx.x, h = blockIdx.y, G = H / Hkv;
  const size_t qo = ((size_t)b * H + (size_t)h * G) * D;
  nfp_decode::decode_attend(
      q + qo, k_hi, k_lo, v_hi, v_lo, out + qo,
      nfp_decode::PagedRows{tables + (size_t)b * MB, BS}, Hkv, h, G, D, BS,
      MB, MB * BS, lens[b], window, fp8 != 0, q_scale);
}

}  // namespace

extern "C" int paged_planar_decode_attention(
    const void* q, const void* k_hi, const void* k_lo, const void* v_hi,
    const void* v_lo, const void* tables, const void* lens, void* out, int B,
    int H, int Hkv, int D, int BS, int MB, int window, int fp8,
    float q_scale, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  const int smem = nfp_decode::smem_bytes(H / Hkv, D, BS);
  cudaError_t err = cudaFuncSetAttribute(
      paged_planar_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, Hkv);
  paged_planar_decode_kernel<<<grid, nfp_decode::kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const uint8_t*>(k_hi),
      static_cast<const uint8_t*>(k_lo), static_cast<const uint8_t*>(v_hi),
      static_cast<const uint8_t*>(v_lo), static_cast<const int*>(tables),
      static_cast<const int*>(lens), static_cast<float*>(out), H, Hkv, D, BS,
      MB, window, fp8, q_scale);
  return (int)cudaGetLastError();
}
