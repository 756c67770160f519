// K5: single-query GQA decode attention over dense per-slot byte-planar
// ("NestedKV") caches, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/planar_decode_attention.py ::
// planar_decode_attention: q (B,H,D) f32; planes k_hi, k_lo, v_hi, v_lo
// (B,Cap,Hkv,D) u8; lens (B,) i32 >= 1; window (<= 0 is global) ->
// (B,H,D) f32. FP16 mode joins hi|lo into the exact f16 K/V; FP8 mode
// reads only the hi planes, as e5m2 (half the bytes).
//
// What bounds it on an H100: the KV bytes, sum(len) * Hkv * D * 2 (K and
// V) * (2 B in FP16 mode, 1 B in FP8) over 3.35 TB/s.
//
// What the design does about it: K4's body (decode_attention.cuh), one
// block per (batch row, kv head), with dense addressing: tile j of row b
// is keys [j*T, j*T + T) at row b*Cap + j*T of the planes, read in place
// (the TPU wrapper transposed all four planes to (B,Hkv,Cap,D) on every
// call). The loop stops at the tile holding key len-1, so a short row in
// a long cache reads only its own keys, and shared memory holds one tile
// whatever Cap is (Cap reaches 32768 at decode_32k).
#include "decode_attention.cuh"

namespace {

constexpr int kTile = 64;   // keys a tile; ref.DECODE_TILE

__global__ void __launch_bounds__(nfp_decode::kThreads)
planar_decode_kernel(const float* __restrict__ q,
                     const uint8_t* __restrict__ k_hi,
                     const uint8_t* __restrict__ k_lo,
                     const uint8_t* __restrict__ v_hi,
                     const uint8_t* __restrict__ v_lo,
                     const int* __restrict__ lens, float* __restrict__ out,
                     int H, int Hkv, int D, int Cap, int window, int fp8,
                     float q_scale) {
  const int b = blockIdx.x, h = blockIdx.y, G = H / Hkv;
  const size_t qo = ((size_t)b * H + (size_t)h * G) * D;
  nfp_decode::decode_attend(
      q + qo, k_hi, k_lo, v_hi, v_lo, out + qo,
      nfp_decode::DenseRows{(size_t)b * Cap, kTile}, Hkv, h, G, D, kTile,
      (Cap + kTile - 1) / kTile, Cap, lens[b], window, fp8 != 0, q_scale);
}

}  // namespace

extern "C" int planar_decode_attention(
    const void* q, const void* k_hi, const void* k_lo, const void* v_hi,
    const void* v_lo, const void* lens, void* out, int B, int H, int Hkv,
    int D, int Cap, int window, int fp8, float q_scale, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  const int smem = nfp_decode::smem_bytes(H / Hkv, D, kTile);
  cudaError_t err = cudaFuncSetAttribute(
      planar_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, Hkv);
  planar_decode_kernel<<<grid, nfp_decode::kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const uint8_t*>(k_hi),
      static_cast<const uint8_t*>(k_lo), static_cast<const uint8_t*>(v_hi),
      static_cast<const uint8_t*>(v_lo), static_cast<const int*>(lens),
      static_cast<float*>(out), H, Hkv, D, Cap, window, fp8, q_scale);
  return (int)cudaGetLastError();
}
