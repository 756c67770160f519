// K5: single-query GQA decode attention over dense per-slot byte-planar
// ("NestedKV") caches, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/planar_decode_attention.py ::
// planar_decode_attention: q (B,H,D) f32; planes k_hi, k_lo, v_hi, v_lo
// (B,Cap,Hkv,D) u8; lens (B,) i32 >= 1; window (<= 0 is global) ->
// (B,H,D) f32. FP16 mode joins hi|lo into the exact f16 K/V; FP8 mode
// reads only the hi planes, as e5m2 (half the bytes). D is 64 or 128.
//
// What bounds it on an H100: the KV bytes of the kept keys,
// sum(kept) * Hkv * D * 2 (K and V) * (2 B in FP16 mode, 1 B in FP8) over
// 3.35 TB/s.
//
// What the design does about it: K4's body (decode_attention.cuh) with
// dense addressing, key kpos of row b at row b*Cap + kpos of the planes,
// read in place (the TPU wrapper transposed all four planes to
// (B,Hkv,Cap,D) on every call). Each row's keys are cut into splits of
// 512, one block a split, so a 32k-key row runs on 64 blocks at once and
// a short row in a long cache reads only its own keys; a second kernel
// merges the splits when Cap exceeds 512.
#include "decode_attention.cuh"

namespace {

using nfp_decode::Layout;

template <int D, bool FP8>
__global__ void __launch_bounds__(nfp_decode::kThreads)
planar_split_kernel(const float* __restrict__ q,
                    const uint8_t* __restrict__ k_hi,
                    const uint8_t* __restrict__ k_lo,
                    const uint8_t* __restrict__ v_hi,
                    const uint8_t* __restrict__ v_lo,
                    const int* __restrict__ lens, float* __restrict__ out,
                    float* __restrict__ part, int B, int H, int Hkv, int Cap,
                    int ns, int S, int window, float q_scale) {
  const int b = blockIdx.z;
  nfp_decode::split_block<D, FP8>(
      q, k_hi, k_lo, v_hi, v_lo, nfp_decode::DenseRows{(size_t)b * Cap},
      lens[b], out, part, B, H, Hkv, ns, S, Cap, window, q_scale);
}

template <int D, bool FP8>
int launch(const void* q, const void* k_hi, const void* k_lo,
           const void* v_hi, const void* v_lo, const void* lens, void* out,
           void* part, int B, int H, int Hkv, int Cap, int ns, int S,
           int window, float q_scale, cudaStream_t stream) {
  constexpr int smem = Layout<D, FP8>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      planar_split_kernel<D, FP8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  planar_split_kernel<D, FP8>
      <<<nfp_decode::split_grid(B, H, Hkv, ns), nfp_decode::kThreads, smem,
         stream>>>(
          static_cast<const float*>(q), static_cast<const uint8_t*>(k_hi),
          static_cast<const uint8_t*>(k_lo), static_cast<const uint8_t*>(v_hi),
          static_cast<const uint8_t*>(v_lo), static_cast<const int*>(lens),
          static_cast<float*>(out), static_cast<float*>(part), B, H, Hkv, Cap,
          ns, S, window, q_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dynamic shared memory of the split kernel; 0 when D has no instance
extern "C" int planar_decode_attention_smem(int D, int fp8) {
  return nfp_decode::smem_bytes(D, fp8 != 0);
}

// splits of a row of Cap keys; the scratch holds B*H*splits*(D+2) f32
// when that is above 1
extern "C" int planar_decode_attention_splits(int Cap) {
  const int S = nfp_decode::split_keys(1);
  return (Cap + S - 1) / S;
}

extern "C" int planar_decode_attention(
    const void* q, const void* k_hi, const void* k_lo, const void* v_hi,
    const void* v_lo, const void* lens, void* out, void* part, int B, int H,
    int Hkv, int D, int Cap, int window, int fp8, float q_scale,
    void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (nfp_decode::smem_bytes(D, fp8 != 0) == 0)
    return (int)cudaErrorInvalidValue;
  const int S = nfp_decode::split_keys(1), ns = (Cap + S - 1) / S;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ns > 0) {
    decltype(&launch<64, true>) fn =
        D == 64 ? (fp8 ? &launch<64, true> : &launch<64, false>)
                : (fp8 ? &launch<128, true> : &launch<128, false>);
    const int err = fn(q, k_hi, k_lo, v_hi, v_lo, lens, out, part, B, H, Hkv,
                       Cap, ns, S, window, q_scale, st);
    if (err != 0) return err;
  }
  return nfp_decode::finish(B, H, D, ns, S, Cap, window,
                            static_cast<const int*>(lens),
                            static_cast<float*>(out),
                            static_cast<const float*>(part), st);
}
