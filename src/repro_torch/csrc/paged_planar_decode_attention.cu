// K4: single-query GQA decode attention over the paged byte-planar
// ("NestedKV") KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/planar_decode_attention.py ::
// paged_planar_decode_attention: q (B,H,D) f32; planes k_hi, k_lo, v_hi,
// v_lo (NB,BS,Hkv,D) u8; tables (B,MB) i32; lens (B,) i32; window (<= 0 is
// global) -> (B,H,D) f32. FP16 mode joins hi|lo into the exact f16 K/V;
// FP8 mode reads only the hi planes, as e5m2 (half the bytes). D is 64,
// 96 (phi-3-vision), 128 or 256.
//
// What bounds it on an H100: the KV bytes of the kept keys,
// sum(kept) * Hkv * D * 2 (K and V) * (2 B in FP16 mode, 1 B in FP8) over
// 3.35 TB/s.
//
// What the design does about it: the body is decode_attention.cuh's, with
// key kpos of row b at pool row table[kpos/BS]*BS + kpos%BS, read in place
// (the TPU wrapper transposed the whole pool on every call). A split is
// 512 keys rounded down to whole table blocks; when MB*BS fits in one
// split (the engine's usual capacity) each block writes its rows of `out`
// itself and nothing else is launched.
#include "decode_attention.cuh"

namespace {

using nfp_decode::Layout;

template <int D, bool FP8>
__global__ void __launch_bounds__(nfp_decode::kThreads)
paged_split_kernel(const float* __restrict__ q,
                   const uint8_t* __restrict__ k_hi,
                   const uint8_t* __restrict__ k_lo,
                   const uint8_t* __restrict__ v_hi,
                   const uint8_t* __restrict__ v_lo,
                   const int* __restrict__ tables,
                   const int* __restrict__ lens, float* __restrict__ out,
                   float* __restrict__ part, int B, int H, int Hkv, int BS,
                   int MB, int ns, int S, int window, float q_scale) {
  const int b = blockIdx.z;
  nfp_decode::split_block<D, FP8>(
      q, k_hi, k_lo, v_hi, v_lo,
      nfp_decode::PagedRows{tables + (size_t)b * MB, BS}, lens[b], out, part,
      B, H, Hkv, ns, S, MB * BS, window, q_scale);
}

template <int D, bool FP8>
struct Launch {
  static int run(const void* q, const void* k_hi, const void* k_lo,
                 const void* v_hi, const void* v_lo, const void* tables,
                 const void* lens, void* out, void* part, int B, int H, int Hkv,
                 int BS, int MB, int ns, int S, int window, float q_scale,
                 cudaStream_t stream) {
    constexpr int smem = Layout<D, FP8>::kSmemBytes;
    cudaError_t err = cudaFuncSetAttribute(
        paged_split_kernel<D, FP8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    paged_split_kernel<D, FP8>
        <<<nfp_decode::split_grid(B, H, Hkv, ns), nfp_decode::kThreads, smem,
           stream>>>(
            static_cast<const float*>(q), static_cast<const uint8_t*>(k_hi),
            static_cast<const uint8_t*>(k_lo), static_cast<const uint8_t*>(v_hi),
            static_cast<const uint8_t*>(v_lo), static_cast<const int*>(tables),
            static_cast<const int*>(lens), static_cast<float*>(out),
            static_cast<float*>(part), B, H, Hkv, BS, MB, ns, S, window,
            q_scale);
    return (int)cudaGetLastError();
  }
};

// the head dims with an instance
int smem(int D, bool fp8) {
  return nfp_decode::smem_bytes<64, 96, 128, 256>(D, fp8);
}

}  // namespace

// dynamic shared memory of the split kernel; 0 when D has no instance
extern "C" int paged_planar_decode_attention_smem(int D, int fp8) {
  return smem(D, fp8 != 0);
}

// splits of a row of MB table blocks of BS keys; the scratch holds
// B*H*splits*(D+2) f32 when that is above 1
extern "C" int paged_planar_decode_attention_splits(int BS, int MB) {
  const int S = nfp_decode::split_keys(BS);
  return (MB * BS + S - 1) / S;
}

extern "C" int paged_planar_decode_attention(
    const void* q, const void* k_hi, const void* k_lo, const void* v_hi,
    const void* v_lo, const void* tables, const void* lens, void* out,
    void* part, int B, int H, int Hkv, int D, int BS, int MB, int window,
    int fp8, float q_scale, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (smem(D, fp8 != 0) == 0 || BS <= 0)
    return (int)cudaErrorInvalidValue;
  const int S = nfp_decode::split_keys(BS), ns = (MB * BS + S - 1) / S;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ns > 0) {
    const auto fn = nfp_decode::pick<Launch, 64, 96, 128, 256>(D, fp8 != 0);
    const int err = fn(q, k_hi, k_lo, v_hi, v_lo, tables, lens, out, part, B,
                       H, Hkv, BS, MB, ns, S, window, q_scale, st);
    if (err != 0) return err;
  }
  return nfp_decode::finish(B, H, D, ns, S, MB * BS, window,
                            static_cast<const int*>(lens),
                            static_cast<float*>(out),
                            static_cast<const float*>(part), st);
}
