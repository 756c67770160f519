// K4: single-query GQA decode attention over the paged byte-planar
// ("NestedKV") KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/planar_decode_attention.py ::
// paged_planar_decode_attention: q (B,H,D) f32; planes k_hi, k_lo, v_hi,
// v_lo (NB,BS,Hkv,D) u8; tables (B,MB) i32; lens (B,) i32; window (<= 0 is
// global) -> (B,H,D) f32. FP16 mode joins hi|lo into the exact f16 K/V;
// FP8 mode reads only the hi planes, as e5m2 (half the bytes). Same math
// as the TPU kernel: q scaled by D^-0.5 in f32, masks kpos < len and
// kpos > len-1-w, online softmax with NEG_INF = -1e30, out = acc/max(l,1e-30).
//
// What bounds it on an H100: the KV bytes, sum(len) * Hkv * D * 2 planes-
// pairs (2 B a value in FP16 mode, 1 B in FP8) over 3.35 TB/s; the
// arithmetic is a few f32 FLOPs per byte.
//
// What the design does about it: one block per (batch row, kv head) keeps
// the G = H/Hkv query rows of that head in shared memory, so each K/V byte
// is read once for all G heads; it walks the row's block table and reads
// the pool in place at byte offset ((blk*BS + t)*Hkv + h)*D (the TPU
// wrapper transposed the whole pool on every call). Blocks wholly past
// `len` or wholly before the window are skipped: for a row with len > 0
// they would add exactly zero after the online-softmax correction. A row
// with len == 0 visits nothing and writes zeros (finite; never read).
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float planar_value(uint32_t hi, uint32_t lo) {
  return __half2float(__ushort_as_half((unsigned short)((hi << 8) | lo)));
}

__global__ void __launch_bounds__(kThreads)
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
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  constexpr int kWarps = kThreads / 32;

  extern __shared__ float smem[];
  float* qs = smem;               // G*D   scaled queries
  float* ks = qs + G * D;         // BS*D  keys of one table block
  float* vs = ks + BS * D;        // BS*D  values of one table block
  float* ps = vs + BS * D;        // G*BS  scores, then probabilities
  float* acc = ps + G * BS;       // G*D   running numerators
  float* ml = acc + G * D;        // G running max, G running sum, G corr
  float* m_run = ml;
  float* l_run = ml + G;
  float* corr = ml + 2 * G;

  for (int i = tid; i < G * D; i += kThreads) {
    qs[i] = q[((size_t)b * H + (size_t)h * G) * D + i] * q_scale;
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_run[g] = kNegInf;
    l_run[g] = 0.f;
  }

  const int len = lens[b];
  int j_lo = 0;
  if (window > 0 && len - window > 0) j_lo = (len - window) / BS;
  int j_hi = len > 0 ? (len + BS - 1) / BS : 0;
  if (j_hi > MB) j_hi = MB;
  const int words = BS * D / 4;   // 4 bytes a load; D % 4 == 0
  __syncthreads();

  for (int j = j_lo; j < j_hi; ++j) {
    const size_t blk = (size_t)tables[(size_t)b * MB + j];
    for (int wi = tid; wi < words; wi += kThreads) {
      const int t = wi / (D / 4), d = (wi % (D / 4)) * 4;
      const size_t off = ((blk * BS + t) * Hkv + h) * D + d;
      const uint32_t kh = *reinterpret_cast<const uint32_t*>(k_hi + off);
      const uint32_t vh = *reinterpret_cast<const uint32_t*>(v_hi + off);
      uint32_t kl = 0u, vl = 0u;
      if (!fp8) {
        kl = *reinterpret_cast<const uint32_t*>(k_lo + off);
        vl = *reinterpret_cast<const uint32_t*>(v_lo + off);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = 8 * e;
        ks[t * D + d + e] = planar_value((kh >> s) & 0xFFu, (kl >> s) & 0xFFu);
        vs[t * D + d + e] = planar_value((vh >> s) & 0xFFu, (vl >> s) & 0xFFu);
      }
    }
    __syncthreads();

    // scores: one warp per (g, t) pair, lanes split D
    for (int p = warp; p < G * BS; p += kWarps) {
      const int g = p / BS, t = p % BS;
      float s = 0.f;
      for (int d = lane; d < D; d += 32) s += qs[g * D + d] * ks[t * D + d];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xFFFFFFFFu, s, o);
      if (lane == 0) {
        const int kpos = j * BS + t;
        const bool keep = kpos < len && (window <= 0 || kpos > len - 1 - window);
        ps[g * BS + t] = keep ? s : kNegInf;
      }
    }
    __syncthreads();

    // online-softmax bookkeeping, one thread per query row
    for (int g = tid; g < G; g += kThreads) {
      const float m_prev = m_run[g];
      float mx = m_prev;
      for (int t = 0; t < BS; ++t) mx = fmaxf(mx, ps[g * BS + t]);
      const float c = expf(m_prev - mx);
      float sum = 0.f;
      for (int t = 0; t < BS; ++t) {
        const float pv = expf(ps[g * BS + t] - mx);
        ps[g * BS + t] = pv;
        sum += pv;
      }
      l_run[g] = l_run[g] * c + sum;
      m_run[g] = mx;
      corr[g] = c;
    }
    __syncthreads();

    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, d = i % D;
      float pv = 0.f;
      for (int t = 0; t < BS; ++t) pv += ps[g * BS + t] * vs[t * D + d];
      acc[i] = acc[i] * corr[g] + pv;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    out[((size_t)b * H + (size_t)h * G) * D + i] = acc[i] / fmaxf(l_run[g], 1e-30f);
  }
}

int smem_bytes(int G, int D, int BS) {
  return (int)sizeof(float) * (2 * G * D + 2 * BS * D + G * BS + 3 * G);
}

}  // namespace

extern "C" int paged_planar_decode_attention(
    const void* q, const void* k_hi, const void* k_lo, const void* v_hi,
    const void* v_lo, const void* tables, const void* lens, void* out, int B,
    int H, int Hkv, int D, int BS, int MB, int window, int fp8,
    float q_scale, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  const int smem = smem_bytes(H / Hkv, D, BS);
  cudaError_t err = cudaFuncSetAttribute(
      paged_planar_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, Hkv);
  paged_planar_decode_kernel<<<grid, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const uint8_t*>(k_hi),
      static_cast<const uint8_t*>(k_lo), static_cast<const uint8_t*>(v_hi),
      static_cast<const uint8_t*>(v_lo), static_cast<const int*>(tables),
      static_cast<const int*>(lens), static_cast<float*>(out), H, Hkv, D, BS,
      MB, window, fp8, q_scale);
  return (int)cudaGetLastError();
}
