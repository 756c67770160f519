// Shared body of the two single-query decode attention kernels of the port
// over byte-planar ("NestedKV") K/V: K4 paged_planar_decode_attention
// (keys found through a block table) and K5 planar_decode_attention (keys
// dense per batch row). Only the addressing of a tile of keys differs; it
// comes in as a functor that maps tile j to the row of its first key.
//
// Math, as the TPU kernels: q scaled by D^-0.5 in f32; keys at kpos < len,
// and with a window w > 0 at kpos > len-1-w; online softmax with
// NEG_INF = -1e30; out = acc / max(l, 1e-30). FP16 mode joins hi|lo into
// the exact f16 values; FP8 mode reads only the hi planes, as e5m2.
//
// Design: one block of 128 threads per (batch row, kv head) holds the
// G = H/Hkv query rows of that head in shared memory, so each K/V byte is
// read once for all G heads. It loops over tiles of T keys: 16-byte plane
// loads into shared memory (row stride D+1 floats, so threads that walk
// keys hit distinct banks), one thread per (query row, key) score, one
// warp per query row for the softmax bookkeeping, one thread per (query
// row, d) for the value sum. Tiles wholly past `len` or wholly before the
// window are skipped: for len > 0 they add exactly zero once the online
// softmax has seen a kept key. Shared memory does not grow with the
// cache, only with T. A row with len == 0 visits nothing and writes zeros.
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nfp_decode {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

// bytes of dynamic shared memory for G query rows, head dim D, T keys a tile
inline int smem_bytes(int G, int D, int T) {
  return (int)sizeof(float) * (2 * G * D + 2 * T * (D + 1) + G * T + 3 * G);
}

__device__ __forceinline__ float planar_value(uint32_t hi, uint32_t lo) {
  return __half2float(__ushort_as_half((unsigned short)((hi << 8) | lo)));
}

// 16 hi bytes and 16 lo bytes (zero in FP8 mode) -> 16 floats at dst
__device__ __forceinline__ void unpack16(uint4 hi, uint4 lo, float* dst) {
  const uint32_t h[4] = {hi.x, hi.y, hi.z, hi.w};
  const uint32_t l[4] = {lo.x, lo.y, lo.z, lo.w};
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const int s = 8 * (e % 4);
    dst[e] = planar_value((h[e / 4] >> s) & 0xFFu, (l[e / 4] >> s) & 0xFFu);
  }
}

__device__ __forceinline__ uint4 load16(const uint8_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// Paged pool (NB, BS, Hkv, D): tile j is table block j.
struct PagedRows {
  const int* table;
  int bs;
  __device__ size_t operator()(int j) const { return (size_t)table[j] * bs; }
};

// Dense per-slot planes (B, Cap, Hkv, D): tile j of row b starts at key j*T.
struct DenseRows {
  size_t row0;
  int t;
  __device__ size_t operator()(int j) const { return row0 + (size_t)j * t; }
};

// One (batch row, kv head): q and out point at this head group's G rows of
// D values; the planes are indexed ((row + t) * Hkv + h) * D + d, where
// row = rows(j) for tile j. Keys at logical position >= limit are not read.
template <class Rows>
__device__ void decode_attend(const float* __restrict__ q,
                              const uint8_t* __restrict__ k_hi,
                              const uint8_t* __restrict__ k_lo,
                              const uint8_t* __restrict__ v_hi,
                              const uint8_t* __restrict__ v_lo,
                              float* __restrict__ out, Rows rows, int Hkv,
                              int h, int G, int D, int T, int n_tiles,
                              int limit, int len, int window, bool fp8,
                              float q_scale) {
  extern __shared__ float smem[];
  const int LD = D + 1;
  float* qs = smem;               // G*D   scaled queries
  float* ks = qs + G * D;         // T*LD  keys of one tile
  float* vs = ks + T * LD;        // T*LD  values of one tile
  float* ps = vs + T * LD;        // G*T   scores, then probabilities
  float* acc = ps + G * T;        // G*D   running numerators
  float* m_run = acc + G * D;     // G     running max
  float* l_run = m_run + G;       // G     running sum
  float* corr = l_run + G;        // G     this tile's correction
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  for (int i = tid; i < G * D; i += kThreads) {
    qs[i] = q[i] * q_scale;
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_run[g] = kNegInf;
    l_run[g] = 0.f;
  }
  int j_lo = 0;
  if (window > 0 && len - window > 0) j_lo = (len - window) / T;
  int j_hi = len > 0 ? (len + T - 1) / T : 0;
  if (j_hi > n_tiles) j_hi = n_tiles;
  const int per_key = D / 16, chunks = T * per_key;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  for (int j = j_lo; j < j_hi; ++j) {
    const size_t row0 = rows(j);
    for (int c = tid; c < chunks; c += kThreads) {
      const int t = c / per_key, d = (c % per_key) * 16;
      uint4 kh = zero, kl = zero, vh = zero, vl = zero;
      if (j * T + t < limit) {
        const size_t off = ((row0 + t) * Hkv + h) * D + d;
        kh = load16(k_hi + off);
        vh = load16(v_hi + off);
        if (!fp8) {
          kl = load16(k_lo + off);
          vl = load16(v_lo + off);
        }
      }
      unpack16(kh, kl, ks + t * LD + d);
      unpack16(vh, vl, vs + t * LD + d);
    }
    __syncthreads();

    for (int p = tid; p < G * T; p += kThreads) {
      const int g = p / T, t = p % T;
      const float* qr = qs + g * D;
      const float* kr = ks + t * LD;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s += qr[d] * kr[d];
      const int kpos = j * T + t;
      const bool keep = kpos < len && (window <= 0 || kpos > len - 1 - window);
      ps[p] = keep ? s : kNegInf;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {
      float* pr = ps + g * T;
      const float m_prev = m_run[g];
      float mx = m_prev;
      for (int t = lane; t < T; t += 32) mx = fmaxf(mx, pr[t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, o));
      float sum = 0.f;
      for (int t = lane; t < T; t += 32) {
        const float pv = expf(pr[t] - mx);
        pr[t] = pv;
        sum += pv;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xFFFFFFFFu, sum, o);
      if (lane == 0) {
        const float c = expf(m_prev - mx);
        l_run[g] = l_run[g] * c + sum;
        m_run[g] = mx;
        corr[g] = c;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, d = i % D;
      const float* pr = ps + g * T;
      float pv = 0.f;
      for (int t = 0; t < T; ++t) pv += pr[t] * vs[t * LD + d];
      acc[i] = acc[i] * corr[g] + pv;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * D; i += kThreads)
    out[i] = acc[i] / fmaxf(l_run[i / D], 1e-30f);
}

}  // namespace nfp_decode
