// Per-token e4m3 activation quantizer for Hopper (sm_90a), in front of K2
// on the serving engine's FP8 path.
//
// Computes repro/core/quant.py :: quantize_act_per_token, which the JAX
// package runs under jit, where XLA fuses it (no pallas_call): x (M,K)
// f32/f16/bf16 -> codes (M,K) e4m3 and scale (M,1) f32, with
//   amax  = max(max_k |x[m,k]|, 1e-12)      (in f32)
//   scale = amax / 448
//   codes = e4m3(clip(x / scale, -448, 448))  (round to nearest even).
// Both divisions are IEEE divisions (__fdiv_rn), not a multiply by a
// reciprocal and not __fdividef, so codes and scales are bitwise those of
// the port's quant.quantize_act_per_token and of the JAX function: one f32
// ulp at an e4m3 midpoint moves a code by a whole step (ROADMAP F-port-2,
// F-port-3).
//
// What bounds it on an H100: the bytes, the row read once and the codes
// and scales written once (M*K*(sizeof(x) + 1) + 4*M); at decode (M = 8,
// K = 4096, bf16: 98 KB, 0.03 us over 3.35 TB/s) the launch itself, which
// is why it is one launch where the eager version took six.
//
// Design: one block of 512 threads a row. Each thread loads its (up to
// four) chunks of 8 elements of the row into registers at once (16-byte
// loads when K % 8 == 0 and x is aligned), so the row is read once, with
// one memory latency; the f32 absmax is reduced by warp shuffles and then
// across the 16 warps in shared memory; the codes are computed from the
// registers and stored 8 at a time. Rows longer than the registers hold
// (K > 16384) take a two-pass variant that reads the row again from L1.
// abs and max are exact, so the order of the reduction does not matter,
// and a row's result does not depend on the other rows.
//
// A serving mesh's row-parallel layers (wo, down) hold a column slice of
// each row a shard, while the scale is the whole row's (GSPMD reduces the
// amax across shards in the JAX package). Two more entry points split the
// launch at that reduction: `row_absmax` writes each row's absmax of the
// slice, the mesh takes the max across shards and the scale from it
// (quant.scale_from_amax), and `quant_per_token_scaled` writes the slice's
// codes under that scale: bitwise the unsharded codes at those columns.
// Each moves the slice's bytes once, as the one-launch quantizer does.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tile.cuh"

namespace nfp_qt {

constexpr int kThreads = 512;
constexpr int kChunks = 4;                 // chunks of 8 held a thread
constexpr int kHeld = kThreads * 8 * kChunks;

// 8 elements of a row from k: 16-byte loads (VEC), else one at a time
template <typename T, bool VEC>
__device__ __forceinline__ void load8(float (&v)[8], const T* xr, int k,
                                      int K) {
  if constexpr (VEC) {
    constexpr int kPerLoad = 16 / sizeof(T);
    alignas(16) T t[8];
#pragma unroll
    for (int j = 0; j < 8; j += kPerLoad)
      *reinterpret_cast<uint4*>(t + j) =
          *reinterpret_cast<const uint4*>(xr + k + j);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = nfp::to_f32(t[j]);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = k + j < K ? nfp::to_f32(xr[k + j]) : 0.f;
  }
}

// the e4m3 codes of 8 elements, divided by the row's scale, into q[k..]
template <bool VEC>
__device__ __forceinline__ void store8(uint8_t* qr, const float (&v)[8],
                                       float s, int k, int K) {
  uint32_t c[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float y = fminf(fmaxf(__fdiv_rn(v[j], s), -448.f), 448.f);
    c[j / 4] |=
        (uint32_t)__nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E4M3)
        << (8 * (j % 4));
  }
  if constexpr (VEC) {
    *reinterpret_cast<uint2*>(qr + k) = make_uint2(c[0], c[1]);
  } else {
    for (int j = 0; j < 8 && k + j < K; ++j)
      qr[k + j] = (uint8_t)(c[j / 4] >> (8 * (j % 4)));
  }
}

// What a launch does with a row. kFull: its absmax, then its scale and
// codes (quant.quantize_act_per_token). The two halves of kFull for a row
// cut into column slices (a row-parallel layer of a serving mesh): kAmax
// writes the slice's absmax alone (not clamped) into `scale`; kScaled
// reads the row's scale from `scale` (computed from every slice's absmax)
// and writes the slice's codes, which are then bitwise kFull's codes of
// the whole row at those columns.
enum Stage { kFull = 0, kAmax = 1, kScaled = 2 };

// HOLD: K <= kHeld, the row stays in registers between the passes
template <typename T, bool VEC, bool HOLD, int STAGE>
__global__ void __launch_bounds__(kThreads)
quant_per_token_kernel(const T* __restrict__ x, uint8_t* __restrict__ q,
                       float* __restrict__ scale, int K) {
  __shared__ float red[kThreads / 32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * K;
  uint8_t* qr = q + row * K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto chunk = [&](int c) { return (c * kThreads + (int)threadIdx.x) * 8; };

  float m = 0.f;
  float v[HOLD ? kChunks : 1][8];
  if constexpr (HOLD) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (chunk(c) < K) {
        load8<T, VEC>(v[c], xr, chunk(c), K);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[c][j] = 0.f;
      }
    }
    if constexpr (STAGE != kScaled) {
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(v[c][j]));
    }
  } else if constexpr (STAGE != kScaled) {
    for (int k = chunk(0); k < K; k += kThreads * 8) {
      load8<T, VEC>(v[0], xr, k, K);
#pragma unroll
      for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(v[0][j]));
    }
  }
  float s;
  if constexpr (STAGE == kScaled) {
    s = scale[row];
  } else {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) red[warp] = m;
    __syncthreads();
    float amax = red[0];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) amax = fmaxf(amax, red[w]);
    if constexpr (STAGE == kAmax) {
      if (threadIdx.x == 0) scale[row] = amax;
      return;
    }
    s = __fdiv_rn(fmaxf(amax, 1e-12f), 448.f);
    if (threadIdx.x == 0) scale[row] = s;
  }

  if constexpr (HOLD) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
      if (chunk(c) < K) store8<VEC>(qr, v[c], s, chunk(c), K);
  } else {
    for (int k = chunk(0); k < K; k += kThreads * 8) {
      load8<T, VEC>(v[0], xr, k, K);
      store8<VEC>(qr, v[0], s, k, K);
    }
  }
}

template <typename T, bool VEC, int STAGE>
void launch_rows(const T* x, uint8_t* q, float* scale, int M, int K,
                 cudaStream_t s) {
  if (K <= kHeld)
    quant_per_token_kernel<T, VEC, true, STAGE>
        <<<M, kThreads, 0, s>>>(x, q, scale, K);
  else
    quant_per_token_kernel<T, VEC, false, STAGE>
        <<<M, kThreads, 0, s>>>(x, q, scale, K);
}

template <typename T, int STAGE>
cudaError_t launch(const void* x, uint8_t* q, float* scale, int M, int K,
                   cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  // every row's base 16-byte (x) and 8-byte (q) aligned (kAmax writes no
  // codes: q is null there)
  if (K % 8 == 0 && nfp::aligned(x, 16) && (STAGE == kAmax || nfp::aligned(q, 8)))
    launch_rows<T, true, STAGE>(xt, q, scale, M, K, s);
  else
    launch_rows<T, false, STAGE>(xt, q, scale, M, K, s);
  return cudaGetLastError();
}

template <int STAGE>
int dispatch(const void* x, int x_type, void* q, void* scale, int M, int K,
             void* stream) {
  uint8_t* qc = static_cast<uint8_t*>(q);
  float* sc = static_cast<float*>(scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K <= 0) return (int)cudaGetLastError();
  switch (x_type) {
    case 0:
      return (int)launch<float, STAGE>(x, qc, sc, M, K, s);
    case 1:
      return (int)launch<__half, STAGE>(x, qc, sc, M, K, s);
    case 2:
      return (int)launch<__nv_bfloat16, STAGE>(x, qc, sc, M, K, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace nfp_qt

// x_type 0: f32, 1: f16, 2: bf16. x (M,K) contiguous; q (M,K) u8 codes;
// scale (M,) f32.
extern "C" int quant_per_token(const void* x, int x_type, void* q,
                               void* scale, int M, int K, void* stream) {
  return nfp_qt::dispatch<nfp_qt::kFull>(x, x_type, q, scale, M, K, stream);
}

// amax (M,) f32 <- max_k |x[m,k]| of a column slice x (M,K), not clamped
extern "C" int row_absmax(const void* x, int x_type, void* amax, int M,
                          int K, void* stream) {
  return nfp_qt::dispatch<nfp_qt::kAmax>(x, x_type, nullptr, amax, M, K,
                                         stream);
}

// q (M,K) u8 codes of a column slice x (M,K) under the row scales given,
// scale (M,) f32 (= max(row absmax, 1e-12) / 448 of the whole row)
extern "C" int quant_per_token_scaled(const void* x, int x_type, void* q,
                                      const void* scale, int M, int K,
                                      void* stream) {
  return nfp_qt::dispatch<nfp_qt::kScaled>(x, x_type, q,
                                           const_cast<void*>(scale), M, K,
                                           stream);
}
