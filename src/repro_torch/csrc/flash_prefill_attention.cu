// K6: causal GQA flash attention for prefill, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_prefill_attention.py ::
// flash_prefill_attention: q (B,S,H,D), k/v (B,S,Hkv,D), all f32, f16 or
// bf16 -> (B,S,H,D) f32. Same math as the TPU kernel: q scaled by D^-0.5
// in f32, scores in f32, keys at kpos <= qpos, online softmax with
// NEG_INF = -1e30, out = acc / max(l, 1e-30).
//
// What bounds it on an H100: operations, 4*B*H*S^2*D/2 for the causal
// half; this first version runs them as f32 FMAs (67 TFLOP/s peak), not
// on the tensor cores (989 TFLOP/s in f16): f16 products of the f32
// probabilities would round them and miss the plain version's tolerance.
//
// What the design does about it: one block of 256 threads per (batch row,
// kv head, tile of BQ = 64/G query positions) holds all G query heads of
// that kv head — R = 64 query rows — so each K/V tile is read once for G
// heads. It walks key tiles of 64 and stops at the diagonal. Each thread
// keeps a 4x4 block of scores and a 4x(D/16) block of the output in
// registers, with the running max and sum of its 4 rows; the 16 threads of
// a row reduce by warp shuffles, so the softmax state never leaves
// registers. Ragged S is masked in the kernel (keys and queries past S
// load as zero and are masked or not stored); nothing is padded.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;     // query rows a block: G * BQ
constexpr int kKeys = 64;     // keys a tile; ref.PREFILL_TILE
constexpr float kNegInf = -1e30f;

template <typename T> __device__ __forceinline__ float4 load4(const T* p);

template <> __device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <> __device__ __forceinline__ float4 load4<__half>(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16>(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xFFFF0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xFFFF0000u));
}

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

template <int D>
constexpr int smem_floats() {
  return kRows * (D + 4) + D * (kKeys + 4) + kKeys * (D + 4) + kRows * (kKeys + 4);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, float* __restrict__ out, int S,
                     int H, int Hkv, float q_scale) {
  constexpr int LDQ = D + 4, LDK = kKeys + 4, LDV = D + 4, LDP = kKeys + 4;
  constexpr int NDG = D / 64;           // output column groups of 64
  static_assert(D % 64 == 0, "D is 64 or 128");
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [kRows][LDQ] scaled q
  float* Kt = Qs + kRows * LDQ;                  // [D][LDK] keys, transposed
  float* Vs = Kt + D * LDK;                      // [kKeys][LDV] values
  float* Ps = Vs + kKeys * LDV;                  // [kRows][LDP] probabilities

  const int G = H / Hkv, BQ = kRows / G;
  const int q0 = blockIdx.x * BQ, hh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  constexpr int C4 = D / 4;            // float4 chunks a row

  // this block's G*BQ query rows, row r = g*BQ + qq at position q0 + qq
  for (int c = tid; c < kRows * C4; c += kThreads) {
    const int r = c / C4, d = (c % C4) * 4, g = r / BQ, pos = q0 + r % BQ;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (pos < S)
      x = load4(q + (((size_t)b * S + pos) * H + (size_t)hh * G + g) * D + d);
    *reinterpret_cast<float4*>(&Qs[r * LDQ + d]) =
        make_float4(x.x * q_scale, x.y * q_scale, x.z * q_scale, x.w * q_scale);
  }

  float m[4], l[4], acc[4][NDG][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int gi = 0; gi < NDG; ++gi)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][gi][e] = 0.f;
  }
  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) qpos[i] = q0 + (tr + 16 * i) % BQ;

  const int k_end = min(S, q0 + BQ);            // causal: the diagonal
  for (int k0 = 0; k0 < k_end; k0 += kKeys) {
    __syncthreads();                            // previous tile consumed
    for (int c = tid; c < kKeys * C4; c += kThreads) {
      const int t = c / C4, d = (c % C4) * 4, pos = k0 + t;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (pos < S) {
        const size_t off = (((size_t)b * S + pos) * Hkv + hh) * D + d;
        kv = load4(k + off);
        vv = load4(v + off);
      }
      Kt[(d + 0) * LDK + t] = kv.x;
      Kt[(d + 1) * LDK + t] = kv.y;
      Kt[(d + 2) * LDK + t] = kv.z;
      Kt[(d + 3) * LDK + t] = kv.w;
      *reinterpret_cast<float4*>(&Vs[t * LDV + d]) = vv;
    }
    __syncthreads();

    // scores of rows tr + 16i against keys 4tc + j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(tr + 16 * i) * LDQ + d]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 kv = *reinterpret_cast<const float4*>(&Kt[(d + e) * LDK + 4 * tc]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float qe = comp(qv[i], e);
          s[i][0] += qe * kv.x;
          s[i][1] += qe * kv.y;
          s[i][2] += qe * kv.z;
          s[i][3] += qe * kv.w;
        }
      }
    }

    // mask, then the online softmax of each row across its 16 threads
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + 4 * tc + j;
        if (!(kpos <= qpos[i] && kpos < S)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      corr[i] = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xFFFFFFFFu, sum, o);
      l[i] = l[i] * corr[i] + sum;
      m[i] = m_new;
      *reinterpret_cast<float4*>(&Ps[(tr + 16 * i) * LDP + 4 * tc]) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();

    // acc = acc * corr + P @ V for rows tr + 16i, columns 64gi + 4tc + e
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int gi = 0; gi < NDG; ++gi)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][gi][e] *= corr[i];
#pragma unroll 2
    for (int c = 0; c < kKeys; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&Ps[(tr + 16 * i) * LDP + c]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int gi = 0; gi < NDG; ++gi) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &Vs[(c + e) * LDV + 64 * gi + 4 * tc]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = comp(pv[i], e);
            acc[i][gi][0] += p * vv.x;
            acc[i][gi][1] += p * vv.y;
            acc[i][gi][2] += p * vv.z;
            acc[i][gi][3] += p * vv.w;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i, g = r / BQ, pos = q0 + r % BQ;
    if (pos >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* o = out + (((size_t)b * S + pos) * H + (size_t)hh * G + g) * D;
#pragma unroll
    for (int gi = 0; gi < NDG; ++gi)
      *reinterpret_cast<float4*>(&o[64 * gi + 4 * tc]) =
          make_float4(acc[i][gi][0] / den, acc[i][gi][1] / den,
                      acc[i][gi][2] / den, acc[i][gi][3] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, float* out, int B,
           int S, int H, int Hkv, float q_scale, cudaStream_t stream) {
  const int smem = (int)sizeof(float) * smem_floats<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int bq = kRows / (H / Hkv);
  dim3 grid((S + bq - 1) / bq, Hkv, B);
  flash_prefill_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), out, S, H, Hkv, q_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, float* out, int B,
             int S, int H, int Hkv, int D, float q_scale, cudaStream_t s) {
  if (D == 64) return launch<T, 64>(q, k, v, out, B, S, H, Hkv, q_scale, s);
  if (D == 128) return launch<T, 128>(q, k, v, out, B, S, H, Hkv, q_scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 f32, 1 f16, 2 bf16 (q, k and v alike). Needs D in {64, 128}
// and (H / Hkv) dividing 64; the wrapper checks both.
extern "C" int flash_prefill_attention(const void* q, const void* k,
                                       const void* v, void* out, int dtype,
                                       int B, int S, int H, int Hkv, int D,
                                       float q_scale, void* stream) {
  if (B <= 0 || S <= 0) return (int)cudaGetLastError();
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_d<float>(q, k, v, o, B, S, H, Hkv, D, q_scale, s);
    case 1: return launch_d<__half>(q, k, v, o, B, S, H, Hkv, D, q_scale, s);
    case 2:
      return launch_d<__nv_bfloat16>(q, k, v, o, B, S, H, Hkv, D, q_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
