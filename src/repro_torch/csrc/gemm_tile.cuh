// The WMMA tiling that was K2's first body (nestedfp8_matmul), kept as the
// body of K1, K2, K3 and K7 for shapes outside their TMA rules (N not a
// multiple of 16, K not a multiple of 8 or 16, unaligned operands): out
// (M,N) f32 = A (M,K) @ B (K,N), with B stored (K,N) row-major exactly as
// the JAX package lays it out. The TMA-fed bodies are wgmma_gemm.cuh (K1,
// K3) and fp8_mma_gemm.cuh (K2, K7).
//
// Design (the first slice's, simple first):
//   * A block of 2 or 4 warps owns a BM x BN output tile and walks K in
//     BK-deep steps. Each step stages the raw global bytes of the next A
//     and B tiles in registers while the tensor cores work on the current
//     tile (register double buffering), then converts them to f16 into
//     shared memory: K1 rebuilds f16 weights from the two byte planes,
//     K2 widens e4m3 bytes to f16 (exact), K3 copies f16, and K7 turns
//     f16/bf16/f32 activations into e4m3 codes (x * 448/amax, clamped,
//     rounded to nearest even) and widens those to f16.
//   * Tensor cores through WMMA 16x16x16, f16 inputs, f32 accumulate.
//   * Every output element sums its K products in the same order — 16-wide
//     steps from k = 0 upwards — whatever the tile shape picked from M, and
//     there is no split-K, so a row's result does not depend on the other
//     rows of the batch (the serving engine's batched == solo guarantee).
//   * Edges are masked: rows past M and columns past N or K load as zero,
//     stores past M or N are skipped. A vector path (8 elements a load)
//     runs when K and N are multiples of 8 and the pointers are aligned.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace nfp {

// kQuant*: K7, whose A operand is quantized to e4m3 inside the kernel;
// the suffix names the activation type it reads.
enum class Op { kNested16, kNested8, kF16, kQuantF16, kQuantBF16, kQuantF32 };

template <Op OP>
constexpr bool kQuant =
    OP == Op::kQuantF16 || OP == Op::kQuantBF16 || OP == Op::kQuantF32;

// NestedFP reconstruction of one weight (paper Fig. 6), bit-exact with
// repro.core.nestedfp.decode: undo the RNE carry with lower's MSB.
__device__ __forceinline__ uint32_t nested_f16_bits(uint32_t u, uint32_t l) {
  const uint32_t corrected = (u & 0x7Fu) - (l >> 7);
  return (((u >> 7) << 15) | ((corrected >> 1) << 8) | l) & 0xFFFFu;
}

// e4m3 byte -> f16 bits of (value * 2^-8): the f16 exponent bias exceeds
// e4m3's by 8, so shifting the 7 magnitude bits into place is exact for
// normals and subnormals alike. Callers multiply by 256 (also exact).
__device__ __forceinline__ uint32_t e4m3_f16_bits_scaled(uint32_t b) {
  return ((b & 0x80u) << 8) | ((b & 0x7Fu) << 7);
}

__device__ __forceinline__ uint32_t pack2(uint32_t lo, uint32_t hi) {
  return (lo & 0xFFFFu) | (hi << 16);
}

// 8 bytes (two words) of NestedFP planes -> 8 f16 values (uint4)
__device__ __forceinline__ uint4 nested8_to_f16x8(uint2 u, uint2 l) {
  uint32_t w[4];
  const uint32_t us[2] = {u.x, u.y}, ls[2] = {l.x, l.y};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t uw = us[i / 2], lw = ls[i / 2];
    const int s0 = (i % 2) * 16, s1 = s0 + 8;
    w[i] = pack2(nested_f16_bits((uw >> s0) & 0xFFu, (lw >> s0) & 0xFFu),
                 nested_f16_bits((uw >> s1) & 0xFFu, (lw >> s1) & 0xFFu));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 8 e4m3 bytes -> 8 f16 values holding the exact e4m3 values
__device__ __forceinline__ uint4 e4m3x8_to_f16x8(uint2 b) {
  const __half2 k256 = __floats2half2_rn(256.f, 256.f);
  uint32_t w[4];
  const uint32_t bs[2] = {b.x, b.y};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t bw = bs[i / 2];
    const int s0 = (i % 2) * 16, s1 = s0 + 8;
    uint32_t p = pack2(e4m3_f16_bits_scaled((bw >> s0) & 0xFFu),
                       e4m3_f16_bits_scaled((bw >> s1) & 0xFFu));
    __half2 h = *reinterpret_cast<__half2*>(&p);
    h = __hmul2(h, k256);
    w[i] = *reinterpret_cast<uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// e4m3 code of x * inv, clamped to +-448 first (as the JAX kernel's
// clip), rounded to nearest even by the hardware conversion.
__device__ __forceinline__ uint32_t quant_e4m3(float x, float inv) {
  const float v = fminf(fmaxf(x * inv, -448.f), 448.f);
  return (uint32_t)__nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3);
}

// An activation of type T (f32, f16 or bf16) in f32, exactly
template <typename T>
__device__ __forceinline__ float to_f32(T v) {
  if constexpr (std::is_same<T, float>::value)
    return v;
  else if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __bfloat162float(v);
  else
    return __half2float(v);
}

// 8 activations (as 32-bit words of f32 bits, or 16-bit f16/bf16 bits in
// the low half) -> 8 f16 values holding their e4m3 codes' exact values
template <Op OP>
__device__ __forceinline__ uint4 quant8_to_f16x8(const uint32_t (&x)[8],
                                                 float inv) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float f;
    if constexpr (OP == Op::kQuantF32) f = __uint_as_float(x[j]);
    else if constexpr (OP == Op::kQuantBF16) f = __uint_as_float(x[j] << 16);
    else f = __half2float(__ushort_as_half((unsigned short)x[j]));
    w[j / 4] |= quant_e4m3(f, inv) << (8 * (j % 4));
  }
  return e4m3x8_to_f16x8(make_uint2(w[0], w[1]));
}

// Raw global bytes of one 8-element chunk, as loaded (converted later).
template <Op OP> struct AChunk { uint4 v; };             // 8 x 16-bit
template <> struct AChunk<Op::kNested8> { uint2 v; };    // 8 x e4m3
template <> struct AChunk<Op::kQuantF32> { uint4 v, w; };  // 8 x f32

template <Op OP> struct BChunk;
template <> struct BChunk<Op::kNested16> { uint2 u, l; };  // 8 upper + 8 lower
template <> struct BChunk<Op::kNested8> { uint2 u; };      // 8 upper only
template <> struct BChunk<Op::kF16> { uint4 w; };          // 8 x f16
template <> struct BChunk<Op::kQuantF16> { uint2 u; };     // 8 upper only
template <> struct BChunk<Op::kQuantBF16> { uint2 u; };
template <> struct BChunk<Op::kQuantF32> { uint2 u; };

template <Op OP, bool VEC>
__device__ __forceinline__ void load_a(AChunk<OP>& c, const void* a, int m,
                                       int k, int M, int K) {
  if constexpr (OP == Op::kNested8) {
    const uint8_t* p = static_cast<const uint8_t*>(a);
    if (VEC) {
      c.v = (m < M && k < K)
          ? *reinterpret_cast<const uint2*>(p + (size_t)m * K + k)
          : make_uint2(0u, 0u);
    } else {
      uint32_t w[2] = {0u, 0u};
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (m < M && k + j < K)
          w[j / 4] |= (uint32_t)p[(size_t)m * K + k + j] << (8 * (j % 4));
      c.v = make_uint2(w[0], w[1]);
    }
  } else if constexpr (OP == Op::kQuantF32) {
    const uint32_t* p = static_cast<const uint32_t*>(a);
    if (VEC) {
      const bool in = m < M && k < K;
      const uint4* q = reinterpret_cast<const uint4*>(p + (size_t)m * K + k);
      c.v = in ? q[0] : make_uint4(0u, 0u, 0u, 0u);
      c.w = in ? q[1] : make_uint4(0u, 0u, 0u, 0u);
    } else {
      uint32_t w[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (m < M && k + j < K) w[j] = p[(size_t)m * K + k + j];
      c.v = make_uint4(w[0], w[1], w[2], w[3]);
      c.w = make_uint4(w[4], w[5], w[6], w[7]);
    }
  } else {
    const uint16_t* p = static_cast<const uint16_t*>(a);
    if (VEC) {
      c.v = (m < M && k < K)
          ? *reinterpret_cast<const uint4*>(p + (size_t)m * K + k)
          : make_uint4(0u, 0u, 0u, 0u);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (m < M && k + j < K)
          w[j / 2] |= (uint32_t)p[(size_t)m * K + k + j] << (16 * (j % 2));
      c.v = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

template <bool VEC>
__device__ __forceinline__ uint2 load_bytes8(const uint8_t* p, int k, int n,
                                             int K, int N) {
  if (VEC) {
    return (k < K && n < N)
        ? *reinterpret_cast<const uint2*>(p + (size_t)k * N + n)
        : make_uint2(0u, 0u);
  }
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (k < K && n + j < N)
      w[j / 4] |= (uint32_t)p[(size_t)k * N + n + j] << (8 * (j % 4));
  return make_uint2(w[0], w[1]);
}

template <Op OP, bool VEC>
__device__ __forceinline__ void load_b(BChunk<OP>& c, const uint8_t* b0,
                                       const uint8_t* b1, int k, int n,
                                       int K, int N) {
  if constexpr (OP == Op::kNested16) {
    c.u = load_bytes8<VEC>(b0, k, n, K, N);
    c.l = load_bytes8<VEC>(b1, k, n, K, N);
  } else if constexpr (OP == Op::kNested8 || kQuant<OP>) {
    c.u = load_bytes8<VEC>(b0, k, n, K, N);
  } else {
    const uint16_t* p = reinterpret_cast<const uint16_t*>(b0);
    if (VEC) {
      c.w = (k < K && n < N)
          ? *reinterpret_cast<const uint4*>(p + (size_t)k * N + n)
          : make_uint4(0u, 0u, 0u, 0u);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (k < K && n + j < N)
          w[j / 2] |= (uint32_t)p[(size_t)k * N + n + j] << (16 * (j % 2));
      c.w = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

template <Op OP>
__device__ __forceinline__ uint4 a_to_f16(const AChunk<OP>& c, float inv) {
  if constexpr (OP == Op::kNested8) {
    return e4m3x8_to_f16x8(c.v);
  } else if constexpr (OP == Op::kQuantF32) {
    const uint32_t x[8] = {c.v.x, c.v.y, c.v.z, c.v.w,
                           c.w.x, c.w.y, c.w.z, c.w.w};
    return quant8_to_f16x8<OP>(x, inv);
  } else if constexpr (kQuant<OP>) {
    const uint32_t ws[4] = {c.v.x, c.v.y, c.v.z, c.v.w};
    uint32_t x[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = (ws[j / 2] >> (16 * (j % 2))) & 0xFFFFu;
    return quant8_to_f16x8<OP>(x, inv);
  } else {
    return c.v;
  }
}

template <Op OP>
__device__ __forceinline__ uint4 b_to_f16(const BChunk<OP>& c) {
  if constexpr (OP == Op::kNested16) return nested8_to_f16x8(c.u, c.l);
  else if constexpr (OP == Op::kNested8 || kQuant<OP>)
    return e4m3x8_to_f16x8(c.u);
  else return c.w;
}

// scale: optional per-row dequant factor (K2): out = acc * scale[m*stride] * 2^-8;
// for K7 (kQuant*) it points at amax: A is quantized with 448/amax and
// out = acc * (amax/448) * 2^-8, the JAX kernel's order of operations.
template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, Op OP, bool VEC>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N)
gemm_kernel(const void* __restrict__ a, const uint8_t* __restrict__ b0,
            const uint8_t* __restrict__ b1, const float* __restrict__ scale,
            int scale_stride, float* __restrict__ out, int M, int N, int K) {
  using namespace nvcuda;
  constexpr int T = 32 * WARPS_M * WARPS_N;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int FM = WM / 16, FN = WN / 16;
  constexpr int LDA = BK + 8, LDB = BN + 8, LDC = BN + 4;
  constexpr int A_CH = BM * BK / 8 / T, B_CH = BK * BN / 8 / T;
  static_assert(WM % 16 == 0 && WN % 16 == 0 && BK % 16 == 0, "tile shape");
  static_assert(BM * BK % (8 * T) == 0 && BK * BN % (8 * T) == 0, "chunks");

  __shared__ __align__(128) half As[BM * LDA];
  __shared__ __align__(128) half Bs[BK * LDB];
  __shared__ __align__(128) float Cs[BM * LDC];

  float inv = 0.f, deq = 0.f;
  if constexpr (kQuant<OP>) {
    inv = 448.f / scale[0];
    deq = scale[0] / 448.f;
  }
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  AChunk<OP> ar[A_CH];
  BChunk<OP> br[B_CH];

  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_CH; ++i) {
      const int c = tid + i * T, r = c / (BK / 8), col = (c % (BK / 8)) * 8;
      load_a<OP, VEC>(ar[i], a, m0 + r, k0 + col, M, K);
    }
#pragma unroll
    for (int i = 0; i < B_CH; ++i) {
      const int c = tid + i * T, r = c / (BN / 8), col = (c % (BN / 8)) * 8;
      load_b<OP, VEC>(br[i], b0, b1, k0 + r, n0 + col, K, N);
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < A_CH; ++i) {
      const int c = tid + i * T, r = c / (BK / 8), col = (c % (BK / 8)) * 8;
      *reinterpret_cast<uint4*>(&As[r * LDA + col]) = a_to_f16<OP>(ar[i], inv);
    }
#pragma unroll
    for (int i = 0; i < B_CH; ++i) {
      const int c = tid + i * T, r = c / (BN / 8), col = (c % (BN / 8)) * 8;
      *reinterpret_cast<uint4*>(&Bs[r * LDB + col]) = b_to_f16<OP>(br[i]);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    stage();
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);   // in flight while the MMAs run
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, half, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, half, wmma::row_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], &As[(wm * WM + i * 16) * LDA + kk], LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], &Bs[kk * LDB + wn * WN + j * 16], LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(&Cs[(wm * WM + i * 16) * LDC + wn * WN + j * 16],
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += T) {
    const int r = e / BN, c = e % BN, m = m0 + r, n = n0 + c;
    if (m < M && n < N) {
      float v = Cs[r * LDC + c];
      if constexpr (kQuant<OP>) v = v * deq * 0.00390625f;
      else if (scale != nullptr)
        v = v * scale[(size_t)m * scale_stride] * 0.00390625f;
      out[(size_t)m * N + n] = v;
    }
  }
}

inline bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

template <Op OP, bool VEC>
void launch_config(const void* a, const uint8_t* b0, const uint8_t* b1,
                   const float* scale, int scale_stride, float* out, int M,
                   int N, int K, cudaStream_t stream) {
  if (M <= 32) {
    // decode-sized M: narrow tiles so the weight stream spreads over
    // enough blocks to keep the memory system busy
    constexpr int BM = 16, BN = 32, BK = 64;
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    gemm_kernel<BM, BN, BK, 1, 2, OP, VEC><<<grid, 64, 0, stream>>>(
        a, b0, b1, scale, scale_stride, out, M, N, K);
  } else {
    constexpr int BM = 64, BN = 64, BK = 32;
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    gemm_kernel<BM, BN, BK, 2, 2, OP, VEC><<<grid, 128, 0, stream>>>(
        a, b0, b1, scale, scale_stride, out, M, N, K);
  }
}

template <Op OP>
int launch_gemm(const void* a, const void* b0, const void* b1,
                const float* scale, int scale_stride, float* out, int M,
                int N, int K, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaGetLastError();
  const uintptr_t a_al = OP == Op::kNested8 ? 8 : 16;
  const uintptr_t b_al = OP == Op::kF16 ? 16 : 8;   // u8 planes: 8 a load
  const bool vec = K % 8 == 0 && N % 8 == 0 && aligned(a, a_al) &&
                   aligned(b0, b_al) && (b1 == nullptr || aligned(b1, b_al));
  const uint8_t* p0 = static_cast<const uint8_t*>(b0);
  const uint8_t* p1 = static_cast<const uint8_t*>(b1);
  if (vec)
    launch_config<OP, true>(a, p0, p1, scale, scale_stride, out, M, N, K, stream);
  else
    launch_config<OP, false>(a, p0, p1, scale, scale_stride, out, M, N, K, stream);
  return (int)cudaGetLastError();
}

}  // namespace nfp
