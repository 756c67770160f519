// K7: FP8-mode NestedFP GEMM with per-tensor activation quantization, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/nestedfp8_matmul.py ::
// nestedfp8_matmul_fused_quant: x (M,K) f16/bf16/f32, upper (K,N) u8 read
// as e4m3, amax (1,) f32 the per-tensor absmax of x (taken outside, as the
// JAX wrapper expects) -> out (M,N) f32 =
//   (e4m3(clip(x * (448/amax))) @ e4m3(upper)) * (amax/448) * 2^-8.
// The scale is applied by multiplying with the inverse, never by dividing
// (ROADMAP F-port-2), and the epilogue keeps the order (acc * deq) * 2^-8.
//
// What bounds it on an H100: at decode (M = 8) the weight bytes, K*N at
// 3.35 TB/s (5.0 us for 4096 x 4096); at prefill (M = 8192) the fp8
// tensor-core rate, 2*M*K*N at 1,979 TFLOP/s (0.14 ms for 4096 x 4096);
// this body's products run at the f16 rate, half of that (see Products).
//
// Design (measurements in PERF.md §6):
//  * Quantize once. A pre-pass (quant_kernel, launched from the same C
//    entry) writes the e4m3 codes of x into an (M,K) u8 scratch that the
//    wrapper allocates: 16-byte loads, the same nfp::quant_e4m3 as the
//    in-register path of gemm_tile.cuh, so the codes are bitwise those of
//    quantizing inside the tile. The TPU kernel quantized each x tile again
//    for every output column block, which here would repeat the work N/BN
//    times. The pre-pass runs at every M, a few us at M = 8, so no in-tile
//    variant was built for M <= 64.
//  * The GEMM is the body of fp8_mma_gemm.cuh, shared with K2 (TMA ring,
//    transposing load of the (K,N) upper plane, mma.sync e4m3 with f32
//    sums, tile configs by M alone, no split-K), with its AmaxScale
//    epilogue: (acc * (amax/448)) * 2^-8. Every x type runs this one body
//    (PERF.md §6).
//
// Which body runs (the shape rule, decided here before any launch, never
// by catching a failure): the mma body needs K % 16 == 0, N % 16 == 0
// and a 16-byte aligned upper (nfp_f8::mma_body; the scratch is always
// aligned). Any other shape takes gemm_tile.cuh's kQuant body: the WMMA
// tiling with x quantized in registers.
#include <algorithm>

#include "fp8_mma_gemm.cuh"

namespace nfp_fq {

constexpr int kQuantThreads = 256;

using nfp::to_f32;

// The pre-pass: x (n elements of f32, f16 or bf16) -> e4m3 codes, 8 a
// thread; VEC takes 16-byte loads and 8-byte stores (x 16-byte and q
// 8-byte aligned).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kQuantThreads)
quant_kernel(const T* __restrict__ x, uint8_t* __restrict__ q,
             const float* __restrict__ amax, size_t n) {
  constexpr int kPerLoad = 16 / sizeof(T);
  const float inv = 448.f / amax[0];
  const size_t stride = (size_t)gridDim.x * kQuantThreads * 8;
  for (size_t i = ((size_t)blockIdx.x * kQuantThreads + threadIdx.x) * 8;
       i < n; i += stride) {
    if (VEC && i + 8 <= n) {
      alignas(16) T v[8];
#pragma unroll
      for (int j = 0; j < 8; j += kPerLoad)
        *reinterpret_cast<uint4*>(v + j) =
            *reinterpret_cast<const uint4*>(x + i + j);
      uint32_t c[2] = {0u, 0u};
#pragma unroll
      for (int j = 0; j < 8; ++j)
        c[j / 4] |= nfp::quant_e4m3(to_f32(v[j]), inv) << (8 * (j % 4));
      *reinterpret_cast<uint2*>(q + i) = make_uint2(c[0], c[1]);
    } else {
      for (size_t j = i; j < n && j < i + 8; ++j)
        q[j] = (uint8_t)nfp::quant_e4m3(to_f32(x[j]), inv);
    }
  }
}

template <typename T>
cudaError_t launch_quant(const void* x, uint8_t* q, const float* amax,
                         size_t n, cudaStream_t s) {
  const size_t groups = (n + 7) / 8;
  const int blocks = (int)std::min<size_t>((groups + kQuantThreads - 1) /
                                           kQuantThreads, 132 * 16);
  const T* xt = static_cast<const T*>(x);
  if (nfp::aligned(x, 16) && nfp::aligned(q, 8))
    quant_kernel<T, true><<<blocks, kQuantThreads, 0, s>>>(xt, q, amax, n);
  else
    quant_kernel<T, false><<<blocks, kQuantThreads, 0, s>>>(xt, q, amax, n);
  return cudaGetLastError();
}

}  // namespace nfp_fq

// x_type 0: f32, 1: f16, 2: bf16. xq: an (M,K) u8 scratch for the e4m3
// codes, 16-byte aligned, when the mma body runs
// (nestedfp8_matmul_fused_quant_smem > 0); unused otherwise.
extern "C" int nestedfp8_matmul_fused_quant(const void* x, int x_type,
                                            const void* upper,
                                            const void* amax, void* xq,
                                            void* out, int M, int N, int K,
                                            void* stream) {
  const float* a = static_cast<const float*>(amax);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaGetLastError();
  if (x_type < 0 || x_type > 2) return (int)cudaErrorInvalidValue;
  if (!nfp_f8::mma_body(N, K, upper)) {
    switch (x_type) {
      case 0:
        return nfp::launch_gemm<nfp::Op::kQuantF32>(x, upper, nullptr, a, 0,
                                                    o, M, N, K, s);
      case 1:
        return nfp::launch_gemm<nfp::Op::kQuantF16>(x, upper, nullptr, a, 0,
                                                    o, M, N, K, s);
      default:
        return nfp::launch_gemm<nfp::Op::kQuantBF16>(x, upper, nullptr, a,
                                                     0, o, M, N, K, s);
    }
  }
  uint8_t* q = static_cast<uint8_t*>(xq);
  const size_t n = (size_t)M * K;
  cudaError_t err =
      x_type == 0   ? nfp_fq::launch_quant<float>(x, q, a, n, s)
      : x_type == 1 ? nfp_fq::launch_quant<__half>(x, q, a, n, s)
                    : nfp_fq::launch_quant<__nv_bfloat16>(x, q, a, n, s);
  if (err != cudaSuccess) return (int)err;
  const uint8_t* u = static_cast<const uint8_t*>(upper);
  return (int)nfp_f8::by_m(M, [&](auto c) {
    return nfp_f8::launch_mma<decltype(c), nfp_f8::AmaxScale>(q, u, a, 0, o,
                                                              M, N, K, s);
  });
}

// Dynamic shared memory (bytes) of the body that the entry above picks
// for (M, N, K) and this upper: 0 for the gemm_tile.cuh body, whose
// tiles are static shared memory.
extern "C" int nestedfp8_matmul_fused_quant_smem(const void* upper, int M,
                                                 int N, int K) {
  if (!nfp_f8::mma_body(N, K, upper)) return 0;
  return nfp_f8::by_m(M, [](auto c) { return decltype(c)::kSmem; });
}
