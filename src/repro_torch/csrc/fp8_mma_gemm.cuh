// The FP8 GEMM body of K2 (nestedfp8_matmul.cu) and K7
// (nestedfp8_matmul_fused_quant.cu), for Hopper (sm_90a):
//   out (M,N) f32 = (codes (M,K) e4m3 @ upper (K,N) read as e4m3)
//                   * scale * 2^-8,
// with the codes an (M,K) u8 buffer that TMA reads in place (K2: the
// caller's x_q; K7: the scratch its pre-pass writes) and `upper` the
// NestedFP upper plane exactly as the JAX package lays it out.
//
// What bounds it on an H100: at decode (M = 8) the weight bytes, K*N at
// 3.35 TB/s (5.0 us for 4096 x 4096); at prefill (M = 8192) the fp8
// tensor-core rate, 2*M*K*N at 1,979 TFLOP/s (0.14 ms for 4096 x 4096);
// this body's products run at the f16 rate, half of that (see Products).
//
// Design (measurements in PERF.md §6):
//  * Products: mma.sync m16n8k32 .f32.e4m3.e4m3.f32, the e4m3 fragments
//    read by ldmatrix from 128B-swizzled K-major shared memory, all of K
//    chained in f32 accumulators. On sm_90a ptxas lowers each of these to
//    e4m3 -> f16 unpacks (F2FP.F16.E4M3) and two HMMA.16816.F32 (see
//    cuobjdump -sass of the build): the products are exact and the sums
//    f32-accurate, at the f16 tensor-core rate, not the FP8 one. Hopper's
//    FP8 rate comes only from wgmma, whose FP8 sums keep about 14 bits
//    (DeepSeek-V3, section 3.3.2): even with its partial sums promoted to
//    f32 they missed the f32 plain version by ~1e-3 at K = 14336, enough
//    to move the next layer's per-tensor amax and every e4m3 code with it
//    (ROADMAP F-port-4). At decode the weight bytes set the pace, so the
//    f16-rate products cost nothing there.
//  * Layout decision: upper stays (K,N), N-contiguous, exactly the JAX
//    package's plane, and is transposed on the way in (a transposing
//    load): the k32 e4m3 fragments need K-major operands. One weight copy
//    then serves K1, K2, K3, K7 and the converters unchanged; a per-call
//    transposed copy would triple decode's weight bytes.
//  * Loads by TMA, one thread issuing them for the block (see mma_kernel
//    for which), completing on an mbarrier: the codes land as a
//    (BM x 128-byte) box directly in the swizzled K-major layout that
//    ldmatrix reads; the weights land as a raw (128 k x BN) box, its k
//    rows permuted by a 3-D tensor map (see raw_offset) so that the
//    transposing reads are free of bank conflicts. Not cp.async: a warp
//    keeps only a few 16-byte copies in flight, too few to stream tiles.
//  * Transposing load: the producer warps turn each raw tile into the
//    K-major operand, a 16 k x 4 n block a thread: four 32-bit words, four
//    4 x 4 byte transposes by __byte_perm, four 16-byte stores into the
//    swizzled buffer; then an arrival on the stage's full barrier.
//  * Warp specialisation over a ring of STAGES stages in dynamic shared
//    memory: the loading thread waits on empty[s] (every consumer thread
//    is done with the stage), the transposers on landed[s] (the TMA
//    bytes), the consumer warps on full[s].
//  * Tiles, picked by M alone (by_m): 4, 4, 8 and 8 consumer warps for
//    M <= 16, <= 64, <= 256 and beyond, with BN = 32 (12-16 stages) up to
//    M = 256 and BM = BN = 128 (4 stages) beyond, where blocks are walked
//    in groups of 8 row tiles so a group's x rows stay in L2 while the
//    weights stream once per group; K2 also takes BN = 128 at decode when
//    N is wide (by_m_n). Only the rows of x that exist are loaded (see
//    launch_mma).
//  * Epilogue, a compile-time choice of how the f32 sums are scaled:
//    AmaxScale (K7) reads the per-tensor amax and applies
//    (acc * (amax / 448)) * 2^-8, the JAX fused kernel's order; RowScale
//    (K2) reads scale[m * stride] once per fragment row (stride 0: one
//    per-tensor scalar, 1: one per-token factor a row) and applies
//    (acc * s) * 2^-8, the order of ref.nestedfp8_matmul_ref.
//  * Batch invariance: every M runs the same instruction on the same k
//    order (k = 0 upwards in 32-wide steps, chained in f32) and there is
//    no split-K, so a row's result does not depend on the other rows
//    (tests/test_torch_gpu.py checks it bitwise across the configs).
//
// The shape rule (mma_body; each entry adds its own conditions on the
// codes buffer): K % 16 == 0, N % 16 == 0 and a 16-byte aligned upper, as
// TMA needs of the row strides and the base addresses; ragged edges of M,
// N and K are then zero-filled by TMA and masked at the stores. The
// mbarrier, TMA and swizzle helpers are tma.cuh's, shared with K1 and K3.
#pragma once

#include <type_traits>

#include "gemm_tile.cuh"
#include "tma.cuh"

namespace nfp_f8 {

using nfp::encode_fn;
using nfp::mbar_arrive;
using nfp::mbar_expect_tx;
using nfp::mbar_init;
using nfp::mbar_wait;
using nfp::smem_u32;
using nfp::sw128_offset;
using nfp::tma_load_2d;
using nfp::tma_load_3d;

constexpr int kBK = 128;          // k bytes of a tile: one 128-byte swizzle row

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// c += a (16 x 32 e4m3, row) * b (32 x 8 e4m3, col), f32 accumulators
__device__ __forceinline__ void mma_e4m3(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 4 words of 4 bytes (rows k..k+3, each holding columns n..n+3) -> 4 words
// each holding rows k..k+3 of one column: o[j] byte i = w[i] byte j
__device__ __forceinline__ void transpose4x4(const uint32_t (&w)[4],
                                             uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t t1 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
  o[0] = __byte_perm(t0, t2, 0x5410);
  o[1] = __byte_perm(t0, t2, 0x7632);
  o[2] = __byte_perm(t1, t3, 0x5410);
  o[3] = __byte_perm(t1, t3, 0x7632);
}

// A tile configuration: each consumer warp computes MT x NT tiles of
// 16 x 8, the consumer warps form a CM x CN grid, and STAGES k tiles of
// 128 bytes are in flight.
template <int MT_, int NT_, int CM_, int CN_, int STAGES_>
struct Cfg {
  static constexpr int MT = MT_, NT = NT_, CM = CM_, CN = CN_;
  static constexpr int STAGES = STAGES_;
  static constexpr int BM = 16 * MT * CM, BN = 8 * NT * CN;
  static constexpr int kConsumers = CM * CN;             // warps
  static constexpr int kThreads = 32 * kConsumers + 128; // + the producers
  // A codes, B operand (K-major), B raw staging, per stage; three
  // barriers a stage; 1024 bytes of slack to align the swizzle atoms
  static constexpr int kSmem =
      STAGES * (BM * kBK + 2 * BN * kBK) + 3 * STAGES * 8 + 1024;
  static_assert(BN == 32 || BN == 128, "raw tile layouts exist for these");
  static_assert(NT == 1 || NT % 2 == 0, "B fragments load in pairs");
};

// The epilogue's scale (see the note at the top)
struct AmaxScale {};   // K7: scale -> the per-tensor amax
struct RowScale {};    // K2: scale[m * stride]

// Where k row kr (0..127) and byte n of a raw weight tile lie in shared
// memory. The TMA box reads rows in the order kr = 16 * kg + i -> shared
// row 8 * i + kg, so the 8 row groups kg that a quarter-warp reads at once
// sit in 8 consecutive shared rows; at BN = 128 the 128-byte swizzle then
// XORs their 16-byte chunks with kg and the reads hit distinct banks.
template <int BN>
__device__ __forceinline__ uint32_t raw_offset(int kr, int n) {
  const int row = 8 * (kr & 15) + (kr >> 4);
  if constexpr (BN == 128)
    return (uint32_t)(row * 128 + ((((n >> 4) ^ (row & 7))) << 4) + (n & 15));
  else
    return (uint32_t)(row * BN + n);
}

// The body. Block: C::kConsumers consumer warps, then a producer
// warpgroup; grid: one block per (BM x BN) output tile, walked in groups
// of GROUP_M row tiles. Who issues the loads: at BN = 128 thread 0 of the
// first consumer warp, as soon as its stage is released, so all four
// producer warps transpose (eight units a tile, two each); at BN = 32
// (two units a tile) producer warp 0, which keeps the ring fuller at
// decode (PERF.md).
template <class C, class E>
__global__ void __launch_bounds__(C::kThreads, 1)
mma_kernel(const __grid_constant__ CUtensorMap map_a,
           const __grid_constant__ CUtensorMap map_b,
           const float* __restrict__ scale, int scale_stride,
           float* __restrict__ out, int M, int N, int K, int a_rows) {
  static_assert(std::is_same<E, AmaxScale>::value ||
                    std::is_same<E, RowScale>::value,
                "an epilogue of the note");
  constexpr int BM = C::BM, BN = C::BN, STAGES = C::STAGES;
  constexpr int MT = C::MT, NT = C::NT, NCW = C::kConsumers, GROUP_M = 8;
  constexpr int A_BYTES = BM * kBK, B_BYTES = BN * kBK;
  constexpr bool kConsumerLoads = BN == 128;
  constexpr int kTransposers = kConsumerLoads ? 4 : 3;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base0 = smem_u32(smem_raw);
  const uint32_t base = (base0 + 1023u) & ~1023u;
  uint8_t* sbase = smem_raw + (base - base0);
  const uint32_t a_s = base, b_s = a_s + STAGES * A_BYTES,
                 raw_s = b_s + STAGES * B_BYTES,
                 bars = raw_s + STAGES * B_BYTES;
  // landed[s]: both TMA tiles of stage s have arrived (1 arrival + bytes);
  // full[s]: operands ready for the consumers (one arrival a transposer
  // thread); empty[s]: every consumer thread is done with stage s
  auto landed = [&](int s) { return bars + 8 * s; };
  auto full = [&](int s) { return bars + 8 * (STAGES + s); };
  auto empty = [&](int s) { return bars + 8 * (2 * STAGES + s); };
  uint8_t* raw_p = sbase + (raw_s - base);
  uint8_t* b_p = sbase + (b_s - base);

  // tile of this block
  const int num_m = (M + BM - 1) / BM, num_n = (N + BN - 1) / BN;
  const int bid = blockIdx.x, per_group = GROUP_M * num_n;
  const int first_m = (bid / per_group) * GROUP_M;
  const int gsize = min(num_m - first_m, GROUP_M);
  const int m0 = (first_m + (bid % per_group) % gsize) * BM;
  const int n0 = ((bid % per_group) / gsize) * BN;
  const int T = (K + kBK - 1) / kBK;

  // one thread issues both TMA tiles of k tile t into its stage
  auto issue = [&](int t) {
    const int s = t % STAGES, k0 = t * kBK;
    mbar_expect_tx(landed(s), a_rows * kBK + B_BYTES);
    tma_load_2d(a_s + s * A_BYTES, &map_a, k0, m0, landed(s));
    tma_load_3d(raw_s + s * B_BYTES, &map_b, n0, k0 / 16, 0, landed(s));
  };

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(landed(s), 1);
      mbar_init(full(s), 32 * kTransposers);
      mbar_init(empty(s), 32 * NCW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 32 * NCW) {
    const int p = tid - 32 * NCW, lane = p & 31, warp = p >> 5;
    if (!kConsumerLoads && warp == 0) {
      // ---- loader warp ----
      if (lane == 0) {
        for (int t = 0; t < T; ++t) {
          if (t >= STAGES)
            mbar_wait(empty(t % STAGES), (t / STAGES - 1) & 1);
          issue(t);
        }
      }
    } else {
      // ---- transposer warps: raw (128 k x BN n) -> K-major operand. A
      // unit is 16 k (kg) x 4 n (ng); a quarter-warp takes the 8 kg of one
      // ng, so its 16-byte stores fill one 128-byte row.
      for (int t = 0; t < T; ++t) {
        const int s = t % STAGES;
        mbar_wait(landed(s), (t / STAGES) & 1);
        const uint8_t* raw = raw_p + s * B_BYTES;
        uint8_t* bop = b_p + s * B_BYTES;
#pragma unroll
        for (int wu = warp - (4 - kTransposers); wu < BN / 16;
             wu += kTransposers) {
          const int kg = lane & 7, ng = wu * 4 + (lane >> 3);
          uint32_t w[16];
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int kr = kg * 16 + i;
            w[i] = *reinterpret_cast<const uint32_t*>(
                raw + raw_offset<BN>(kr, 4 * ng));
          }
          uint32_t o[4][4];                          // [column j][k word]
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const uint32_t wq[4] = {w[4 * q], w[4 * q + 1], w[4 * q + 2],
                                    w[4 * q + 3]};
            uint32_t oq[4];
            transpose4x4(wq, oq);
#pragma unroll
            for (int j = 0; j < 4; ++j) o[j][q] = oq[j];
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = ng * 4 + j;
            *reinterpret_cast<uint4*>(bop + sw128_offset(n, kg)) =
                make_uint4(o[j][0], o[j][1], o[j][2], o[j][3]);
          }
        }
        mbar_arrive(full(s));
      }
    }
  } else {
    // ---- consumer warps: ldmatrix + mma.sync over the stage, k from 0
    // upwards in 32-byte steps, all of K chained in the f32 accumulators
    const int lane = tid & 31, warp = tid >> 5;
    const int wm = warp / C::CN, wn = warp % C::CN;
    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    // ldmatrix row addresses: lanes 8i..8i+7 name the 8 rows of matrix i.
    // A (16 rows x 32 k bytes): matrices (rows 0-7 | 8-15) x (k 0-15 |
    // 16-31) in the order of mma's a0..a3. B (n rows, K-major): matrices
    // (k 0-15 | 16-31) of n 0-7, then of n 8-15: b0, b1 of two n8 tiles.
    const int a_row = (wm * MT) * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int a_chunk = lane >> 4;
    const int b_row = (wn * NT) * 8 + (lane & 7) + (lane >> 4) * 8;
    const int b_chunk = (lane >> 3) & 1;
    if (kConsumerLoads && tid == 0)
      for (int t = 0; t < min(T, STAGES); ++t) issue(t);
    for (int t = 0; t < T; ++t) {
      const int s = t % STAGES;
      mbar_wait(full(s), (t / STAGES) & 1);
      const uint32_t a_st = a_s + s * A_BYTES, b_st = b_s + s * B_BYTES;
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk) {
        uint32_t a[MT][4], b[NT][2];
#pragma unroll
        for (int i = 0; i < MT; ++i)
          ldsm_x4(a[i], a_st + sw128_offset(a_row + 16 * i, 2 * kk + a_chunk));
        if constexpr (NT == 1) {
          ldsm_x2(b[0], b_st + sw128_offset(b_row, 2 * kk + b_chunk));
        } else {
#pragma unroll
          for (int j = 0; j < NT; j += 2) {
            uint32_t r[4];
            ldsm_x4(r, b_st + sw128_offset(b_row + 8 * j, 2 * kk + b_chunk));
            b[j][0] = r[0];
            b[j][1] = r[1];
            b[j + 1][0] = r[2];
            b[j + 1][1] = r[3];
          }
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_e4m3(acc[i][j], a[i], b[j]);
      }
      mbar_arrive(empty(s));
      if (kConsumerLoads && tid == 0 && t + STAGES < T) {
        mbar_wait(empty(s), (t / STAGES) & 1);
        issue(t + STAGES);
      }
      __syncwarp();
    }
    // epilogue: lane l holds rows l/4 (+8) and columns 2(l%4) (+1) of each
    // 16 x 8 tile; one scale a fragment row
    float deq = 0.f;
    if constexpr (std::is_same<E, AmaxScale>::value) deq = scale[0] / 448.f;
    const int g = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + (wm * MT + i) * 16 + g + 8 * h;
        if (m >= M) continue;
        float s = deq;
        if constexpr (std::is_same<E, RowScale>::value)
          s = scale[(size_t)m * scale_stride];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = n0 + (wn * NT + j) * 8 + 2 * tq;
          if (n < N)
            *reinterpret_cast<float2*>(out + (size_t)m * N + n) =
                make_float2(acc[i][j][2 * h] * s * 0.00390625f,
                            acc[i][j][2 * h + 1] * s * 0.00390625f);
        }
      }
  }
}

// One launch of the body on (M,K) codes at xq (16-byte aligned, K % 16
// == 0) against upper: two tensor maps, the dynamic shared memory
// attribute (set once for each instance), the grid.
template <class C, class E>
cudaError_t launch_mma(const uint8_t* xq, const uint8_t* up,
                       const float* scale, int scale_stride, float* out,
                       int M, int N, int K, cudaStream_t s) {
  constexpr int BM = C::BM, BN = C::BN;
  auto encode = encode_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  // A: the (M,K) codes, boxes of BM rows x 128 bytes in the 128-byte
  // swizzle that ldmatrix reads. When M < BM the box covers
  // only the rows there are (rounded up to 8; TMA fills the rows past M
  // with zeros and reads none of them); the shared rows past the box hold
  // stale bytes, which reach only output rows that are not stored, and
  // TMA does not spend its time writing zeros there.
  CUtensorMap map_a, map_b;
  const int a_rows = M < BM ? (M + 7) / 8 * 8 : BM;
  if (!nfp::encode_2d(&map_a, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, xq, M, K,
                      a_rows, kBK, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  // B: upper (K,N) seen as (n, kg, i) with k = 16 kg + i, boxes of
  // BN x 8 x 16: 128 k rows, stored in the order raw_offset expects
  const cuuint64_t b_dim[3] = {(cuuint64_t)N, (cuuint64_t)(K / 16), 16};
  const cuuint64_t b_stride[2] = {(cuuint64_t)N * 16, (cuuint64_t)N};
  const cuuint32_t b_box[3] = {BN, 8, 16}, one[3] = {1, 1, 1};
  const CUresult r = encode(&map_b, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
                            const_cast<uint8_t*>(up), b_dim, b_stride, b_box,
                            one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            BN == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                      : CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  auto kern = mma_kernel<C, E>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (attr != cudaSuccess) return attr;
  const int blocks = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  kern<<<blocks, C::kThreads, C::kSmem, s>>>(map_a, map_b, scale,
                                             scale_stride, out, M, N, K,
                                             a_rows);
  return cudaGetLastError();
}

// the tile configurations, by M alone (each is the fastest of those
// timed at its M, PERF.md §6): 4 consumer warps of 16 x 8 (M <= 16),
// 4 of 16 x 32 (M <= 64), 8 of 16 x 32 (M <= 256; narrow N tiles so that
// N = 1024 still gives 64 blocks), 8 of 64 x 32 (prefill). Rows past M
// are loaded by no one and stored by no one.
using Decode16 = Cfg<1, 1, 1, 4, 16>;
using Decode64 = Cfg<1, 4, 4, 1, 12>;
using Mid = Cfg<1, 4, 8, 1, 8>;
using Prefill = Cfg<4, 4, 2, 4, 4>;

template <class F>
auto by_m(int M, F f) {
  if (M <= 16) return f(Decode16{});
  if (M <= 64) return f(Decode64{});
  if (M <= 256) return f(Mid{});
  return f(Prefill{});
}

// K2's choice: by_m, except that at M <= 16 an N wider than one wave of
// Decode16's 32-column blocks on 132 SMs takes DecodeWide, 4 consumer
// warps of 16 x 32 with BN = 128 (6 stages): at decode a block's time is
// its walk over K, whatever its BN, so one wave of wider blocks beats
// several waves of narrow ones (N = 14336: 112 blocks, not 448). The k
// order is the same in every config, so the choice moves no result.
using DecodeWide = Cfg<1, 4, 1, 4, 6>;

template <class F>
auto by_m_n(int M, int N, F f) {
  if (M <= 16 && N > 32 * 132) return f(DecodeWide{});
  return by_m(M, f);
}

// the shape rule on N, K and upper: TMA needs 16-byte row strides and
// base addresses
inline bool mma_body(int N, int K, const void* upper) {
  return K % 16 == 0 && N % 16 == 0 && nfp::aligned(upper, 16);
}

}  // namespace nfp_f8
