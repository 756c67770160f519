// The TMA + wgmma GEMM body of K1 (nestedfp16_matmul.cu) and K3
// (f16_matmul.cu) for Hopper (sm_90a): out (M,N) f32 = x (M,K) f16 @ W,
// with W (K,N) N-contiguous as the JAX package stores it: rebuilt from the
// NestedFP byte planes `upper` and `lower` (K1) or read as f16 (K3).
//
// Operands are swapped: each consumer warpgroup computes out^T for 64
// weight columns n (wgmma's A side, 64 rows) against BMX rows of x
// (wgmma's N side, 8..256), so decode M = 8 runs m64n8k16 with no padded
// rows. Both operands come from 128B-swizzled shared memory:
//  * x: a TMA box of BMX rows x 64 k lands K-major, as wgmma's B wants it
//    (no transpose: x (M,K) is row-major).
//  * W: MN-major (wgmma's transpose bit for A): each k row holds 64
//    n-contiguous f16, the planes' own order, so nothing is transposed.
//    K3 loads it by TMA straight into that layout; in K1 the producer
//    warps rebuild it in place from raw TMA boxes of the two planes, four
//    weights per 32-bit word (nested4_to_f16x4).
//
// Warp specialisation over a ring of STAGES stages (KS k tiles of 64
// each) in dynamic shared memory. The last warp is the loader: one thread
// issues each stage's TMA boxes and completes them on landed[s]. In K1
// the raw plane boxes land in the 8 KB blocks where the f16 operand goes,
// and rebuild groups (a warpgroup, three warps at prefill) each own every
// G-th stage, rebuild its blocks in place and arrive on full[s]. The
// consumer warpgroups wait for both, chain four wgmma k16 steps a tile
// into f32 accumulators (one wgmma group in flight) and release the stage
// on empty[s].
//
// Pace (PERF.md §6, H100 at 700 W): at M = 8192 the consumers' wgmma and
// the rebuild together, K1 ~1.4x torch.matmul and ~1.3x K3 (which is
// within ~10% of torch.matmul); at M = 8 the per-stage round trip of one
// block an SM (a deeper ring, more rebuild warps and fewer integer
// operations a weight each moved it by less than the spread), K1 ~1.15x
// torch.matmul.
//
// Batch invariance: every tile config runs k = 0 upwards in 16-wide
// steps chained in f32, with no split-K, so a row's result does not
// depend on M (tests/test_torch_gpu.py checks it bitwise across configs).
//
// The shape rule (wg_body): TMA needs 16-byte aligned bases and row
// strides, so N % 16 == 0, K % 8 == 0 and 16-byte aligned x and weights;
// ragged M, N and K are then zero-filled by TMA and masked at the stores.
// Any other shape takes gemm_tile.cuh's body.
#pragma once

#include <cuda_fp16.h>

#include "gemm_tile.cuh"
#include "tma.cuh"

namespace nfp_wg {

using nfp::mbar_arrive;
using nfp::mbar_expect_tx;
using nfp::mbar_init;
using nfp::mbar_wait;
using nfp::tma_load_2d;

constexpr int kBK = 64;          // k of a tile: 64 f16, one 128-byte row of x
constexpr int kWBlock = 64 * kBK * 2;   // one warpgroup's W tile, bytes
constexpr int kGroupM = 8;       // row tiles walked together (L2 reuse)

// A tile configuration: BMX rows of x (the wgmma N), CW consumer
// warpgroups of 64 weight columns each, STAGES stages in flight, and in
// K1 G rebuild groups of RT threads (G divides STAGES: group g owns
// stages g, g + G, ...).
template <int BMX_, int CW_, int STAGES_, bool NESTED_, int G_, int RT_,
          int KS_ = 1>
struct Cfg {
  static constexpr int BMX = BMX_, CW = CW_, STAGES = STAGES_, G = G_;
  static constexpr int RT = RT_, KS = KS_;   // KS k tiles of 64 a stage
  static constexpr bool NESTED = NESTED_;
  static constexpr int BNW = 64 * CW;
  static constexpr int X_SUB = BMX * kBK * 2;    // one k tile of x
  static constexpr int X_BYTES = KS * X_SUB;
  static constexpr int W_BYTES = KS * BNW * kBK * 2;
  static constexpr int kThreads = 128 * CW + G * RT + 32;  // + the loader
  // three barriers a stage; 1024 bytes of slack to align the swizzle atoms
  static constexpr int kSmem =
      STAGES * (X_BYTES + W_BYTES) + 3 * STAGES * 8 + 1024;
  static_assert(BMX % 8 == 0 && BMX <= 256, "wgmma N");
  static_assert(NESTED ? G >= 1 && STAGES % G == 0 : G == 0, "rebuilders");
  static_assert(RT % 32 == 0 && G <= 4, "whole warps, named barriers 1-4");
};

// wgmma.mma_async m64nNk16, f32 += f16 * f16, A (the weights) MN-major
// and B (the rows of x) K-major, both from shared memory by descriptor
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void run(float (&d)[4], uint64_t a,
                                             uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.f16.f16 {"
      "%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t a,
                                             uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a,
                                             uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a,
                                             uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void run(float (&d)[128], uint64_t a,
                                             uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
  }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads across a wgmma wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// bar.sync on named barrier 1 + id (id < 4) for n threads, the id spelt
// out so that ptxas reserves only the barriers in use
template <int n>
__device__ __forceinline__ void named_sync(int id) {
  switch (id) {
    case 0: asm volatile("bar.sync 1, %0;\n" ::"n"(n) : "memory"); break;
    case 1: asm volatile("bar.sync 2, %0;\n" ::"n"(n) : "memory"); break;
    case 2: asm volatile("bar.sync 3, %0;\n" ::"n"(n) : "memory"); break;
    default: asm volatile("bar.sync 4, %0;\n" ::"n"(n) : "memory"); break;
  }
}

// Shared-memory matrix descriptor of a 128B-swizzled operand: start
// address, leading and stride byte offsets (16-byte units). K-major B:
// SBO = 1024 (8 rows of 128 bytes), LBO unused. MN-major A: SBO = 1024
// (from one 8-k group to the next), LBO = the next 64-column block.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFFu) |
         ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | (1ull << 62);
}

// NestedFP reconstruction of four weights at once, bit-exact with
// nfp::nested_f16_bits (and nestedfp.decode) for every byte pair: u and l
// hold four upper and four lower bytes; returns their four f16 (lo, hi
// words). Per byte, corrected = (u & 0x7F) - (l >> 7) is taken as an 8-bit
// two's complement (a guard bit stops the borrow at the byte), halved by
// an arithmetic shift, and ORed with u's sign; two byte permutes then
// interleave lower (low byte) and the result (high byte).
__device__ __forceinline__ uint2 nested4_to_f16x4(uint32_t u, uint32_t l) {
  const uint32_t c = (l >> 7) & 0x01010101u;
  const uint32_t e = ((u | 0x80808080u) - c) ^ 0x80808080u;
  const uint32_t h = (u & 0x80808080u) | (e & 0x80808080u) |
                     ((e >> 1) & 0x7F7F7F7Fu);
  return make_uint2(__byte_perm(l, h, 0x5140), __byte_perm(l, h, 0x7362));
}

template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
wg_kernel(const __grid_constant__ CUtensorMap map_x,
          const __grid_constant__ CUtensorMap map_w0,
          const __grid_constant__ CUtensorMap map_w1,
          float* __restrict__ out, int M, int N, int K) {
  constexpr int BMX = C::BMX, BNW = C::BNW, STAGES = C::STAGES;
  constexpr int X_BYTES = C::X_BYTES, W_BYTES = C::W_BYTES;
  constexpr int NCT = 128 * C::CW;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base0 = nfp::smem_u32(smem_raw);
  const uint32_t base = (base0 + 1023u) & ~1023u;
  uint8_t* sbase = smem_raw + (base - base0);
  const uint32_t x_s = base, w_s = x_s + STAGES * X_BYTES,
                 bars = w_s + STAGES * W_BYTES;
  // landed[s]: the stage's TMA boxes have arrived (1 arrival + bytes);
  // full[s] (K1): W rebuilt (one arrival a thread of its rebuild group);
  // empty[s]:
  // every consumer thread is done with stage s
  auto landed = [&](int s) { return bars + 8 * s; };
  auto full = [&](int s) { return bars + 8 * (STAGES + s); };
  auto empty = [&](int s) { return bars + 8 * (2 * STAGES + s); };

  // tile of this block: groups of kGroupM row tiles, rows fastest
  const int num_m = (M + BMX - 1) / BMX, num_n = (N + BNW - 1) / BNW;
  const int bid = blockIdx.x, per_group = kGroupM * num_n;
  const int first_m = (bid / per_group) * kGroupM;
  const int gsize = min(num_m - first_m, kGroupM);
  const int m0 = (first_m + (bid % per_group) % gsize) * BMX;
  const int n0 = ((bid % per_group) / gsize) * BNW;
  constexpr int KS = C::KS, BLOCKS = KS * C::CW;   // 8 KB W blocks a stage
  const int T = (K + KS * kBK - 1) / (KS * kBK);

  // one thread issues the TMA boxes of k tile t into its stage
  auto issue = [&](int t) {
    const int s = t % STAGES, k0 = t * KS * kBK;
    mbar_expect_tx(landed(s), X_BYTES + W_BYTES);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int k = k0 + ks * kBK;
      tma_load_2d(x_s + s * X_BYTES + ks * C::X_SUB, &map_x, k, m0,
                  landed(s));
#pragma unroll
      for (int g = 0; g < C::CW; ++g) {
        // K3: the f16 block, swizzled as wgmma reads it; K1: the raw upper
        // and lower boxes (64 k x 64 bytes each) that it is rebuilt from,
        // in the same 8 KB
        const uint32_t blk = w_s + s * W_BYTES + (ks * C::CW + g) * kWBlock;
        tma_load_2d(blk, &map_w0, n0 + 64 * g, k, landed(s));
        if constexpr (C::NESTED)
          tma_load_2d(blk + kWBlock / 2, &map_w1, n0 + 64 * g, k, landed(s));
      }
    }
  };

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(landed(s), 1);
      mbar_init(full(s), C::RT);
      mbar_init(empty(s), NCT);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= NCT) {
    const int p = tid - NCT;
    if (p >= C::G * C::RT) {
      // ---- loader warp: lane 0 keeps the ring full, refilling a stage
      // as soon as the consumers release it
      if (p == C::G * C::RT)
        for (int t = 0; t < T; ++t) {
          if (t >= STAGES)
            mbar_wait(empty(t % STAGES), (t / STAGES - 1) & 1);
          issue(t);
        }
    } else if constexpr (C::NESTED) {
      // ---- K1's rebuild groups, in place: each 8 KB block arrives as
      // the raw upper (64 k x 64 bytes) and lower boxes and leaves as the
      // f16 operand. The RT threads of a group load the block whole (its
      // 512 units of 8 columns of one k row, 4-6 a thread), meet at a
      // named barrier, then write it back rebuilt; a quarter-warp's stores
      // fill one 128-byte operand row. Group g owns stages g, g + G, ...:
      // it rebuilds tiles g, g + G, ... in order, so its waits on landed[]
      // stay in phase order (a stage's next fill needs its arrival first).
      constexpr int RT = C::RT, BLOCK_UNITS = kBK * 64 / 8;
      constexpr int UNITS = (BLOCK_UNITS + RT - 1) / RT;
      const int grp = p / RT, pt = p % RT;
      for (int t = grp; t < T; t += C::G) {
        const int s = t % STAGES;
        mbar_wait(landed(s), (t / STAGES) & 1);
#pragma unroll
        for (int b = 0; b < BLOCKS; ++b) {
          uint8_t* blk = sbase + (w_s - base) + s * W_BYTES + b * kWBlock;
          uint2 u[UNITS], l[UNITS];
#pragma unroll
          for (int q = 0; q < UNITS; ++q) {
            const int at = (pt + RT * q) * 8;       // row (i / 8), col 8 (i % 8)
            if (at < BLOCK_UNITS * 8) {
              u[q] = *reinterpret_cast<const uint2*>(blk + at);
              l[q] = *reinterpret_cast<const uint2*>(blk + kWBlock / 2 + at);
            }
          }
          named_sync<RT>(grp);
#pragma unroll
          for (int q = 0; q < UNITS; ++q) {
            const int i = pt + RT * q;
            if (i >= BLOCK_UNITS) break;
            const uint2 a = nested4_to_f16x4(u[q].x, l[q].x);
            const uint2 b = nested4_to_f16x4(u[q].y, l[q].y);
            *reinterpret_cast<uint4*>(blk + nfp::sw128_offset(i / 8, i % 8)) =
                make_uint4(a.x, a.y, b.x, b.y);
          }
        }
        // the generic-proxy stores, made visible to wgmma's async proxy
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(full(s));
      }
    }
  } else {
    // ---- consumer warpgroups: wgmma over the stage, k from 0 upwards
    const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
    float acc[BMX / 2];
#pragma unroll
    for (int i = 0; i < BMX / 2; ++i) acc[i] = 0.f;
    for (int t = 0; t < T; ++t) {
      const int s = t % STAGES;
      mbar_wait(landed(s), (t / STAGES) & 1);
      if constexpr (C::NESTED) mbar_wait(full(s), (t / STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint32_t xa = x_s + s * X_BYTES + ks * C::X_SUB;
        const uint32_t wa = w_s + s * W_BYTES + (ks * C::CW + wg) * kWBlock;
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          Wgmma<BMX>::run(acc, sw128_desc(wa + kk * 2048, kWBlock, 1024),
                          sw128_desc(xa + kk * 32, 16, 1024));
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (t > 0) mbar_arrive(empty((t - 1) % STAGES));
    }
    wgmma_wait<0>();
    fence_regs(acc);
    // epilogue: warp w holds weight columns 16w + lane/4 (+8), x rows
    // 8j + 2(lane % 4) (+1) of each 8-row group j
    const int n = n0 + 64 * wg + 16 * warp + (lane >> 2);
    const int m = m0 + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < BMX / 2; ++j) {
      const int nj = n + 8 * ((j >> 1) & 1), mj = m + 8 * (j >> 2) + (j & 1);
      if (mj < M && nj < N) out[(size_t)mj * N + nj] = acc[j];
    }
  }
}

template <class C>
cudaError_t launch(const void* x, const void* w0, const void* w1, float* out,
                   int M, int N, int K, cudaStream_t s) {
  CUtensorMap mx, m0, m1;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  bool ok = nfp::encode_2d(&mx, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 2, x, M, K,
                           C::BMX, kBK, sw);
  if constexpr (C::NESTED) {
    // the planes as stored: boxes of 64 k rows x 64 bytes, unswizzled
    ok = ok && nfp::encode_2d(&m0, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w0, K,
                              N, kBK, 64, CU_TENSOR_MAP_SWIZZLE_NONE);
    ok = ok && nfp::encode_2d(&m1, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w1, K,
                              N, kBK, 64, CU_TENSOR_MAP_SWIZZLE_NONE);
  } else {
    // f16 W: boxes of 64 k rows x 64 columns, swizzled as wgmma reads them
    ok = ok && nfp::encode_2d(&m0, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 2, w0, K,
                              N, kBK, 64, sw);
    m1 = m0;
  }
  if (!ok) return cudaErrorInvalidValue;
  auto kern = wg_kernel<C>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (attr != cudaSuccess) return attr;
  const int blocks = ((M + C::BMX - 1) / C::BMX) * ((N + C::BNW - 1) / C::BNW);
  kern<<<blocks, C::kThreads, C::kSmem, s>>>(mx, m0, m1, out, M, N, K);
  return cudaGetLastError();
}

// the tile configurations, by M alone: the fewest rows of x that cover M
// up to 64 (one warpgroup of 64 weight columns, so that N = 4096 gives
// 64 blocks), 128 rows up to M = 512, and two warpgroups x 256 rows for
// prefill; ~195 KB of stages from M = 33 on. At M <= 8 a stage holds two
// k tiles (128 k), which halves the per-stage barrier and TMA round trips
// that set the pace there (8 stages of 18 KB; deeper rings, 3 k tiles a
// stage or more rebuild warps measured no faster, PERF.md §6). K1 and K3
// share them; K1 adds two rebuild warpgroups, and at prefill one group of
// three warps, so that the block stays at 384 threads (more would cap the
// consumers' registers at 128, below what their 128 accumulators need).
template <bool NESTED, class F>
auto by_m(int M, F f) {
  constexpr int G = NESTED ? 2 : 0;
  if (M <= 8) return f(Cfg<8, 1, 8, NESTED, G, 128, 2>{});
  if (M <= 32) return f(Cfg<32, 1, 8, NESTED, G, 128>{});
  if (M <= 64) return f(Cfg<64, 1, 12, NESTED, G, 128>{});
  if (M <= 512) return f(Cfg<128, 1, 8, NESTED, G, 128>{});
  return f(Cfg<256, 2, 4, NESTED, G / 2, 96>{});
}

// the shape rule: TMA needs 16-byte aligned bases and row strides
inline bool wg_body(int N, int K, const void* x, const void* w0,
                    const void* w1) {
  return N % 16 == 0 && K % 8 == 0 && nfp::aligned(x, 16) &&
         nfp::aligned(w0, 16) && (w1 == nullptr || nfp::aligned(w1, 16));
}

// out = x @ W on the wgmma body when the shape rule holds, else on
// gemm_tile.cuh's body; w1 (lower) is null for K3
template <bool NESTED>
int run(const void* x, const void* w0, const void* w1, float* out, int M,
        int N, int K, cudaStream_t s) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaGetLastError();
  constexpr nfp::Op kOp = NESTED ? nfp::Op::kNested16 : nfp::Op::kF16;
  if (!wg_body(N, K, x, w0, w1))
    return nfp::launch_gemm<kOp>(x, w0, w1, nullptr, 0, out, M, N, K, s);
  return (int)by_m<NESTED>(M, [&](auto c) {
    return launch<decltype(c)>(x, w0, w1, out, M, N, K, s);
  });
}

// dynamic shared memory (bytes) of the body that run() picks: 0 for
// gemm_tile.cuh's, whose tiles are static
template <bool NESTED>
int smem(const void* x, const void* w0, const void* w1, int M, int N, int K) {
  if (!wg_body(N, K, x, w0, w1)) return 0;
  return by_m<NESTED>(M, [](auto c) { return decltype(c)::kSmem; });
}

}  // namespace nfp_wg
