// Shared body of the two single-query decode attention kernels of the port
// over byte-planar ("NestedKV") K/V: K4 paged_planar_decode_attention
// (keys found through a block table) and K5 planar_decode_attention (keys
// dense per batch row). Only the addressing of a key differs; it comes in
// as a functor that maps a key's logical position to its row in the planes.
//
// Math, as the TPU kernels: q scaled by D^-0.5 in f32; keys at kpos < len,
// and with a window w > 0 at kpos > len-1-w; online softmax with
// NEG_INF = -1e30; out = acc / max(l, 1e-30). FP16 mode joins hi|lo into
// the exact f16 values; FP8 mode reads only the hi planes, as e5m2.
//
// What bounds it on an H100: the KV bytes of the kept keys, sum(kept) *
// Hkv * D * 2 (K and V) * (2 B in FP16 mode, 1 B in FP8) over 3.35 TB/s.
// The products are 2 (FP16) or 4 (FP8) multiply-adds a byte, and each
// byte also needs unpacking.
//
// Design:
//  - Split over the keys. A row's keys are cut on a fixed grid of S keys
//    (split_keys: 512 for K5, 512 rounded down to whole table blocks for
//    K4), and one block of 4 warps takes one split of one (batch row, kv
//    head, group of up to 8 query heads). The grid, (splits, Hkv * head
//    groups, B), comes from the shapes alone: no host read of `lens`, so
//    the launch can be captured in a CUDA graph. A block whose split
//    holds no kept key exits at once. S does not depend on B, on the other
//    rows or on the card, so a row's bits do not depend on its batch.
//    512 rather than 256: it halves the blocks' fixed costs and the
//    scratch, which a probe on the card showed faster at lens <= 32768 in
//    both modes and about even at lens <= 1056; a ring of 3 stages was
//    no faster than 2.
//  - Inside a split the kept keys go to the warps in steps of 16, step j
//    to warp j % 4; every step a warp takes starts on a kept key, so no
//    warp ever sees a step of masked keys only (its max would stay at
//    NEG_INF and its masked keys would weigh e^0 = 1). Each warp streams
//    its steps through its own cp.async ring of plane bytes in shared
//    memory (rows padded by 16 bytes, so ldmatrix reads hit distinct
//    banks), zero-filled past the kept keys, with no block barrier in the
//    loop: the next step's loads overlap this step's products.
//  - The products run on the tensor cores (mma.sync m16n8k16, f16 in,
//    f32 sums), fed by ldmatrix straight from the plane bytes: one byte
//    permute joins a word of hi bytes and a word of lo bytes into two f16
//    (in FP8 mode, hi bytes and zeros: e5m2 is the top byte of an f16),
//    with no conversion to f32. As f32 FMAs the same work is about 44
//    instructions a key and kv head for G = 4, D = 128 (32 FMAs, 8
//    conversions, 4 permutes), against ~70 that FP8's byte rate leaves on
//    132 SMs; on the tensor cores it is 2 mma a key. To keep the f32
//    plain version's accuracy, both A operands are split in two f16
//    terms, as K6 does for P: q * 2^e (e puts max|q| just below 2^14) as
//    hi + lo in rows g and g + 8 of the m16 tile, and p * 2^12 likewise,
//    so q and p are carried to ~2^-22 and no lo term goes subnormal; the
//    powers of two come off exactly. QK^T's k slots follow ldmatrix's
//    byte order (slot 2t+e is d = 4t+e, slot 2t+8+e is d = 4t+2+e), which
//    q's fragments repeat; PV's n columns are the even and the odd d of
//    each 16, so a thread ends with 4 adjacent outputs. exp runs as exp2
//    on log2(e)-scaled scores, as in K6.
//  - Head dims 64, 80 (zamba2-2.7b's shared attention), 96 (phi-3-vision),
//    128 and 256 (gemma3-1b); each C entry lists the ones it instantiates.
//    The planes keep D unpadded (rows of 80 or 96 bytes, 16-byte aligned);
//    in shared memory a key row is padded to DP, D rounded up to 32 (the
//    32 bytes of an ldmatrix x4 slice), and the pad bytes are zero-filled
//    by cp.async from no source, as are q's pad lanes, so their products
//    are 0 and the pad columns of PV are never written out. The softmax
//    scale is the caller's D^-0.5 of the real D. At D = 256 a thread's PV
//    accumulator alone is 128 f32 registers, so q's A fragments (64
//    words a thread at D = 256) are not kept in registers: warp 0 writes
//    them once to shared memory (8 KB after the warps' rings, the same
//    for every warp) and each step loads the two it needs per k32 slice.
//    Values and order of the products are those of the register path.
//  - The warps' states merge in warp order in shared memory, then either
//    straight into `out` (one split a row: Cap or MB*BS within S) or into
//    an f32 scratch (m, l, acc per split) that combine_kernel merges in
//    split order: M = max m_s, out = sum e^(m_s-M) acc_s / max(sum
//    e^(m_s-M) l_s, 1e-30). No atomics; a single split gives the same bits
//    either way (e^0 = 1).
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nfp_decode {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStepKeys = 16;     // keys a warp takes a step: PV's k16
constexpr int kSplitKeys = 512;   // keys a block: 32 steps, 8 a warp
constexpr int kRows = 8;          // query heads a block: m16 rows g, g + 8
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kPScale = 4096.f;        // p * 2^12 before its split
constexpr float kPUnscale = 1.f / 4096.f;

template <int D, bool FP8>
struct Layout {
  static_assert(D % 16 == 0 && D <= 256, "D is a multiple of 16, <= 256");
  static constexpr int kDP = (D + 31) / 32 * 32;  // D padded in shared memory
  static constexpr int kKB = kDP / 16;            // k16 blocks of QK^T
  static constexpr bool kQSmem = kDP > 128;       // q fragments in smem
  static constexpr int kQBytes = kQSmem ? kKB * 32 * 16 : 0;
  static constexpr int kStages = 2;               // ring depth of a warp
  static constexpr int kLd = kDP + 16;            // padded key row, bytes
  static constexpr int kPlanes = FP8 ? 2 : 4;     // k_hi, v_hi[, k_lo, v_lo]
  static constexpr int kPlaneBytes = kStepKeys * kLd;
  static constexpr int kStageBytes = kPlanes * kPlaneBytes;
  static constexpr int kRingBytes = kStages * kStageBytes;
  // a warp's state for the merge: acc [kRows][DP], m [kRows], l [kRows]
  static constexpr int kMergeBytes = 4 * (kRows * kDP + 2 * kRows);
  static constexpr int kWarpBytes =
      kRingBytes > kMergeBytes ? kRingBytes : kMergeBytes;
  static constexpr int kSmemBytes = kWarps * kWarpBytes + kQBytes;
};

// dynamic shared memory of the body for head dim D among the instances
// Ds, or 0 when D is not one of them
template <int... Ds>
inline int smem_bytes(int D, bool fp8) {
  int r = 0;
  ((r = D == Ds ? (fp8 ? Layout<Ds, true>::kSmemBytes
                       : Layout<Ds, false>::kSmemBytes) : r), ...);
  return r;
}

// the launch function Launch<D, FP8>::run of head dim D among the
// instances Ds, or nullptr
template <template <int, bool> class Launch, int... Ds>
inline auto pick(int D, bool fp8) -> decltype(&Launch<64, true>::run) {
  decltype(&Launch<64, true>::run) fn = nullptr;
  ((fn = D == Ds ? (fp8 ? &Launch<Ds, true>::run : &Launch<Ds, false>::run)
                 : fn), ...);
  return fn;
}

// keys a split holds: kSplitKeys, rounded down to whole table blocks of
// `block` keys (at least one); dense rows pass block = 1
inline int split_keys(int block) {
  return block >= kSplitKeys ? block : (kSplitKeys / block) * block;
}

// kept keys of a row: [*lo, *hi), empty when *hi <= *lo
__device__ __forceinline__ void kept_keys(int len, int window, int limit,
                                          int* lo, int* hi) {
  *hi = min(len, limit);
  *lo = (window > 0 && len - window > 0) ? len - window : 0;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (src is not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col), f16 in, f32 accumulators
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) -> the f16 pair rn(x), rn(y), x low; *lo gets rn(x - rn(x)),
// rn(y - rn(y))
__device__ __forceinline__ uint32_t split2(float x, float y, uint32_t* lo) {
  const __half2 hi = __floats2half2_rn(x, y);
  const float2 h = __half22float2(hi);
  const __half2 rest = __floats2half2_rn(x - h.x, y - h.y);
  *lo = *reinterpret_cast<const uint32_t*>(&rest);
  return *reinterpret_cast<const uint32_t*>(&hi);
}

// K fragment from a non-transposed ldmatrix word: hi/lo hold the bytes of
// d = 4t .. 4t+3 of one key; b0 gets f16 of d 4t, 4t+1, b1 of 4t+2, 4t+3
template <bool FP8>
__device__ __forceinline__ void join_k(uint32_t hi, uint32_t lo, uint32_t* b0,
                                       uint32_t* b1) {
  if (FP8) {
    *b0 = __byte_perm(hi, 0u, 0x1404);
    *b1 = __byte_perm(hi, 0u, 0x3424);
  } else {
    *b0 = __byte_perm(lo, hi, 0x5140);
    *b1 = __byte_perm(lo, hi, 0x7362);
  }
}

// V fragment from a transposed ldmatrix word: hi/lo hold the bytes of
// (key 2t, d 2u), (2t, 2u+1), (2t+1, 2u), (2t+1, 2u+1); *even gets f16 of
// keys 2t, 2t+1 at d 2u, *odd at d 2u+1
template <bool FP8>
__device__ __forceinline__ void join_v(uint32_t hi, uint32_t lo,
                                       uint32_t* even, uint32_t* odd) {
  if (FP8) {
    *even = __byte_perm(hi, 0u, 0x2404);
    *odd = __byte_perm(hi, 0u, 0x3414);
  } else {
    *even = __byte_perm(lo, hi, 0x6240);
    *odd = __byte_perm(lo, hi, 0x7351);
  }
}

// Paged pool (NB, BS, Hkv, D): key kpos is row table[kpos/BS]*BS + kpos%BS.
struct PagedRows {
  const int* table;
  int bs;
  __device__ size_t operator()(int kpos) const {
    return (size_t)table[kpos / bs] * bs + kpos % bs;
  }
};

// Dense per-slot planes (B, Cap, Hkv, D): key kpos of row b is b*Cap+kpos.
struct DenseRows {
  size_t row0;
  __device__ size_t operator()(int kpos) const { return row0 + kpos; }
};

// Where a block's result goes: straight to `out` rows (stride D), or to
// the split's scratch slots (acc stride ns*D, (m, l) stride ns*2).
struct Dest {
  float* acc;
  float* ml;          // nullptr: write out = acc / max(l, 1e-30) to acc
  size_t acc_stride, ml_stride;
};

// Zeros for the rows of a block with no kept key, when it writes `out`.
__device__ __forceinline__ void write_zeros(const Dest& dst, int n_rows,
                                            int D) {
  if (dst.ml) return;
  for (int i = threadIdx.x; i < n_rows * D; i += kThreads)
    dst.acc[(i / D) * dst.acc_stride + i % D] = 0.f;
}

// One block: query rows q[g*D + d], g < n_rows, of kv head h, over the
// kept keys [lo, hi) (lo < hi) of one split, keys addressed by `rows`.
template <int D, bool FP8, class Rows>
__device__ __forceinline__ void attend_split(
    const float* __restrict__ q, int n_rows, const uint8_t* __restrict__ k_hi,
    const uint8_t* __restrict__ k_lo, const uint8_t* __restrict__ v_hi,
    const uint8_t* __restrict__ v_lo, const Rows& rows, int Hkv, int h,
    int lo, int hi, float q_scale, const Dest& dst) {
  using L = Layout<D, FP8>;
  constexpr int DP = L::kDP;       // D padded to 32 in shared memory
  constexpr int KB = DP / 16;      // k16 blocks of QK^T, d16 blocks of PV
  constexpr int CH = DP / 16;      // 16-byte chunks of a padded key row
  constexpr int CHD = D / 16;      // the chunks that hold plane bytes
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  uint8_t* own = smem + warp * L::kWarpBytes;
  const uint32_t ring = smem_u32(own);

  // this warp's steps: j = warp, warp + 4, ... of the split's n_st
  const int n_st = (hi - lo + kStepKeys - 1) / kStepKeys;
  const int mine = n_st > warp ? (n_st - warp + kWarps - 1) / kWarps : 0;

  auto load = [&](int i) {
    if (i < mine) {
      const int k0 = lo + (warp + kWarps * i) * kStepKeys;
      const uint32_t st = ring + (i % L::kStages) * L::kStageBytes;
#pragma unroll
      for (int it = 0; it < kStepKeys * CH / 32; ++it) {
        const int c = lane + 32 * it, t = c / CH, ch = c % CH, kpos = k0 + t;
        const bool ok = kpos < hi && ch < CHD;   // pad chunks: zeros
        const size_t off = ok ? (rows(kpos) * Hkv + h) * D + ch * 16 : 0;
        const uint32_t at = st + t * L::kLd + ch * 16;
        cp_async16(at, k_hi + off, ok);
        cp_async16(at + L::kPlaneBytes, v_hi + off, ok);
        if (!FP8) {
          cp_async16(at + 2 * L::kPlaneBytes, k_lo + off, ok);
          cp_async16(at + 3 * L::kPlaneBytes, v_lo + off, ok);
        }
      }
    }
    cp_async_commit();
  };

  // the first steps' loads fly while q is set up
  for (int s = 0; s < L::kStages - 1; ++s) load(s);

  // q as the A operand of QK^T: rows grp (hi term) and grp + 8 (lo term),
  // k slots in ldmatrix's byte order, scaled by 2^e with max|q| < 2^14
  auto q_at = [&](int kb) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (grp < n_rows && 16 * kb < D)      // pad lanes past D stay 0
      v = *reinterpret_cast<const float4*>(q + grp * D + 16 * kb + 4 * tig);
    v.x *= q_scale;
    v.y *= q_scale;
    v.z *= q_scale;
    v.w *= q_scale;
    return v;
  };
  float4 qv[L::kQSmem ? 1 : KB];
  float amax = 0.f;
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) {
    const float4 v = q_at(kb);
    if constexpr (!L::kQSmem) qv[kb] = v;
    amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                             fmaxf(fabsf(v.z), fabsf(v.w))));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xFFFFFFFFu, amax, o));
  int ex = 0;
  frexpf(amax, &ex);
  const int e = amax > 0.f ? max(-100, min(100, 14 - ex)) : 0;
  const float up = ldexpf(1.f, e);
  const float down = ldexpf(1.f, -e) * kLog2e;   // back, and to log2 units
  uint32_t qa[L::kQSmem ? 1 : KB][4];
  uint4* qsm = reinterpret_cast<uint4*>(smem + kWarps * L::kWarpBytes);
  if constexpr (L::kQSmem) {
    if (warp == 0) {
#pragma unroll 4
      for (int kb = 0; kb < KB; ++kb) {
        const float4 v = q_at(kb);
        uint4 f;
        f.x = split2(v.x * up, v.y * up, &f.y);
        f.z = split2(v.z * up, v.w * up, &f.w);
        qsm[kb * 32 + lane] = f;
      }
    }
    __syncthreads();
  } else {
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      qa[kb][0] = split2(qv[kb].x * up, qv[kb].y * up, &qa[kb][1]);
      qa[kb][2] = split2(qv[kb].z * up, qv[kb].w * up, &qa[kb][3]);
    }
  }

  float m = kNegInf, l = 0.f;      // row grp, l summed over this thread's keys
  float acc[KB][2][4];             // [d16 block][even/odd d][mma C]
#pragma unroll
  for (int db = 0; db < KB; ++db)
#pragma unroll
    for (int par = 0; par < 2; ++par)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[db][par][r] = 0.f;
  // ldmatrix row of this lane: key (lane & 7) + 8 * bit 3, 16 bytes * bit 4
  const uint32_t a_off =
      ((lane & 7) + ((lane >> 3) & 1) * 8) * L::kLd + (lane >> 4) * 16;

  for (int i = 0; i < mine; ++i) {
    load(i + L::kStages - 1);
    cp_async_wait<L::kStages - 1>();
    __syncwarp();
    const uint32_t st = ring + (i % L::kStages) * L::kStageBytes + a_off;
    const int k0 = lo + (warp + kWarps * i) * kStepKeys;

    // scores: n-tile n holds keys k0 + 8n + 2 tig + {0, 1}
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kb = 0; kb < DP / 32; ++kb) {
      uint32_t kh[4], kl[4] = {0u, 0u, 0u, 0u};
      ldsm_x4(kh, st + kb * 32);
      if (!FP8) ldsm_x4(kl, st + 2 * L::kPlaneBytes + kb * 32);
#pragma unroll
      for (int half = 0; half < 2; ++half) {   // d 16*(2 kb + half)..
        uint32_t a[4];
        if constexpr (L::kQSmem) {
          const uint4 f = qsm[(2 * kb + half) * 32 + lane];
          a[0] = f.x;
          a[1] = f.y;
          a[2] = f.z;
          a[3] = f.w;
        } else {
#pragma unroll
          for (int r = 0; r < 4; ++r) a[r] = qa[2 * kb + half][r];
        }
#pragma unroll
        for (int n = 0; n < 2; ++n) {          // keys 8n..
          const int mt = 2 * half + n;
          uint32_t b0, b1;
          join_k<FP8>(kh[mt], kl[mt], &b0, &b1);
          mma16816(sc[n], a, b0, b1);
        }
      }
    }
    float p[4], mx = kNegInf;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int kpos = k0 + 8 * n + 2 * tig + e2;
        const float s2 = (sc[n][e2] + sc[n][2 + e2]) * down;
        p[2 * n + e2] = kpos < hi ? s2 : kNegInf;
        mx = fmaxf(mx, p[2 * n + e2]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float corr = exp2f(m - m_new);
    m = m_new;
    float psum = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      p[r] = exp2f(p[r] - m_new);
      psum += p[r];
    }
    l = l * corr + psum;
    // acc is 0 before the first step; later a max rarely moves
    if (i > 0 && __any_sync(0xFFFFFFFFu, corr != 1.f)) {
#pragma unroll
      for (int db = 0; db < KB; ++db)
#pragma unroll
        for (int par = 0; par < 2; ++par)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[db][par][r] *= corr;
    }
    uint32_t pa[4];
    pa[0] = split2(p[0] * kPScale, p[1] * kPScale, &pa[1]);
    pa[2] = split2(p[2] * kPScale, p[3] * kPScale, &pa[3]);
#pragma unroll
    for (int vb = 0; vb < DP / 32; ++vb) {
      uint32_t vh[4], vl[4] = {0u, 0u, 0u, 0u};
      ldsm_x4_trans(vh, st + L::kPlaneBytes + vb * 32);
      if (!FP8) ldsm_x4_trans(vl, st + 3 * L::kPlaneBytes + vb * 32);
#pragma unroll
      for (int half = 0; half < 2; ++half) {   // d16 block 2 vb + half
        uint32_t e0, o0, e1, o1;
        join_v<FP8>(vh[2 * half], vl[2 * half], &e0, &o0);          // keys 0-7
        join_v<FP8>(vh[2 * half + 1], vl[2 * half + 1], &e1, &o1);  // 8-15
        mma16816(acc[2 * vb + half][0], pa, e0, e1);
        mma16816(acc[2 * vb + half][1], pa, o0, o1);
      }
    }
    __syncwarp();
  }
  cp_async_wait<0>();
  l += __shfl_xor_sync(0xFFFFFFFFu, l, 1);
  l += __shfl_xor_sync(0xFFFFFFFFu, l, 2);

  // this warp's state into its own ring (its reads are done), then merge
  float* wacc = reinterpret_cast<float*>(own);
  __syncwarp();
  if (mine > 0 && grp < n_rows) {
#pragma unroll
    for (int db = 0; db < KB; ++db)
      *reinterpret_cast<float4*>(wacc + grp * DP + 16 * db + 4 * tig) =
          make_float4(acc[db][0][0] + acc[db][0][2],
                      acc[db][1][0] + acc[db][1][2],
                      acc[db][0][1] + acc[db][0][3],
                      acc[db][1][1] + acc[db][1][3]);
    if (tig == 0) {
      wacc[kRows * DP + grp] = m;
      wacc[kRows * DP + kRows + grp] = l;
    }
  }
  __syncthreads();
  const int n_act = min(n_st, kWarps);      // warps that took a step
  for (int idx = threadIdx.x; idx < n_rows * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    float mw[kWarps], M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      mw[w] = reinterpret_cast<const float*>(
          smem + w * L::kWarpBytes)[kRows * DP + g];
      if (w < n_act) M = fmaxf(M, mw[w]);
    }
    float o = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w < n_act) {
        const float* ws = reinterpret_cast<const float*>(smem + w * L::kWarpBytes);
        const float c = exp2f(mw[w] - M);
        o += c * ws[g * DP + d];
        lsum += c * ws[kRows * DP + kRows + g];
      }
    }
    o *= kPUnscale;
    if (dst.ml) {
      dst.acc[g * dst.acc_stride + d] = o;
      if (d == 0) {
        dst.ml[g * dst.ml_stride] = M;
        dst.ml[g * dst.ml_stride + 1] = lsum;
      }
    } else {
      dst.acc[g * dst.acc_stride + d] = o / fmaxf(lsum, 1e-30f);
    }
  }
}

// Merge the splits of one (batch row, query head) in split order. grid
// (H, B), thread t takes d = t and t + kThreads (D <= 2 * kThreads);
// part holds acc (B, H, ns, D), then
// (m, l) (B, H, ns, 2). Each split's weight e^(m_s - M) is taken once,
// into shared memory, a chunk of kThreads splits at a time, and the acc
// loads of a chunk are independent, so they overlap: the pass is a few
// rounds of loads, not one a split.
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ part, const int* __restrict__ lens,
               float* __restrict__ out, int B, int H, int D, int ns, int S,
               int limit, int window) {
  __shared__ float red[kWarps], wt[kThreads], lt[kThreads];
  const int hq = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  int klo, khi;
  kept_keys(lens[b], window, limit, &klo, &khi);
  int s_lo = 0, s_hi = 0;
  if (khi > klo) {
    s_lo = klo / S;
    s_hi = (khi + S - 1) / S;
  }
  const size_t bh = (size_t)b * H + hq;
  const float* acc = part + bh * ns * D;
  const float* ml = part + (size_t)B * H * ns * D + bh * ns * 2;
  float M = kNegInf;
  for (int s = s_lo + tid; s < s_hi; s += kThreads) M = fmaxf(M, ml[2 * s]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    M = fmaxf(M, __shfl_xor_sync(0xFFFFFFFFu, M, o));
  if ((tid & 31) == 0) red[tid >> 5] = M;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) M = fmaxf(M, red[w]);
  float o = 0.f, o2 = 0.f, lsum = 0.f;
  const bool two = tid + kThreads < D;    // a second column, D > kThreads
  for (int c0 = s_lo; c0 < s_hi; c0 += kThreads) {
    const int n = min(kThreads, s_hi - c0);
    __syncthreads();                      // the last chunk's weights are used
    if (tid < n) {
      wt[tid] = exp2f(ml[2 * (c0 + tid)] - M);
      lt[tid] = ml[2 * (c0 + tid) + 1];
    }
    __syncthreads();
    if (tid < D) {
      const float* a = acc + (size_t)c0 * D + tid;
      if (two) {
#pragma unroll 8
        for (int i = 0; i < n; ++i) {
          lsum += wt[i] * lt[i];
          o += wt[i] * a[(size_t)i * D];
          o2 += wt[i] * a[(size_t)i * D + kThreads];
        }
      } else {
#pragma unroll 8
        for (int i = 0; i < n; ++i) {
          lsum += wt[i] * lt[i];
          o += wt[i] * a[(size_t)i * D];
        }
      }
    }
  }
  if (tid < D) out[bh * D + tid] = o / fmaxf(lsum, 1e-30f);
  if (two) out[bh * D + tid + kThreads] = o2 / fmaxf(lsum, 1e-30f);
}

// The split kernel's work for block (s, y, b) of a row whose keys are
// addressed by `rows`: y = h * n_groups + group of 8 query heads.
template <int D, bool FP8, class Rows>
__device__ __forceinline__ void split_block(
    const float* __restrict__ q, const uint8_t* __restrict__ k_hi,
    const uint8_t* __restrict__ k_lo, const uint8_t* __restrict__ v_hi,
    const uint8_t* __restrict__ v_lo, const Rows& rows, int len,
    float* __restrict__ out, float* __restrict__ part, int B, int H, int Hkv,
    int ns, int S, int limit, int window, float q_scale) {
  const int s = blockIdx.x, b = blockIdx.z, G = H / Hkv;
  const int n_groups = (G + kRows - 1) / kRows;
  const int h = blockIdx.y / n_groups, g0 = (blockIdx.y % n_groups) * kRows;
  const int n_rows = min(kRows, G - g0);
  const size_t bh = (size_t)b * H + (size_t)h * G + g0;
  Dest dst;
  if (ns == 1) {
    dst = Dest{out + bh * D, nullptr, (size_t)D, 0};
  } else {
    dst = Dest{part + (bh * ns + s) * D,
               part + (size_t)B * H * ns * D + (bh * ns + s) * 2,
               (size_t)ns * D, (size_t)ns * 2};
  }
  int klo, khi;
  kept_keys(len, window, limit, &klo, &khi);
  const int lo = max(klo, s * S), hi = min(khi, s * S + S);
  if (lo >= hi) {
    write_zeros(dst, n_rows, D);
    return;
  }
  attend_split<D, FP8>(q + bh * D, n_rows, k_hi, k_lo, v_hi, v_lo, rows, Hkv,
                       h, lo, hi, q_scale, dst);
}

// grid of a split kernel: (splits, Hkv * groups of kRows query heads, B)
inline dim3 split_grid(int B, int H, int Hkv, int ns) {
  const int G = H / Hkv;
  return dim3(ns, Hkv * ((G + kRows - 1) / kRows), B);
}

// After a split kernel: merge the splits when a row has more than one, or
// write zeros when there are no keys at all. Returns the cudaError_t.
inline int finish(int B, int H, int D, int ns, int S, int limit, int window,
                  const int* lens, float* out, const float* part,
                  cudaStream_t stream) {
  if (ns > 1)
    combine_kernel<<<dim3(H, B), kThreads, 0, stream>>>(part, lens, out, B, H,
                                                        D, ns, S, limit,
                                                        window);
  else if (ns == 0)
    cudaMemsetAsync(out, 0, sizeof(float) * B * H * D, stream);
  return (int)cudaGetLastError();
}

}  // namespace nfp_decode
