// K6: causal GQA flash attention for prefill, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_prefill_attention.py ::
// flash_prefill_attention: q (B,S,H,D), k/v (B,S,Hkv,D), all f32, f16 or
// bf16 -> (B,S,H,D) f32. Same math as the TPU kernel: scores in f32 scaled
// by D^-0.5, keys at kpos <= qpos, online softmax with NEG_INF = -1e30,
// out = acc / max(l, 1e-30). Any S: keys and queries past S load as zero
// and are masked or not stored; nothing is padded. D is 64, 80
// (zamba2-2.7b's shared attention), 96 (phi-3-vision), 128 or 256
// (gemma3-1b's global layers) and G = H / Hkv is any whole number up to
// 64. A block holds BQ = 64 / G (rounded down) positions of all G heads;
// where G does not divide 64 (deepseek-coder-33b's G = 7: BQ = 9, 63
// rows) the block's last 64 - G * BQ rows are dead: their q loads as
// zero and they are never stored.
//
// What bounds it on an H100: at llama3.1-8b's heads and (B, S) = (8, 1024)
// the f32 output write, 134 MB in 0.070 ms at 3.35 TB/s; the causal half
// of the operations, 4*B*H*S^2*D/2 = 68.7 GFLOP, takes 0.0695 ms at the
// 989 TFLOP/s of the f16/bf16 tensor cores. Longer S moves it to the
// operations. At gemma3-1b's (8, 1024), H = 4, Hkv = 1, D = 256 the
// operations bound it: 17.2 GFLOP, 0.0174 ms, against 0.010 ms of output.
//
// Two bodies, chosen by the input type alone (the C entry point's switch):
//
// f16 / bf16 (flash_prefill_tc_kernel), the serving runtime's types. One
// block of 4 warps per (batch row, kv head, tile of BQ = 64/G query
// positions) holds all G query heads of that kv head, 64 query rows, so
// each K/V tile is read once for G heads; each warp owns a 16-row strip.
//  - Both products run on the tensor cores as mma.sync m16n8k16 with f32
//    accumulators, operands from shared memory by ldmatrix (.trans for V).
//    QK^T takes the unscaled q and k in their own type: their products are
//    exact in f32, and the f32 scores are scaled by D^-0.5 (times log2 e,
//    for exp2) afterwards, one f32 rounding from the plain version's.
//  - PV splits the f32 probabilities in two terms of the input type,
//    p_hi = rn(p) and p_lo = rn(p - p_hi), and accumulates p_hi V + p_lo V
//    in f32: the residual is below 2^-16 p in bf16 (2^-22 in f16, or
//    2^-25 absolute where f16 goes subnormal), so the output stays within
//    the plain version's 2e-4 where one rounding of p (2^-9 in bf16) would
//    not. The score accumulators of the m16n8k16 layout are the A operand
//    of PV in registers, as in FlashAttention-2: P never leaves them. The
//    split doubles PV, so the tensor cores do 1.5x the causal operations.
//  - K/V tiles of 64 keys stream through a ring of 2 stages in shared
//    memory by cp.async (16 bytes a thread, zero-filled past S), so the
//    load of tile j+1 overlaps the products on tile j. Rows are padded by
//    16 bytes, so the 8 rows of each ldmatrix phase hit distinct banks.
//    At D <= 128, Q goes once through the second stage's K slot into
//    registers. Nothing in this body needs D % 64: mma.sync takes k16 and
//    n8 steps, and at D = 80 and 96 a shared row of D + 8 halves is 176 or
//    208 bytes, a whole number of 16-byte cp.async chunks and ldmatrix
//    rows, whose 8 rows of a phase fall on distinct banks (row pitches of
//    44 and 52 words: 12r and 20r mod 32 step through disjoint 4-word
//    groups). The tensors keep D unpadded in memory.
//  - D = 256 would hold 128 f32 of O, the scores and 64 registers of q
//    fragments a thread, beyond the 255 registers a thread may use. There
//    Q keeps a shared-memory slot of its own (33 KB) and each k-step loads
//    its A fragment by ldmatrix, as the D = 256 decode kernels do; tiles
//    are 32 keys, so the ring (66 KB) and Q fit two blocks on an SM.
//  - The online-softmax state (m, l) of a thread's 2 rows stays in
//    registers; the 4 threads of a row reduce its max by quad shuffles.
//  - The key loop stops at the diagonal; only tiles that hold a key past
//    the block's first query position (or past S) are masked element by
//    element. Blocks take the query tiles longest first, so the
//    causal imbalance leaves no tail of idle SMs.
// It uses mma.sync, not wgmma with TMA: P must stay in registers as the
// next product's A operand, split in two terms, which wgmma's
// register-A form allows only with a warpgroup-wide 64-row layout and a
// producer/consumer design beyond this kernel's scope. A warp-specialised
// wgmma design (FlashAttention-3's) is the next step if K6 stays above
// 2x SDPA.
//
// f32 (flash_prefill_kernel), the reference runtime the tests run: one
// block of 256 threads per (batch row, kv head, tile of BQ = 64/G query
// positions) as above, q scaled by D^-0.5 in f32, both products as f32
// FMAs (67 TFLOP/s peak). Each thread keeps a 4x4 block of scores and a
// 4x(DP/16) block of the output in registers, with the running max and
// sum of its 4 rows; the 16 threads of a row reduce by warp shuffles. K is
// stored transposed and P goes through shared memory. The output's
// columns go in groups of 64, so V's shared rows are padded to DP, D
// rounded up to 64 (D = 80 and 96: 128), with the pad columns zero and
// never stored. At D = 256 that is 215 KB of shared memory (under the
// 227 KB opt-in), one block an SM.
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

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// D rounded up to the 64 output columns of a thread group
template <int D>
__host__ __device__ constexpr int padded64() { return (D + 63) / 64 * 64; }

template <int D>
constexpr int smem_floats() {
  return kRows * (D + 4) + D * (kKeys + 4) + kKeys * (padded64<D>() + 4) +
         kRows * (kKeys + 4);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, float* __restrict__ out, int S,
                     int H, int Hkv, float q_scale) {
  constexpr int DP = padded64<D>();    // V's row, padded to groups of 64
  constexpr int LDQ = D + 4, LDK = kKeys + 4, LDV = DP + 4, LDP = kKeys + 4;
  constexpr int NDG = DP / 64;          // output column groups of 64
  static_assert(D % 16 == 0 && D <= 256, "D is a multiple of 16, <= 256");
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [kRows][LDQ] scaled q
  float* Kt = Qs + kRows * LDQ;                  // [D][LDK] keys, transposed
  float* Vs = Kt + D * LDK;                      // [kKeys][LDV] values
  float* Ps = Vs + kKeys * LDV;                  // [kRows][LDP] probabilities

  const int G = H / Hkv, BQ = kRows / G;
  const int q0 = blockIdx.x * BQ, hh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  constexpr int C4 = D / 4;            // float4 chunks a row

  // this block's G*BQ query rows, row r = g*BQ + qq at position q0 + qq;
  // rows past G*BQ (g == G) are dead and load as zero
  for (int c = tid; c < kRows * C4; c += kThreads) {
    const int r = c / C4, d = (c % C4) * 4, g = r / BQ, pos = q0 + r % BQ;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (pos < S && g < G)
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
  // V's pad columns [D, DP): zero once (tiles never write them)
  if constexpr (DP > D)
    for (int c = tid; c < kKeys * (DP - D); c += kThreads)
      Vs[(c / (DP - D)) * LDV + D + c % (DP - D)] = 0.f;

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
    if (pos >= S || g >= G) continue;    // past S, or a dead row
    const float den = fmaxf(l[i], 1e-30f);
    float* o = out + (((size_t)b * S + pos) * H + (size_t)hh * G + g) * D;
#pragma unroll
    for (int gi = 0; gi < NDG; ++gi)
      if (64 * gi + 4 * tc < D)          // pad columns are not stored
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

// ---------------------------------------------------------------------------
// f16 / bf16: tensor cores (mma.sync m16n8k16), cp.async ring
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcRows = 16 * kTcWarps;   // = kRows: one 16-row strip a warp
constexpr int kStages = 2;               // K/V tiles in flight
constexpr float kLog2e = 1.4426950408889634f;

// D = 256 keeps q in a shared slot of its own and takes 32-key tiles;
// smaller D loads q's fragments into registers through one K slot
template <int D>
__host__ __device__ constexpr bool tc_q_in_smem() { return D > 128; }

template <int D>
__host__ __device__ constexpr int tc_keys() { return tc_q_in_smem<D>() ? 32 : kKeys; }

// halves a K or V tile in shared memory: rows of D padded by 8 halves
template <int D>
__host__ __device__ constexpr int tc_tile() { return tc_keys<D>() * (D + 8); }

template <int D>
constexpr int tc_smem_bytes() {
  return (kStages * 2 * tc_tile<D>() + (tc_q_in_smem<D>() ? kTcRows * (D + 8) : 0)) * 2;
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

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col), f32 accumulators
template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1);

template <>
__device__ __forceinline__ void mma16816<__half>(float (&c)[4],
                                                 const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float (&c)[4],
                                                        const uint32_t (&a)[4],
                                                        uint32_t b0,
                                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) -> the pair rn(x), rn(y) in T, packed x low; *lo gets the pair
// rn(x - rn(x)), rn(y - rn(y))
template <typename T>
__device__ __forceinline__ uint32_t split2(float x, float y, uint32_t* lo);

template <>
__device__ __forceinline__ uint32_t split2<__half>(float x, float y,
                                                   uint32_t* lo) {
  const __half2 hi = __floats2half2_rn(x, y);
  const float2 h = __half22float2(hi);
  const __half2 rest = __floats2half2_rn(x - h.x, y - h.y);
  *lo = *reinterpret_cast<const uint32_t*>(&rest);
  return *reinterpret_cast<const uint32_t*>(&hi);
}

template <>
__device__ __forceinline__ uint32_t split2<__nv_bfloat16>(float x, float y,
                                                          uint32_t* lo) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
  const float2 h = __bfloat1622float2(hi);
  const __nv_bfloat162 rest = __floats2bfloat162_rn(x - h.x, y - h.y);
  *lo = *reinterpret_cast<const uint32_t*>(&rest);
  return *reinterpret_cast<const uint32_t*>(&hi);
}

// grid: one block per (query tile, batch row, kv head), query tiles
// longest first: blockIdx.x = (n_qt - 1 - qt) * (B * Hkv) + b * Hkv + hh
template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_prefill_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, float* __restrict__ out,
                        int B, int S, int H, int Hkv, float scale_log2,
                        int n_qt) {
  constexpr int LD = D + 8;            // halves a shared row
  constexpr int KT = tc_keys<D>();     // keys a tile
  constexpr int TILE = tc_tile<D>();   // halves a K or V tile
  constexpr int C8 = D / 8;            // 16-byte chunks a row
  constexpr int KD = D / 16;           // k-steps of QK^T
  constexpr int NB = KT / 8;           // key n-blocks of the scores
  constexpr bool QS = tc_q_in_smem<D>();
  static_assert(D % 16 == 0 && D <= 256, "D is a multiple of 16, <= 256");
  static_assert(QS || kTcRows <= KT, "Q goes through one K slot");
  extern __shared__ float4 smem4[];
  // stage st: K tile at sm + 2 * st * TILE, V tile right after it
  T* sm = reinterpret_cast<T*>(smem4);

  const int G = H / Hkv, BQ = kTcRows / G;
  const int bh = blockIdx.x % (B * Hkv);
  const int qt = n_qt - 1 - (int)(blockIdx.x / (B * Hkv));
  const int b = bh / Hkv, hh = bh % Hkv, q0 = qt * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t kstride = (size_t)Hkv * D;         // elements between keys
  const T* kb = k + (size_t)b * S * kstride + (size_t)hh * D;
  const T* vb = v + (size_t)b * S * kstride + (size_t)hh * D;

  const int k_end = min(S, q0 + BQ);              // causal: the diagonal
  const int n_tiles = (k_end + KT - 1) / KT;

  auto load_kv = [&](int tile, int st) {
    T* ks = sm + 2 * st * TILE;
    T* vs = ks + TILE;
    for (int c = tid; c < KT * C8; c += kTcThreads) {
      const int t = c / C8, ch = (c % C8) * 8, pos = tile * KT + t;
      const bool ok = pos < S;
      const size_t off = (size_t)(ok ? pos : 0) * kstride + ch;
      cp_async16(smem_u32(ks + t * LD + ch), kb + off, ok);
      cp_async16(smem_u32(vs + t * LD + ch), vb + off, ok);
    }
  };

  // this block's G*BQ query rows, row r = g*BQ + qq at position q0 + qq,
  // into Q's own slot past the ring (D = 256) or the last stage's K slot,
  // with the first kStages - 1 K/V tiles; rows past G*BQ (g == G) are
  // dead and load as zero
  T* qs = QS ? sm + 2 * kStages * TILE : sm + 2 * (kStages - 1) * TILE;
  for (int c = tid; c < kTcRows * C8; c += kTcThreads) {
    const int r = c / C8, ch = (c % C8) * 8, g = r / BQ, pos = q0 + r % BQ;
    const bool ok = pos < S && g < G;
    const T* src =
        q + (((size_t)b * S + (ok ? pos : 0)) * H + (size_t)hh * G + g) * D + ch;
    cp_async16(smem_u32(qs + r * LD + ch), src, ok);
  }
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load_kv(t, t);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();
  // A fragments of the warp's strip: in registers, or (D = 256) read from
  // Q's slot at each k-step
  const uint32_t qa = smem_u32(qs + (warp * 16 + lane % 16) * LD + (lane / 16) * 8);
  uint32_t qf[QS ? 1 : KD][4];
  if constexpr (!QS) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) ldsm_x4(qf[kk], qa + kk * 32);
    __syncthreads();                   // the Q slot is refilled below
  }

  // this thread's rows of the strip: lane/4 and lane/4 + 8
  const int r0 = warp * 16 + lane / 4;
  const int qpos[2] = {q0 + r0 % BQ, q0 + (r0 + 8) % BQ};
  float o[D / 8][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int nxt = j + kStages - 1;
    if (nxt < n_tiles) load_kv(nxt, nxt % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();      // tile j has landed
    __syncthreads();
    const T* ks = sm + 2 * (j % kStages) * TILE;
    const T* vs = ks + TILE;

    // S = Q K^T (unscaled) for the strip's 16 rows x KT keys
    float s[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      if constexpr (QS) ldsm_x4(qf[0], qa + kk * 32);
      const uint32_t(&a)[4] = qf[QS ? 0 : kk];
#pragma unroll
      for (int np = 0; np < NB / 2; ++np) {
        uint32_t kf[4];   // B fragments of key n-blocks 2np and 2np + 1
        ldsm_x4(kf, smem_u32(ks + (16 * np + lane % 8 + (lane / 16) * 8) * LD +
                             16 * kk + ((lane / 8) % 2) * 8));
        mma16816<T>(s[2 * np], a, kf[0], kf[1]);
        mma16816<T>(s[2 * np + 1], a, kf[2], kf[3]);
      }
    }

    // scale, mask a tile that reaches past the block's first query
    // position (the diagonal, and keys past S), online softmax in the
    // exp2 domain
    const bool diag = (j + 1) * KT - 1 > q0;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nb][e] * scale_log2;
        if (diag) {
          const int kpos = j * KT + 8 * nb + 2 * (lane % 4) + (e & 1);
          if (!(kpos <= qpos[e / 2] && kpos < S)) x = kNegInf;
        }
        s[nb][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xFFFFFFFFu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xFFFFFFFFu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nb][e] = exp2f(s[nb][e] - m[e / 2]);
        l[e / 2] += s[nb][e];
      }
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nd][e] *= corr[e / 2];

    // O += P_hi V + P_lo V, 16 keys a step; P from the score registers
#pragma unroll
    for (int kc = 0; kc < KT / 16; ++kc) {
      uint32_t ph[4], pl[4];
      ph[0] = split2<T>(s[2 * kc][0], s[2 * kc][1], &pl[0]);
      ph[1] = split2<T>(s[2 * kc][2], s[2 * kc][3], &pl[1]);
      ph[2] = split2<T>(s[2 * kc + 1][0], s[2 * kc + 1][1], &pl[2]);
      ph[3] = split2<T>(s[2 * kc + 1][2], s[2 * kc + 1][3], &pl[3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];   // B fragments of value columns 16dp.. and 16dp+8..
        ldsm_x4_trans(vf, smem_u32(vs + (16 * kc + lane % 8 +
                                         ((lane / 8) % 2) * 8) * LD +
                                   16 * dp + (lane / 16) * 8));
        mma16816<T>(o[2 * dp], ph, vf[0], vf[1]);
        mma16816<T>(o[2 * dp], pl, vf[0], vf[1]);
        mma16816<T>(o[2 * dp + 1], ph, vf[2], vf[3]);
        mma16816<T>(o[2 * dp + 1], pl, vf[2], vf[3]);
      }
    }
    __syncthreads();                   // stage j % kStages consumed
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xFFFFFFFFu, l[i], 1);
    l[i] += __shfl_xor_sync(0xFFFFFFFFu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i, g = r / BQ, pos = q0 + r % BQ;
    if (pos >= S || g >= G) continue;    // past S, or a dead row
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = out + (((size_t)b * S + pos) * H + (size_t)hh * G + g) * D;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<float2*>(&orow[8 * nd + 2 * (lane % 4)]) =
          make_float2(o[nd][2 * i] / den, o[nd][2 * i + 1] / den);
  }
}

template <typename T, int D>
int launch_tc(const void* q, const void* k, const void* v, float* out, int B,
              int S, int H, int Hkv, float q_scale, cudaStream_t stream) {
  const int smem = tc_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_tc_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int bq = kTcRows / (H / Hkv);
  const int n_qt = (S + bq - 1) / bq;
  flash_prefill_tc_kernel<T, D><<<n_qt * B * Hkv, kTcThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), out, B, S, H, Hkv, q_scale * kLog2e, n_qt);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tc_d(const void* q, const void* k, const void* v, float* out, int B,
                int S, int H, int Hkv, int D, float q_scale, cudaStream_t s) {
  if (D == 64) return launch_tc<T, 64>(q, k, v, out, B, S, H, Hkv, q_scale, s);
  if (D == 80) return launch_tc<T, 80>(q, k, v, out, B, S, H, Hkv, q_scale, s);
  if (D == 96) return launch_tc<T, 96>(q, k, v, out, B, S, H, Hkv, q_scale, s);
  if (D == 128)
    return launch_tc<T, 128>(q, k, v, out, B, S, H, Hkv, q_scale, s);
  if (D == 256)
    return launch_tc<T, 256>(q, k, v, out, B, S, H, Hkv, q_scale, s);
  return (int)cudaErrorInvalidValue;
}

int launch_f32(const void* q, const void* k, const void* v, float* out, int B,
               int S, int H, int Hkv, int D, float q_scale, cudaStream_t s) {
  if (D == 64) return launch<float, 64>(q, k, v, out, B, S, H, Hkv, q_scale, s);
  if (D == 80) return launch<float, 80>(q, k, v, out, B, S, H, Hkv, q_scale, s);
  if (D == 96) return launch<float, 96>(q, k, v, out, B, S, H, Hkv, q_scale, s);
  if (D == 128)
    return launch<float, 128>(q, k, v, out, B, S, H, Hkv, q_scale, s);
  if (D == 256)   // 215 KB of shared memory, under the 227 KB opt-in
    return launch<float, 256>(q, k, v, out, B, S, H, Hkv, q_scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 f32 (the SIMT body), 1 f16, 2 bf16 (the tensor-core body); q,
// k and v alike. Needs D in {64, 80, 96, 128, 256} and H / Hkv a whole
// number up to 64; the wrapper checks both.
extern "C" int flash_prefill_attention(const void* q, const void* k,
                                       const void* v, void* out, int dtype,
                                       int B, int S, int H, int Hkv, int D,
                                       float q_scale, void* stream) {
  if (B <= 0 || S <= 0) return (int)cudaGetLastError();
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_f32(q, k, v, o, B, S, H, Hkv, D, q_scale, s);
    case 1: return launch_tc_d<__half>(q, k, v, o, B, S, H, Hkv, D, q_scale, s);
    case 2:
      return launch_tc_d<__nv_bfloat16>(q, k, v, o, B, S, H, Hkv, D, q_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
