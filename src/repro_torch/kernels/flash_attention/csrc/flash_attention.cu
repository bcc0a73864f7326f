// Flash attention forward for Hopper (sm_90a), bfloat16 or float32 inputs.
//
// Replaces the Pallas kernel of src/repro/kernels/flash_attention/
// flash_attention.py (`flash_attention_fwd`, body `_kernel`): for every
// q-head row b and query i
//
//     o[b, i] = sum_j softmax_j(q[b, i] . k[b / group, j] * D^-1/2) v[b / group, j]
//
// over the keys j that the index-derived mask leaves live: all of them
// ("none"), j <= i ("causal"), or i - window < j <= i ("window"), with
// positions 0 .. Sq-1 and 0 .. Sk-1.  GQA reads kv head b / group, so KV is
// never repeated in memory.  Scores are q.k accumulated in float32 times
// D^-1/2; masked ones are -1e30; p = exp(s - m) is rounded to the input
// type before the PV product (the Pallas kernel casts p to v's dtype), the
// row sum l adds the unrounded p, and the output is acc / max(l, 1e-30)
// rounded to the input type.
//
// Bound.  At the model path's shapes (gemma3-1b and recurrentgemma-9b: D =
// 256, S = 2048 and 4096, windows 512 and 2048) attention is bound by
// operations: 4 D flops per live (query, key) pair against one read of Q,
// K, V and one write of O, so bfloat16 wants the tensor cores (989 TFLOP/s
// dense on the H100 SXM) and float32 the FP32 cores (67 TFLOP/s).
//
// Design, bfloat16 (`flash_tc_kernel`).  The TPU kernel walks a sequential
// kv grid axis and carries (m, l, acc) in VMEM scratch from one grid step to
// the next.  Here a CTA of 8 warps, two groups of 4 (warp w of a group owns
// rows 16 w .. 16 w + 15 of a 64-query tile), loops over the 64-key tiles
// of the kv band the mask can reach (causal: up to the tile's last query;
// window: from the 64-aligned tile holding its first query's first key),
// so tiles wholly outside the mask are never loaded, as `pl.when(live)`
// skips them.  The wrapper picks one of two modes (`launch_plan`):
//
//   * split (causal, or an odd group): both groups own one q head's tile;
//     group 0 takes the even kv tiles, group 1 the odd ones, each with its
//     own K and V buffers, and at the end group 1 hands its (m, l, acc) to
//     group 0 through shared memory to be merged as two splits of a
//     flash-decode.  The longest CTA of a causal launch (the last q tile,
//     32 kv tiles at S = 2048) so walks 16 tiles per group.
//   * pack (otherwise): group g owns q head 2 blockIdx.x + g; both heads
//     read one kv head (the group is even), so they share every K and V
//     tile and the loads from L2 halve.
//
//   * Both products run on the tensor cores: S = Q K^T and O += P V are
//     `mma.sync.m16n8k16` bf16 x bf16 -> f32 with the accumulators in
//     registers.  Operands come from shared memory by `ldmatrix` (`.trans`
//     for V).  P leaves the S accumulators rounded to bf16, which is both
//     the Pallas kernel's rounding and the A operand of the second product.
//     Q's fragments stay in registers across the kv loop where D <= 128; at
//     D = 256 they would take 64 more registers beside the 128 of the O
//     accumulator, so they are read from shared memory per tile instead.
//   * K and V tiles arrive by `cp.async` (16-byte pieces where the rows and
//     pointers allow, else 8 or 4), one K and one V buffer per reader, as
//     in FlashAttention-2: V of tile t is in flight while the scores of tile
//     t are computed, K of the next tile while P V of tile t is.  At D = 256
//     shared memory holds 169 KB (split) or 135 KB (pack): one CTA an SM.
//     Rows past Sq or Sk are zero-filled by the copy itself.  D is padded
//     with zeros to 32, 64, 128 or 256 in shared memory, and every row is 16
//     bytes longer than that so that the 8 rows an `ldmatrix` reads fall on
//     distinct banks.  Rows of exactly the padded D in 16-byte copies (every
//     model shape) take a copy loop with constant offsets: a division per
//     copy would cost more issue slots than the tile's `mma`s.
//   * Softmax runs on the accumulator layout: a row's 64 scores lie in one
//     quad of lanes, so its max is two shuffles; the row sum l stays a
//     partial sum per lane until the end.  Element masks are applied only to
//     the tiles that straddle the diagonal or the window's edge and to the
//     ragged last tile.  Scores are taken in log2 units (times D^-1/2
//     log2(e)) so that p = 2^(x - m) is one `ex2.approx` (relative error
//     ~2^-22, far inside the bf16 tolerance); masked ones are -1e30.  A
//     row with no live key yet in a tile (or in all of a group's tiles)
//     adds 2^0 terms that the next live key's correction 2^(-1e30 - m) (or
//     the merge's) wipes out exactly, as in the Pallas kernel; the wrapper
//     refuses inputs where some query row has no live key at all.
//   * Under a causal or window mask the grid launches the q tiles in
//     reverse, so the longest tiles start first.
//
// Float32 (`flash_fwd_kernel`) runs on the FP32 cores (TF32 would not hold
// the 1e-5 tolerance): 8 warps per 64 queries, 32-key blocks staged as
// float32, q tiles in reverse under a mask as above.
//
// Interface: plain C, called through ctypes; the launcher returns
// cudaGetLastError() so the Python wrapper raises on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kMaxD = 256;

// ---------------------------------------------------------------------------
// float32: the SIMT kernel
// ---------------------------------------------------------------------------
constexpr int kBQ = 64;                 // queries per CTA
constexpr int kBK = 32;                 // keys per block (one per lane)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kBQ / kWarps;     // query rows per warp

// kCols = ceil(D / 32) accumulator columns per lane; kReverse: q tiles
// launched last first
template <int kCols, bool kReverse>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int Sq,
                 int Sk, int D, int group, int mask_kind, int window,
                 float scale) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int ld = D + 4;                 // padded row of Q and K (floats)
  float* const Qs = smem;               // (kBQ, ld)
  float* const Ks = Qs + kBQ * ld;      // (kBK, ld)
  float* const Vs = Ks + kBK * ld;      // (kBK, D)
  float* const Ps = Vs + kBK * D;       // (kBQ, kBK)

  const int b = blockIdx.x;
  const int tile = kReverse ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = tile * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t q_base = static_cast<size_t>(b) * Sq * D;
  const size_t kv_base = static_cast<size_t>(b / group) * Sk * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D;
    const int d = e - r * D;
    const int qi = q0 + r;
    Qs[r * ld + d] = qi < Sq ? q[q_base + static_cast<size_t>(qi) * D + d]
                             : 0.f;
  }

  // the kv band any query of this block can see
  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int k_begin = mask_kind == 2 ? max(0, q0 - window + 1) : 0;
  const int k_end = mask_kind == 0 ? Sk : min(Sk, q_last + 1);

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();                    // Q staged, last block consumed
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D;
      const int d = e - r * D;
      const int kj = k0 + r;
      const size_t g = kv_base + static_cast<size_t>(kj) * D + d;
      const bool in = kj < Sk;
      Ks[r * ld + d] = in ? k[g] : 0.f;
      Vs[r * D + d] = in ? v[g] : 0.f;
    }
    __syncthreads();

    // scores of this warp's rows against key k0 + lane
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float4* k4 = reinterpret_cast<const float4*>(Ks + lane * ld);
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float4 kk = k4[d4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qq = reinterpret_cast<const float4*>(
            Qs + (warp + kWarps * r) * ld)[d4];
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }

    // online softmax, one row per (warp, r), one key per lane
    const int kj = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = warp + kWarps * r;
      const int qi = q0 + row;
      bool live = kj < Sk;
      if (mask_kind != 0) live = live && kj <= qi;
      if (mask_kind == 2) live = live && kj > qi - window;
      const float sv = live ? s[r] * scale : kNeg;
      float mx = sv;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      const float p = expf(sv - m_new);
      float ps = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[r] = l[r] * corr + ps;
      m[r] = m_new;
      Ps[row * kBK + lane] = p;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= corr;
    }
    __syncwarp();

    // acc[r][c] += sum_j P[row, j] V[j, lane + 32 c]
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < D ? Vs[j * D + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = Ps[(warp + kWarps * r) * kBK + j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + warp + kWarps * r;
    if (qi >= Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    float* row = o + q_base + static_cast<size_t>(qi) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (d < D) row[d] = acc[r][c] / den;
    }
  }
}

size_t simt_smem_bytes(int D) {
  const int ld = D + 4;
  return sizeof(float) *
         (static_cast<size_t>(kBQ) * ld + static_cast<size_t>(kBK) * ld +
          static_cast<size_t>(kBK) * D + static_cast<size_t>(kBQ) * kBK);
}

template <int kCols>
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* o,
                        int BH, int n_qtiles, int Sq, int Sk, int D,
                        int group, int mask_kind, int window, float scale,
                        int reverse, cudaStream_t stream) {
  const size_t smem = simt_smem_bytes(D);
  auto* fn = reverse ? flash_fwd_kernel<kCols, true>
                     : flash_fwd_kernel<kCols, false>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fn<<<dim3(BH, n_qtiles), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, D, group,
      mask_kind, window, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_simt(const void* q, const void* k, const void* v,
                          void* o, int BH, int n_qtiles, int Sq, int Sk,
                          int D, int group, int mask_kind, int window,
                          float scale, int reverse, cudaStream_t stream) {
  if (D <= 32)
    return launch_simt<1>(q, k, v, o, BH, n_qtiles, Sq, Sk, D, group,
                          mask_kind, window, scale, reverse, stream);
  if (D <= 64)
    return launch_simt<2>(q, k, v, o, BH, n_qtiles, Sq, Sk, D, group,
                          mask_kind, window, scale, reverse, stream);
  if (D <= 128)
    return launch_simt<4>(q, k, v, o, BH, n_qtiles, Sq, Sk, D, group,
                          mask_kind, window, scale, reverse, stream);
  return launch_simt<8>(q, k, v, o, BH, n_qtiles, Sq, Sk, D, group,
                        mask_kind, window, scale, reverse, stream);
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores, asynchronous copies
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kBQ = 64;                 // queries per CTA, 16 per warp
constexpr int kBK = 64;                 // keys per kv tile
constexpr int kGroupThreads = 128;      // a warp group: 4 warps, 64 rows
constexpr int kThreads = 2 * kGroupThreads;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of kBytes (16: .cg, else .ca); n_src = 0 writes zeros
template <int kBytes>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int n_src) {
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(n_src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(dst), "l"(src), "n"(kBytes), "r"(n_src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// rows 0 .. kRowsT-1 of a tile, by kN threads: row r of D elements from
// src + r * D (rows >= n_rows zero-filled) into dst + r * kLd; vec = bytes
// per copy (16, 8, 4; 0: plain loads).  Rows of exactly kDp elements in
// 16-byte copies (every model shape) take an unrolled path whose offsets
// are constants; the rest divide by the copies a row takes.
template <int kRowsT, int kLd, int kN, int kDp>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          const bf16* any, int n_rows, int D,
                                          int vec, int tid) {
  if (D == kDp && vec == 16) {
    constexpr int kChunks = kDp / 8;    // 16-byte copies a row
    static_assert((kRowsT * kChunks) % kN == 0, "whole rounds of copies");
#pragma unroll
    for (int i = 0; i < kRowsT * kChunks / kN; ++i) {
      const int c = tid + i * kN;
      const int r = c / kChunks;
      const int d = (c % kChunks) * 8;
      const bool in = r < n_rows;
      cp_async<16>(smem_addr(dst + r * kLd + d),
                   in ? src + static_cast<size_t>(r) * kDp + d : any,
                   in ? 16 : 0);
    }
    return;
  }
  if (vec == 0) {
    for (int e = tid; e < kRowsT * D; e += kN) {
      const int r = e / D;
      const int d = e - r * D;
      dst[r * kLd + d] = r < n_rows ? src[static_cast<size_t>(r) * D + d]
                                    : __float2bfloat16_rn(0.f);
    }
    return;
  }
  const int per = vec / 2;              // elements per copy
  const int chunks = D / per;           // copies per row
  for (int c = tid; c < kRowsT * chunks; c += kN) {
    const int r = c / chunks;
    const int d = (c - r * chunks) * per;
    const bool in = r < n_rows;
    const bf16* s = in ? src + static_cast<size_t>(r) * D + d : any;
    const uint32_t a = smem_addr(dst + r * kLd + d);
    if (vec == 16)
      cp_async<16>(a, s, in ? 16 : 0);
    else if (vec == 8)
      cp_async<8>(a, s, in ? 8 : 0);
    else
      cp_async<4>(a, s, in ? 4 : 0);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16 x 16, row) b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Shared memory of one CTA.  kSplit: Q of one head (64 rows), and K and V
// of each warp group; else Q of two heads (128 rows) and one K and one V
// for both groups.  169 and 135 KB at D = 256 (one CTA an SM).
template <int kDp, bool kSplit>
struct Geometry {
  static constexpr int kLd = kDp + 8;   // row in shared memory (elements)
  static constexpr int kTile = kBK * kLd;
  static constexpr int kQRows = kSplit ? kBQ : 2 * kBQ;
  static constexpr int kRows = kQRows + (kSplit ? 4 : 2) * kBK;
  static constexpr size_t kSmem =
      sizeof(bf16) * static_cast<size_t>(kRows) * kLd;
  static constexpr bool kQInRegs = kDp <= 128;
};

// barrier of one warp group (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(group + 1), "n"(kGroupThreads));
}

// 2^x (ex2.approx: relative error ~2^-22; 2^-1e30 = 0, 2^0 = 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// kDp: D padded to 32, 64, 128 or 256.  kSplit: the two warp groups share
// one q head and take the even and the odd kv tiles (merged at the end);
// else group g takes q head 2 blockIdx.x + g (both of one kv head) over
// every kv tile.
template <int kDp, bool kSplit>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, int Sq,
                int Sk, int D, int group, int mask_kind, int window,
                float scale, int vec, int reverse) {
  using G = Geometry<kDp, kSplit>;
  constexpr int kLd = G::kLd;
  constexpr int kSteps = kDp / 16;      // k-steps of Q K^T
  constexpr int kNT = kBK / 8;          // n-tiles of S
  constexpr int kDT = kDp / 8;          // n-tiles of O
  // K and V loads: by the group (kSplit) or by the whole CTA
  constexpr int kLoaders = kSplit ? kGroupThreads : kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const Qs = reinterpret_cast<bf16*>(smem_raw);

  const int tile = reverse ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = tile * kBQ;
  const int tid = threadIdx.x;
  const int wg = tid / kGroupThreads;   // warp group
  const int gt = tid % kGroupThreads;   // thread of the group
  const int warp = gt >> 5;             // warp of the group: rows 16 warp ..
  const int lane = tid & 31;
  const int g = lane >> 2;              // accumulator row (and row + 8)
  const int t4 = lane & 3;              // accumulator column pair
  const int ld_tid = kSplit ? gt : tid;
  const int b = kSplit ? blockIdx.x : 2 * blockIdx.x + wg;  // q-head row
  bf16* const Qg = Qs + (kSplit ? 0 : wg * kBQ * kLd);      // (kBQ, kLd)
  bf16* const Ks = Qs + G::kQRows * kLd + (kSplit ? wg * 2 * G::kTile : 0);
  bf16* const Vs = Ks + G::kTile;                           // (kBK, kLd)
  const bf16* const qb = q + static_cast<size_t>(b) * Sq * D;
  const bf16* const kb = k + static_cast<size_t>(b / group) * Sk * D;
  const bf16* const vb = v + static_cast<size_t>(b / group) * Sk * D;
  auto kv_sync = [&]() {
    if constexpr (kSplit)
      group_sync(wg);
    else
      __syncthreads();
  };

  // the padded columns D .. kDp-1 of every row are zeros for good
  if (D < kDp) {
    const int pad = kDp - D;
    for (int e = tid; e < G::kRows * pad; e += kThreads) {
      const int r = e / pad;
      Qs[r * kLd + D + (e - r * pad)] = __float2bfloat16_rn(0.f);
    }
  }

  // the kv band any query of this tile can see, from a 64-aligned key
  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int k_begin =
      mask_kind == 2 ? max(0, q0 - window + 1) / kBK * kBK : 0;
  const int k_end = mask_kind == 0 ? Sk : min(Sk, q_last + 1);
  const int n_tiles = (k_end - k_begin + kBK - 1) / kBK;
  const int it0 = kSplit ? wg : 0;      // this group's first kv tile
  constexpr int kStride = kSplit ? 2 : 1;

  const bf16* const qt = qb + static_cast<size_t>(q0) * D;
  if (kSplit)
    load_tile<kBQ, kLd, kThreads, kDp>(Qs, qt, q, Sq - q0, D, vec, tid);
  else
    load_tile<kBQ, kLd, kGroupThreads, kDp>(Qg, qt, q, Sq - q0, D, vec, gt);
  if (it0 < n_tiles) {
    const int k0 = k_begin + it0 * kBK;
    load_tile<kBK, kLd, kLoaders, kDp>(Ks, kb + static_cast<size_t>(k0) * D,
                                       k, Sk - k0, D, vec, ld_tid);
  }
  cp_async_commit();

  const int row_a = q0 + warp * 16 + g;  // this lane's two query rows
  const int row_b = row_a + 8;
  // ldmatrix row addresses: A (Q) rows and columns, B (K) keys and
  // columns, B^T (V) keys and columns
  const int a_row = warp * 16 + (lane & 15);
  const int a_col = (lane >> 4) * 8;
  const int k_row = (lane & 7) + ((lane >> 4) << 3);
  const int k_col = ((lane >> 3) & 1) * 8;
  const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int v_col = (lane >> 4) * 8;
  // scores in log2 units: s D^-1/2 log2(e), so p = 2^(x - m)
  const float sl2 = scale * 1.4426950408889634f;

  uint32_t qf[G::kQInRegs ? kSteps : 1][4];
  float acc[kDT][4];
#pragma unroll
  for (int n = 0; n < kDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;

  cp_async_wait<0>();                   // Q and the first K
  __syncthreads();
  if constexpr (G::kQInRegs) {
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
      ldsm_x4(qf[kk], smem_addr(Qg + a_row * kLd + kk * 16 + a_col));
  }

  // K of the next tile is in flight while P V of this one runs, V of this
  // tile while its scores do (FlashAttention-2's order)
  for (int it = it0; it < n_tiles; it += kStride) {
    const int k0 = k_begin + it * kBK;
    cp_async_wait<0>();                 // K of tile it landed
    kv_sync();                          // ... and V of the last tile is free
    load_tile<kBK, kLd, kLoaders, kDp>(Vs, vb + static_cast<size_t>(k0) * D,
                                       v, Sk - k0, D, vec, ld_tid);
    cp_async_commit();

    // S = Q K^T: this warp's 16 rows x 64 keys
    float s[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t a[4];
      if constexpr (G::kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        ldsm_x4(a, smem_addr(Qg + a_row * kLd + kk * 16 + a_col));
      }
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, smem_addr(Ks + (np * 16 + k_row) * kLd + kk * 16 +
                              k_col));
        mma(s[2 * np], a, bk[0], bk[1]);
        mma(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // scale; element masks only where the tile is not wholly live
    const bool full =
        k0 + kBK <= Sk &&
        (mask_kind == 0 ||
         (k0 + kBK - 1 <= q0 &&
          (mask_kind == 1 || k0 >= q0 + kBQ - window)));
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * sl2;
        if (!full) {
          const int kj = k0 + n * 8 + 2 * t4 + (e & 1);
          const int qi = e < 2 ? row_a : row_b;
          bool live = kj < Sk;
          if (mask_kind != 0) live = live && kj <= qi;
          if (mask_kind == 2) live = live && kj > qi - window;
          if (!live) x = kNeg;
        }
        s[n][e] = x;
      }

    // online softmax over the quad that holds each row
    float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float c0 = ex2(m0 - mn0);
    const float c1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      s[n][0] = ex2(s[n][0] - mn0);
      s[n][1] = ex2(s[n][1] - mn0);
      s[n][2] = ex2(s[n][2] - mn1);
      s[n][3] = ex2(s[n][3] - mn1);
      ls0 += s[n][0] + s[n][1];
      ls1 += s[n][2] + s[n][3];
    }
    l0 = l0 * c0 + ls0;
    l1 = l1 * c1 + ls1;
    if (!__all_sync(0xffffffffu, c0 == 1.f && c1 == 1.f)) {
#pragma unroll
      for (int n = 0; n < kDT; ++n) {
        acc[n][0] *= c0;
        acc[n][1] *= c0;
        acc[n][2] *= c1;
        acc[n][3] *= c1;
      }
    }

    cp_async_wait<0>();                 // V of tile it landed
    kv_sync();                          // ... and K of tile it is free
    if (it + kStride < n_tiles) {
      const int k2 = k0 + kStride * kBK;
      load_tile<kBK, kLd, kLoaders, kDp>(Ks,
                                         kb + static_cast<size_t>(k2) * D, k,
                                         Sk - k2, D, vec, ld_tid);
      cp_async_commit();
    }

    // O += P V, P rounded to bf16 as the A operand
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kDT / 2; ++dp) {
        uint32_t bv[4];
        ldsm_x4_t(bv, smem_addr(Vs + (j * 16 + v_row) * kLd + dp * 16 +
                                v_col));
        mma(acc[2 * dp], pa, bv[0], bv[1]);
        mma(acc[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
  }

  if constexpr (kSplit) {
    // Merge the odd tiles' (m, l, acc) into the even ones': group 1 leaves
    // its state in its own K and V buffers (256 (kDp + 8) bytes hold the
    // 128 threads' kDp / 2 + 4 floats), lane by lane, as [value][thread].
    group_sync(wg);                     // every warp of the group is done
    float* const xs = reinterpret_cast<float*>(Qs + kBQ * kLd + 2 * G::kTile);
    if (wg == 1) {
      xs[0 * kGroupThreads + gt] = m0;
      xs[1 * kGroupThreads + gt] = m1;
      xs[2 * kGroupThreads + gt] = l0;
      xs[3 * kGroupThreads + gt] = l1;
#pragma unroll
      for (int n = 0; n < kDT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          xs[(4 + 4 * n + e) * kGroupThreads + gt] = acc[n][e];
    }
    __syncthreads();
    if (wg == 1) return;
    const float om0 = xs[0 * kGroupThreads + gt];
    const float om1 = xs[1 * kGroupThreads + gt];
    const float mn0 = fmaxf(m0, om0);
    const float mn1 = fmaxf(m1, om1);
    const float a0 = ex2(m0 - mn0), b0 = ex2(om0 - mn0);
    const float a1 = ex2(m1 - mn1), b1 = ex2(om1 - mn1);
    l0 = l0 * a0 + xs[2 * kGroupThreads + gt] * b0;
    l1 = l1 * a1 + xs[3 * kGroupThreads + gt] * b1;
#pragma unroll
    for (int n = 0; n < kDT; ++n) {
      acc[n][0] = acc[n][0] * a0 + xs[(4 + 4 * n) * kGroupThreads + gt] * b0;
      acc[n][1] = acc[n][1] * a0 + xs[(5 + 4 * n) * kGroupThreads + gt] * b0;
      acc[n][2] = acc[n][2] * a1 + xs[(6 + 4 * n) * kGroupThreads + gt] * b1;
      acc[n][3] = acc[n][3] * a1 + xs[(7 + 4 * n) * kGroupThreads + gt] * b1;
    }
  }

  // l was summed per lane: add the quad's partial sums
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float den0 = fmaxf(l0, 1e-30f);
  const float den1 = fmaxf(l1, 1e-30f);
  bf16* const ob = o + static_cast<size_t>(b) * Sq * D;
#pragma unroll
  for (int n = 0; n < kDT; ++n) {
    const int d = n * 8 + 2 * t4;
    if (d >= D) continue;
    if (row_a < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<size_t>(row_a) * D +
                                         d) =
          __floats2bfloat162_rn(acc[n][0] / den0, acc[n][1] / den0);
    if (row_b < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<size_t>(row_b) * D +
                                         d) =
          __floats2bfloat162_rn(acc[n][2] / den1, acc[n][3] / den1);
  }
}

// cudaFuncSetAttribute(MaxDynamicSharedMemorySize) once per kernel and
// device (a host call on every launch otherwise); bit d of ``done``, which
// each kernel instance keeps, marks device d as set
template <typename F>
cudaError_t set_smem_once(F* fn, size_t bytes, unsigned& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && (done >> dev & 1u)) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < 32) done |= 1u << dev;
  return err;
}

template <int kDp, bool kSplit>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int BH, int n_qtiles, int Sq, int Sk, int D, int group,
                   int mask_kind, int window, float scale, int vec,
                   int reverse, cudaStream_t stream) {
  constexpr size_t smem = Geometry<kDp, kSplit>::kSmem;
  auto* fn = flash_tc_kernel<kDp, kSplit>;
  static unsigned smem_set = 0;
  cudaError_t err = set_smem_once(fn, smem, smem_set);
  if (err != cudaSuccess) return err;
  fn<<<dim3(kSplit ? BH : BH / 2, n_qtiles), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Sq, Sk, D, group,
      mask_kind, window, scale, vec, reverse);
  return cudaGetLastError();
}

template <int kDp>
cudaError_t launch_mode(const void* q, const void* k, const void* v, void* o,
                        int BH, int n_qtiles, int Sq, int Sk, int D,
                        int group, int mask_kind, int window, float scale,
                        int vec, int reverse, int split,
                        cudaStream_t stream) {
  return split ? launch<kDp, true>(q, k, v, o, BH, n_qtiles, Sq, Sk, D,
                                   group, mask_kind, window, scale, vec,
                                   reverse, stream)
               : launch<kDp, false>(q, k, v, o, BH, n_qtiles, Sq, Sk, D,
                                    group, mask_kind, window, scale, vec,
                                    reverse, stream);
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int BH, int n_qtiles, int Sq, int Sk, int D, int Dp,
                     int group, int mask_kind, int window, float scale,
                     int vec, int reverse, int split, cudaStream_t stream) {
  switch (Dp) {
    case 32:
      return launch_mode<32>(q, k, v, o, BH, n_qtiles, Sq, Sk, D, group,
                             mask_kind, window, scale, vec, reverse, split,
                             stream);
    case 64:
      return launch_mode<64>(q, k, v, o, BH, n_qtiles, Sq, Sk, D, group,
                             mask_kind, window, scale, vec, reverse, split,
                             stream);
    case 128:
      return launch_mode<128>(q, k, v, o, BH, n_qtiles, Sq, Sk, D, group,
                              mask_kind, window, scale, vec, reverse, split,
                              stream);
    default:
      return launch_mode<256>(q, k, v, o, BH, n_qtiles, Sq, Sk, D, group,
                              mask_kind, window, scale, vec, reverse, split,
                              stream);
  }
}

}  // namespace tc


}  // namespace

extern "C" {

// q (BH, Sq, D), k and v (BH / group, Sk, D), o (BH, Sq, D), all contiguous
// and of one type (is_bf16: bfloat16, else float32); mask_kind 0 none,
// 1 causal, 2 window.  D must be a multiple of 4 in [4, 256].  The launch
// geometry comes from the wrapper: n_qtiles tiles of 64 queries (launched
// last tile first when reverse is set); for bfloat16, Dp is D padded to 32,
// 64, 128 or 256, vec the bytes of one asynchronous copy (16, 8 or 4,
// dividing the row and every pointer; 0: plain loads), and split chooses
// the CTA's two warp groups to split the kv tiles of one q head (else they
// take two q heads of one kv head: group and BH even).
int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                               void* o, int BH, int Sq, int Sk, int D,
                               int group, int mask_kind, int window,
                               float scale, int is_bf16, int n_qtiles, int Dp,
                               int vec, int reverse, int split,
                               cudaStream_t stream) {
  if (D < 4 || D > kMaxD || D % 4 != 0 || group < 1 || BH % group != 0 ||
      mask_kind < 0 || mask_kind > 2 || n_qtiles != (Sq + kBQ - 1) / kBQ)
    return static_cast<int>(cudaErrorInvalidValue);
  if (BH == 0 || Sq == 0) return static_cast<int>(cudaGetLastError());
  if (!is_bf16)
    return static_cast<int>(dispatch_simt(q, k, v, o, BH, n_qtiles, Sq, Sk,
                                          D, group, mask_kind, window, scale,
                                          reverse, stream));
  if ((Dp != 32 && Dp != 64 && Dp != 128 && Dp != 256) || Dp < D ||
      (vec != 0 && vec != 4 && vec != 8 && vec != 16) ||
      (vec != 0 && (2 * D) % vec != 0) || (!split && group % 2 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(tc::dispatch(q, k, v, o, BH, n_qtiles, Sq, Sk, D,
                                       Dp, group, mask_kind, window, scale,
                                       vec, reverse, split, stream));
}

}  // extern "C"
