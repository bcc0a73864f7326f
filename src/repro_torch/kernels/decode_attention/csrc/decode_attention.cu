// Flash-decode attention for Hopper (sm_90a): one new token's G grouped
// q heads against a ring-buffer KV cache, float32, bfloat16 or
// float8_e4m3fn.
//
// Replaces the Pallas kernel of src/repro/kernels/decode_attention/
// decode_attention.py (`decode_attention_fwd`, body `_kernel`): for every
// (batch, kv head) row r and q head g of its group
//
//     o[r, g] = sum_j softmax_j(q[r, g] . k[r, j] * D^-1/2) v[r, j]
//
// over the cache slots j with valid[r, j] != 0.  K and V are taken in q's
// type (the reference's wrapper casts the cache to it; a float8_e4m3fn
// element widens exactly, NaN staying NaN); scores are float32
// times D^-1/2; p = exp(s - m) is rounded to q's type before the PV product
// and l sums the unrounded p, as the Pallas kernel does; an invalid slot
// gets p = 0 by selection.  The output is acc / max(l, 1e-30) in q's type.
//
// Bound.  Decode is bound by bytes: each cache slot's K and V are read
// once (2 W D elements per row) for 4 D operations per (q head, slot).
// At the generation path's shapes (4 sequences, 1 kv head, D = 256; gemma3-1b
// 4 q heads over 512 or 1032 slots, recurrentgemma-9b 16 over 2048) a call
// moves 2-8 MB, one to a few microseconds at the card's memory rate, so
// what costs is the number of times each K and V row is read, the loads in
// flight, and the launches.
//
// Design.  The TPU kernel walks a sequential grid axis over the cache and
// carries (m, l, acc) in VMEM scratch.  At decode shapes there are only a
// few (batch, kv head) rows, so the cache is split instead, and the splits
// are merged by a second kernel:
//
//   * `decode_partial_kernel`: one CTA of 4 warps per (row, split of whole
//     64-key blocks, 16 q heads): every q head of a row with G <= 16, so
//     each K and V row is read once a call (G > 16 takes ceil(G / 16)
//     CTAs, each reading the split).  The split's K and V arrive by
//     `cp.async` (16-byte pieces where the rows and pointers allow) into a
//     two-stage ring of tiles, 64 keys for a bfloat16 cache and 32 for
//     float32; at the path's shapes a split is one tile, so all of its
//     loads are in flight at once.  With bfloat16 q, the scores of the 16
//     head rows (zero rows past G) against a tile are one tensor-core
//     product (`mma.sync.m16n8k16`, K by `ldmatrix` or, from a float32
//     cache, rounded to bfloat16 on the way), and so is P V (V by
//     `ldmatrix.trans`).  With float32 q, a thread owns a key and reads its
//     K row from shared memory, so no score needs a butterfly sum; P V runs
//     with a thread per column.  The running max and sum of each head live
//     with the 8 threads that take its softmax; the partial output and (m,
//     l) of each (row, split, head) go to float32 scratch.  A split without
//     any valid slot ends with m = -1e30, l = 0 and acc = 0.
//   * `decode_combine_kernel`: one CTA per (row, q head), a thread per
//     column: the splits' partials merged with weights exp(m_i - max_i m_i),
//     computed once per CTA by one warp while every column's partial loads
//     are in flight.  The output is acc / max(l, 1e-30).
//   * A float8_e4m3fn cache (internvl2's) is read as bytes, 4 to 16 at a
//     time, and each element is widened exactly to q's type as it is
//     stored into the shared-memory tile (`load_rows_fp8`): one byte per
//     element crosses device memory, half a bfloat16 cache's, and no
//     widened copy of the ring is ever written.  From the tile on, the
//     kernel is the one of a cache in q's type.  These loads are plain
//     (not `cp.async`): the tile's stores wait for them.
//
// Interface: plain C, called through ctypes; the launcher returns
// cudaGetLastError() so the Python wrapper raises on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kHeads = 16;              // q heads of one CTA
constexpr int kSplitKeys = 64;          // a split is whole blocks of these
constexpr int kThreads = 128;
constexpr float kNeg = -1e30f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// float8_e4m3fn bits (1 sign, 4 exponent of bias 7, 3 mantissa; no
// infinity, S.1111.111 NaN) as the float of the same value: exact
__device__ __forceinline__ float e4m3_to_float(uint32_t b) {
  const uint32_t sign = (b & 0x80u) << 24;
  const uint32_t em = b & 0x7fu;
  if (em == 0x7fu) return __uint_as_float(sign | 0x7fc00000u);   // NaN
  if (em < 8u) {                        // zero or subnormal: m 2^-9
    const float f = static_cast<float>(em) * 0.001953125f;
    return sign ? -f : f;
  }
  return __uint_as_float(sign | (((em >> 3) + 120u) << 23) |
                         ((em & 7u) << 20));
}

// the four float8 elements of a 32-bit word, widened into dst[0..3]
template <typename T>
__device__ __forceinline__ void widen4(T* dst, uint32_t w) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    dst[i] = from_float<T>(e4m3_to_float((w >> (8 * i)) & 0xffu));
}

// kRowsT float8 cache rows of D elements, row j at src + j * stride (rows
// >= n_rows zero-filled), widened into dst + j * kLd; vec = bytes per
// read (16, 8, 4; 0: one element at a time)
template <typename T, int kRowsT, int kLd>
__device__ __forceinline__ void load_rows_fp8(T* dst, const uint8_t* src,
                                              size_t stride, int n_rows,
                                              int D, int vec, int tid) {
  const int per = vec ? vec : 1;
  const int chunks = D / per;
  for (int c = tid; c < kRowsT * chunks; c += kThreads) {
    const int r = c / chunks;
    const int d = (c - r * chunks) * per;
    T* const out = dst + r * kLd + d;
    if (r >= n_rows) {
      for (int i = 0; i < per; ++i) out[i] = from_float<T>(0.f);
      continue;
    }
    const uint8_t* const s = src + r * stride + d;
    if (vec == 16) {
      const uint4 w = *reinterpret_cast<const uint4*>(s);
      widen4(out, w.x);
      widen4(out + 4, w.y);
      widen4(out + 8, w.z);
      widen4(out + 12, w.w);
    } else if (vec == 8) {
      const uint2 w = *reinterpret_cast<const uint2*>(s);
      widen4(out, w.x);
      widen4(out + 4, w.y);
    } else if (vec == 4) {
      widen4(out, *reinterpret_cast<const uint32_t*>(s));
    } else {
      out[0] = from_float<T>(e4m3_to_float(*s));
    }
  }
}

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

// kRowsT cache rows of D elements, row j at src + j * stride (rows >=
// n_rows zero-filled), into dst + j * kLd; vec = bytes per copy (16, 8, 4;
// 0: plain loads).  Rows of exactly kDp elements in 16-byte copies (every
// model shape) take an unrolled path with constant offsets.
template <typename T, int kRowsT, int kLd, int kDp>
__device__ __forceinline__ void load_rows(T* dst, const T* src,
                                          size_t stride, const T* any,
                                          int n_rows, int D, int vec,
                                          int tid) {
  if (D == kDp && vec == 16) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));
    constexpr int kChunks = kDp / kPer;  // 16-byte copies a row
    static_assert((kRowsT * kChunks) % kThreads == 0, "whole rounds");
#pragma unroll
    for (int i = 0; i < kRowsT * kChunks / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / kChunks;
      const int d = (c % kChunks) * kPer;
      const bool in = r < n_rows;
      cp_async<16>(smem_addr(dst + r * kLd + d),
                   in ? src + r * stride + d : any, in ? 16 : 0);
    }
    return;
  }
  if (vec == 0) {
    for (int e = tid; e < kRowsT * D; e += kThreads) {
      const int r = e / D;
      const int d = e - r * D;
      dst[r * kLd + d] = r < n_rows ? src[r * stride + d] : from_float<T>(0.f);
    }
    return;
  }
  const int per = vec / static_cast<int>(sizeof(T));
  const int chunks = D / per;
  for (int c = tid; c < kRowsT * chunks; c += kThreads) {
    const int r = c / chunks;
    const int d = (c - r * chunks) * per;
    const bool in = r < n_rows;
    const T* s = in ? src + r * stride + d : any;
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

// two consecutive elements as a packed bf16 pair (rounded from float32)
__device__ __forceinline__ uint32_t pair_bf16(const float* p) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  return pack_bf16(x.x, x.y);
}

// Shared memory of one CTA; rows padded by 16 bytes (ldmatrix and float4
// reads of 8 rows fall on distinct banks)
template <typename Tq, typename Tkv, int kDp>
struct Layout {
  static constexpr int kTK = sizeof(Tkv) == 2 ? 64 : 32;  // keys a tile
  static constexpr int kLdQ = kDp + 16 / static_cast<int>(sizeof(Tq));
  static constexpr int kLdKV = kDp + 16 / static_cast<int>(sizeof(Tkv));
  static constexpr int kLdS = kTK + 4;
  static constexpr int kLdP = kTK + 16 / static_cast<int>(sizeof(Tq));
  static constexpr size_t kQ = sizeof(Tq) * kHeads * kLdQ;
  static constexpr size_t kKV = sizeof(Tkv) * kTK * kLdKV;   // one tile
  static constexpr size_t kS = sizeof(float) * kHeads * kLdS;
  static constexpr size_t kP = sizeof(Tq) * kHeads * kLdP;
  static constexpr size_t kBytes = kQ + 4 * kKV + kS + kP +
                                   sizeof(float) * kHeads;
};

// kDp: D padded to 64, 128 or 256; Tkv: the tiles' type; Tg: the cache's
// (Tkv, or uint8_t for float8_e4m3fn bits widened to Tkv = Tq)
template <typename Tq, typename Tkv, typename Tg, int kDp>
__global__ void __launch_bounds__(kThreads, 1)
decode_partial_kernel(const Tq* __restrict__ q, const Tg* __restrict__ k,
                      const Tg* __restrict__ v,
                      const int* __restrict__ valid,
                      float* __restrict__ part, float* __restrict__ ml,
                      int G, int W, int D, int kh, int valid_stride,
                      int nsplit, int split_len, float scale, int vec) {
  using L = Layout<Tq, Tkv, kDp>;
  constexpr int kTK = L::kTK;
  constexpr bool kMma = sizeof(Tq) == 2;
  constexpr bool kFp8 = std::is_same<Tg, uint8_t>::value;
  static_assert(!kFp8 || std::is_same<Tkv, Tq>::value,
                "a float8 cache widens to q's type");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tq* const Qs = reinterpret_cast<Tq*>(smem_raw);             // (16, kLdQ)
  Tkv* const Ks = reinterpret_cast<Tkv*>(smem_raw + L::kQ);   // 2 tiles
  Tkv* const Vs = reinterpret_cast<Tkv*>(smem_raw + L::kQ + 2 * L::kKV);
  float* const Ss =
      reinterpret_cast<float*>(smem_raw + L::kQ + 4 * L::kKV);  // (16, kLdS)
  Tq* const Ps = reinterpret_cast<Tq*>(smem_raw + L::kQ + 4 * L::kKV +
                                       L::kS);               // (16, kLdP)
  float* const corr_s = reinterpret_cast<float*>(
      smem_raw + L::kQ + 4 * L::kKV + L::kS + L::kP);        // (16,)

  const int row = blockIdx.x;
  const int split = blockIdx.y;
  const int h0 = blockIdx.z * kHeads;
  const int nh = min(kHeads, G - h0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t kstride = static_cast<size_t>(kh) * D;
  const size_t kbase =
      (static_cast<size_t>(row / kh) * W * kh + row % kh) * D;
  const int* const vrow = valid + static_cast<size_t>(valid_stride) * row;
  const int j_begin = split * split_len;
  const int j_end = min(W, j_begin + split_len);
  const int n_tiles = (j_end - j_begin + kTK - 1) / kTK;

  // zero the padded columns of the K and V ring once
  if (D < kDp) {
    const int pad = kDp - D;
    for (int e = tid; e < 4 * kTK * pad; e += kThreads) {
      const int r = e / pad;
      Ks[r * L::kLdKV + D + (e - r * pad)] = from_float<Tkv>(0.f);
    }
  }
  auto load_tile = [&](int j0, int stage) {
    const size_t off = kbase + static_cast<size_t>(j0) * kstride;
    if constexpr (kFp8) {
      load_rows_fp8<Tkv, kTK, L::kLdKV>(Ks + stage * kTK * L::kLdKV, k + off,
                                        kstride, j_end - j0, D, vec, tid);
      load_rows_fp8<Tkv, kTK, L::kLdKV>(Vs + stage * kTK * L::kLdKV, v + off,
                                        kstride, j_end - j0, D, vec, tid);
    } else {
      load_rows<Tkv, kTK, L::kLdKV, kDp>(Ks + stage * kTK * L::kLdKV,
                                         k + off, kstride, k, j_end - j0, D,
                                         vec, tid);
      load_rows<Tkv, kTK, L::kLdKV, kDp>(Vs + stage * kTK * L::kLdKV,
                                         v + off, kstride, v, j_end - j0, D,
                                         vec, tid);
    }
  };
  load_tile(j_begin, 0);
  cp_async_commit();
  // q heads h0 .. h0 + nh - 1 (zero rows and columns past them)
  for (int e = tid; e < kHeads * kDp; e += kThreads) {
    const int h = e / kDp;
    const int d = e - h * kDp;
    Qs[h * L::kLdQ + d] =
        (h < nh && d < D)
            ? q[(static_cast<size_t>(row) * G + h0 + h) * D + d]
            : from_float<Tq>(0.f);
  }

  // the softmax of head (tid >> 3) runs on 8 threads; its running max and
  // sum live in each of them
  const int sh = tid >> 3;
  const int sub = tid & 7;
  float m_run = kNeg, l_run = 0.f;

  // P V accumulators: mma layout (rows = heads) or a thread per column
  constexpr int kDT = kDp / 32;                  // n-tiles of a warp
  constexpr int kCols = (kDp + kThreads - 1) / kThreads;
  float acc[kMma ? kDT : kHeads][kMma ? 4 : kCols];
#pragma unroll
  for (int i = 0; i < (kMma ? kDT : kHeads); ++i)
#pragma unroll
    for (int e = 0; e < (kMma ? 4 : kCols); ++e) acc[i][e] = 0.f;

  const int g = lane >> 2;
  const int t4 = lane & 3;
  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = j_begin + it * kTK;
    const int stage = it & 1;
    if (it + 1 < n_tiles) load_tile(j0 + kTK, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const Tkv* const Kt = Ks + stage * kTK * L::kLdKV;
    const Tkv* const Vt = Vs + stage * kTK * L::kLdKV;

    // scores of the 16 heads against the tile's keys, times D^-1/2
    if constexpr (kMma) {
      constexpr int kKeysW = kTK / 4;            // keys of a warp
      float s[kKeysW / 8][4];
#pragma unroll
      for (int n = 0; n < kKeysW / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      const int kw = warp * kKeysW;
#pragma unroll
      for (int kk = 0; kk < kDp / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, smem_addr(Qs + (lane & 15) * L::kLdQ + kk * 16 +
                             (lane >> 4) * 8));
        if constexpr (sizeof(Tkv) == 2) {        // 16 keys: one ldmatrix
          uint32_t bk[4];
          ldsm_x4(bk, smem_addr(Kt + (kw + (lane & 7) + ((lane >> 4) << 3)) *
                                         L::kLdKV +
                                kk * 16 + ((lane >> 3) & 1) * 8));
          mma(s[0], a, bk[0], bk[1]);
          mma(s[1], a, bk[2], bk[3]);
        } else {                                 // 8 keys from float32
          const float* kr = reinterpret_cast<const float*>(Kt) +
                            (kw + g) * L::kLdKV + kk * 16 + 2 * t4;
          mma(s[0], a, pair_bf16(kr), pair_bf16(kr + 8));
        }
      }
#pragma unroll
      for (int n = 0; n < kKeysW / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          Ss[(g + (e >> 1) * 8) * L::kLdS + kw + n * 8 + 2 * t4 + (e & 1)] =
              s[n][e] * scale;
    } else {
      // a thread per key, kTK / 8 heads each
      constexpr int kHP = kHeads * kTK / kThreads;
      const int j = tid % kTK;
      const int hb = (tid / kTK) * kHP;
      float s[kHP];
#pragma unroll
      for (int h = 0; h < kHP; ++h) s[h] = 0.f;
      const Tkv* const kr = Kt + j * L::kLdKV;
#pragma unroll 4
      for (int d = 0; d < kDp; d += 4) {
        float kv4[4];
        if constexpr (sizeof(Tkv) == 4) {
          const float4 x = *reinterpret_cast<const float4*>(kr + d);
          kv4[0] = x.x; kv4[1] = x.y; kv4[2] = x.z; kv4[3] = x.w;
        } else {
          const uint2 x = *reinterpret_cast<const uint2*>(kr + d);
          using bf162 = __nv_bfloat162;
          const bf162 lo = *reinterpret_cast<const bf162*>(&x.x);
          const bf162 hi = *reinterpret_cast<const bf162*>(&x.y);
          kv4[0] = __low2float(lo); kv4[1] = __high2float(lo);
          kv4[2] = __low2float(hi); kv4[3] = __high2float(hi);
        }
#pragma unroll
        for (int h = 0; h < kHP; ++h) {
          const float4 qq = *reinterpret_cast<const float4*>(
              reinterpret_cast<const float*>(Qs) + (hb + h) * L::kLdQ + d);
          s[h] = fmaf(qq.x, kv4[0], s[h]);
          s[h] = fmaf(qq.y, kv4[1], s[h]);
          s[h] = fmaf(qq.z, kv4[2], s[h]);
          s[h] = fmaf(qq.w, kv4[3], s[h]);
        }
      }
#pragma unroll
      for (int h = 0; h < kHP; ++h) Ss[(hb + h) * L::kLdS + j] = s[h] * scale;
    }
    __syncthreads();

    // online softmax of head sh over the tile: invalid slots (and keys
    // past the split) score -1e30 and get p = 0 by selection
    {
      constexpr int kPer = kTK / 8;
      float sv[kPer];
      bool ok[kPer];
      float mx = kNeg;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int jj = sub + 8 * i;
        const int j = j0 + jj;
        ok[i] = j < j_end && vrow[j] != 0;
        sv[i] = ok[i] ? Ss[sh * L::kLdS + jj] : kNeg;
        mx = fmaxf(mx, sv[i]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run, mx);
      const float corr = expf(m_run - m_new);
      float ps = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const float p = ok[i] ? expf(sv[i] - m_new) : 0.f;
        ps += p;
        Ps[sh * L::kLdP + sub + 8 * i] = from_float<Tq>(p);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l_run = l_run * corr + ps;
      m_run = m_new;
      if (sub == 0) corr_s[sh] = corr;
    }
    __syncthreads();

    // acc = acc * corr + P V
    if constexpr (kMma) {
      const float c0 = corr_s[g];
      const float c1 = corr_s[g + 8];
#pragma unroll
      for (int n = 0; n < kDT; ++n) {
        acc[n][0] *= c0;
        acc[n][1] *= c0;
        acc[n][2] *= c1;
        acc[n][3] *= c1;
      }
      const int dw = warp * (kDp / 4);           // this warp's columns
#pragma unroll
      for (int jk = 0; jk < kTK / 16; ++jk) {
        uint32_t pa[4];
        ldsm_x4(pa, smem_addr(Ps + (lane & 15) * L::kLdP + jk * 16 +
                              (lane >> 4) * 8));
#pragma unroll
        for (int dp = 0; dp < kDT / 2; ++dp) {
          if constexpr (sizeof(Tkv) == 2) {
            uint32_t bv[4];
            ldsm_x4_t(bv, smem_addr(Vt + (jk * 16 + (lane & 7) +
                                          (((lane >> 3) & 1) << 3)) *
                                             L::kLdKV +
                                    dw + dp * 16 + (lane >> 4) * 8));
            mma(acc[2 * dp], pa, bv[0], bv[1]);
            mma(acc[2 * dp + 1], pa, bv[2], bv[3]);
          } else {
            const float* vf = reinterpret_cast<const float*>(Vt);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float* c =
                  vf + (jk * 16 + 2 * t4) * L::kLdKV + dw + dp * 16 + h * 8 + g;
              mma(acc[2 * dp + h], pa, pack_bf16(c[0], c[L::kLdKV]),
                  pack_bf16(c[8 * L::kLdKV], c[9 * L::kLdKV]));
            }
          }
        }
      }
    } else {
      const float* const pf = reinterpret_cast<const float*>(Ps);
#pragma unroll
      for (int h = 0; h < kHeads; ++h) {
        const float c = corr_s[h];
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) acc[h][cc] *= c;
      }
      for (int j = 0; j < kTK; ++j) {
        float vv[kCols];
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) {
          const int d = tid + kThreads * cc;
          vv[cc] = d < kDp ? to_float(Vt[j * L::kLdKV + d]) : 0.f;
        }
#pragma unroll
        for (int h = 0; h < kHeads; ++h) {
          const float p = pf[h * L::kLdP + j];
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc)
            acc[h][cc] = fmaf(p, vv[cc], acc[h][cc]);
        }
      }
    }
    __syncthreads();                    // stage and S, P free again
  }

  // this split's partial output and (m, l) of each head
  const size_t slot0 = (static_cast<size_t>(row) * nsplit + split) * G + h0;
  if (sub == 0 && sh < nh) {
    ml[(slot0 + sh) * 2] = m_run;
    ml[(slot0 + sh) * 2 + 1] = l_run;
  }
  if constexpr (kMma) {
    const int dw = warp * (kDp / 4);
#pragma unroll
    for (int n = 0; n < kDT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = g + (e >> 1) * 8;
        const int d = dw + n * 8 + 2 * t4 + (e & 1);
        if (h < nh && d < D) part[(slot0 + h) * D + d] = acc[n][e];
      }
  } else {
#pragma unroll
    for (int h = 0; h < kHeads; ++h)
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        const int d = tid + kThreads * cc;
        if (h < nh && d < D) part[(slot0 + h) * D + d] = acc[h][cc];
      }
  }
}

// one CTA per (row, q head), a thread per column (D <= blockDim): each
// column's partials of the first kBatch splits are loaded at once, while
// warp 0 turns the splits' (m, l) into weights exp(m_i - max m) and the
// merged l
template <typename Tq>
__global__ void __launch_bounds__(256)
decode_combine_kernel(const float* __restrict__ part,
                      const float* __restrict__ ml, Tq* __restrict__ o,
                      int G, int D, int nsplit) {
  constexpr int kBatch = 32;
  extern __shared__ float w_s[];        // (nsplit,) weights
  __shared__ float l_s;
  const int row = blockIdx.x / G;
  const int g = blockIdx.x - row * G;
  const size_t first = static_cast<size_t>(row) * nsplit * G + g;
  const size_t step = static_cast<size_t>(G) * D;
  const int d = threadIdx.x;
  const int lane = d & 31;
  const float* const pd = part + first * D + min(d, D - 1);
  float pv[kBatch];
#pragma unroll
  for (int i = 0; i < kBatch; ++i) pv[i] = i < nsplit ? pd[i * step] : 0.f;
  if (d < 32) {
    float mx = kNeg;
    for (int i = lane; i < nsplit; i += 32)
      mx = fmaxf(mx, ml[(first + static_cast<size_t>(i) * G) * 2]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float l = 0.f;
    for (int i = lane; i < nsplit; i += 32) {
      const size_t slot = first + static_cast<size_t>(i) * G;
      const float w = expf(ml[slot * 2] - mx);
      w_s[i] = w;
      l = fmaf(w, ml[slot * 2 + 1], l);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) l_s = l;
  }
  __syncthreads();
  float a = 0.f;
#pragma unroll
  for (int i = 0; i < kBatch; ++i)
    if (i < nsplit) a = fmaf(w_s[i], pv[i], a);
  for (int i = kBatch; i < nsplit; ++i) a = fmaf(w_s[i], pd[i * step], a);
  if (d < D)
    o[(static_cast<size_t>(row) * G + g) * D + d] =
        from_float<Tq>(a / fmaxf(l_s, 1e-30f));
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

template <typename Tq, typename Tkv, typename Tg, int kDp>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* valid, float* part, float* ml, void* o,
                   int rows, int G, int W, int D, int kh, int valid_stride,
                   int nsplit, int split_len, float scale, int vec,
                   cudaStream_t stream) {
  constexpr size_t smem = Layout<Tq, Tkv, kDp>::kBytes;
  auto* fn = decode_partial_kernel<Tq, Tkv, Tg, kDp>;
  static unsigned smem_set = 0;
  cudaError_t err = set_smem_once(fn, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(rows, nsplit, (G + kHeads - 1) / kHeads);
  fn<<<grid, kThreads, smem, stream>>>(
      static_cast<const Tq*>(q), static_cast<const Tg*>(k),
      static_cast<const Tg*>(v), valid, part, ml, G, W, D, kh, valid_stride,
      nsplit, split_len, scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<Tq>
      <<<rows * G, (D + 31) / 32 * 32, sizeof(float) * nsplit, stream>>>(
          part, ml, static_cast<Tq*>(o), G, D, nsplit);
  return cudaGetLastError();
}

template <typename Tq, typename Tkv, typename Tg = Tkv>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const int* valid, float* part, float* ml, void* o,
                     int rows, int G, int W, int D, int kh, int valid_stride,
                     int nsplit, int split_len, float scale, int vec,
                     cudaStream_t stream) {
  if (D <= 64)
    return launch<Tq, Tkv, Tg, 64>(q, k, v, valid, part, ml, o, rows, G, W, D,
                               kh, valid_stride, nsplit, split_len, scale,
                               vec, stream);
  if (D <= 128)
    return launch<Tq, Tkv, Tg, 128>(q, k, v, valid, part, ml, o, rows, G, W, D,
                                kh, valid_stride, nsplit, split_len, scale,
                                vec, stream);
  return launch<Tq, Tkv, Tg, 256>(q, k, v, valid, part, ml, o, rows, G, W, D, kh,
                              valid_stride, nsplit, split_len, scale, vec,
                              stream);
}

}  // namespace

extern "C" {

// q (rows, G, D); k and v: row r's key j at ((r / kh) * W * kh + r % kh +
// j * kh) * D, i.e. a (rows / kh, W, kh, D) cache (kh = 1: (rows, W, D));
// valid: row r's slot j at valid[r * valid_stride + j] (int32, stride 0
// shares one row); part (rows, nsplit, G, D) and ml (rows, nsplit, G, 2)
// float32 scratch; o (rows, G, D) of q's type.  Splits of split_len keys
// (a multiple of 64) cover the W slots.  1 <= D <= 256.  kv_type: the
// cache's type, 0 float32, 1 bfloat16, 2 float8_e4m3fn.  vec: bytes of one
// copy of the cache (16, 8 or 4, dividing a row of D elements and both
// cache pointers; 0: plain loads).
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* valid, void* part, void* ml, void* o,
                            int rows, int G, int W, int D, int kh,
                            int valid_stride, int nsplit, int split_len,
                            float scale, int q_bf16, int kv_type, int vec,
                            cudaStream_t stream) {
  if (kv_type < 0 || kv_type > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int kv_bytes = kv_type == 0 ? 4 : kv_type == 1 ? 2 : 1;
  if (D < 1 || D > 256 || G < 1 || W < 1 || kh < 1 || rows % kh != 0 ||
      nsplit < 1 || split_len < 1 || split_len % kSplitKeys != 0 ||
      static_cast<long long>(nsplit) * split_len < W ||
      static_cast<long long>(nsplit - 1) * split_len >= W ||
      (vec != 0 && vec != 4 && vec != 8 && vec != 16) ||
      (vec != 0 && (D * kv_bytes) % vec != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  const int* vd = static_cast<const int*>(valid);
  float* pp = static_cast<float*>(part);
  float* mm = static_cast<float*>(ml);
  cudaError_t err;
  if (kv_type == 2)
    err = q_bf16 ? dispatch<bf16, bf16, uint8_t>(q, k, v, vd, pp, mm, o,
                                                 rows, G, W, D, kh,
                                                 valid_stride, nsplit,
                                                 split_len, scale, vec,
                                                 stream)
                 : dispatch<float, float, uint8_t>(q, k, v, vd, pp, mm, o,
                                                   rows, G, W, D, kh,
                                                   valid_stride, nsplit,
                                                   split_len, scale, vec,
                                                   stream);
  else if (q_bf16)
    err = kv_type == 1 ? dispatch<bf16, bf16>(q, k, v, vd, pp, mm, o, rows, G, W,
                                         D, kh, valid_stride, nsplit,
                                         split_len, scale, vec, stream)
                  : dispatch<bf16, float>(q, k, v, vd, pp, mm, o, rows, G, W,
                                          D, kh, valid_stride, nsplit,
                                          split_len, scale, vec, stream);
  else
    err = kv_type == 1 ? dispatch<float, bf16>(q, k, v, vd, pp, mm, o, rows, G, W,
                                          D, kh, valid_stride, nsplit,
                                          split_len, scale, vec, stream)
                  : dispatch<float, float>(q, k, v, vd, pp, mm, o, rows, G, W,
                                           D, kh, valid_stride, nsplit,
                                           split_len, scale, vec, stream);
  return static_cast<int>(err);
}

}  // extern "C"
