// Flash attention forward for Hopper (sm_90a), float32 or bfloat16 inputs.
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
// never repeated in memory.
//
// Design.  The TPU kernel walks a sequential kv grid axis and carries the
// online-softmax state (m, l, acc) in VMEM scratch from one grid step to
// the next.  Here one CTA of 8 warps owns one (b, 64-query block) and
// loops over the kv blocks itself; nothing carries between CTAs.  The loop
// runs only over the kv band the mask can reach (causal: up to the block's
// last query; window: from its first query - window + 1), so fully masked
// blocks cost nothing, as `pl.when(live)` does.  Per 32-key block:
//
//   * the CTA stages K and V (as float32) in shared memory, K rows padded
//     to D + 4 floats so that 32 lanes reading 32 rows as float4 hit
//     distinct banks;
//   * warp w owns query rows w, w + 8, ..., w + 56 and lane j owns key j of
//     the block: each lane computes its 8 scores from float4 reads of Q
//     (broadcast) and K, so a row's max and sum are warp shuffles;
//   * the running max m and sum l of each row live in registers, as does
//     the float32 accumulator: lane j holds columns j, j + 32, ... of its
//     warp's 8 rows (8 x 8 floats at D = 256, 64 KB a CTA in registers
//     across 256 threads, not in shared memory);
//   * p = exp(s - m_new) is rounded to the input type before the PV
//     product, as the Pallas kernel casts p to v's dtype, and l sums the
//     unrounded p; a row divides by max(l, 1e-30) at the end.
//
// Masked scores are -1e30, as in the reference, so a block in which a row
// has no live key yet adds exp(0) terms that the next live key's
// correction exp(-1e30 - m) wipes out exactly, as in the Pallas kernel.
// The wrapper refuses inputs where some query row has no live key at all.
//
// Bound.  At the shapes of the model path (gemma3-1b: D = 256, S = 2048,
// window 512) attention is bound by operations: 4 * D flops per live
// (query, key) pair against one read of Q, K, V and one write of O.  This
// kernel runs its products on the FP32 cores from shared memory (no
// mma.sync, wgmma or TMA yet), so it sits well above the bf16 tensor-core
// bound; that is work for a later change.
//
// Interface: plain C, called through ctypes; the launcher returns
// cudaGetLastError() so the Python wrapper raises on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;                 // queries per CTA
constexpr int kBK = 32;                 // keys per block (one per lane)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kBQ / kWarps;     // query rows per warp
constexpr int kMaxD = 256;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// p as the PV product sees it: rounded to the input type
__device__ __forceinline__ float round_p(float p, float) { return p; }
__device__ __forceinline__ float round_p(float p, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

// kCols = ceil(D / 32) accumulator columns per lane
template <typename T, int kCols>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                 int D, int group, int mask_kind, int window, float scale) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int ld = D + 4;                 // padded row of Q and K (floats)
  float* const Qs = smem;               // (kBQ, ld)
  float* const Ks = Qs + kBQ * ld;      // (kBK, ld)
  float* const Vs = Ks + kBK * ld;      // (kBK, D)
  float* const Ps = Vs + kBK * D;       // (kBQ, kBK)

  const int b = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t q_base = static_cast<size_t>(b) * Sq * D;
  const size_t kv_base = static_cast<size_t>(b / group) * Sk * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D;
    const int d = e - r * D;
    const int qi = q0 + r;
    Qs[r * ld + d] =
        qi < Sq ? to_float(q[q_base + static_cast<size_t>(qi) * D + d]) : 0.f;
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
      Ks[r * ld + d] = in ? to_float(k[g]) : 0.f;
      Vs[r * D + d] = in ? to_float(v[g]) : 0.f;
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
      Ps[row * kBK + lane] = round_p(p, T());
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
    T* row = o + q_base + static_cast<size_t>(qi) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (d < D) store(row + d, acc[r][c] / den);
    }
  }
}

size_t smem_bytes(int D) {
  const int ld = D + 4;
  return sizeof(float) *
         (static_cast<size_t>(kBQ) * ld + static_cast<size_t>(kBK) * ld +
          static_cast<size_t>(kBK) * D + static_cast<size_t>(kBQ) * kBK);
}

template <typename T, int kCols>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int BH, int Sq, int Sk, int D, int group, int mask_kind,
                   int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  auto* fn = flash_fwd_kernel<T, kCols>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Sq + kBQ - 1) / kBQ);
  fn<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, D, group,
      mask_kind, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int BH, int Sq, int Sk, int D, int group, int mask_kind,
                     int window, float scale, cudaStream_t stream) {
  if (D <= 32)
    return launch<T, 1>(q, k, v, o, BH, Sq, Sk, D, group, mask_kind, window,
                        scale, stream);
  if (D <= 64)
    return launch<T, 2>(q, k, v, o, BH, Sq, Sk, D, group, mask_kind, window,
                        scale, stream);
  if (D <= 128)
    return launch<T, 4>(q, k, v, o, BH, Sq, Sk, D, group, mask_kind, window,
                        scale, stream);
  return launch<T, 8>(q, k, v, o, BH, Sq, Sk, D, group, mask_kind, window,
                      scale, stream);
}

}  // namespace

extern "C" {

// q (BH, Sq, D), k and v (BH / group, Sk, D), o (BH, Sq, D), all contiguous
// and of one type (is_bf16: bfloat16, else float32); mask_kind 0 none,
// 1 causal, 2 window.  D must be a multiple of 4 in [4, 256].
int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                               void* o, int BH, int Sq, int Sk, int D,
                               int group, int mask_kind, int window,
                               float scale, int is_bf16,
                               cudaStream_t stream) {
  if (D < 4 || D > kMaxD || D % 4 != 0 || group < 1 || BH % group != 0 ||
      mask_kind < 0 || mask_kind > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (BH == 0 || Sq == 0) return static_cast<int>(cudaGetLastError());
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, BH, Sq, Sk, D, group,
                                        mask_kind, window, scale, stream)
              : dispatch<float>(q, k, v, o, BH, Sq, Sk, D, group, mask_kind,
                                window, scale, stream);
  return static_cast<int>(err);
}

}  // extern "C"
