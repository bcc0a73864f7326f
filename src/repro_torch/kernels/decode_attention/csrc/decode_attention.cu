// Flash-decode attention for Hopper (sm_90a): one new token's G grouped
// q heads against a ring-buffer KV cache, float32 or bfloat16.
//
// Replaces the Pallas kernel of src/repro/kernels/decode_attention/
// decode_attention.py (`decode_attention_fwd`, body `_kernel`): for every
// (batch, kv head) row r and q head g of its group
//
//     o[r, g] = sum_j softmax_j(q[r, g] . k[r, j] * D^-1/2) v[r, j]
//
// over the cache slots j with valid[r, j] != 0.  K and V are taken in q's
// type (the reference's wrapper casts the cache to it); the output is in
// q's type.
//
// Design.  The TPU kernel walks a sequential grid axis over the cache and
// carries (m, l, acc) in VMEM scratch.  At decode shapes there are only a
// few (batch, kv head) rows (gemma3-1b at B = 4: 4 rows), so one CTA per
// row would leave most of the 132 SMs idle.  The cache is split instead:
//
//   * `decode_partial_kernel`: one warp per (row, split of whole 32-key
//     blocks, group of up to 4 q heads).  Lane j holds columns j, j + 32,
//     ... of q and of the float32 accumulator (the flash kernel's lane
//     layout: 8 columns a lane at D = 256).  A key's score is a partial
//     dot per lane and a butterfly sum; lane j keeps key j's score, so a
//     block's max and sum are warp shuffles.  Per block the running max m
//     and sum l are updated once, p = exp(s - m) is rounded to q's type
//     before the PV product and l sums the unrounded p, as the Pallas
//     kernel does.  Invalid slots get p = 0 by selection, so a split
//     without any valid slot ends with m = -1e30, l = 0, acc = 0.  K and V
//     rows are read where they lie in the (B, W, KH, D) cache (row r is kv
//     head r % kh of batch r / kh), coalesced across the lanes.
//   * `decode_combine_kernel`: per (row, q head, column), the splits'
//     partials merged with weights exp(m_i - max_i m_i); the output is
//     acc / max(l, 1e-30).
//
// Bound.  Decode is bound by bytes: each cache slot's K and V are read
// once (2 W D elements per row) for 4 D operations per (q head, slot).
// At gemma3-1b's decode shapes a call moves 2-4 MB, a microsecond at the
// card's memory rate, so two launches and the serial walk of each warp's
// 32 keys set its time.
//
// Interface: plain C, called through ctypes; the launcher returns
// cudaGetLastError() so the Python wrapper raises on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kG = 4;                   // q heads of a warp
constexpr int kBlock = 32;              // keys of a block (one per lane)
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// a value as q's type holds it
__device__ __forceinline__ float as_q(float x, float) { return x; }
__device__ __forceinline__ float as_q(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// kCols = ceil(D / 32) columns per lane
template <typename Tq, typename Tkv, int kCols>
__global__ void __launch_bounds__(32)
decode_partial_kernel(const Tq* __restrict__ q, const Tkv* __restrict__ k,
                      const Tkv* __restrict__ v,
                      const int* __restrict__ valid,
                      float* __restrict__ part, float* __restrict__ ml,
                      int G, int W, int D, int kh, int valid_stride,
                      int nsplit, int split_len, float scale) {
  const int row = blockIdx.x;
  const int split = blockIdx.y;
  const int g0 = blockIdx.z * kG;
  const int lane = threadIdx.x;
  const size_t kstride = static_cast<size_t>(kh) * D;
  const size_t kbase =
      (static_cast<size_t>(row / kh) * W * kh + row % kh) * D;
  const int* const vrow = valid + static_cast<size_t>(valid_stride) * row;

  float qr[kG][kCols];
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      qr[g][c] = (g0 + g < G && d < D)
                     ? to_float(q[(static_cast<size_t>(row) * G + g0 + g) * D + d])
                     : 0.f;
    }

  float m[kG], l[kG], acc[kG][kCols];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    m[g] = kNeg;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[g][c] = 0.f;
  }

  const int j_begin = split * split_len;
  const int j_end = min(W, j_begin + split_len);
  for (int k0 = j_begin; k0 < j_end; k0 += kBlock) {
    const int kn = min(kBlock, j_end - k0);
    // scores: lane jj ends up holding key k0 + jj's
    float sj[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) sj[g] = 0.f;
    for (int jj = 0; jj < kn; ++jj) {
      const Tkv* const kr = k + kbase + static_cast<size_t>(k0 + jj) * kstride;
      float kk[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = lane + 32 * c;
        kk[c] = d < D ? as_q(to_float(kr[d]), Tq()) : 0.f;
      }
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        float part_dot = 0.f;
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          part_dot = fmaf(qr[g][c], kk[c], part_dot);
        const float s = warp_sum(part_dot);
        if (lane == jj) sj[g] = s;
      }
    }
    const bool ok = lane < kn && vrow[k0 + lane] != 0;
    float pr[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const float sv = ok ? sj[g] * scale : kNeg;
      const float m_new = fmaxf(m[g], warp_max(sv));
      const float corr = expf(m[g] - m_new);
      const float p = ok ? expf(sv - m_new) : 0.f;
      l[g] = l[g] * corr + warp_sum(p);
      m[g] = m_new;
      pr[g] = as_q(p, Tq());
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[g][c] *= corr;
    }
    for (int jj = 0; jj < kn; ++jj) {
      const Tkv* const vr = v + kbase + static_cast<size_t>(k0 + jj) * kstride;
      float vv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < D ? as_q(to_float(vr[d]), Tq()) : 0.f;
      }
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const float pj = __shfl_sync(0xffffffffu, pr[g], jj);
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[g][c] = fmaf(pj, vv[c], acc[g][c]);
      }
    }
  }

#pragma unroll
  for (int g = 0; g < kG; ++g) {
    if (g0 + g >= G) continue;
    const size_t slot = (static_cast<size_t>(row) * nsplit + split) * G + g0 + g;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (d < D) part[slot * D + d] = acc[g][c];
    }
    if (lane == 0) {
      ml[slot * 2] = m[g];
      ml[slot * 2 + 1] = l[g];
    }
  }
}

template <typename Tq>
__global__ void __launch_bounds__(256)
decode_combine_kernel(const float* __restrict__ part,
                      const float* __restrict__ ml, Tq* __restrict__ o,
                      int G, int D, int nsplit) {
  const int row = blockIdx.x;
  for (int e = threadIdx.x; e < G * D; e += blockDim.x) {
    const int g = e / D;
    const int d = e - g * D;
    const size_t first = static_cast<size_t>(row) * nsplit * G + g;
    float mx = kNeg;
    for (int i = 0; i < nsplit; ++i)
      mx = fmaxf(mx, ml[(first + static_cast<size_t>(i) * G) * 2]);
    float l = 0.f, a = 0.f;
    for (int i = 0; i < nsplit; ++i) {
      const size_t slot = first + static_cast<size_t>(i) * G;
      const float w = expf(ml[slot * 2] - mx);
      l = fmaf(w, ml[slot * 2 + 1], l);
      a = fmaf(w, part[slot * D + d], a);
    }
    store(o + (static_cast<size_t>(row) * G + g) * D + d, a / fmaxf(l, 1e-30f));
  }
}

template <typename Tq, typename Tkv, int kCols>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* valid, float* part, float* ml, void* o,
                   int rows, int G, int W, int D, int kh, int valid_stride,
                   int nsplit, int split_len, float scale,
                   cudaStream_t stream) {
  const dim3 grid(rows, nsplit, (G + kG - 1) / kG);
  decode_partial_kernel<Tq, Tkv, kCols><<<grid, 32, 0, stream>>>(
      static_cast<const Tq*>(q), static_cast<const Tkv*>(k),
      static_cast<const Tkv*>(v), valid, part, ml, G, W, D, kh, valid_stride,
      nsplit, split_len, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<Tq><<<rows, 256, 0, stream>>>(
      part, ml, static_cast<Tq*>(o), G, D, nsplit);
  return cudaGetLastError();
}

template <typename Tq, typename Tkv>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const int* valid, float* part, float* ml, void* o,
                     int rows, int G, int W, int D, int kh, int valid_stride,
                     int nsplit, int split_len, float scale,
                     cudaStream_t stream) {
  if (D <= 64)
    return launch<Tq, Tkv, 2>(q, k, v, valid, part, ml, o, rows, G, W, D, kh,
                              valid_stride, nsplit, split_len, scale, stream);
  if (D <= 128)
    return launch<Tq, Tkv, 4>(q, k, v, valid, part, ml, o, rows, G, W, D, kh,
                              valid_stride, nsplit, split_len, scale, stream);
  return launch<Tq, Tkv, 8>(q, k, v, valid, part, ml, o, rows, G, W, D, kh,
                            valid_stride, nsplit, split_len, scale, stream);
}

}  // namespace

extern "C" {

// q (rows, G, D); k and v: row r's key j at ((r / kh) * W * kh + r % kh +
// j * kh) * D, i.e. a (rows / kh, W, kh, D) cache (kh = 1: (rows, W, D));
// valid: row r's slot j at valid[r * valid_stride + j] (int32, stride 0
// shares one row); part (rows, nsplit, G, D) and ml (rows, nsplit, G, 2)
// float32 scratch; o (rows, G, D) of q's type.  Splits of split_len keys
// (a multiple of 32) cover the W slots.  1 <= D <= 256.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* valid, void* part, void* ml, void* o,
                            int rows, int G, int W, int D, int kh,
                            int valid_stride, int nsplit, int split_len,
                            float scale, int q_bf16, int kv_bf16,
                            cudaStream_t stream) {
  if (D < 1 || D > 256 || G < 1 || W < 1 || kh < 1 || rows % kh != 0 ||
      nsplit < 1 || split_len < 1 || split_len % kBlock != 0 ||
      static_cast<long long>(nsplit) * split_len < W ||
      static_cast<long long>(nsplit - 1) * split_len >= W)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  const int* vd = static_cast<const int*>(valid);
  float* pp = static_cast<float*>(part);
  float* mm = static_cast<float*>(ml);
  cudaError_t err;
  if (q_bf16)
    err = kv_bf16 ? dispatch<__nv_bfloat16, __nv_bfloat16>(
                        q, k, v, vd, pp, mm, o, rows, G, W, D, kh,
                        valid_stride, nsplit, split_len, scale, stream)
                  : dispatch<__nv_bfloat16, float>(
                        q, k, v, vd, pp, mm, o, rows, G, W, D, kh,
                        valid_stride, nsplit, split_len, scale, stream);
  else
    err = kv_bf16 ? dispatch<float, __nv_bfloat16>(
                        q, k, v, vd, pp, mm, o, rows, G, W, D, kh,
                        valid_stride, nsplit, split_len, scale, stream)
                  : dispatch<float, float>(q, k, v, vd, pp, mm, o, rows, G,
                                           W, D, kh, valid_stride, nsplit,
                                           split_len, scale, stream);
  return static_cast<int>(err);
}

}  // extern "C"
