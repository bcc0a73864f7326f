// Mamba2 SSD (state-space duality) chunked scan for Hopper (sm_90a),
// float32 or bfloat16 x / B / C, float32 dt, A and outputs.
//
// Replaces the Pallas kernel of src/repro/kernels/ssd_scan/ssd_scan.py
// (`ssd_scan_fwd`, body `_kernel`): for every (batch, head) row bh, with
// b = bh / heads, the recurrence
//
//     h_t = h_{t-1} exp(dt_t A) + dt_t B_t x_t        y_t = C_t . h_t
//
// computed by chunks of Q steps (Mamba2's Alg. 1).  Within a chunk, with
// cum the cumulative sum of dt A from the chunk's start,
//
//     y_t = sum_{s <= t} exp(cum_t - cum_s) (C_t . B_s) dt_s x_s
//           + exp(cum_t) C_t . h_start
//     h_end = exp(cum_last) h_start
//             + sum_s exp(cum_last - cum_s) dt_s x_s B_s^T
//
// Design.  The TPU kernel walks a sequential chunk grid axis and carries
// the (P, N) state in VMEM scratch.  Here the chunks run in parallel, in
// Mamba2's own GPU decomposition of the chunked algorithm (arXiv:2405.21060,
// its SSD algorithm section; the bmm / chunk_state / state_passing /
// chunk_scan split): one call launches four kernels.
//
//   1. ssd_cb_kernel, per (batch, chunk, 64 x 64 tile at or below the
//      diagonal): CB = C . B^T, a (Q, Q) float32 tile shared by the batch
//      row's `heads` heads, computed once (B_ and C_ are (B, S, N)).
//   2. ssd_state_kernel, per (row, chunk): cum, the cumulative sum of dt A
//      (written for the others), and the chunk's local end state
//      sum_s exp(cum_last - cum_s) dt_s x_s B_s^T, a (P, N) tile.
//   3. ssd_pass_kernel, per (row, state element): the short pass over the
//      row's chunks h_start[c] = h_start[c-1] exp(cum_last[c-1]) +
//      local[c-1], written in place over the local states.
//   4. ssd_out_kernel, per (row, chunk, 64-row tile of t):
//      y = (L o CB) . (x dt) + exp(cum_t) (C_t . h_start).
//
// At mamba2-130m's forward (8 x 2048 tokens, 24 heads) that is 640, 1,536,
// 1,536 and 6,144 CTAs, where the sequential form had 192.
//
// Tensor cores.  Every product runs on the tensor cores as
// `mma.sync.m16n8k8` in TF32 with float32 accumulation.  A single
// TF32 pass keeps 10 mantissa bits (~5e-4 relative), far outside the
// scan's float32 bars, so an operand that is not exact in TF32 is split,
// a = a_hi + a_lo (both TF32, a_lo the rounded rest), and the product is
// a_lo b_hi + a_hi b_lo + a_hi b_hi (the dropped a_lo b_lo is ~2^-22 of
// it).  bfloat16 x, B and C are exact in TF32, so they are never split:
// C B^T on bfloat16 inputs is one pass, and every other bfloat16 product
// two; every float32 product takes three.  The operand staged in shared
// memory is float32 (rows padded so that the fragment loads are free of
// bank conflicts); dt is folded into L o CB, not into x, so x stays exact.
// Each warp owns a 16-row strip of a 64-column output tile (8 m16n8
// accumulators) and loads its fragments with the k index permuted (a
// thread's two k slots are adjacent), so that a k-contiguous operand row
// is read as float2.
//
// Decays.  cum is summed in float64 (one add per step, a trifle), and
// each exp(cum_t - cum_s) takes the float64 difference: a chunk's cum
// reaches |cum| ~ 200, where a float32 sum's rounding (in any order) moves
// exp(cum_t - cum_s) by ~1e-5 relative even for neighbouring t and s.
// The plain version's float32 cumsum has that error, so the kernels stay
// within a fraction of its own error from the float64 recurrence.
//
// Overflow.  exp(cum_t - cum_s) overflows to inf above the diagonal once a
// chunk's cumulative decay passes ~88 (mamba2-130m at Q = 256 reaches
// ~-180).  The kernel never evaluates exp there: it selects between the
// value and 0 (`s <= t ? exp(...) * g : 0`), and never multiplies by a 0/1
// mask; the padding of every staged tile is written as zeros, never left
// as whatever shared memory held.  A last chunk shorter than Q is simply
// shorter, which is what padding with dt = 0 computes.
//
// Bound.  The recurrence needs at least 4 P N operations per (token, head)
// (the state update and the readout, a multiply and an add each), 12.9
// GFLOP at mamba2-130m's forward: 0.026 ms at the TF32 tensor rate (495
// TFLOP/s).  One read of x, dt, B and C and one write of y and the state
// is 167 MB in bfloat16 (0.050 ms at 3.35 TB/s) and 226 MB in float32
// (0.067 ms), so the call is bound by bytes.  The decomposition adds the
// CB tiles (16.8 MB) and the states (50 MB written, read and rewritten,
// read again), most of which stay in the 50 MB L2.
//
// Interface: plain C, called through ctypes; the launcher returns
// cudaGetLastError() after each launch so the Python wrapper raises on a
// refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kT = 64;                  // rows of a tile (t, s or p)
constexpr int kP = 64;                  // x columns / state rows (padded)
constexpr int kN = 128;                 // state columns (padded)
constexpr int kMaxQ = 256;
// row strides (floats): 8 mod 32 where a fragment reads k as float2 along
// the row, 4 mod 32 where k runs down the rows
constexpr int kLdK = kN + 8;            // C, B^T and h tiles, k = n
constexpr int kLdM = kT + 8;            // masked decay tile [t][s], k = s
constexpr int kLdX = kP + 4;            // x tile [s][p], k = s
constexpr int kLdB = kN + 4;            // B tile [s][n], k = s
constexpr int kCbThreads = 128;
constexpr int kStateThreads = 256;
constexpr int kPassThreads = 256;
constexpr int kOutThreads = 128;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32, lo the rounded rest
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc (16 x 8 kNT) += A (16 x kdim) . B (kdim x 8 kNT), kdim a multiple of
// 8, on the tensor cores.  A's element (r, k) is a[r * lda + k] when kAK
// (k contiguous) and a[k * lda + r] otherwise; B's element (k, n) is
// b[n * ldb + k] when kBK and b[k * ldb + n] otherwise.  A split operand is
// taken in two TF32 parts (see the header); an unsplit one must be exact in
// TF32.  Lane (g, c) = (lane / 4, lane % 4) feeds the mma's k slots c and
// c + 4 with k0 + 2c and k0 + 2c + 1, a permutation of k that both
// operands share, so a k-contiguous row is read as one float2.
// Accumulator j holds rows g and g + 8, columns 8 j + 2c and 8 j + 2c + 1.
template <int kNT, bool kAK, bool kBK, bool kSplitA, bool kSplitB>
__device__ __forceinline__ void warp_mma(float (&acc)[kNT][4],
                                         const float* a, int lda,
                                         const float* b, int ldb, int kdim,
                                         int lane) {
  const int g = lane >> 2;
  const int c = lane & 3;
  for (int k0 = 0; k0 < kdim; k0 += 8) {
    const int k = k0 + 2 * c;
    float av[4];
    if constexpr (kAK) {
      const float2 r0 = *reinterpret_cast<const float2*>(a + g * lda + k);
      const float2 r1 =
          *reinterpret_cast<const float2*>(a + (g + 8) * lda + k);
      av[0] = r0.x;
      av[2] = r0.y;
      av[1] = r1.x;
      av[3] = r1.y;
    } else {
      av[0] = a[k * lda + g];
      av[2] = a[(k + 1) * lda + g];
      av[1] = a[k * lda + g + 8];
      av[3] = a[(k + 1) * lda + g + 8];
    }
    uint32_t ah[4], al[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (kSplitA) {
        split_tf32(av[e], ah[e], al[e]);
      } else {
        ah[e] = __float_as_uint(av[e]);
        al[e] = 0u;
      }
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int n = 8 * j + g;
      float b0, b1;
      if constexpr (kBK) {
        const float2 v = *reinterpret_cast<const float2*>(b + n * ldb + k);
        b0 = v.x;
        b1 = v.y;
      } else {
        b0 = b[k * ldb + n];
        b1 = b[(k + 1) * ldb + n];
      }
      uint32_t bh0, bh1, bl0 = 0u, bl1 = 0u;
      if constexpr (kSplitB) {
        split_tf32(b0, bh0, bl0);
        split_tf32(b1, bh1, bl1);
      } else {
        bh0 = __float_as_uint(b0);
        bh1 = __float_as_uint(b1);
      }
      if constexpr (kSplitA) mma_tf32(acc[j], al, bh0, bh1);
      if constexpr (kSplitB) mma_tf32(acc[j], ah, bl0, bl1);
      mma_tf32(acc[j], ah, bh0, bh1);
    }
  }
}

template <int kNT>
__device__ __forceinline__ void zero(float (&acc)[kNT][4]) {
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// the 16 bytes of `raw` as float32 values: 8 bfloat16 or 4 float32
__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    f[2 * e] = __uint_as_float(w[e] << 16);
    f[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[4]) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}

// tile[r * ld + c] <- src[r * cols + c] (times scale[r] when kScaled) for
// r < rows, c < cols; 0 elsewhere in [0, kRows) x [0, kCols).  kFull: cols
// == kCols and src 16-byte aligned, so each thread loads 16 bytes at a
// time, up to 8 loads in flight before their stores; otherwise one element
// a load.
template <int kThreads, int kRows, int kCols, bool kFull,
          bool kScaled = false, typename T>
__device__ __forceinline__ void stage(float* tile, int ld, const T* src,
                                      int rows, int cols, int tid,
                                      const float* scale = nullptr) {
  if constexpr (kFull) {
    constexpr int V = 16 / sizeof(T);
    constexpr int kPerRow = kCols / V;
    constexpr int kPer = kRows * kPerRow / kThreads;
    constexpr int kBatch = kPer < 8 ? kPer : 8;
    static_assert(kRows * kPerRow % kThreads == 0 && kPer % kBatch == 0,
                  "whole batches of 16-byte loads");
#pragma unroll
    for (int u0 = 0; u0 < kPer; u0 += kBatch) {
      uint4 raw[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int v = tid + (u0 + u) * kThreads;
        const int r = v / kPerRow;
        const int c = (v - r * kPerRow) * V;
        raw[u] = r < rows ? __ldg(reinterpret_cast<const uint4*>(
                                src + static_cast<size_t>(r) * kCols + c))
                          : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int v = tid + (u0 + u) * kThreads;
        const int r = v / kPerRow;
        const int c = (v - r * kPerRow) * V;
        float f[V];
        unpack(raw[u], f);
        if constexpr (kScaled) {
          const float sc = r < rows ? scale[r] : 0.f;
#pragma unroll
          for (int e = 0; e < V; ++e) f[e] *= sc;
        }
        float4* const dst = reinterpret_cast<float4*>(tile + r * ld + c);
#pragma unroll
        for (int e = 0; e < V / 4; ++e)
          dst[e] = make_float4(f[4 * e], f[4 * e + 1], f[4 * e + 2],
                               f[4 * e + 3]);
      }
    }
  } else {
    for (int e = tid; e < kRows * kCols; e += kThreads) {
      const int r = e / kCols;
      const int c = e - r * kCols;
      float v = 0.f;
      if (r < rows && c < cols) {
        v = to_float(src[static_cast<size_t>(r) * cols + c]);
        if constexpr (kScaled) v *= scale[r];
      }
      tile[r * ld + c] = v;
    }
  }
}

__host__ __device__ constexpr int round8(int v) { return (v + 7) / 8 * 8; }

// ---------------------------------------------------------------------------
// 1. CB = C . B^T per (batch, chunk), by 64 x 64 tiles at or below the
//    diagonal; cb is (Bb, nc, Qp, Qp), Qp = Q rounded up to 64
// ---------------------------------------------------------------------------
template <typename T, bool kFull>
__global__ void __launch_bounds__(kCbThreads, 3)
ssd_cb_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm,
              float* __restrict__ cb, int S, int N, int Q, int nc, int Qp) {
  constexpr bool kExact = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ float4 smem4[];
  float* const Cs = reinterpret_cast<float*>(smem4);   // (kT, kLdK) [t][n]
  float* const Bs = Cs + kT * kLdK;                    // (kT, kLdK) [s][n]
  const int bc = blockIdx.x;
  const int b = bc / nc;
  const int c = bc - b * nc;
  int i = 0, j = blockIdx.y;             // the tile (i, j), j <= i
  while (j > i) j -= ++i;
  const int c0 = c * Q;
  const int qn = min(Q, S - c0);
  const int t0 = i * kT;
  const int s0 = j * kT;
  if (t0 >= qn) return;                  // never read
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t row0 = static_cast<size_t>(b) * S + c0;
  stage<kCbThreads, kT, kN, kFull>(Cs, kLdK, Cm + (row0 + t0) * N, qn - t0,
                                   N, tid);
  stage<kCbThreads, kT, kN, kFull>(Bs, kLdK, Bm + (row0 + s0) * N, qn - s0,
                                   N, tid);
  __syncthreads();
  float acc[8][4];
  zero(acc);
  warp_mma<8, true, true, !kExact, !kExact>(acc, Cs + 16 * warp * kLdK, kLdK,
                                            Bs, kLdK, round8(N), lane);
  const int g = lane >> 2;
  const int cc = lane & 3;
  float* const out = cb + (static_cast<size_t>(bc) * Qp + t0 + 16 * warp + g)
                              * Qp + s0 + 2 * cc;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    *reinterpret_cast<float2*>(out + 8 * jj) =
        make_float2(acc[jj][0], acc[jj][1]);
    *reinterpret_cast<float2*>(out + 8 * static_cast<size_t>(Qp) + 8 * jj) =
        make_float2(acc[jj][2], acc[jj][3]);
  }
}

// cum[0 .. qn) = cumsum(dts * a) in float64, by warp 0: a sequential sum
// per lane over its stretch, then a warp scan of the stretches
__device__ __forceinline__ void chunk_cumsum(double* cum, const float* dts,
                                             float a, int qn, int lane) {
  const int per = (qn + 31) / 32;
  const int beg = min(lane * per, qn);
  const int end = min(beg + per, qn);
  double run = 0.0;
  for (int t = beg; t < end; ++t) {
    run += static_cast<double>(dts[t]) * a;
    cum[t] = run;
  }
  double inc = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += v;
  }
  double excl = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) excl = 0.0;
  for (int t = beg; t < end; ++t) cum[t] += excl;
}

// ---------------------------------------------------------------------------
// 2. per (row, chunk): cum -> cumg (BH, nc, Qp) float64, and the local end
//    state
//    sum_s exp(cum_last - cum_s) dt_s x_s B_s^T -> states (BH, nc, P, N)
// ---------------------------------------------------------------------------
template <typename T, bool kFull>
__global__ void __launch_bounds__(kStateThreads, 2)
ssd_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ Bm,
                 double* __restrict__ cumg, float* __restrict__ states, int S,
                 int P, int N, int Q, int heads, int nc, int Qp) {
  constexpr bool kExact = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ float4 smem4[];
  float* const Xs = reinterpret_cast<float*>(smem4);   // (kT, kLdX) [s][p]
  float* const Bs = Xs + kT * kLdX;                    // (kT, kLdB) [s][n]
  double* const cum = reinterpret_cast<double*>(Bs + kT * kLdB);  // (kMaxQ)
  float* const dts = reinterpret_cast<float*>(cum + kMaxQ);      // (kMaxQ)
  float* const w = dts + kMaxQ;                        // (kMaxQ)
  const int rc = blockIdx.x;
  const int bh = rc / nc;
  const int c = rc - bh * nc;
  const int b = bh / heads;
  const int c0 = c * Q;
  const int qn = min(Q, S - c0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int t = tid; t < qn; t += kStateThreads)
    dts[t] = dt[static_cast<size_t>(bh) * S + c0 + t];
  __syncthreads();
  if (warp == 0) chunk_cumsum(cum, dts, A[bh], qn, lane);
  __syncthreads();
  const double cum_last = cum[qn - 1];
  for (int t = tid; t < qn; t += kStateThreads) {
    cumg[static_cast<size_t>(rc) * Qp + t] = cum[t];
    w[t] = static_cast<float>(exp(cum_last - cum[t]) * dts[t]);
  }

  const int wm = warp & 3;               // state rows 16 wm ..
  const int wn = warp >> 2;              // state columns 64 wn ..
  float acc[8][4];
  zero(acc);
  const T* const xr = x + (static_cast<size_t>(bh) * S + c0) * P;
  const T* const br = Bm + (static_cast<size_t>(b) * S + c0) * N;
  for (int s0 = 0; s0 < qn; s0 += kT) {
    const int sn = min(kT, qn - s0);
    __syncthreads();                     // w ready, the last tile consumed
    stage<kStateThreads, kT, kP, kFull, true>(
        Xs, kLdX, xr + static_cast<size_t>(s0) * P, sn, P, tid, w + s0);
    stage<kStateThreads, kT, kN, kFull>(
        Bs, kLdB, br + static_cast<size_t>(s0) * N, sn, N, tid);
    __syncthreads();
    warp_mma<8, false, false, true, !kExact>(acc, Xs + 16 * wm, kLdX,
                                             Bs + 64 * wn, kLdB, round8(sn),
                                             lane);
  }
  const int g = lane >> 2;
  const int cc = lane & 3;
  float* const st = states + static_cast<size_t>(rc) * P * N;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = 16 * wm + g + (e >> 1) * 8;
      const int n = 64 * wn + 8 * jj + 2 * cc + (e & 1);
      if (p < P && n < N) st[p * N + n] = acc[jj][e];
    }
  }
}

// ---------------------------------------------------------------------------
// 3. per (row, V state elements): states[c] <- the state chunk c starts
//    from; the final state -> st_out (BH, P, N).  Four chunks' loads are in
//    flight before their stores; V = 4 takes 16 bytes a load (P N % 4 == 0).
// ---------------------------------------------------------------------------
template <int V>
struct Vec;
template <>
struct Vec<1> {
  using type = float;
  static __device__ __forceinline__ float zero() { return 0.f; }
  // a d + b
  static __device__ __forceinline__ float step(float a, float d, float b) {
    return a * d + b;
  }
};
template <>
struct Vec<4> {
  using type = float4;
  static __device__ __forceinline__ float4 zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ float4 step(float4 a, float d, float4 b) {
    return make_float4(a.x * d + b.x, a.y * d + b.y, a.z * d + b.z,
                       a.w * d + b.w);
  }
};

template <int V>
__global__ void __launch_bounds__(kPassThreads)
ssd_pass_kernel(const double* __restrict__ cumg, float* __restrict__ states,
                float* __restrict__ st_out, int S, int PN, int Q, int nc,
                int Qp, int blocks_per_row) {
  using Vt = typename Vec<V>::type;
  constexpr int kAhead = 4;
  const int bh = blockIdx.x / blocks_per_row;
  const int e = ((blockIdx.x - bh * blocks_per_row) * kPassThreads
                 + threadIdx.x) * V;
  if (e >= PN) return;
  Vt carry = Vec<V>::zero();
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
    Vt local[kAhead];
    float decay[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int c = c0 + u;
      if (c < nc) {
        const size_t rc = static_cast<size_t>(bh) * nc + c;
        local[u] = *reinterpret_cast<const Vt*>(states + rc * PN + e);
        decay[u] = static_cast<float>(
            exp(cumg[rc * Qp + min(Q, S - c * Q) - 1]));
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int c = c0 + u;
      if (c < nc) {
        const size_t rc = static_cast<size_t>(bh) * nc + c;
        *reinterpret_cast<Vt*>(states + rc * PN + e) = carry;
        carry = Vec<V>::step(carry, decay[u], local[u]);
      }
    }
  }
  *reinterpret_cast<Vt*>(st_out + static_cast<size_t>(bh) * PN + e) = carry;
}

// ---------------------------------------------------------------------------
// 4. per (row, chunk, 64-row tile of t): y
// ---------------------------------------------------------------------------
constexpr int kOutTile = 2 * kT * kLdK;  // phase 1: C and h tiles
static_assert(kT * kLdM + kT * kLdX <= kOutTile, "phase 2 fits phase 1");

template <typename T, bool kFull>
__global__ void __launch_bounds__(kOutThreads, 3)
ssd_out_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const T* __restrict__ Cm, const float* __restrict__ cb,
               const double* __restrict__ cumg,
               const float* __restrict__ states, float* __restrict__ y,
               int S, int P, int N, int Q, int heads, int nc, int Qp) {
  constexpr bool kExact = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  float* const Cs = smem;                // phase 1 (kT, kLdK) [t][n]
  float* const Hs = Cs + kT * kLdK;      // phase 1 (kT, kLdK) [p][n]
  float* const Ms = smem;                // phase 2 (kT, kLdM) [t][s]
  float* const Xs = Ms + kT * kLdM;      // phase 2 (kT, kLdX) [s][p]
  double* const cum = reinterpret_cast<double*>(smem + kOutTile);  // kMaxQ
  float* const dts = reinterpret_cast<float*>(cum + kMaxQ);        // kMaxQ
  const int rc = blockIdx.x;
  const int bh = rc / nc;
  const int c = rc - bh * nc;
  const int b = bh / heads;
  const int i = blockIdx.y;
  const int t0 = i * kT;
  const int c0 = c * Q;
  const int qn = min(Q, S - c0);
  if (t0 >= qn) return;
  const int tn = min(kT, qn - t0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int cc = lane & 3;
  const int t_end = t0 + tn;
  for (int t = tid; t < t_end; t += kOutThreads) {
    cum[t] = cumg[static_cast<size_t>(rc) * Qp + t];
    dts[t] = dt[static_cast<size_t>(bh) * S + c0 + t];
  }
  float acc[8][4];
  zero(acc);

  // carried state: exp(cum_t) C_t . h_start (h_start = 0 in chunk 0)
  if (c > 0) {
    const T* const cr = Cm + (static_cast<size_t>(b) * S + c0 + t0) * N;
    stage<kOutThreads, kT, kN, kFull>(Cs, kLdK, cr, tn, N, tid);
    const float* const hs = states + static_cast<size_t>(rc) * P * N;
    stage<kOutThreads, kT, kN, kFull>(Hs, kLdK, hs, P, N, tid);
    __syncthreads();
    warp_mma<8, true, true, !kExact, true>(acc, Cs + 16 * warp * kLdK, kLdK,
                                           Hs, kLdK, round8(N), lane);
    const int r0 = 16 * warp + g;
    const float d0 =
        r0 < tn ? static_cast<float>(exp(cum[t0 + r0])) : 0.f;
    const float d1 =
        r0 + 8 < tn ? static_cast<float>(exp(cum[t0 + r0 + 8])) : 0.f;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      acc[jj][0] *= d0;
      acc[jj][1] *= d0;
      acc[jj][2] *= d1;
      acc[jj][3] *= d1;
    }
  }

  // the tiles of s at or below the diagonal: (L o CB dt) . x
  const T* const xr = x + (static_cast<size_t>(bh) * S + c0) * P;
  const float* const cbr =
      cb + (static_cast<size_t>(b) * nc + c) * Qp * Qp;
  for (int j = 0; j <= i; ++j) {
    const int s0 = j * kT;
    const int sn = min(kT, qn - s0);
    __syncthreads();                     // cum staged; the last tiles used
    // L o CB dt, four s at a time (CB rows are 64-float aligned); select,
    // never mask-multiply: exp above the diagonal is inf
    constexpr int kGroups = kT * kT / 4 / kOutThreads;
    float4 g4[kGroups];
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const int e = tid + u * kOutThreads;
      const int t = e / (kT / 4);
      const int s = (e - t * (kT / 4)) * 4;
      g4[u] = (t < tn && s0 + s <= t0 + t)
                  ? __ldg(reinterpret_cast<const float4*>(
                        cbr + static_cast<size_t>(t0 + t) * Qp + s0 + s))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const int e = tid + u * kOutThreads;
      const int t = e / (kT / 4);
      const int s = (e - t * (kT / 4)) * 4;
      const int ts = t0 + t;
      const float g[4] = {g4[u].x, g4[u].y, g4[u].z, g4[u].w};
      float mv[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int ss = s0 + s + v;
        mv[v] = (t < tn && s + v < sn && ss <= ts)
                    ? expf(static_cast<float>(cum[ts] - cum[ss])) * g[v]
                          * dts[ss]
                    : 0.f;
      }
      *reinterpret_cast<float4*>(Ms + t * kLdM + s) =
          make_float4(mv[0], mv[1], mv[2], mv[3]);
    }
    stage<kOutThreads, kT, kP, kFull>(
        Xs, kLdX, xr + static_cast<size_t>(s0) * P, sn, P, tid);
    __syncthreads();
    warp_mma<8, true, false, true, !kExact>(acc, Ms + 16 * warp * kLdM, kLdM,
                                            Xs, kLdX, round8(sn), lane);
  }

  float* const yr = y + (static_cast<size_t>(bh) * S + c0 + t0) * P;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = 16 * warp + g + (e >> 1) * 8;
      const int p = 8 * jj + 2 * cc + (e & 1);
      if (t < tn && p < P) yr[static_cast<size_t>(t) * P + p] = acc[jj][e];
    }
  }
}

constexpr size_t kCbSmem = sizeof(float) * 2 * kT * kLdK;
constexpr size_t kStateSmem =
    sizeof(float) * (kT * kLdX + kT * kLdB + 2 * kMaxQ)
    + sizeof(double) * kMaxQ;
constexpr size_t kOutSmem =
    sizeof(float) * (kOutTile + kMaxQ) + sizeof(double) * kMaxQ;

template <typename T, bool kFull>
cudaError_t set_smem() {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_cb_kernel<T, kFull>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kCbSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_state_kernel<T, kFull>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kStateSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_out_kernel<T, kFull>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kOutSmem));
  return err;
}

template <typename T, bool kFull>
cudaError_t launch(const T* x, const float* dt, const float* A, const T* Bm,
                   const T* Cm, float* y, float* st, float* cb, double* cumg,
                   float* states, int BH, int S, int P, int N, int Q,
                   int heads, cudaStream_t stream) {
  cudaError_t err = set_smem<T, kFull>();
  if (err != cudaSuccess) return err;
  const int nc = S > 0 ? (S + Q - 1) / Q : 0;
  const int Qp = (Q + kT - 1) / kT * kT;
  const int n_tiles = Qp / kT;
  const int Bb = BH / heads;
  if (nc > 0) {
    ssd_cb_kernel<T, kFull><<<dim3(Bb * nc, n_tiles * (n_tiles + 1) / 2),
                              kCbThreads, kCbSmem, stream>>>(
        Bm, Cm, cb, S, N, Q, nc, Qp);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ssd_state_kernel<T, kFull><<<BH * nc, kStateThreads, kStateSmem,
                                 stream>>>(x, dt, A, Bm, cumg, states, S, P,
                                           N, Q, heads, nc, Qp);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const int PN = P * N;
  if (PN % 4 == 0) {
    const int per_row = (PN / 4 + kPassThreads - 1) / kPassThreads;
    ssd_pass_kernel<4><<<BH * per_row, kPassThreads, 0, stream>>>(
        cumg, states, st, S, PN, Q, nc, Qp, per_row);
  } else {
    const int per_row = (PN + kPassThreads - 1) / kPassThreads;
    ssd_pass_kernel<1><<<BH * per_row, kPassThreads, 0, stream>>>(
        cumg, states, st, S, PN, Q, nc, Qp, per_row);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (nc > 0) {
    ssd_out_kernel<T, kFull><<<dim3(BH * nc, n_tiles), kOutThreads,
                               kOutSmem, stream>>>(
        x, dt, Cm, cb, cumg, states, y, S, P, N, Q, heads, nc, Qp);
    err = cudaGetLastError();
  }
  return err;
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// the 16-byte loaders take rows of exactly the padded tiles (P = 64, N =
// 128) from 16-byte aligned arrays; other shapes load element by element
template <typename T>
cudaError_t dispatch(const void* x, const void* dt, const void* A,
                     const void* Bm, const void* Cm, void* y, void* st,
                     void* cb, void* cumg, void* states, int BH, int S, int P,
                     int N, int Q, int heads, cudaStream_t stream) {
  const bool full = P == kP && N == kN && aligned16(x) && aligned16(Bm)
                    && aligned16(Cm) && aligned16(states) && aligned16(cb);
  auto* run = full ? launch<T, true> : launch<T, false>;
  return run(static_cast<const T*>(x), static_cast<const float*>(dt),
             static_cast<const float*>(A), static_cast<const T*>(Bm),
             static_cast<const T*>(Cm), static_cast<float*>(y),
             static_cast<float*>(st), static_cast<float*>(cb),
             static_cast<double*>(cumg), static_cast<float*>(states), BH, S,
             P, N, Q, heads, stream);
}

template <typename T>
cudaError_t occupancy(int which, int* blocks) {
  cudaError_t err = set_smem<T, true>();
  if (err != cudaSuccess) return err;
  switch (which) {
    case 0:
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, ssd_cb_kernel<T, true>, kCbThreads, kCbSmem);
    case 1:
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, ssd_state_kernel<T, true>, kStateThreads, kStateSmem);
    case 2:
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, ssd_pass_kernel<4>, kPassThreads, 0);
    default:
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, ssd_out_kernel<T, true>, kOutThreads, kOutSmem);
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory (bytes) and CTAs per SM of kernel `which` (0 CB,
// 1 state, 2 pass, 3 out) for bfloat16 (is_bf16) or float32 inputs.
int ssd_scan_occupancy(int which, int is_bf16, int* smem, int* blocks) {
  static const size_t bytes[4] = {kCbSmem, kStateSmem, 0, kOutSmem};
  if (which < 0 || which > 3) return static_cast<int>(cudaErrorInvalidValue);
  *smem = static_cast<int>(bytes[which]);
  return static_cast<int>(is_bf16 ? occupancy<__nv_bfloat16>(which, blocks)
                                  : occupancy<float>(which, blocks));
}

// x (BH, S, P), dt (BH, S) float32, A (BH) float32, B and C (BH / heads, S,
// N), y (BH, S, P) float32, st (BH, P, N) float32, all contiguous; x, B and
// C of one type (is_bf16: bfloat16, else float32).  Scratch: cb (BH /
// heads, nc, Qp, Qp) and states (BH, nc, P, N) float32, cum (BH, nc, Qp)
// float64, with nc = ceil(S / Q) and Qp = Q rounded up to 64.
// 1 <= P <= 64, 1 <= N <= 128, 1 <= Q <= 256 (the chunk, at most S).
int ssd_scan_fwd_launch(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, void* y, void* st,
                        void* cb, void* cum, void* states, int BH, int S,
                        int P, int N, int Q, int heads, int is_bf16,
                        cudaStream_t stream) {
  if (P < 1 || P > kP || N < 1 || N > kN || heads < 1 ||
      BH % heads != 0 || S < 0 || (S > 0 && (Q < 1 || Q > S || Q > kMaxQ)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (BH == 0) return static_cast<int>(cudaGetLastError());
  if (S == 0) Q = 1;                     // no chunk: the pass writes zeros
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, st, cb, cum,
                                        states, BH, S, P, N, Q, heads, stream)
              : dispatch<float>(x, dt, A, Bm, Cm, y, st, cb, cum, states, BH,
                                S, P, N, Q, heads, stream);
  return static_cast<int>(err);
}

}  // extern "C"
