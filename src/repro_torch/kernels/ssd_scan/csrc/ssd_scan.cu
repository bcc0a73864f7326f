// Mamba2 SSD (state-space duality) chunked scan for Hopper (sm_90a),
// bfloat16 or float32 x / B / C, float32 dt, A and outputs.
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
// The TPU kernel walks a sequential chunk grid axis and carries the (P, N)
// state in VMEM scratch.  Here the chunks run in parallel.
//
// Bound.  The recurrence needs at least 4 P N operations per (token, head)
// (the state update and the readout, a multiply and an add each), 12.9
// GFLOP at mamba2-130m's forward.  One read of x, dt, B and C and one write
// of y and the state is 167 MB in bfloat16 (0.050 ms at 3.35 TB/s) and 226
// MB in float32 (0.067 ms): the call is bound by bytes.
//
// Decays (both designs).  cum is summed in float64 (one add per step, a
// trifle), and each exp(cum_t - cum_s) takes the float64 difference: a
// chunk's cum reaches |cum| ~ 200, where a float32 sum's rounding (in any
// order) moves exp(cum_t - cum_s) by ~1e-5 relative even for neighbouring t
// and s.  The plain version's float32 cumsum has that error, so the kernels
// stay within a fraction of its own error from the float64 recurrence.
// exp(cum_t - cum_s) overflows to inf above the diagonal once a chunk's
// cumulative decay passes ~88 (mamba2-130m at Q = 256 reaches ~-180): the
// kernels select between the value and 0 there and never multiply by a 0/1
// mask.  A last chunk shorter than Q is simply shorter, which is what
// padding with dt = 0 computes.
//
// ---------------------------------------------------------------------------
// bfloat16: `wgmma`, TMA and a chained state pass, one kernel a call
// ---------------------------------------------------------------------------
// ssd_wg_scan_kernel, persistent: one CTA an SM takes (row, chunk) units
// in chunk-major order from an atomic ticket, so every chunk's predecessor
// is an earlier unit.  Inside a chunk it works by 64-step tiles, each a sub-chunk: with r
// the last step of the tile before t's (cum_r = 0 for the first tile) and
// h_r the state after it,
//
//     y_t = exp(cum_t - cum_r) C_t . h_r
//           + sum_{s in t's tile, s <= t} exp(cum_t - cum_s) (C_t . B_s)
//             dt_s x_s
//     h_r' = exp(cum_r' - cum_r) h_r + sum_{s in the tile}
//            exp(cum_r' - cum_s) dt_s x_s B_s^T   (r' the tile's last step)
//
// so that C.B^T and the decay matrix are only taken on the four diagonal
// tiles, not the ten tiles at or below the diagonal of the chunk's form.
// Three warp groups share a unit's tiles:
//   * warp group 0, the producer and the states.  A unit ahead of its use,
//     warp 0 sums the unit's cum in float64 (8 steps a lane and a warp
//     scan) and forms w_s = exp(cum_r' - cum_s) dt_s and each tile's decay
//     exp(cum_r' - cum_r).  One thread issues every copy: the start state
//     (float32, one bulk copy) once the chunk's predecessor has published
//     it (a count per (row, chunk), acquire), the chunk's C (up to 256 t x
//     128 n) by TMA, and the tiles of x (64 s x 64 p) and B (64 s x 128 n)
//     into a three-stage ring that runs on across units (a full and an
//     empty mbarrier per stage), refilled as its stages free up.  The
//     group's products carry the state tile by tile as `wgmma` m64n128k16
//     on the decayed state, the A operand (x w)^T built in registers
//     (`ldmatrix.trans` of the x tile, times w, split in three bfloat16
//     parts) one k16 step while the last one's products run, B read from
//     the ring through an MN-major descriptor.  The state at each tile's
//     start goes to the consumer that owns the tile, in three bfloat16
//     parts in shared memory (one hand-over buffer); the chunk's end state
//     is published for the next chunk (each thread's stores, then its
//     release increment) or written as the final state.  The start states
//     cross memory once each way, in L2; x is read once for the states and
//     y.
//   * two consumer warp groups, y: consumer w owns t-tiles w and 3 - w.
//     Per tile: exp(cum_t - cum_r) C_t . h_r as `wgmma` with both operands
//     K-major in shared memory, then the tile's C.B^T the same way, L o CB
//     dt formed in registers (as FlashAttention-3 forms P) and split in
//     three bfloat16 register A operands against x read MN-major (never
//     copied transposed).  y is stored from registers.
// Units go out in order from a ticket (`sync[0]`), taken by a CTA that is
// running, never by blockIdx.x: the lowest unit not yet published is held by
// a resident CTA, its predecessor has published, and that CTA has
// published every earlier unit of its own, so it can always run, however
// few CTAs are resident at once (SMs held by another kernel or an SM
// limit).  A CTA that draws a ticket past the last unit stops.  A CTA
// draws its next ticket after its current unit's first tile, a tile before
// the ring needs it: the later the draw, the fewer units a busy CTA holds
// that an idle one could run (drawn a unit earlier, the prefill's 384
// units took 20% longer on an H100).
//
// Precision.  bfloat16 x, B and C are exact as bfloat16 operands, so C.B^T
// is one pass (float32 accumulation).  Every float32 operand (L o CB dt,
// (x w)^T, h_r) is split a = hi + mid + lo, three bfloat16 parts (24
// bits, float32's own; hi and mid truncated by a byte permute, lo
// rounded), each product three passes at the bfloat16 rate (1.5 TF32
// passes).  Two parts keep 16 bits: on the card phase's inputs (CPU
// emulation) that is 37% of the float32 bar against 1.4% for three.  The
// consumers take cum as float pairs (hi, lo) of the float64 sum, and each
// cum_t - cum_s from them (`dcum`): the float64 difference within two
// roundings of itself, never the float32 rounding of |cum|.  Rows past S
// and columns past P or N come back as zeros from the TMA unit; a tile's
// rows of the next chunk are selected away (w = 0, L = 0).  P and N must
// be multiples of 8 (16-byte TMA strides): the wrapper pads.
//
// ---------------------------------------------------------------------------
// float32: four chunk-parallel kernels in split TF32 (`mma.sync`)
// ---------------------------------------------------------------------------
// Mamba2's own GPU decomposition (arXiv:2405.21060, its SSD algorithm
// section): ssd_cb_kernel (C.B^T per batch row and chunk, by 64 x 64 tiles
// at or below the diagonal), ssd_state_kernel (cum and each chunk's local
// end state), ssd_pass_kernel (the start states, in place) and
// ssd_out_kernel (y per 64-row tile).  Every product is `mma.sync.m16n8k8`
// in TF32 with each operand split a = a_hi + a_lo (both TF32) and the
// product a_lo b_hi + a_hi b_lo + a_hi b_hi.  The model never runs float32;
// these kernels are kept as they were.
//
// Interface: plain C, called through ctypes; the launchers return
// cudaGetLastError() after each launch so the Python wrapper raises on a
// refused launch, or kEncodeFailed + the driver's CUresult when a tensor
// map cannot be encoded.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxQ = 256;

// cum[0 .. qn) = cumsum(dts * a) in float64, by one warp: a sequential sum
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

// ===========================================================================
// float32: the four split-TF32 kernels
// ===========================================================================
constexpr int kT = 64;                  // rows of a tile (t, s or p)
constexpr int kP = 64;                  // x columns / state rows (padded)
constexpr int kN = 128;                 // state columns (padded)
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
// 8, on the tensor cores, both operands split in two TF32 parts.  A's
// element (r, k) is a[r * lda + k] when kAK (k contiguous) and a[k * lda +
// r] otherwise; B's element (k, n) is b[n * ldb + k] when kBK and b[k * ldb
// + n] otherwise.  Lane (g, c) = (lane / 4, lane % 4) feeds the mma's k
// slots c and c + 4 with k0 + 2c and k0 + 2c + 1, a permutation of k that
// both operands share, so a k-contiguous row is read as one float2.
// Accumulator j holds rows g and g + 8, columns 8 j + 2c and 8 j + 2c + 1.
template <int kNT, bool kAK, bool kBK>
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
    for (int e = 0; e < 4; ++e) split_tf32(av[e], ah[e], al[e]);
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
      uint32_t bh0, bh1, bl0, bl1;
      split_tf32(b0, bh0, bl0);
      split_tf32(b1, bh1, bl1);
      mma_tf32(acc[j], al, bh0, bh1);
      mma_tf32(acc[j], ah, bl0, bl1);
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

// tile[r * ld + c] <- src[r * cols + c] (times scale[r] when kScaled) for
// r < rows, c < cols; 0 elsewhere in [0, kRows) x [0, kCols).  kFull: cols
// == kCols and src 16-byte aligned, so each thread loads 16 bytes at a
// time, up to 8 loads in flight before their stores; otherwise one element
// a load.
template <int kThreads, int kRows, int kCols, bool kFull,
          bool kScaled = false>
__device__ __forceinline__ void stage(float* tile, int ld, const float* src,
                                      int rows, int cols, int tid,
                                      const float* scale = nullptr) {
  if constexpr (kFull) {
    constexpr int kPerRow = kCols / 4;
    constexpr int kPer = kRows * kPerRow / kThreads;
    constexpr int kBatch = kPer < 8 ? kPer : 8;
    static_assert(kRows * kPerRow % kThreads == 0 && kPer % kBatch == 0,
                  "whole batches of 16-byte loads");
#pragma unroll
    for (int u0 = 0; u0 < kPer; u0 += kBatch) {
      float4 raw[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int v = tid + (u0 + u) * kThreads;
        const int r = v / kPerRow;
        const int c = (v - r * kPerRow) * 4;
        raw[u] = r < rows ? __ldg(reinterpret_cast<const float4*>(
                                src + static_cast<size_t>(r) * kCols + c))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int v = tid + (u0 + u) * kThreads;
        const int r = v / kPerRow;
        const int c = (v - r * kPerRow) * 4;
        float4 f = raw[u];
        if constexpr (kScaled) {
          const float sc = r < rows ? scale[r] : 0.f;
          f = make_float4(f.x * sc, f.y * sc, f.z * sc, f.w * sc);
        }
        *reinterpret_cast<float4*>(tile + r * ld + c) = f;
      }
    }
  } else {
    for (int e = tid; e < kRows * kCols; e += kThreads) {
      const int r = e / kCols;
      const int c = e - r * kCols;
      float v = 0.f;
      if (r < rows && c < cols) {
        v = src[static_cast<size_t>(r) * cols + c];
        if constexpr (kScaled) v *= scale[r];
      }
      tile[r * ld + c] = v;
    }
  }
}

__host__ __device__ constexpr int round8(int v) { return (v + 7) / 8 * 8; }

// 1. CB = C . B^T per (batch, chunk), by 64 x 64 tiles at or below the
//    diagonal; cb is (Bb, nc, Qp, Qp), Qp = Q rounded up to 64
template <bool kFull>
__global__ void __launch_bounds__(kCbThreads, 3)
ssd_cb_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
              float* __restrict__ cb, int S, int N, int Q, int nc, int Qp) {
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
  warp_mma<8, true, true>(acc, Cs + 16 * warp * kLdK, kLdK, Bs, kLdK,
                          round8(N), lane);
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

// 2. per (row, chunk): cum -> cumg (BH, nc, Qp) float64, and the local end
//    state sum_s exp(cum_last - cum_s) dt_s x_s B_s^T -> states (BH, nc, P,
//    N)
template <bool kFull>
__global__ void __launch_bounds__(kStateThreads, 2)
ssd_state_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 double* __restrict__ cumg, float* __restrict__ states, int S,
                 int P, int N, int Q, int heads, int nc, int Qp) {
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
  const float* const xr = x + (static_cast<size_t>(bh) * S + c0) * P;
  const float* const br = Bm + (static_cast<size_t>(b) * S + c0) * N;
  for (int s0 = 0; s0 < qn; s0 += kT) {
    const int sn = min(kT, qn - s0);
    __syncthreads();                     // w ready, the last tile consumed
    stage<kStateThreads, kT, kP, kFull, true>(
        Xs, kLdX, xr + static_cast<size_t>(s0) * P, sn, P, tid, w + s0);
    stage<kStateThreads, kT, kN, kFull>(
        Bs, kLdB, br + static_cast<size_t>(s0) * N, sn, N, tid);
    __syncthreads();
    warp_mma<8, false, false>(acc, Xs + 16 * wm, kLdX, Bs + 64 * wn, kLdB,
                              round8(sn), lane);
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

// 3. per (row, V state elements): states[c] <- the state chunk c starts
//    from; the final state -> st_out (BH, P, N).  Four chunks' loads are in
//    flight before their stores; V = 4 takes 16 bytes a load (P N % 4 == 0).
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

// 4. per (row, chunk, 64-row tile of t): y
constexpr int kOutTile = 2 * kT * kLdK;  // phase 1: C and h tiles
static_assert(kT * kLdM + kT * kLdX <= kOutTile, "phase 2 fits phase 1");

template <bool kFull>
__global__ void __launch_bounds__(kOutThreads, 3)
ssd_out_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ Cm, const float* __restrict__ cb,
               const double* __restrict__ cumg,
               const float* __restrict__ states, float* __restrict__ y,
               int S, int P, int N, int Q, int heads, int nc, int Qp) {
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
    const float* const cr = Cm + (static_cast<size_t>(b) * S + c0 + t0) * N;
    stage<kOutThreads, kT, kN, kFull>(Cs, kLdK, cr, tn, N, tid);
    const float* const hs = states + static_cast<size_t>(rc) * P * N;
    stage<kOutThreads, kT, kN, kFull>(Hs, kLdK, hs, P, N, tid);
    __syncthreads();
    warp_mma<8, true, true>(acc, Cs + 16 * warp * kLdK, kLdK, Hs, kLdK,
                            round8(N), lane);
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
  const float* const xr = x + (static_cast<size_t>(bh) * S + c0) * P;
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
      const float gv[4] = {g4[u].x, g4[u].y, g4[u].z, g4[u].w};
      float mv[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int ss = s0 + s + v;
        mv[v] = (t < tn && s + v < sn && ss <= ts)
                    ? expf(static_cast<float>(cum[ts] - cum[ss])) * gv[v]
                          * dts[ss]
                    : 0.f;
      }
      *reinterpret_cast<float4*>(Ms + t * kLdM + s) =
          make_float4(mv[0], mv[1], mv[2], mv[3]);
    }
    stage<kOutThreads, kT, kP, kFull>(
        Xs, kLdX, xr + static_cast<size_t>(s0) * P, sn, P, tid);
    __syncthreads();
    warp_mma<8, true, false>(acc, Ms + 16 * warp * kLdM, kLdM, Xs, kLdX,
                             round8(sn), lane);
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

template <bool kFull>
cudaError_t set_smem() {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_cb_kernel<kFull>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kCbSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_state_kernel<kFull>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kStateSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_out_kernel<kFull>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kOutSmem));
  return err;
}

template <bool kFull>
cudaError_t launch_f32(const float* x, const float* dt, const float* A,
                       const float* Bm, const float* Cm, float* y, float* st,
                       float* cb, double* cumg, float* states, int BH, int S,
                       int P, int N, int Q, int heads, cudaStream_t stream) {
  cudaError_t err = set_smem<kFull>();
  if (err != cudaSuccess) return err;
  const int nc = S > 0 ? (S + Q - 1) / Q : 0;
  const int Qp = (Q + kT - 1) / kT * kT;
  const int n_tiles = Qp / kT;
  const int Bb = BH / heads;
  if (nc > 0) {
    ssd_cb_kernel<kFull><<<dim3(Bb * nc, n_tiles * (n_tiles + 1) / 2),
                           kCbThreads, kCbSmem, stream>>>(Bm, Cm, cb, S, N, Q,
                                                          nc, Qp);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ssd_state_kernel<kFull><<<BH * nc, kStateThreads, kStateSmem, stream>>>(
        x, dt, A, Bm, cumg, states, S, P, N, Q, heads, nc, Qp);
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
    ssd_out_kernel<kFull><<<dim3(BH * nc, n_tiles), kOutThreads, kOutSmem,
                            stream>>>(x, dt, Cm, cb, cumg, states, y, S, P, N,
                                      Q, heads, nc, Qp);
    err = cudaGetLastError();
  }
  return err;
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// ===========================================================================
// bfloat16: wgmma, TMA rings, a chained state pass
// ===========================================================================
namespace hop {

constexpr int kGroup = 128;             // threads of a warp group
constexpr int kTile = 64;               // rows of a t or s tile
constexpr int kSlab = kTile * 128;      // 64 rows of 128 bytes (64 bf16)
constexpr int kMaxTiles = kMaxQ / kTile;
constexpr int kHSize = 64 * 128;        // floats of a (padded) start state
constexpr double kLog2e = 1.4426950408889634;

// an s-tile of a ring stage: x (64 s x 64 p), then B (64 s x 128 n) in two
// slabs of 64 columns; every slab 128-byte swizzled
constexpr int kXBytes = kSlab;
constexpr int kBBytes = 2 * kSlab;
constexpr int kStageBytes = kXBytes + kBBytes;

// A unit buffer (floats): cum log2(e) of each step as float pairs (hi,
// lo), dt, w (each step's weight in its tile's state), then each tile's
// reference (the cum of its last step, hi and lo) and its state's decay
// over the tile
constexpr int kLo = kMaxQ;
constexpr int kDt = 2 * kMaxQ;
constexpr int kW = 3 * kMaxQ;
constexpr int kRefHi = 4 * kMaxQ;
constexpr int kRefLo = kRefHi + kMaxTiles;
constexpr int kDecay = kRefLo + kMaxTiles;
constexpr int kUid = kDecay + kMaxTiles;   // the unit's ticket (an int)
// a multiple of 4 floats: the second buffer is read by 16-byte loads too
constexpr int kUnitFloats = (kUid + 1 + 3) / 4 * 4;
// the CTA's tickets, a ring of its next units (the loader runs at most
// kStages + 1 units ahead of the states)
constexpr int kTix = 8;

// the kernel: warp group 0 (the producer and the states) and two consumer
// warp groups; shared memory: a unit's C (256 t x 128 n in two slabs of 256
// rows), the start state's three bf16 parts (each 64 p x 128 n in two
// slabs), the start state as published (float32), the ring, two unit
// buffers (cum as float pairs, dt, w, the decay, the ticket), the
// mbarriers, the CTA's tickets
constexpr int kStages = 3;
constexpr int kThreads = 3 * kGroup;
constexpr int kCBytes = 2 * kMaxQ * 128;
constexpr int kHBytes = 3 * 2 * kSlab;
constexpr int kHStageBytes = 4 * kHSize;
constexpr size_t kSmem = kCBytes + kHBytes + kHStageBytes
                         + kStages * kStageBytes
                         + sizeof(float) * 2 * kUnitFloats
                         + 8 * (7 + 2 * kStages) + sizeof(int) * kTix
                         + 1024;
static_assert(kTix >= kStages + 2, "the ring of tickets outruns the loader");
static_assert(kSmem <= 232448, "fits a CTA's shared memory");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// one arrival that also expects `bytes` of TMA transactions
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// until the phase of parity `parity` has completed (no time limit: a trap
// on one would hold ptxas to the launch's register count)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// box (c0 column, c1 row, c2 outer) of `map` into shared memory at dst,
// completing its bytes on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(bar)
      : "memory");
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) from src into
// shared memory at dst, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kRegs));
}

// the kCount threads of named barrier kId
template <int kId, int kCount>
__device__ __forceinline__ void bar_sync() {
  asm volatile("bar.sync %0, %1;\n" :: "n"(kId), "n"(kCount) : "memory");
}

// this thread's shared-memory stores made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void red_release_add(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// until at most kPending committed groups are still in flight
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(kPending)
               : "memory");
}

// The compiler sees a wgmma read and write its registers when it is
// issued; these empty statements pin their reads and writes to after the
// wait.
template <int kN>
__device__ __forceinline__ void keep(float (&r)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

__device__ __forceinline__ void keep(uint32_t (&r)[3][4]) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[k][e]) :: "memory");
}

__device__ __forceinline__ void keep(uint32_t (&r)[3][4][4]) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        asm volatile("" : "+r"(r[k][i][e]) :: "memory");
}

// wgmma's shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

// d (64 x 64) = [d +] A B: A 64 x 16 and B^T 64 x 16 in shared memory,
// both K-major; d += A B where scale_d, else d = A B
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64) += A B: A 64 x 16 as bf16 fragments in registers, B 16 x 64
// in shared memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128) += A B: A 64 x 16 as bf16 fragments in registers, B 16 x
// 128 in shared memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// four 8 x 8 bf16 matrices at the rows whose addresses lanes 8 m .. 8 m + 7
// give, transposed: lane (g, c) receives, of matrix m, rows 2c and 2c + 1
// of column g (the first in the low half)
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// 2^x (ex2.approx: relative error ~2^-22; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (v0, v1) = hi + mid + lo, three bf16 pairs (v0 in the low halves), each
// the rest of the ones before: hi and mid its upper 16 bits (truncated: a
// byte permute, no conversion), lo rounded; the parts hold 24 bits, as
// float32 does
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const uint32_t b0 = __float_as_uint(v0);
  const uint32_t b1 = __float_as_uint(v1);
  hi = __byte_perm(b0, b1, 0x7632);
  const float r0 = v0 - __uint_as_float(b0 & 0xffff0000u);
  const float r1 = v1 - __uint_as_float(b1 & 0xffff0000u);
  const uint32_t c0 = __float_as_uint(r0);
  const uint32_t c1 = __float_as_uint(r1);
  mid = __byte_perm(c0, c1, 0x7632);
  lo = bits(__floats2bfloat162_rn(r0 - __uint_as_float(c0 & 0xffff0000u),
                                  r1 - __uint_as_float(c1 & 0xffff0000u)));
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return make_float2(__uint_as_float(v << 16),
                     __uint_as_float(v & 0xffff0000u));
}

// cum_t - cum_s (log2 units) from the float pairs (hi, lo) that hold each
// float64 cum: the hi parts' difference rounded once, the lo parts' added:
// within two roundings of the difference itself, never the float32
// rounding of |cum|
__device__ __forceinline__ float dcum(float ht, float lt, float hs,
                                      float ls) {
  return (ht - hs) + (lt - ls);
}

// Byte offset of 16-byte chunk `chunk` (of 8) of row r of a 128-byte-
// swizzled slab (the swizzle repeats every 8 rows of 128 bytes)
__device__ __forceinline__ uint32_t swz(int r, int chunk) {
  return static_cast<uint32_t>(r * 128 + ((chunk ^ (r & 7)) << 4));
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------
struct Unit {
  int row, b, c, c0, qn, nt;
};

// unit u: heads of one (batch row, chunk) consecutive, so that CTAs at
// work together share its B and C in L2
__device__ __forceinline__ Unit unit_of(int u, int S, int Q, int heads,
                                        int Bb) {
  Unit w;
  const int h = u % heads;
  const int bc = u / heads;
  w.b = bc % Bb;
  w.c = bc / Bb;
  w.row = w.b * heads + h;
  w.c0 = w.c * Q;
  w.qn = min(Q, S - w.c0);
  w.nt = (w.qn + kTile - 1) / kTile;
  return w;
}

// y_i += (L o C_i B_i^T dt) x_i for t-tile i's own steps: S by wgmma (C_i
// at ci, B_i at bi, both K-major), L o S dt in registers split in three
// bf16 A operands, x_i at xi read MN-major.  Select, never mask-multiply:
// exp above the diagonal is inf.
__device__ __forceinline__ void diagonal(
    float (&y)[32], float (&s)[32], uint32_t (&m)[3][4][4], uint32_t ci,
    uint32_t bi, uint32_t xi, const float* ub, int i, int qn, int warp,
    int g, int q4) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint32_t off = (kk & 3) * 32;          // 16 n of a 64-n slab
    wgmma_ss64(s, desc(ci + (kk >> 2) * (kCBytes / 2) + off, 16, 1024),
               desc(bi + (kk >> 2) * kSlab + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  keep(s);
  const int ta = kTile * i + 16 * warp + g;     // rows ta and ta + 8
  const float ha = ub[ta], la = ub[kLo + ta];
  const float hb = ub[ta + 8], lb = ub[kLo + ta + 8];
  const bool va = ta < qn;
  const bool vb = ta + 8 < qn;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int sc = kTile * i + 8 * jj + 2 * q4;
    const float2 hs = *reinterpret_cast<const float2*>(ub + sc);
    const float2 ls = *reinterpret_cast<const float2*>(ub + kLo + sc);
    const float2 d = *reinterpret_cast<const float2*>(ub + kDt + sc);
    const float v0 = va && sc <= ta
        ? ex2(dcum(ha, la, hs.x, ls.x)) * s[4 * jj] * d.x : 0.f;
    const float v1 = va && sc + 1 <= ta
        ? ex2(dcum(ha, la, hs.y, ls.y)) * s[4 * jj + 1] * d.y : 0.f;
    const float v2 = vb && sc <= ta + 8
        ? ex2(dcum(hb, lb, hs.x, ls.x)) * s[4 * jj + 2] * d.x : 0.f;
    const float v3 = vb && sc + 1 <= ta + 8
        ? ex2(dcum(hb, lb, hs.y, ls.y)) * s[4 * jj + 3] * d.y : 0.f;
    // accumulator columns 8 jj .. are A's k = 16 (jj / 2) + 8 (jj % 2) ..
    const int kk = jj >> 1;
    const int e = (jj & 1) * 2;
    split3(v0, v1, m[0][kk][e], m[1][kk][e], m[2][kk][e]);
    split3(v2, v3, m[0][kk][e + 1], m[1][kk][e + 1], m[2][kk][e + 1]);
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t dx = desc(xi + kk * 16 * 128, kSlab, 8 * 128);
    wgmma_rs64(y, m[2][kk], dx);
    wgmma_rs64(y, m[1][kk], dx);
    wgmma_rs64(y, m[0][kk], dx);
  }
  wgmma_commit();
  wgmma_wait<0>();
  keep(y);
  keep(m);
}

// y_i = exp(cum_t - cum_r) C_i . h: h the state at the end of step r (the
// last of tile i - 1, or before the chunk: cum_r = 0 for i = 0) in three
// bf16 parts at hb (64 p x 128 n each), C_i at ci, both K-major
__device__ __forceinline__ void boundary(float (&y)[32], uint32_t ci,
                                         uint32_t hb, const float* ub, int i,
                                         int warp, int g) {
  wgmma_fence();
#pragma unroll
  for (int part = 2; part >= 0; --part)
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      wgmma_ss64(y, desc(ci + (kk >> 2) * (kCBytes / 2) + off, 16, 1024),
                 desc(hb + (2 * part + (kk >> 2)) * kSlab + off, 16, 1024),
                 part < 2 || kk > 0);
    }
  wgmma_commit();
  wgmma_wait<0>();
  keep(y);
  const float hr = i > 0 ? ub[kRefHi + i - 1] : 0.f;
  const float lr = i > 0 ? ub[kRefLo + i - 1] : 0.f;
  const int ta = kTile * i + 16 * warp + g;
  const float ea = ex2(dcum(ub[ta], ub[kLo + ta], hr, lr));
  const float eb = ex2(dcum(ub[ta + 8], ub[kLo + ta + 8], hr, lr));
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    y[4 * jj] *= ea;
    y[4 * jj + 1] *= ea;
    y[4 * jj + 2] *= eb;
    y[4 * jj + 3] *= eb;
  }
}

// the consumer that owns t-tile i: consumer 0 tiles 0 and 3, consumer 1
// tiles 1 and 2, so that each reads the states handed to it in the order
// they are formed
__device__ __forceinline__ int owner(int i) {
  return i == 0 || i == 3 ? 0 : 1;
}

// A state in the accumulator layout of m64n128 (element 4 jj + 2 h + e is
// (p, n) = (p0 + 8 h, 8 jj + 2 q4 + e)) into the hand-over buffer at hb in
// three bf16 parts, K-major: [p][n], n in two 128-byte-swizzled slabs of
// 64, the parts 2 slabs apart
__device__ __forceinline__ void store_parts(const float (&acc)[64],
                                            unsigned char* hb, int p0,
                                            int q4) {
#pragma unroll
  for (int jj = 0; jj < 16; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + 8 * h;
      const int nn = 8 * jj + 2 * q4;
      uint32_t hi, mid, lo;
      split3(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1], hi, mid, lo);
      unsigned char* const dst =
          hb + (nn >> 6) * kSlab + swz(p, (nn & 63) >> 3) + (nn & 7) * 2;
      *reinterpret_cast<uint32_t*>(dst) = hi;
      *reinterpret_cast<uint32_t*>(dst + 2 * kSlab) = mid;
      *reinterpret_cast<uint32_t*>(dst + 4 * kSlab) = lo;
    }
}

// y (BH, S, P) float32 of tile i from the accumulator
__device__ __forceinline__ void store_y(const float (&acc)[32], float* y,
                                        const Unit& u, int S, int P, int i,
                                        int warp, int g, int q4) {
  const int ta = kTile * i + 16 * warp + g;
  float* const yr = y + (static_cast<size_t>(u.row) * S + u.c0) * P;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int p = 8 * jj + 2 * q4;
    if (p >= P) continue;                        // P even: p + 1 < P too
    if (ta < u.qn)
      *reinterpret_cast<float2*>(yr + static_cast<size_t>(ta) * P + p) =
          make_float2(acc[4 * jj], acc[4 * jj + 1]);
    if (ta + 8 < u.qn)
      *reinterpret_cast<float2*>(yr + static_cast<size_t>(ta + 8) * P + p) =
          make_float2(acc[4 * jj + 2], acc[4 * jj + 3]);
  }
}

// Persistent: each CTA takes its units one by one from the ticket sync[0]
// (chunk-major: every chunk's predecessor is an earlier unit), so the
// lowest unpublished unit can always run whichever CTAs are resident.
// Warp group 0: the producer and the states; 1 and 2: the y consumers.
// tx maps x (P, S, BH), tb and tc map B and C (N, S, Bb), boxes of 64 x
// 64; states (BH, nc, 64, 128) holds the start state of chunks 1 .. nc - 1,
// published here; st (BH, P, N) the final state; out (BH, S, P) y.
// sync[1 + bh nc + c] counts warp group 0's threads that have published
// states[bh, c]; all of sync 0 at launch.
__global__ void __launch_bounds__(kThreads, 1)
ssd_wg_scan_kernel(const __grid_constant__ CUtensorMap tx,
                   const __grid_constant__ CUtensorMap tb,
                   const __grid_constant__ CUtensorMap tc,
                   const float* __restrict__ dt, const float* __restrict__ A,
                   float* __restrict__ states, float* __restrict__ st,
                   float* __restrict__ out, unsigned* __restrict__ sync,
                   int BH, int S, int P, int N, int Q, int heads, int nc) {
  extern __shared__ __align__(1024) unsigned char smem_f[];
  const uint32_t raw = smem_addr(smem_f);
  const uint32_t sC = (raw + 1023u) & ~1023u;
  unsigned char* const gen = smem_f + (sC - raw);
  const uint32_t sH = sC + kCBytes;
  const uint32_t sHs = sH + kHBytes;
  const uint32_t sR = sHs + kHStageBytes;
  float* const hstage = reinterpret_cast<float*>(gen + kCBytes + kHBytes);
  // two unit buffers: cum log2(e) as float pairs (hi, lo), dt, w, decay
  float* const unit = reinterpret_cast<float*>(
      gen + kCBytes + kHBytes + kHStageBytes + kStages * kStageBytes);
  // the ticket of the CTA's unit held in unit buffer `buf`
  auto uid_of = [&](int buf) {
    return reinterpret_cast<const int*>(unit + buf * kUnitFloats)[kUid];
  };
  // mbarriers: the unit's C full and empty, its start state full and
  // empty, a handed-over state full (one a consumer) and empty, then of
  // each stage full and empty
  const uint32_t c_full = smem_addr(unit + 2 * kUnitFloats);
  const uint32_t c_empty = c_full + 8;
  const uint32_t h_full = c_empty + 8;
  const uint32_t h_empty = h_full + 8;
  const uint32_t hb_full = h_empty + 8;        // 2
  const uint32_t hb_empty = hb_full + 16;
  const uint32_t full = hb_empty + 8;
  const uint32_t empty = full + 8 * kStages;
  int* const tix = reinterpret_cast<int*>(unit + 2 * kUnitFloats)
                   + 2 * (7 + 2 * kStages);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int Bb = BH / heads;
  const int units = BH * nc;
  if (threadIdx.x == 0) {
    mbar_init(c_full, 1);
    mbar_init(c_empty, 12);                    // lane 0 of every warp
    mbar_init(h_full, 1);
    mbar_init(h_empty, 4);                     // lane 0 of warp group 0's
    mbar_init(hb_full, 1);
    mbar_init(hb_full + 8, 1);
    mbar_init(hb_empty, 4);                    // the reading consumer's
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);             // warp group 0's, the owner's
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // ---- warp group 0: the producer and the states ----
    const int tid = threadIdx.x;
    const int g = lane >> 2;
    const int q4 = lane & 3;
    // ldmatrix rows: lane l gives row l % 8 of matrix l / 8 (matrices: s
    // 0-7 / 8-15 of the k16 step by p 0-7 / 8-15 of this warp's 16 rows)
    const int lm = lane >> 3;
    const int ls = (lm >> 1) * 8 + (lane & 7);
    const int lchunk = 2 * warp + (lm & 1);
    const int p0 = 16 * warp + g;
    // Thread 0 alone: the tickets of the CTA's units, in order, unit k's
    // in slot k % kTix of a ring (rewritten only once the loader and the
    // states are past unit k).  `draw` sends the atomic for the next one on
    // its way; `ticket(k)` stores it, or draws at once, when unit k is
    // needed.  The draw comes as late as the ring's prefetch allows, so
    // that a CTA holds few units that another could take sooner.
    int taken = 0;                             // tickets stored
    bool drawn = false;                        // the next one in flight
    unsigned pend = 0;
    auto draw = [&]() {
      if (!drawn) pend = atomicAdd(sync, 1u);
      drawn = true;
    };
    auto ticket = [&](int k) {
      while (taken <= k) {
        draw();
        tix[taken % kTix] = static_cast<int>(pend);
        drawn = false;
        ++taken;
      }
      return tix[k % kTix];
    };
    // The next tile to load: the CTA's unit nl (`ul`; none once `ldone`),
    // its tile jl.  Loads it into its ring stage once every reader is done
    // with the stage.  The whole warp group waits (and reads a new unit's
    // ticket), one thread issues the copies.
    int nl = 0, jl = 0, it_load = 0;
    bool ldone = false;
    Unit ul{};
    auto load_next = [&]() {
      if (jl == 0) {
        if (tid == 0) ticket(nl);
        bar_sync<2, kGroup>();
        const int lid = tix[nl % kTix];
        ldone = lid >= units;
        if (!ldone) ul = unit_of(lid, S, Q, heads, Bb);
      }
      if (ldone) return;
      const int s = it_load % kStages;
      const uint32_t dst = sR + s * kStageBytes;
      mbar_wait(empty + 8 * s, ((it_load / kStages) & 1) ^ 1);
      if (tid == 0) {
        mbar_expect_tx(full + 8 * s, kStageBytes);
        tma_load(dst, &tx, 0, ul.c0 + kTile * jl, ul.row, full + 8 * s);
        tma_load(dst + kXBytes, &tb, 0, ul.c0 + kTile * jl, ul.b,
                 full + 8 * s);
        tma_load(dst + kXBytes + kSlab, &tb, 64, ul.c0 + kTile * jl, ul.b,
                 full + 8 * s);
      }
      ++it_load;
      if (++jl == ul.nt) {
        jl = 0;
        ++nl;
      }
    };
    // The unit's dt (8 steps a lane of warp 0; 0 past the chunk) and A,
    // fetched into registers well before `prepare` uses them
    float dnext[8];
    float anext = 0.f;
    auto fetch = [&](const Unit& u) {
      if (warp == 0) {
        const float* const dtr = dt + static_cast<size_t>(u.row) * S + u.c0;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int t = 8 * lane + k;
          dnext[k] = t < u.qn ? dtr[t] : 0.f;
        }
        anext = A[u.row];
      }
    };
    // The ticket of the CTA's next unit (warp 0), its dt fetched if there
    // is one
    int nid = units;
    auto next_unit = [&](int k) {
      if (warp == 0) {
        if (lane == 0) nid = ticket(k);
        nid = __shfl_sync(0xffffffffu, nid, 0);
        if (nid < units) fetch(unit_of(nid, S, Q, heads, Bb));
      }
    };
    // Into unit buffer `buf`: the next unit's ticket, and if there is such
    // a unit its cum (float64, a sequential sum per lane of warp 0 and a
    // warp scan) as float pairs, dt, w and the decay; then the whole group
    // reads the ticket
    auto prepare = [&](int buf) {
      if (warp == 0 && lane == 0)
        reinterpret_cast<int*>(unit + buf * kUnitFloats)[kUid] = nid;
      if (warp == 0 && nid < units) {
        double cs[8];
        double run = 0.0;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          run += static_cast<double>(dnext[k]) * anext;
          cs[k] = run;
        }
        double inc = run;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const double v = __shfl_up_sync(0xffffffffu, inc, off);
          if (lane >= off) inc += v;
        }
        double excl = __shfl_up_sync(0xffffffffu, inc, 1);
        if (lane == 0) excl = 0.0;
        // each tile's reference: the cum of its last step (lane 8 i + 7's
        // last; past the chunk cum stays flat, so a partial tile's is the
        // chunk's last step)
        const double end = (cs[7] + excl) * kLog2e;
        const double ref = __shfl_sync(0xffffffffu, end, lane | 7);
        float* const ub = unit + buf * kUnitFloats;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int t = 8 * lane + k;
          const double c2 = (cs[k] + excl) * kLog2e;
          const float hi = static_cast<float>(c2);
          ub[t] = hi;
          ub[kLo + t] = static_cast<float>(c2 - hi);
          ub[kDt + t] = dnext[k];
          // dt is 0 past the chunk, so w is too
          ub[kW + t] = ex2(static_cast<float>(ref - c2)) * dnext[k];
        }
        double prev = 0.0;
#pragma unroll
        for (int i = 0; i < kMaxTiles; ++i) {
          const double r = __shfl_sync(0xffffffffu, end, 8 * i + 7);
          if (lane == 0) {
            const float hi = static_cast<float>(r);
            ub[kRefHi + i] = hi;
            ub[kRefLo + i] = static_cast<float>(r - hi);
            ub[kDecay + i] = static_cast<float>(exp2(r - prev));
          }
          prev = r;
        }
      }
      bar_sync<2, kGroup>();
    };
    // the unit's start state once its chunk's predecessor has published it
    // and the last one has been read (unit n of the CTA)
    auto load_h = [&](const Unit& u, int n) {
      mbar_wait(h_empty, (n & 1) ^ 1);
      if (tid == 0) {
        if (u.c > 0) {
          const size_t rc = static_cast<size_t>(u.row) * nc + u.c;
          while (ld_acquire(sync + 1 + rc) < kGroup) {
          }
          asm volatile("fence.proxy.async.global;\n" ::: "memory");
          mbar_expect_tx(h_full, kHStageBytes);
          bulk_load(sHs, states + rc * kHSize, kHStageBytes, h_full);
        } else {
          mbar_arrive(h_full);
        }
      }
    };
    // the unit's C, once every reader is done with the last one
    auto load_c = [&](const Unit& u, int n) {
      mbar_wait(c_empty, (n & 1) ^ 1);
      if (tid == 0) {
        mbar_expect_tx(c_full, u.nt * 2 * kSlab);
        for (int i = 0; i < u.nt; ++i) {
          tma_load(sC + i * kSlab, &tc, 0, u.c0 + kTile * i, u.b, c_full);
          tma_load(sC + kCBytes / 2 + i * kSlab, &tc, 64, u.c0 + kTile * i,
                   u.b, c_full);
        }
      }
    };
    // Hand the state of the unit's t-tile i (its start) to the consumer
    // that owns the tile, once the last state handed over has been read
    int hk = 0;                                // states handed over
    auto hand_over = [&](const float (&acc)[64], int i) {
      mbar_wait(hb_empty, (hk & 1) ^ 1);
      store_parts(acc, gen + kCBytes, p0, q4);
      fence_async_smem();
      bar_sync<2, kGroup>();
      if (tid == 0) mbar_arrive(hb_full + 8 * owner(i));
      ++hk;
    };
    // the CTA's unit n from buffer n & 1 once prepared: its C, its start
    // state; past the last unit, the end for the consumers (c_full with no
    // bytes, once they are done with the last unit)
    auto issue = [&](int n) {
      const int id = uid_of(n & 1);
      if (id < units) {
        const Unit un = unit_of(id, S, Q, heads, Bb);
        load_c(un, n);
        load_h(un, n);
      } else {
        mbar_wait(c_empty, (n & 1) ^ 1);
        if (tid == 0) mbar_arrive(c_full);
      }
    };
    next_unit(0);
    prepare(0);
    issue(0);
    for (int k = 0; k < kStages; ++k) load_next();
    uint32_t a[2][3][4];
    int it = 0;                                // ring tiles consumed
    for (int n = 0;; ++n) {
      const int uid = uid_of(n & 1);
      if (uid >= units) break;
      const Unit u = unit_of(uid, S, Q, heads, Bb);
      const size_t rc = static_cast<size_t>(u.row) * nc + u.c;
      const float* const ub = unit + (n & 1) * kUnitFloats;
      mbar_wait(c_full, n & 1);
      mbar_wait(h_full, n & 1);
      // the state before the chunk, then after each tile: h_i = D_i h_{i-1}
      // + sum over tile i of w_s x_s B_s^T, w_s = exp(cum_r - cum_s) dt_s,
      // r the tile's last step, D_i = exp(cum_r - cum_r'), r' the last
      // tile's; accumulator element 4 jj + 2 h + e is (p, n) = (p0 + 8 h,
      // 8 jj + 2 q4 + e).  Every state a consumer reads is handed over in
      // three bf16 parts.
      float acc[64];
#pragma unroll
      for (int jj = 0; jj < 16; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2 v = make_float2(0.f, 0.f);
          if (u.c > 0)
            v = *reinterpret_cast<const float2*>(
                hstage + (p0 + 8 * h) * 128 + 8 * jj + 2 * q4);
          acc[4 * jj + 2 * h] = v.x;
          acc[4 * jj + 2 * h + 1] = v.y;
        }
      if (lane == 0) mbar_arrive(h_empty);
      hand_over(acc, 0);
      const float* const ws = ub + kW;
      for (int j = 0; j < u.nt; ++j, ++it) {
        const int s = it % kStages;
        const uint32_t xs = sR + s * kStageBytes;
        const uint32_t bs = xs + kXBytes;
        const float dj = ub[kDecay + j];
#pragma unroll
        for (int e = 0; e < 64; ++e) acc[e] *= dj;
        mbar_wait(full + 8 * s, (it / kStages) & 1);
        // A = (x w)^T: rows p (this warp's 16), k = s, in three bf16 parts,
        // built for one k16 step while the last one's products run
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t r[4];
          ldsm_x4_trans(xs + swz(16 * kk + ls, lchunk), r);
          uint32_t (&ak)[3][4] = a[kk & 1];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int sl = kTile * j + 16 * kk + 8 * (e >> 1) + 2 * q4;
            const float2 v = unpack_bf16(r[e]);
            split3(v.x * ws[sl], v.y * ws[sl + 1], ak[0][e], ak[1][e],
                   ak[2][e]);
          }
          wgmma_fence();
          // B (s x n, n contiguous): 16 s rows of both slabs
          const uint64_t db = desc(bs + kk * 16 * 128, kSlab, 8 * 128);
          wgmma_rs128(acc, ak[2], db);
          wgmma_rs128(acc, ak[1], db);
          wgmma_rs128(acc, ak[0], db);
          wgmma_commit();
          wgmma_wait<1>();                     // the last step's are done
          keep(a[(kk + 1) & 1]);
        }
        wgmma_wait<0>();
        keep(acc);
        keep(a[1]);
        if (lane == 0) mbar_arrive(empty + 8 * s);
        // the next unit's ticket on its way, a tile before the ring needs
        // it (unless it has it already)
        if (j == 0 && tid == 0 && taken == n + 1) draw();
        if (j + 1 < u.nt) hand_over(acc, j + 1);
        // into the stage freed first (the last tile's refill waits for the
        // publication below)
        if (j + 1 < u.nt) load_next();
        if (j == (u.nt > 1 ? 1 : 0)) next_unit(n + 1);   // and its dt
      }
      if (lane == 0) mbar_arrive(c_empty);     // w and decay read
      if (u.c + 1 < nc) {
        float* const hd = states + (rc + 1) * kHSize;
#pragma unroll
        for (int jj = 0; jj < 16; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            __stcg(reinterpret_cast<float2*>(hd + (p0 + 8 * h) * 128
                                             + 8 * jj + 2 * q4),
                   make_float2(acc[4 * jj + 2 * h],
                               acc[4 * jj + 2 * h + 1]));
        // each thread's stores, then its release: the count reaches kGroup
        // once every one of them is visible
        red_release_add(sync + 1 + rc + 1, 1u);
      } else {
        float* const so = st + static_cast<size_t>(u.row) * P * N;
#pragma unroll
        for (int jj = 0; jj < 16; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = p0 + 8 * h;
            const int nn = 8 * jj + 2 * q4;
            if (p < P && nn < N)               // N even: nn + 1 < N too
              *reinterpret_cast<float2*>(so + p * N + nn) =
                  make_float2(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]);
          }
      }
      load_next();
      // the next unit's cum, w, C and start state: the start state after
      // this unit's publication, which it may be
      prepare((n + 1) & 1);
      issue(n + 1);
    }
  } else {
    // ---- consumers: t-tiles w and 3 - w ----
    const int w = (warp >> 2) - 1;
    const int tid = threadIdx.x % kGroup;
    const int cw = tid >> 5;                   // warp within the group
    const int g = lane >> 2;
    const int q4 = lane & 3;
    float y[32], s[32];
    uint32_t m[3][4][4];
    int it = 0;                                // ring tiles of past units
    int hk = 0;                                // states handed to this one
    for (int n = 0;; ++n) {
      mbar_wait(c_full, n & 1);
      const int uid = uid_of(n & 1);
      if (uid >= units) break;
      const Unit u = unit_of(uid, S, Q, heads, Bb);
      const float* const ub = unit + (n & 1) * kUnitFloats;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int i = k == 0 ? w : kMaxTiles - 1 - w;
        if (i >= u.nt) continue;
        // y_i = exp(cum_t - cum_r) C_i . h (h the state at the tile's
        // start, r its step) + the tile's own steps
        mbar_wait(hb_full + 8 * w, hk & 1);
        ++hk;
        if (u.c > 0 || i > 0) {
          boundary(y, sC + i * kSlab, sH, ub, i, cw, g);
        } else {
#pragma unroll
          for (int e = 0; e < 32; ++e) y[e] = 0.f;
        }
        if (lane == 0) mbar_arrive(hb_empty);
        const int st_ = (it + i) % kStages;
        const uint32_t xi = sR + st_ * kStageBytes;
        mbar_wait(full + 8 * st_, ((it + i) / kStages) & 1);
        diagonal(y, s, m, sC + i * kSlab, xi + kXBytes, xi, ub, i, u.qn, cw,
                 g, q4);
        if (lane == 0) mbar_arrive(empty + 8 * st_);
        store_y(y, out, u, S, P, i, cw, g, q4);
      }
      if (lane == 0) mbar_arrive(c_empty);
      it += u.nt;
    }
  }
}

// cuTensorMapEncodeTiled, fetched from the driver through the runtime so
// that the library links no driver library of its own
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

constexpr int kEncodeFailed = 10000;    // + the CUresult of the encode

int encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || ptr == nullptr)
      return static_cast<int>(cudaErrorSymbolNotFound);
    cached = reinterpret_cast<EncodeTiled>(ptr);
  }
  *fn = cached;
  return 0;
}

// A map of an (outer, rows, width) bf16 tensor in boxes of 64 x 64 x 1,
// 128-byte swizzled; reads outside the tensor come back as zeros
int encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int width,
           int rows, int outer) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[2] = {2ull * width, 2ull * width * rows};
  const cuuint32_t box[3] = {64u, 64u, 1u};
  const cuuint32_t unit[3] = {1u, 1u, 1u};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                          const_cast<void*>(ptr), dims, strides, box, unit,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(res);
}

// cudaFuncSetAttribute(MaxDynamicSharedMemorySize) once per kernel and
// device; bit d of `done` marks device d as set
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

cudaError_t set_smem_bf16() {
  static unsigned set = 0;
  return set_smem_once(ssd_wg_scan_kernel, kSmem, set);
}

// the current device's SMs, read once per device
cudaError_t sm_count(int* sms) {
  static int count[32] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && count[dev] > 0) {
    *sms = count[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < 32) count[dev] = *sms;
  return err;
}

int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, float* y, float* st, float* states,
           unsigned* sync, int BH, int S, int P, int N, int Q, int heads,
           cudaStream_t stream) {
  cudaError_t cerr;
  if (S == 0) {                                // no chunk: a zero state
    cerr = cudaMemsetAsync(st, 0, sizeof(float) * BH * P * N, stream);
    return static_cast<int>(cerr);
  }
  const int nc = (S + Q - 1) / Q;
  const int Bb = BH / heads;
  EncodeTiled fn;
  int err = encoder(&fn);
  if (err != 0) return err;
  CUtensorMap tx, tb, tc;
  if ((err = encode(fn, &tx, x, P, S, BH)) ||
      (err = encode(fn, &tb, Bm, N, S, Bb)) ||
      (err = encode(fn, &tc, Cm, N, S, Bb)))
    return err;
  if ((cerr = set_smem_bf16()) != cudaSuccess) return static_cast<int>(cerr);
  int sms = 0;
  if ((cerr = sm_count(&sms)) != cudaSuccess) return static_cast<int>(cerr);
  cerr = cudaMemsetAsync(sync, 0, sizeof(unsigned) * (1 + BH * nc), stream);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  // persistent, one CTA an SM at most; the units go out by ticket, so the
  // chain needs no CTA to be resident with another
  const int units = BH * nc;
  ssd_wg_scan_kernel<<<units < sms ? units : sms, kThreads, kSmem,
                       stream>>>(tx, tb, tc, dt, A, states, st, y, sync, BH,
                                 S, P, N, Q, heads, nc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hop

}  // namespace

extern "C" {

// Dynamic shared memory (bytes) and CTAs per SM of kernel `which` of one
// call: bfloat16 (is_bf16) 0 ssd_wg_scan_kernel; float32 0 CB, 1 state, 2
// pass, 3 out.
int ssd_scan_occupancy(int which, int is_bf16, int* smem, int* blocks) {
  if (is_bf16) {
    if (which != 0) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = hop::set_smem_bf16();
    if (err != cudaSuccess) return static_cast<int>(err);
    *smem = static_cast<int>(hop::kSmem);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, hop::ssd_wg_scan_kernel, hop::kThreads, hop::kSmem));
  }
  static const size_t bytes[4] = {kCbSmem, kStateSmem, 0, kOutSmem};
  if (which < 0 || which > 3) return static_cast<int>(cudaErrorInvalidValue);
  *smem = static_cast<int>(bytes[which]);
  cudaError_t err = set_smem<true>();
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (which) {
    case 0:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, ssd_cb_kernel<true>, kCbThreads, kCbSmem);
      break;
    case 1:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, ssd_state_kernel<true>, kStateThreads, kStateSmem);
      break;
    case 2:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, ssd_pass_kernel<4>, kPassThreads, 0);
      break;
    default:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, ssd_out_kernel<true>, kOutThreads, kOutSmem);
  }
  return static_cast<int>(err);
}

// float32: x (BH, S, P), dt (BH, S), A (BH), B and C (BH / heads, S, N), y
// (BH, S, P), st (BH, P, N), all float32 and contiguous.  Scratch: cb (BH /
// heads, nc, Qp, Qp) and states (BH, nc, P, N) float32, cum (BH, nc, Qp)
// float64, with nc = ceil(S / Q) and Qp = Q rounded up to 64.  1 <= P <= 64,
// 1 <= N <= 128, 1 <= Q <= 256 (the chunk, at most S).
int ssd_scan_f32_launch(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, void* y, void* st,
                        void* cb, void* cum, void* states, int BH, int S,
                        int P, int N, int Q, int heads, cudaStream_t stream) {
  if (P < 1 || P > kP || N < 1 || N > kN || heads < 1 ||
      BH % heads != 0 || S < 0 || (S > 0 && (Q < 1 || Q > S || Q > kMaxQ)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (BH == 0) return static_cast<int>(cudaGetLastError());
  if (S == 0) Q = 1;                     // no chunk: the pass writes zeros
  // the 16-byte loaders take rows of exactly the padded tiles (P = 64, N =
  // 128) from 16-byte aligned arrays; other shapes load element by element
  const bool full = P == kP && N == kN && aligned16(x) && aligned16(Bm)
                    && aligned16(Cm) && aligned16(states) && aligned16(cb);
  auto* run = full ? launch_f32<true> : launch_f32<false>;
  return static_cast<int>(run(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<float*>(y),
      static_cast<float*>(st), static_cast<float*>(cb),
      static_cast<double*>(cum), static_cast<float*>(states), BH, S, P, N, Q,
      heads, stream));
}

// bfloat16: x (BH, S, P), B and C (BH / heads, S, N) bfloat16, 16-byte
// aligned, with P and N multiples of 8 (the wrapper pads); dt (BH, S), A
// (BH), y (BH, S, P), st (BH, P, N) float32; all contiguous.  Scratch:
// states (BH, nc, 64, 128) float32, sync (1 + BH nc) uint32 (zeroed here).
// 8 <= P <= 64, 8 <= N <= 128, 1 <= Q <= 256 (at most S).  Returns a
// cudaError_t, or kEncodeFailed (10000) + the CUresult of a tensor map that
// cannot be encoded.
int ssd_scan_bf16_launch(const void* x, const void* dt, const void* A,
                         const void* Bm, const void* Cm, void* y, void* st,
                         void* states, void* sync, int BH, int S, int P,
                         int N, int Q, int heads, cudaStream_t stream) {
  if (P < 8 || P > kP || P % 8 != 0 || N < 8 || N > kN || N % 8 != 0 ||
      heads < 1 || BH % heads != 0 || S < 0 ||
      (S > 0 && (Q < 1 || Q > S || Q > kMaxQ)) ||
      !aligned16(x) || !aligned16(Bm) || !aligned16(Cm))
    return static_cast<int>(cudaErrorInvalidValue);
  if (BH == 0) return static_cast<int>(cudaGetLastError());
  return hop::launch(x, static_cast<const float*>(dt),
                     static_cast<const float*>(A), Bm, Cm,
                     static_cast<float*>(y), static_cast<float*>(st),
                     static_cast<float*>(states),
                     static_cast<unsigned*>(sync), BH, S, P, N, Q, heads,
                     stream);
}

}  // extern "C"
