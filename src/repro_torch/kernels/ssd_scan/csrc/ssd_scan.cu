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
//     h_end = exp(cum_last) h_start + sum_s exp(cum_last - cum_s) dt_s x_s B_s^T
//
// Design.  The TPU kernel walks a sequential chunk grid axis and carries
// the (P, N) state in VMEM scratch.  Here one CTA of 256 threads owns one
// row bh and loops over its chunks itself, carrying the state in shared
// memory; nothing carries between CTAs.  A chunk's x dt stays in shared
// memory (transposed, 64 x Q); C and B are read per batch row b (never
// copied per head) in tiles of 64 time steps, since whole (Q, N) tiles
// (128 KB each) and the (Q, Q) decay matrix (256 KB) do not fit.  Every
// product is a 64 x 64 (or 64 x 128) output tile, each thread holding a
// 4 x 4 (4 x 8) register tile of rows ty + 16 i and columns tx + 16 j and
// reading its operands as float4 along the product's inner dimension
// (rows padded to conflict-free strides).  Per chunk:
//
//   * warp 0 forms cum (a sequential sum per lane, then a warp scan);
//   * for each 64-row tile of C: the carried-state term exp(cum_t) C_t .
//     h_start, then, for each B tile at or below the diagonal, the tile
//     exp(cum_t - cum_s) (C_t . B_s) in shared memory, applied to x dt;
//   * the state update accumulates exp(cum_last - cum_s) dt_s x_s B_s^T
//     over the B tiles in registers.
//
// Overflow.  exp(cum_t - cum_s) overflows to inf above the diagonal once a
// chunk's cumulative decay passes ~88 (mamba2-130m at Q = 256 reaches
// ~-180).  The kernel never evaluates exp there: it selects between the
// value and 0 (`s <= t ? exp(...) * g : 0`), and never multiplies by a 0/1
// mask; the padding of x dt and of the tiles is written as zeros, never
// left as whatever shared memory held.  A last chunk shorter than Q is
// simply shorter, which is what padding with dt = 0 computes.
//
// Bound.  At mamba2-130m's shapes (P = 64, N = 128, Q = 256) the call is
// bound by operations: the recurrence needs at least 4 P N operations per
// (token, head) (the state update and the readout, a multiply and an add
// each), against one read of x, dt, B and C and one write of y and the
// state.  This kernel runs the chunked form (about three times as many
// operations) on the FP32 cores from shared memory, without tensor cores.
// Its 187 KB of shared memory allow one CTA of 8 warps per SM, too few
// warps to hide the latency of the tile loads and of shared memory;
// mma.sync / wgmma tiles and a smaller footprint are work for a later
// change.
//
// Interface: plain C, called through ctypes; the launcher returns
// cudaGetLastError() so the Python wrapper raises on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;                  // time steps of a tile
constexpr int kP = 64;                  // x columns / state rows (padded)
constexpr int kN = 128;                 // state columns (padded)
constexpr int kLdN = kN + 4;            // row of a C, B or state tile
constexpr int kLdM = kT + 4;            // row of the masked-decay tile
constexpr int kMaxQ = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// tile rows [0, kT) x columns [0, kN) <- src (row-major, N wide); zero
// outside `rows` x N
template <typename T>
__device__ __forceinline__ void load_rows(float* tile, const T* src,
                                          int rows, int N, int tid) {
  for (int e = tid; e < kT * kN; e += kThreads) {
    const int r = e / kN;
    const int n = e - r * kN;
    tile[r * kLdN + n] =
        (r < rows && n < N) ? to_float(src[static_cast<size_t>(r) * N + n])
                            : 0.f;
  }
}

__host__ __device__ constexpr int x_ld(int Q) {
  return (Q + kT - 1) / kT * kT + 4;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, float* __restrict__ y,
                float* __restrict__ st_out, int S, int P, int N, int Q,
                int heads) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int ldq = x_ld(Q);
  float* const Cs = smem;                // (kT, kLdN)  C tile [t][n]
  float* const Bs = Cs + kT * kLdN;      // (kT, kLdN)  B tile [s][n]
  float* const st = Bs + kT * kLdN;      // (kP, kLdN)  state [p][n]
  float* const Ms = st + kP * kLdN;      // (kT, kLdM)  masked decay [t][s]
  float* const xdt = Ms + kT * kLdM;     // (kP, ldq)   x dt [p][s]
  float* const dts = xdt + kP * ldq;     // (Q)
  float* const cum = dts + Q;            // (Q)
  float* const wend = cum + Q;           // (kT)

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int ty = tid >> 4;               // register-tile rows ty + 16 i
  const int tx = tid & 15;               // and columns tx + 16 j
  const float a = A[bh];
  const T* const xb = x + static_cast<size_t>(bh) * S * P;
  const float* const dtb = dt + static_cast<size_t>(bh) * S;
  const T* const Bb = Bm + static_cast<size_t>(b) * S * N;
  const T* const Cb = Cm + static_cast<size_t>(b) * S * N;
  float* const yb = y + static_cast<size_t>(bh) * S * P;

  for (int e = tid; e < kP * kLdN; e += kThreads) st[e] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int qn = min(Q, S - c0);
    const int qpad = (qn + kT - 1) / kT * kT;
    __syncthreads();                     // the last chunk is done
    for (int t = tid; t < qn; t += kThreads) dts[t] = dtb[c0 + t];
    __syncthreads();
    if (warp == 0) {                     // cum = cumsum(dt * A)
      const int per = (qn + 31) / 32;
      const int beg = min(lane * per, qn);
      const int end = min(beg + per, qn);
      float run = 0.f;
      for (int t = beg; t < end; ++t) {
        run += dts[t] * a;
        cum[t] = run;
      }
      float inc = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, inc, off);
        if (lane >= off) inc += v;
      }
      float excl = __shfl_up_sync(0xffffffffu, inc, 1);
      if (lane == 0) excl = 0.f;
      for (int t = beg; t < end; ++t) cum[t] += excl;
    }
    // x dt, transposed; zero past P and past the chunk's last step
    for (int e = tid; e < qpad * kP; e += kThreads) {
      const int s = e / kP;
      const int p = e - s * kP;
      xdt[p * ldq + s] =
          (p < P && s < qn)
              ? to_float(xb[static_cast<size_t>(c0 + s) * P + p]) * dts[s]
              : 0.f;
    }
    __syncthreads();

    // ---- y, by tiles of 64 rows ------------------------------------------
    for (int t0 = 0; t0 < qn; t0 += kT) {
      const int tn = min(kT, qn - t0);
      load_rows(Cs, Cb + static_cast<size_t>(c0 + t0) * N, tn, N, tid);
      __syncthreads();

      // carried state: exp(cum_t) C_t . h_start
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
      for (int n = 0; n < kN; n += 4) {
        float4 c[4], h[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) c[i] = ld4(Cs + (ty + 16 * i) * kLdN + n);
#pragma unroll
        for (int j = 0; j < 4; ++j) h[j] = ld4(st + (tx + 16 * j) * kLdN + n);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = dot4(c[i], h[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        const float dec = t < tn ? expf(cum[t0 + t]) : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = t < tn ? acc[i][j] * dec : 0.f;
      }

      // the B tiles at or below the diagonal
      for (int s0 = 0; s0 < t0 + tn; s0 += kT) {
        const int sn = min(kT, qn - s0);
        __syncthreads();                 // Bs and Ms of the last tile used
        load_rows(Bs, Bb + static_cast<size_t>(c0 + s0) * N, sn, N, tid);
        __syncthreads();
        float g[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) g[i][j] = 0.f;
#pragma unroll 2
        for (int n = 0; n < kN; n += 4) {
          float4 c[4], bb[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) c[i] = ld4(Cs + (ty + 16 * i) * kLdN + n);
#pragma unroll
          for (int j = 0; j < 4; ++j) bb[j] = ld4(Bs + (tx + 16 * j) * kLdN + n);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) g[i][j] = dot4(c[i], bb[j], g[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = ty + 16 * i;
          const int ts = t0 + t;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = tx + 16 * j;
            const int ss = s0 + s;
            // select, never mask-multiply: exp above the diagonal is inf
            Ms[t * kLdM + s] = (t < tn && s < sn && ss <= ts)
                                   ? expf(cum[ts] - cum[ss]) * g[i][j]
                                   : 0.f;
          }
        }
        __syncthreads();
#pragma unroll 2
        for (int s = 0; s < kT; s += 4) {
          float4 m[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) m[i] = ld4(Ms + (ty + 16 * i) * kLdM + s);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            xv[j] = ld4(xdt + (tx + 16 * j) * ldq + s0 + s);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = dot4(m[i], xv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (t >= tn) continue;
        float* const row = yb + static_cast<size_t>(c0 + t0 + t) * P;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          if (p < P) row[p] = acc[i][j];
        }
      }
      __syncthreads();                   // Cs is reloaded next
    }

    // ---- state update ----------------------------------------------------
    const float cum_end = cum[qn - 1];
    const float chunk_decay = expf(cum_end);
    float sacc[4][8];                    // rows ty + 16 i, columns tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        sacc[i][j] = st[(ty + 16 * i) * kLdN + tx + 16 * j] * chunk_decay;
    for (int s0 = 0; s0 < qn; s0 += kT) {
      const int sn = min(kT, qn - s0);
      __syncthreads();                   // Bs and wend of the last tile used
      load_rows(Bs, Bb + static_cast<size_t>(c0 + s0) * N, sn, N, tid);
      if (tid < kT) wend[tid] = tid < sn ? expf(cum_end - cum[s0 + tid]) : 0.f;
      __syncthreads();
      for (int s = 0; s < sn; ++s) {
        const float w = wend[s];
        float bv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = Bs[s * kLdN + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float xv = xdt[(ty + 16 * i) * ldq + s0 + s] * w;
#pragma unroll
          for (int j = 0; j < 8; ++j) sacc[i][j] = fmaf(xv, bv[j], sacc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        st[(ty + 16 * i) * kLdN + tx + 16 * j] = sacc[i][j];
  }

  __syncthreads();
  float* const stb = st_out + static_cast<size_t>(bh) * P * N;
  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N;
    stb[e] = st[p * kLdN + (e - p * N)];
  }
}

size_t smem_bytes(int Q) {
  return sizeof(float) *
         (3 * static_cast<size_t>(kT) * kLdN + static_cast<size_t>(kT) * kLdM +
          static_cast<size_t>(kP) * x_ld(Q) + 2 * static_cast<size_t>(Q) +
          kT);
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, void* y, void* st, int BH,
                   int S, int P, int N, int Q, int heads,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(Q);
  auto* fn = ssd_scan_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fn<<<BH, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<float*>(y),
      static_cast<float*>(st), S, P, N, Q, heads);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (BH, S, P), dt (BH, S) float32, A (BH) float32, B and C (BH / heads, S,
// N), y (BH, S, P) float32, st (BH, P, N) float32, all contiguous; x, B and
// C of one type (is_bf16: bfloat16, else float32).  1 <= P <= 64,
// 1 <= N <= 128, 1 <= Q <= 256 (the chunk, at most S).
int ssd_scan_fwd_launch(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, void* y, void* st,
                        int BH, int S, int P, int N, int Q, int heads,
                        int is_bf16, cudaStream_t stream) {
  if (P < 1 || P > kP || N < 1 || N > kN || heads < 1 ||
      BH % heads != 0 || S < 0 || (S > 0 && (Q < 1 || Q > S || Q > kMaxQ)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (BH == 0) return static_cast<int>(cudaGetLastError());
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, st, BH, S, P, N,
                                      Q, heads, stream)
              : launch<float>(x, dt, A, Bm, Cm, y, st, BH, S, P, N, Q, heads,
                              stream);
  return static_cast<int>(err);
}

}  // extern "C"
