// CCKP dynamic program of AMDP (paper §VI-B) for Hopper (sm_90a), float32.
//
// Replaces the Pallas kernel of src/repro/kernels/cckp_dp/cckp_dp.py
// (`cckp_model_dp`, body `_kernel`): one model group of the
// cardinality-constrained knapsack's (max,+) recurrence
//
//     Y'[t, k]    = max_q  Y[t - q*p, k - q] + q*a
//     bestq[t, k] = the first q attaining it          (q = 0 .. n_steps-1)
//
// with reads outside the grid counting as NEG = -1e30.  The TPU kernel
// keeps one (T+1, K+1) grid in VMEM and shifts it by a STATIC (p, 1) per
// step, so the reference splits a fleet into subgroups by p and calls it
// once per model.  Here p is data: one launch covers a whole batch of grids
// (B, T1, K1), each lane b with its own p[b, i] and a[b, i], and runs all m
// models of one AMDP call, model after model.
//
// Bound.  One call reads Y once (4 bytes a cell), writes the final Y (4)
// and one int32 argmax table per model (4 m): 16 bytes a cell for AMDP's
// m = 2.  At the fleet's grids (T1 = 1201, K1 = 13, B = 16384 lanes) that
// is 4.09 GB, 1.22 ms at 3.35 TB/s; the walks' ~2 float operations per q
// are far below the FP32 rate.  The design keeps everything else on chip:
//
//   * One CTA per lane (blockIdx.x); no 64-bit division.  In the shared
//     instance the lane's grid (62.4 KB at the fleet's shape) is loaded
//     once, coalesced, every model runs on it in shared memory, and only
//     the final grid goes back to device memory: the intermediate grid
//     between models never leaves the SM.
//   * The update runs in place, by blocks of kThreads rows from the top
//     row down.  Cell (t, k) reads only rows t - q p <= t, so a block's
//     reads see the model's input as long as the rows above have been
//     written and the block itself has not: each thread walks the q of
//     its row's cells into a stage, the block synchronises, then the
//     stage is copied into the grid and the argmax table (one coalesced
//     run of rows), and the block synchronises again.
//   * A thread owns one row and walks its cells k = 0 .. K1-1, so the 32
//     lanes of a warp share k, and so the length of their q-walk
//     (min(n_steps, k + 1, t / p + 1)); consecutive rows at one k lie K1
//     floats apart, which for an odd K1 is free of bank conflicts.
//   * Grids whose lane and stage exceed a block's shared memory (the
//     reference docstring's 4001 x 301, say) run the same code with the
//     grid in `out` and the stage in a scratch array of device memory
//     (the global instance); the wrapper chooses by shape.
//
// Roundings.  The candidate is formed with two explicit roundings,
// __fmul_rn then __fadd_rn: every reference path (the jitted scan, the
// vmapped traced-shift scan and the Pallas body) rounds the product and the
// sum separately, and nvcc would otherwise contract a*b + c into one FMA,
// whose single rounding flips DP ties and, through the backtrack,
// assignments.  `val > best` is strict, so the first argmax wins, as in the
// reference.  Once t - q p is negative every later q reads NEG as well, and
// NEG + q*a == NEG in float32 for the accuracies AMDP uses, which never
// beats best >= NEG, so the walk stops there.
//
// Interface: plain C, called through ctypes; the launcher returns
// cudaGetLastError() so the Python wrapper raises on a refused launch.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;           // rows of one block of the update
constexpr float kNeg = -1e30f;

// floats of the q * a table: q < min(n_steps, K1)
__host__ __device__ int table_len(int K1, int n_steps) {
  return max(0, min(n_steps, K1));
}

// bytes of dynamic shared memory: the q * a table, and in the shared
// instance the lane's grid and the stage (one value and one count per cell
// of a block of rows)
size_t smem_bytes(int T1, int K1, int n_steps, bool shared) {
  size_t floats = table_len(K1, n_steps);
  if (shared)
    floats += static_cast<size_t>(T1) * K1
              + 2 * static_cast<size_t>(kThreads) * K1;
  return sizeof(float) * floats;
}

// The walks of row t's cells, into the stage row (vrow, qrow): cell (t, k)
// takes q < min(q_cap, k + 1) and reads in[t K1 + k - q stride].  Any K1.
__device__ __forceinline__ void walk_row(const float* in, const float* qa,
                                         int t, int K1, int stride,
                                         int q_cap, float* vrow, int* qrow) {
  for (int k = 0; k < K1; ++k) {
    const int q_end = min(q_cap, k + 1);             // k - q >= 0
    float best = kNeg;
    int bq = 0;
    const float* src = in + t * K1 + k;              // q = 0
    for (int q = 0; q < q_end; ++q, src -= stride) {
      const float v = __fadd_rn(*src, qa[q]);
      if (v > best) {
        best = v;
        bq = q;
      }
    }
    vrow[k] = best;
    qrow[k] = bq;
  }
}

// The same for K1 == kK known at compile time: q outer, the row's cells in
// registers, every (q, k >= q) pair unrolled, so that one q's kK - q reads
// (consecutive cells of row t - q p) are independent and the q * a of a q
// is read once.  Each cell still takes its q in increasing order.
template <int kK>
__device__ __forceinline__ void walk_row_fixed(const float* in,
                                               const float* qa, int t,
                                               int stride, int q_cap,
                                               float* vrow, int* qrow) {
  float best[kK];
  int bq[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    best[k] = kNeg;
    bq[k] = 0;
  }
  const float* src = in + t * kK;                    // row t - q p, minus q
#pragma unroll
  for (int q = 0; q < kK; ++q, src -= stride) {
    if (q < q_cap) {
      const float w = qa[q];
#pragma unroll
      for (int k = q; k < kK; ++k) {
        const float v = __fadd_rn(src[k], w);
        if (v > best[k]) {
          best[k] = v;
          bq[k] = q;
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    vrow[k] = best[k];
    qrow[k] = bq[k];
  }
}

// kShared: the lane's grid and the stage in shared memory; otherwise the
// grid is `out` and the stage lives in `vscratch` / `qscratch` (kThreads *
// K1 entries per lane).  kK: K1 when it is known at compile time, else 0.
// p and a are (B, m); bestq is (m, B, T1, K1).
template <bool kShared, int kK>
__global__ void __launch_bounds__(kThreads)
cckp_models_dp_kernel(const float* y, const int* __restrict__ p,
                      const float* __restrict__ a, float* out,
                      int* __restrict__ bestq, float* vscratch,
                      int* qscratch, int B, int T1, int K1_arg, int m,
                      int n_steps) {
  extern __shared__ float4 smem4[];
  const int K1 = kK > 0 ? kK : K1_arg;
  float* const qa = reinterpret_cast<float*>(smem4);   // q * a
  const int n_qa = min(n_steps, K1);
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int cells = T1 * K1;
  const float* const src_lane = y + static_cast<size_t>(b) * cells;
  float* grid;
  float* vstage;
  int* qstage;
  if constexpr (kShared) {
    grid = qa + table_len(K1, n_steps);
    vstage = grid + cells;
    qstage = reinterpret_cast<int*>(vstage + kThreads * K1);
    // the lane's grid by asynchronous copies: all of it in flight at once
    for (int e = tid; e < cells; e += kThreads) {
      const unsigned dst =
          static_cast<unsigned>(__cvta_generic_to_shared(grid + e));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                   :: "r"(dst), "l"(src_lane + e));
    }
    asm volatile("cp.async.wait_all;\n" ::);
  } else {
    grid = out + static_cast<size_t>(b) * cells;
    vstage = vscratch + static_cast<size_t>(b) * kThreads * K1;
    qstage = qscratch + static_cast<size_t>(b) * kThreads * K1;
  }

  for (int i = 0; i < m; ++i) {
    const int pi = p[b * m + i];
    const float ai = a[b * m + i];
    // q * a for every q a walk can take, rounded once
    for (int q = tid; q < n_qa; q += kThreads)
      qa[q] = __fmul_rn(static_cast<float>(q), ai);
    // the grid this model reads: the global instance's first model reads
    // y itself and writes `out`
    const float* const in = (kShared || i > 0) ? grid : src_lane;
    // q p <= t < T1 for every q walked, so the index stride fits an int
    const int stride = pi <= T1 ? pi * K1 + 1 : 0;
    int* const table = bestq + (static_cast<size_t>(i) * B + b) * cells;
    __syncthreads();                     // the grid holds the model's input
    for (int t_hi = T1; t_hi > 0; t_hi -= kThreads) {
      const int t_lo = max(0, t_hi - kThreads);
      const int t = t_lo + tid;
      if (t < t_hi) {
        const int q_row = pi > 0 ? t / pi + 1 : INT_MAX;   // t - q p >= 0
        const int q_cap = min(n_steps, q_row);
        if constexpr (kK > 0)
          walk_row_fixed<kK>(in, qa, t, stride, q_cap, vstage + tid * kK,
                             qstage + tid * kK);
        else
          walk_row(in, qa, t, K1, stride, q_cap, vstage + tid * K1,
                   qstage + tid * K1);
      }
      __syncthreads();                   // every read of these rows done
      const int base = t_lo * K1;
      const int n = (t_hi - t_lo) * K1;
      for (int e = tid; e < n; e += kThreads) {
        grid[base + e] = vstage[e];
        table[base + e] = qstage[e];
      }
      __syncthreads();                   // the stage is free again
    }
  }
  if constexpr (kShared) {
    float* const dst = out + static_cast<size_t>(b) * cells;
    for (int e = tid; e < cells; e += kThreads) dst[e] = grid[e];
  }
}

// the instance for a (K1, shared) pair: K1 up to kMaxFixedK compiled for
// its own K1 in the shared instance, the rest generic
constexpr int kMaxFixedK = 16;
using KernelFn = void (*)(const float*, const int*, const float*, float*,
                          int*, float*, int*, int, int, int, int, int);

template <int kK>
KernelFn fixed_kernel(int K1) {
  if constexpr (kK > kMaxFixedK) {
    return nullptr;
  } else {
    return K1 == kK ? cckp_models_dp_kernel<true, kK>
                    : fixed_kernel<kK + 1>(K1);
  }
}

KernelFn kernel_for(int K1, bool shared) {
  if (!shared) return cckp_models_dp_kernel<false, 0>;
  const KernelFn fn = fixed_kernel<1>(K1);
  return fn ? fn : cckp_models_dp_kernel<true, 0>;
}

// largest dynamic shared memory a block may use on this device
int max_shared(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
  return static_cast<int>(err);
}

cudaError_t set_smem(KernelFn fn, size_t smem) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

extern "C" {

// Bytes of shared memory one CTA of the shared (shared = 1) or global
// instance takes for a (T1, K1) grid walked over n_steps; the wrapper takes
// the shared instance when its bytes fit the device's opt-in limit
// (cckp_dp_max_shared) and the global one otherwise.
long long cckp_dp_smem_bytes(int T1, int K1, int n_steps, int shared) {
  return static_cast<long long>(smem_bytes(T1, K1, n_steps, shared != 0));
}

int cckp_dp_max_shared(int* bytes) { return max_shared(bytes); }

// CTAs of the shared (shared = 1) or global instance that fit one SM for
// a (T1, K1) grid, as the occupancy calculator gives it.
int cckp_dp_occupancy(int T1, int K1, int n_steps, int shared,
                      int* blocks) {
  const size_t smem = smem_bytes(T1, K1, n_steps, shared != 0);
  const KernelFn fn = kernel_for(K1, shared != 0);
  cudaError_t err = set_smem(fn, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kThreads,
                                                        smem);
  return static_cast<int>(err);
}

// y (B, T1, K1) float32; p, a (B, m) int32 / float32; out (B, T1, K1)
// float32; bestq (m, B, T1, K1) int32, all contiguous.  shared = 1 takes
// the shared instance (vscratch, qscratch unused), shared = 0 the global
// one with vscratch / qscratch of B * kThreads * K1 entries.  T1 * K1 <
// 2^31.
int cckp_models_dp_launch(const float* y, const int* p, const float* a,
                          float* out, int* bestq, float* vscratch,
                          int* qscratch, int B, int T1, int K1, int m,
                          int n_steps, int shared, cudaStream_t stream) {
  if (B < 0 || T1 < 0 || K1 < 0 || m < 0 ||
      static_cast<long long>(T1) * K1 > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || static_cast<long long>(T1) * K1 == 0)
    return static_cast<int>(cudaGetLastError());
  const size_t smem = smem_bytes(T1, K1, n_steps, shared != 0);
  const KernelFn fn = kernel_for(K1, shared != 0);
  const cudaError_t err = set_smem(fn, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fn<<<B, kThreads, smem, stream>>>(y, p, a, out, bestq, vscratch, qscratch,
                                    B, T1, K1, m, n_steps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
