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
// step, so the reference splits a fleet into subgroups by p.  Here p is
// data: one launch covers a whole batch of grids (B, T1, K1), each lane b
// with its own p[b] and a[b], and AMDP launches once per model.
//
// Design.  One thread per output cell (b, t, k) walks q upward and reads
// Y[b, t - q*p, k - q] directly (the reference's q-fold shift of the
// grid).  Once k - q or t - q*p is negative every later q reads NEG as
// well, and NEG + q*a == NEG in float32 for the accuracies AMDP uses, which
// never beats best >= NEG, so the walk stops there.  The candidate is
// formed with two explicit roundings, __fmul_rn then __fadd_rn: every
// reference path (the jitted scan, the vmapped traced-shift scan and the
// Pallas body) rounds the product and the sum separately, and nvcc would
// otherwise contract a*b + c into one FMA, whose single rounding flips DP
// ties and, through the backtrack, assignments.  `val > best` is strict, so
// the first argmax wins, as in the reference.
//
// Bound.  Each cell reads its own Y once from device memory (the other
// q-1 reads of a walk hit neighbouring cells of the same lane, in L1/L2)
// and writes Y' and bestq: 12 bytes a cell, about two float operations per
// q.  At the fleet's grids (T1 = 1201, K1 = 13) that is memory-bound:
// B = 16384 lanes move 3.07 GB, 0.92 ms at 3.35 TB/s.  Shared-memory tiles
// of a lane's rows, narrower bestq types and fusing the m models are left
// for later.
//
// Interface: plain C, called through ctypes; the launcher returns
// cudaGetLastError() so the Python wrapper raises on a refused launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;

__global__ void cckp_model_dp_kernel(const float* __restrict__ y,
                                     const int* __restrict__ p_in,
                                     const float* __restrict__ a_in,
                                     float* __restrict__ out,
                                     int* __restrict__ bestq,
                                     long long n_cells, int T1, int K1,
                                     int n_steps) {
  const int cells = T1 * K1;                     // cells of one lane
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x
                     + threadIdx.x;
       e < n_cells; e += stride) {
    const int b = static_cast<int>(e / cells);
    const int rem = static_cast<int>(e - static_cast<long long>(b) * cells);
    const int t = rem / K1;
    const int k = rem - t * K1;
    const int p = p_in[b];
    const float a = a_in[b];
    const float* lane = y + static_cast<size_t>(b) * cells;
    float best = kNeg;
    int bq = 0;
    const int q_end = min(n_steps, k + 1);       // k - q >= 0
    for (int q = 0; q < q_end; ++q) {
      const long long tt = static_cast<long long>(t)
                           - static_cast<long long>(q) * p;
      if (tt < 0) break;                         // and every later q too
      const float src = lane[static_cast<int>(tt) * K1 + (k - q)];
      const float val = __fadd_rn(src, __fmul_rn(static_cast<float>(q), a));
      if (val > best) {
        best = val;
        bq = q;
      }
    }
    out[e] = best;
    bestq[e] = bq;
  }
}

}  // namespace

extern "C" {

int cckp_model_dp_launch(const float* y, const int* p, const float* a,
                         float* out, int* bestq, int B, int T1, int K1,
                         int n_steps, cudaStream_t stream) {
  const long long n = static_cast<long long>(B) * T1 * K1;
  if (n > 0) {
    const long long want = (n + kThreads - 1) / kThreads;
    const int blocks = static_cast<int>(want < (1 << 20) ? want : (1 << 20));
    cckp_model_dp_kernel<<<blocks, kThreads, 0, stream>>>(
        y, p, a, out, bestq, n, T1, K1, n_steps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
