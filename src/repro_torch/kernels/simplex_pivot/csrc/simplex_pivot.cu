// Batched simplex pivot kernels for Hopper (sm_90a), float64.
//
// Replaces the two Pallas kernels of src/repro/kernels/simplex_pivot/
// simplex_pivot.py:
//
//   simplex_pivot  (TPU: `simplex_pivot`, body `_kernel`) — the rank-1
//       tableau pivot  tab' = tab - tab[:, j] (x) tab[r, :] / tab[r, j]
//       on every active lane of a (B, R+1, C0+1) stack, pivot row replaced
//       by the normalised row.
//   reduced_pivot  (TPU: `reduced_pivot`, body `_reduced_kernel`) — one
//       fused revised-simplex iteration per lane: BTRAN pricing out of the
//       (R, R) basis inverse, Dantzig/Bland entering column, FTRAN, ratio
//       test with artificial drive-out and smallest-label tie-break, eta
//       update of [Binv | xB] and the basis labels, per-lane flags.
//
// Bound.  Both do a few kFLOP per lane and are bound by device memory: at
// the fleet shape (R = 14, C0 = 38) a simplex_pivot call moves 15*39*8 B
// in and out per active lane; a reduced_pivot call reads the (R, C0)
// column slab, costs, factor and basis of a lane (~5.9 kB) and writes the
// factor back on pivoting lanes.  The least it needs is less: a lane with
// lane_ok False enters no column and needs only column 0 of its slab, a
// Bland lane only the columns up to the one it enters.  chip_smoke.py
// computes the bound of each call from its inputs, lane by lane.
//
// Design.  One block per lane; the lane's data is staged in shared memory
// before any write, so the in-place update cannot race (the Pallas body
// reads an input block that is never overwritten).  Both kernels update
// IN PLACE and skip lanes that do not pivot: an inactive lane costs its
// flag read only (simplex_pivot) or its pricing reads only
// (reduced_pivot).  reduced_pivot stages the whole slab of every lane:
// a version that staged only column 0 on lanes with lane_ok False and
// skipped their pricing was slower on the fleet shape (PERF.md).
// Selection and ratio-test scans run in one thread in index order, which
// reproduces the reference's first-index tie rules exactly.  The rank-1 updates are one fused multiply-add per element
// (__fma_rn: a single rounding), the arithmetic of the plain PyTorch
// version (torch.addcmul in repro_torch/kernels/simplex_pivot/ref.py) and
// of XLA's code for the reference on the CPU; the pricing and FTRAN dot
// products accumulate in index order with explicit round-to-nearest
// intrinsics, so structurally identical columns (identical jobs) price to
// bit-identical reduced costs and keep their exact ties.
//
// Interface: plain C, called through ctypes; each launcher returns
// cudaGetLastError() so the Python wrapper raises on a refused launch.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;

__global__ void simplex_pivot_kernel(double* __restrict__ tabs,
                                     const int* __restrict__ r_in,
                                     const int* __restrict__ j_in,
                                     const unsigned char* __restrict__ mask,
                                     int R1, int C1) {
  const int b = blockIdx.x;
  if (!mask[b]) return;                       // skipped: no read, no write
  extern __shared__ double smem[];
  double* prow = smem;                        // (C1) normalised pivot row
  double* colv = smem + C1;                   // (R1) pivot column
  double* tab = tabs + static_cast<size_t>(b) * R1 * C1;
  const int r = min(max(r_in[b], 0), R1 - 1);
  const int j = min(max(j_in[b], 0), C1 - 1);
  const double piv = tab[r * C1 + j];
  for (int k = threadIdx.x; k < C1; k += blockDim.x)
    prow[k] = tab[r * C1 + k] / piv;
  for (int i = threadIdx.x; i < R1; i += blockDim.x)
    colv[i] = tab[i * C1 + j];
  __syncthreads();                            // staged before any write
  const int n = R1 * C1;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int i = e / C1;
    const int k = e - i * C1;
    tab[e] = (i == r) ? prow[k] : __fma_rn(-colv[i], prow[k], tab[e]);
  }
}

__global__ void reduced_pivot_kernel(
    const double* __restrict__ A, const double* __restrict__ c,
    double* __restrict__ Binv, double* __restrict__ xB,
    int* __restrict__ bas, const unsigned char* __restrict__ use_bland,
    const unsigned char* __restrict__ may_pivot,
    const unsigned char* __restrict__ lane_ok,
    unsigned char* __restrict__ flags, int R, int C0, double art_cost,
    double tol) {
  const int b = blockIdx.x;
  extern __shared__ double smem[];
  double* sA = smem;                  // (R, C0) column slab
  double* sc = sA + R * C0;           // (C0) phase costs
  double* sB = sc + C0;               // (R, R) basis inverse
  double* sx = sB + R * R;            // (R) basic solution
  double* scB = sx + R;               // (R) basic costs
  double* sy = scB + R;               // (R) simplex multipliers
  double* src = sy + R;               // (C0) reduced costs
  double* sd = src + C0;              // (R) FTRAN column
  int* sbas = reinterpret_cast<int*>(sd + R);   // (R) labels
  __shared__ int s_j, s_r, s_do;

  const size_t lane = static_cast<size_t>(b);
  const double* gA = A + lane * R * C0;
  double* gB = Binv + lane * R * R;
  double* gx = xB + lane * R;
  int* gbas = bas + lane * R;
  const int t = threadIdx.x;
  const int nt = blockDim.x;

  for (int e = t; e < R * C0; e += nt) sA[e] = gA[e];
  for (int k = t; k < C0; k += nt) sc[k] = c[lane * C0 + k];
  for (int e = t; e < R * R; e += nt) sB[e] = gB[e];
  for (int i = t; i < R; i += nt) { sx[i] = gx[i]; sbas[i] = gbas[i]; }
  __syncthreads();

  // BTRAN + pricing: rc = c - (cB Binv) A; virtual artificials (label
  // >= C0) price at art_cost
  for (int i = t; i < R; i += nt) {
    const int lab = sbas[i];
    scB[i] = lab >= C0 ? art_cost : sc[max(lab, 0)];
  }
  __syncthreads();
  for (int k = t; k < R; k += nt) {
    double s = 0.0;
    for (int i = 0; i < R; ++i) s = __dadd_rn(s, __dmul_rn(scB[i], sB[i * R + k]));
    sy[k] = s;
  }
  __syncthreads();
  for (int k = t; k < C0; k += nt) {
    double s = 0.0;
    for (int i = 0; i < R; ++i) s = __dadd_rn(s, __dmul_rn(sy[i], sA[i * C0 + k]));
    src[k] = __dsub_rn(sc[k], s);
  }
  __syncthreads();

  // entering column: Dantzig = first index of the most negative reduced
  // cost, Bland = first eligible index
  if (t == 0) {
    const bool ok = lane_ok[b] != 0;
    int has = 0, jd = 0, jb = 0;
    double smin = CUDART_INF;
    for (int k = 0; k < C0; ++k) {
      const double v = src[k];
      if (ok && v < -tol) {
        if (!has) jb = k;
        has = 1;
        if (v < smin) { smin = v; jd = k; }
      }
    }
    s_j = has ? (use_bland[b] ? jb : jd) : 0;
    s_do = has;
  }
  __syncthreads();
  const int j = s_j;

  // FTRAN: d = Binv A_j
  for (int i = t; i < R; i += nt) {
    double s = 0.0;
    for (int k = 0; k < R; ++k) s = __dadd_rn(s, __dmul_rn(sB[i * R + k], sA[k * C0 + j]));
    sd[i] = s;
  }
  __syncthreads();

  // ratio test: drive basic artificials at level 0 out first; among rows
  // within the tie band take the smallest basis label (first row on
  // equal labels)
  if (t == 0) {
    const int has = s_do;
    double rmin = CUDART_INF;
    bool any_finite = false, nan_seen = false;
    for (int i = 0; i < R; ++i) {
      const double di = sd[i];
      double ratio = di > tol ? sx[i] / di : CUDART_INF;
      if (sbas[i] >= C0 && fabs(di) > tol && sx[i] <= tol) ratio = 0.0;
      if (ratio != ratio) nan_seen = true;
      if (ratio < CUDART_INF) any_finite = true;
      if (ratio < rmin) rmin = ratio;
    }
    if (nan_seen) rmin = CUDART_NAN;              // min propagates NaN
    const double band = __dadd_rn(rmin, fmax(__dmul_rn(fabs(rmin), 1e-9), 1e-12));
    int best = 0x7fffffff, r = 0;
    for (int i = 0; i < R; ++i) {
      const double di = sd[i];
      double ratio = di > tol ? sx[i] / di : CUDART_INF;
      if (sbas[i] >= C0 && fabs(di) > tol && sx[i] <= tol) ratio = 0.0;
      const int v = ratio <= band ? sbas[i] : 0x7fffffff;
      if (v < best) { best = v; r = i; }
    }
    const bool unbounded = !any_finite;
    s_r = r;
    s_do = (may_pivot[b] != 0) && has && !unbounded;
    flags[lane * 3 + 0] = static_cast<unsigned char>(has);
    flags[lane * 3 + 1] = static_cast<unsigned char>(unbounded);
    flags[lane * 3 + 2] = static_cast<unsigned char>(rmin <= tol);
  }
  __syncthreads();
  if (!s_do) return;                           // factor passes through

  // eta update of [Binv | xB] from the staged copies
  const int r = s_r;
  const double piv = sd[r];
  for (int e = t; e < R * R; e += nt) {
    const int i = e / R;
    const int k = e - i * R;
    const double brow = sB[r * R + k] / piv;
    gB[e] = (i == r) ? brow : __fma_rn(-sd[i], brow, sB[e]);
  }
  const double xr = sx[r] / piv;
  for (int i = t; i < R; i += nt)
    gx[i] = (i == r) ? xr : __fma_rn(-sd[i], xr, sx[i]);
  if (t == 0) gbas[r] = j;
}

}  // namespace

extern "C" {

int simplex_pivot_launch(double* tabs, const int* r, const int* j,
                         const unsigned char* mask, int B, int R1, int C1,
                         cudaStream_t stream) {
  if (B > 0) {
    const size_t shmem = sizeof(double) * static_cast<size_t>(R1 + C1);
    simplex_pivot_kernel<<<B, kThreads, shmem, stream>>>(tabs, r, j, mask,
                                                        R1, C1);
  }
  return static_cast<int>(cudaGetLastError());
}

int reduced_pivot_launch(const double* A, const double* c, double* Binv,
                         double* xB, int* bas, const unsigned char* use_bland,
                         const unsigned char* may_pivot,
                         const unsigned char* lane_ok, unsigned char* flags,
                         int B, int R, int C0, double art_cost, double tol,
                         cudaStream_t stream) {
  if (B > 0) {
    const size_t shmem =
        sizeof(double) * static_cast<size_t>(R * C0 + 2 * C0 + R * R + 4 * R)
        + sizeof(int) * static_cast<size_t>(R);
    reduced_pivot_kernel<<<B, kThreads, shmem, stream>>>(
        A, c, Binv, xB, bas, use_bland, may_pivot, lane_ok, flags, R, C0,
        art_cost, tol);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
