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
// column slab, costs, factor and basis of a lane (6,296 B) and writes the
// factor back on pivoting lanes.  The least it needs is less: a lane with
// lane_ok False enters no column and needs only column 0 of its slab, a
// Bland lane only the columns up to the one it enters.  chip_smoke.py
// computes the bound of each call from its inputs, lane by lane.
//
// Design.  One warp per lane, several lanes per CTA (kPivotWarps,
// kReducedWarps), no block-wide barrier: a lane's work is a chain of
// short dependent steps, so the card is filled with many independent
// lanes rather than wide ones.  A warp first issues every load of its lane
// at once by cp.async into its own slot of shared memory (16-byte pieces:
// `place` puts each array at its source address's offset modulo 16, so
// only a head and a tail of under 16 bytes go in 4-byte pieces), waits,
// and works from that copy; writes go straight back to device memory, so
// the in-place update cannot race (the Pallas body reads an input block
// that is never overwritten).  Lanes that do not pivot write nothing: a
// masked simplex_pivot lane reads its mask byte only, a reduced_pivot lane
// with lane_ok False stages column 0 of its slab only and skips pricing.
// reduced_pivot has an instance compiled for the LP of each job count up
// to 16 (the fleet's shapes), whose loops have constant trip counts.
// Measured and not kept (PERF.md): persistent warps that stage the next
// lane while working on the current one (slower on full calls and on the
// rollout's partly masked ones, whose active lanes they share unevenly),
// and staging whole slabs of lane_ok False lanes (slower in the rollout).
//
//   reduced_pivot: BTRAN with thread k computing y_k, pricing one column
//   per thread, FTRAN and the ratio test one row per thread (each loops
//   where the lane is wider than a warp); the entering column, rmin and
//   the leaving row are butterfly shuffle reductions over total orders —
//   (reduced cost, column), the ratio, (label, row) — so every order of
//   reduction gives the reference's first-index winner, and a NaN ratio
//   forces rmin to NaN through __any_sync as the reference's min does.
//   simplex_pivot: the whole (R+1, C0+1) tile in one round trip, the
//   normalised row once per column, then the update written back
//   coalesced, row and column indices stepped without a division.
//
// Roundings.  The rank-1 updates are one fused multiply-add per element
// (__fma_rn: a single rounding), the arithmetic of the plain PyTorch
// version (torch.addcmul in repro_torch/kernels/simplex_pivot/ref.py) and
// of XLA's code for the reference on the CPU; every dot product is one
// thread's serial sum in index order with explicit round-to-nearest
// intrinsics (nvcc would contract a*b + c otherwise), so structurally
// identical columns (identical jobs) price to bit-identical reduced costs
// and keep their exact ties; divisions are IEEE.
//
// Shared memory is sized at launch from the shape (`PivotSlot`,
// `ReducedSlot`); above 48 KB a CTA opts in to the device's limit, with
// fewer lanes per CTA where a full CTA's slots exceed it, and a lane whose
// slot alone exceeds it is refused (cudaErrorInvalidValue): there is no
// slower path.
//
// Interface: plain C, called through ctypes; each launcher returns
// cudaGetLastError() so the Python wrapper raises on a refused launch.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <utility>

namespace {

constexpr int kWarp = 32;
constexpr int kPivotWarps = 8;     // lanes (warps) per CTA: simplex_pivot
constexpr int kReducedWarps = 4;   // reduced_pivot
constexpr unsigned kAll = 0xffffffffu;
constexpr size_t kDefaultSmem = 48 * 1024;  // without opting in

__host__ __device__ constexpr size_t pad16(size_t bytes) {
  return (bytes + 15) & ~static_cast<size_t>(15);
}

// room for a staged array: 16 bytes more than it needs, for `place`
__host__ __device__ constexpr size_t staged(size_t bytes) {
  return pad16(bytes) + 16;
}

// byte offsets of one simplex_pivot lane's slot of shared memory
struct PivotSlot {
  size_t tab, row, bytes;
  __host__ __device__ PivotSlot(int R1, int C1) {
    tab = 0;                                        // (R1, C1) tile
    row = tab + staged(sizeof(double) * R1 * C1);   // (C1) pivot row / piv
    bytes = row + pad16(sizeof(double) * C1);
  }
};

// byte offsets of one reduced_pivot lane's slot of shared memory
struct ReducedSlot {
  size_t A, c, B, x, bas, cB, y, d, q, row, bytes;
  __host__ __device__ ReducedSlot(int R, int C0) {
    const size_t r8 = sizeof(double) * R;
    A = 0;                                      // (R, C0) column slab
    c = A + staged(sizeof(double) * R * C0);    // (C0) phase costs
    B = c + staged(sizeof(double) * C0);        // (R, R) basis inverse
    x = B + staged(r8 * R);                     // (R) basic solution
    bas = x + staged(r8);                       // (R) labels
    cB = bas + staged(sizeof(int) * R);         // (R) basic costs
    y = cB + pad16(r8);                         // (R) multipliers
    d = y + pad16(r8);                          // (R) FTRAN column
    q = d + pad16(r8);                          // (R) ratios
    row = q + pad16(r8);                        // (R + 1) [Binv | xB]_r / piv
    bytes = row + pad16(r8 + sizeof(double));
  }
};

// where a staged copy of `src` starts inside its 16-byte aligned region:
// at src's own offset modulo 16, so that the copy goes in 16-byte pieces
template <typename T>
__device__ __forceinline__ T* place(char* region, const T* src) {
  return reinterpret_cast<T*>(region +
                              (reinterpret_cast<uintptr_t>(src) & 15));
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(s), "l"(src), "n"(kBytes) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// `bytes` (a multiple of 4) from src to dst, which agree modulo 16
// (`place`), spread over the warp's threads t: a head and a tail of under
// 16 bytes in 4-byte pieces, the rest in 16-byte pieces
__device__ __forceinline__ void warp_copy(void* dst, const void* src,
                                          size_t bytes, int t) {
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  const size_t lead = (16 - (reinterpret_cast<uintptr_t>(s) & 15)) & 15;
  const size_t head = lead < bytes ? lead : bytes;
  const size_t end = head + ((bytes - head) & ~static_cast<size_t>(15));
  if (4 * static_cast<size_t>(t) < head) cp_async<4>(d + 4 * t, s + 4 * t);
  if (end + 4 * static_cast<size_t>(t) < bytes)
    cp_async<4>(d + end + 4 * t, s + end + 4 * t);
  for (size_t o = head + 16 * static_cast<size_t>(t); o < end;
       o += 16 * kWarp)
    cp_async<16>(d + o, s + o);
}

__device__ __forceinline__ long long lane_of() {
  return static_cast<long long>(blockIdx.x) * (blockDim.x / kWarp) +
         threadIdx.x / kWarp;
}

__global__ void __launch_bounds__(kPivotWarps * kWarp)
simplex_pivot_kernel(double* __restrict__ tabs, const int* __restrict__ r_in,
                     const int* __restrict__ j_in,
                     const unsigned char* __restrict__ mask, int B, int R1,
                     int C1) {
  extern __shared__ __align__(16) char smem[];
  const long long b = lane_of();
  if (b >= B || !mask[b]) return;               // skipped: no read, no write
  const int t = threadIdx.x % kWarp;
  const PivotSlot L(R1, C1);
  char* slot = smem + (threadIdx.x / kWarp) * L.bytes;
  const int n = R1 * C1;
  double* tab = tabs + b * n;
  double* stab = place(slot + L.tab, tab);
  double* prow = reinterpret_cast<double*>(slot + L.row);
  warp_copy(stab, tab, sizeof(double) * n, t);
  const int r = min(max(r_in[b], 0), R1 - 1);
  const int j = min(max(j_in[b], 0), C1 - 1);
  cp_async_wait_all();
  __syncwarp();                                 // staged before any write

  const double piv = stab[r * C1 + j];
  for (int k = t; k < C1; k += kWarp) prow[k] = stab[r * C1 + k] / piv;
  __syncwarp();
  // element e = i * C1 + k, stepped by kWarp without a division
  const int di = kWarp / C1, dk = kWarp % C1;
  int i = t / C1, k = t % C1;
  for (int e = t; e < n; e += kWarp) {
    tab[e] = i == r ? prow[k] : __fma_rn(-stab[i * C1 + j], prow[k], stab[e]);
    i += di;
    k += dk;
    if (k >= C1) { k -= C1; ++i; }
  }
}

// the ratio of row i in the ratio test: x_i / d_i for d_i > tol, else
// inf; 0 for a basic artificial (label >= C0) at level <= tol with
// |d_i| > tol, which is driven out first
__device__ __forceinline__ double ratio_of(double di, double xi, int lab,
                                           int C0, double tol) {
  double q = di > tol ? xi / di : CUDART_INF;
  if (lab >= C0 && fabs(di) > tol && xi <= tol) q = 0.0;
  return q;
}

// The AMR² LP of J jobs on two local models has R = J + 2 rows and
// C0 = 3J + 2 columns (12 jobs, the fleet's batch: 14 x 38).  reduced_pivot
// has an instance compiled for each J <= kMaxJobs, whose loops have
// constant trip counts; every other shape takes the generic instance
// (kR = kC0 = 0)
constexpr int kMaxJobs = 16;

template <int kR, int kC0>
__global__ void __launch_bounds__(kReducedWarps * kWarp)
reduced_pivot_kernel(const double* __restrict__ A,
                     const double* __restrict__ c, double* __restrict__ Binv,
                     double* __restrict__ xB, int* __restrict__ bas,
                     const unsigned char* __restrict__ use_bland,
                     const unsigned char* __restrict__ may_pivot,
                     const unsigned char* __restrict__ lane_ok,
                     unsigned char* __restrict__ flags, int B, int R_,
                     int C0_, double art_cost, double tol) {
  extern __shared__ __align__(16) char smem[];
  const int R = kR > 0 ? kR : R_;
  const int C0 = kC0 > 0 ? kC0 : C0_;
  const long long b = lane_of();
  if (b >= B) return;
  const int t = threadIdx.x % kWarp;
  const ReducedSlot L(R, C0);
  char* slot = smem + (threadIdx.x / kWarp) * L.bytes;
  const double* gA = A + b * R * C0;
  const double* gc = c + b * C0;
  double* gB = Binv + b * R * R;
  double* gx = xB + b * R;
  int* gbas = bas + b * R;
  double* sA = place(slot + L.A, gA);
  double* sc = place(slot + L.c, gc);
  double* sB = place(slot + L.B, gB);
  double* sx = place(slot + L.x, gx);
  int* sbas = place(slot + L.bas, gbas);
  double* scB = reinterpret_cast<double*>(slot + L.cB);
  double* sy = reinterpret_cast<double*>(slot + L.y);
  double* sd = reinterpret_cast<double*>(slot + L.d);
  double* sq = reinterpret_cast<double*>(slot + L.q);
  double* srow = reinterpret_cast<double*>(slot + L.row);

  // every load of the lane in flight at once; the slab only where the
  // lane may enter a column (else its column 0, for the ratio test)
  const bool ok = lane_ok[b] != 0;
  const bool bland = use_bland[b] != 0;
  const bool may = may_pivot[b] != 0;
  warp_copy(sB, gB, sizeof(double) * R * R, t);
  warp_copy(sx, gx, sizeof(double) * R, t);
  warp_copy(sbas, gbas, sizeof(int) * R, t);
  if (ok) {
    warp_copy(sA, gA, sizeof(double) * R * C0, t);
    warp_copy(sc, gc, sizeof(double) * C0, t);
  } else {
    for (int i = t; i < R; i += kWarp) cp_async<8>(sA + i * C0, gA + i * C0);
  }
  cp_async_wait_all();
  __syncwarp();

  int j = 0, has = 0;
  if (ok) {
    // BTRAN: y = cB Binv (virtual artificials, label >= C0, price at
    // art_cost), thread k computing y_k
    for (int i = t; i < R; i += kWarp) {
      const int lab = sbas[i];
      scB[i] = lab >= C0 ? art_cost : sc[max(lab, 0)];
    }
    __syncwarp();
    for (int k = t; k < R; k += kWarp) {
      double s = 0.0;
      for (int i = 0; i < R; ++i)
        s = __dadd_rn(s, __dmul_rn(scB[i], sB[i * R + k]));
      sy[k] = s;
    }
    __syncwarp();
    // pricing, one column per thread: Dantzig = the first column of the
    // most negative reduced cost, Bland = the first eligible column
    double vmin = CUDART_INF;
    int jd = INT_MAX, jb = INT_MAX;
    for (int k = t; k < C0; k += kWarp) {
      double s = 0.0;
      for (int i = 0; i < R; ++i)
        s = __dadd_rn(s, __dmul_rn(sy[i], sA[i * C0 + k]));
      const double v = __dsub_rn(sc[k], s);
      if (v < -tol) {
        jb = min(jb, k);
        if (v < vmin) { vmin = v; jd = k; }
      }
    }
    for (int o = kWarp / 2; o > 0; o /= 2) {
      const double v2 = __shfl_xor_sync(kAll, vmin, o);
      const int j2 = __shfl_xor_sync(kAll, jd, o);
      if (v2 < vmin || (v2 == vmin && j2 < jd)) { vmin = v2; jd = j2; }
      jb = min(jb, __shfl_xor_sync(kAll, jb, o));
    }
    has = jb != INT_MAX;
    j = has ? (bland ? jb : jd) : 0;
  }

  // FTRAN: d = Binv A_j, and the ratio test, one row per thread
  double rmin = CUDART_INF;
  bool any_finite = false, any_nan = false;
  for (int i = t; i < R; i += kWarp) {
    double s = 0.0;
    for (int k = 0; k < R; ++k)
      s = __dadd_rn(s, __dmul_rn(sB[i * R + k], sA[k * C0 + j]));
    sd[i] = s;
    const double q = ratio_of(s, sx[i], sbas[i], C0, tol);
    sq[i] = q;
    any_nan |= q != q;
    any_finite |= q < CUDART_INF;
    if (q < rmin) rmin = q;
  }
  for (int o = kWarp / 2; o > 0; o /= 2)
    rmin = fmin(rmin, __shfl_xor_sync(kAll, rmin, o));
  if (__any_sync(kAll, any_nan)) rmin = CUDART_NAN;  // min propagates NaN
  const bool unbounded = !__any_sync(kAll, any_finite);
  // among rows within the tie band, the smallest basis label, the first
  // row on equal labels: the least (label, row), labels ordered as int32
  const double band =
      __dadd_rn(rmin, fmax(__dmul_rn(fabs(rmin), 1e-9), 1e-12));
  unsigned long long key = ~0ull;
  for (int i = t; i < R; i += kWarp) {
    const int lab = sq[i] <= band ? sbas[i] : INT_MAX;
    const unsigned long long k =
        static_cast<unsigned long long>(static_cast<unsigned>(lab) ^
                                        0x80000000u) << 32 |
        static_cast<unsigned>(i);
    if (k < key) key = k;
  }
  for (int o = kWarp / 2; o > 0; o /= 2) {
    const unsigned long long k2 = __shfl_xor_sync(kAll, key, o);
    if (k2 < key) key = k2;
  }
  const int r = static_cast<int>(key & 0xffffffffu);
  if (t == 0) {
    flags[b * 3 + 0] = static_cast<unsigned char>(has);
    flags[b * 3 + 1] = static_cast<unsigned char>(unbounded);
    flags[b * 3 + 2] = static_cast<unsigned char>(rmin <= tol);
  }
  if (!(may && has && !unbounded)) return;      // factor passes through

  // eta update of [Binv | xB] from the staged copies
  __syncwarp();                                 // sd of every row
  const double piv = sd[r];
  for (int k = t; k <= R; k += kWarp)
    srow[k] = (k < R ? sB[r * R + k] : sx[r]) / piv;
  __syncwarp();
  const int di = kWarp / R, dk = kWarp % R;
  int i = t / R, k = t % R;
  for (int e = t; e < R * R; e += kWarp) {
    gB[e] = i == r ? srow[k] : __fma_rn(-sd[i], srow[k], sB[e]);
    i += di;
    k += dk;
    if (k >= R) { k -= R; ++i; }
  }
  for (int i2 = t; i2 < R; i2 += kWarp)
    gx[i2] = i2 == r ? srow[R] : __fma_rn(-sd[i2], srow[R], sx[i2]);
  if (t == 0) gbas[r] = j;
}

// lanes per CTA and the CTA's shared memory for lane slots of `slot`
// bytes: kMax slots, or as many as the device's opt-in limit holds when
// they exceed 48 KB (the kernel then opts in, once per device);
// cudaErrorInvalidValue when not one slot fits
template <int kMax, typename F>
cudaError_t plan(F* fn, size_t slot, unsigned& opted_in, int* warps,
                 size_t* smem) {
  *warps = kMax;
  *smem = slot * kMax;
  if (*smem <= kDefaultSmem) return cudaSuccess;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const size_t fit = static_cast<size_t>(optin) / slot;
  *warps = fit < kMax ? static_cast<int>(fit) : kMax;
  if (*warps == 0) return cudaErrorInvalidValue;
  *smem = slot * *warps;
  if (dev < 32 && (opted_in >> dev & 1u)) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err == cudaSuccess && dev < 32) opted_in |= 1u << dev;
  return err;
}

using ReducedKernel = decltype(&reduced_pivot_kernel<0, 0>);

// the instances for J = 1 .. kMaxJobs jobs, at index J - 1
template <int... I>
const ReducedKernel* job_instances(std::integer_sequence<int, I...>) {
  static const ReducedKernel table[] = {
      reduced_pivot_kernel<I + 3, 3 * I + 5>...};
  return table;
}

// the job count J of the instance for (R, C0), 0 for the generic one
int jobs_of(int R, int C0) {
  const int jobs = R - 2;
  return jobs >= 1 && jobs <= kMaxJobs && C0 == 3 * jobs + 2 ? jobs : 0;
}

// the reduced_pivot instance for (R, C0), and its opt-in bits
ReducedKernel reduced_kernel_for(int R, int C0, unsigned** opted_in) {
  static unsigned opted[kMaxJobs + 1] = {};     // [J - 1]; generic last
  const int jobs = jobs_of(R, C0);
  if (jobs == 0) {
    *opted_in = &opted[kMaxJobs];
    return reduced_pivot_kernel<0, 0>;
  }
  *opted_in = &opted[jobs - 1];
  return job_instances(std::make_integer_sequence<int, kMaxJobs>())[jobs - 1];
}

unsigned g_simplex_opted_in = 0;

cudaError_t simplex_plan(int R1, int C1, int* warps, size_t* smem) {
  if (R1 < 1 || C1 < 1) return cudaErrorInvalidValue;
  return plan<kPivotWarps>(simplex_pivot_kernel, PivotSlot(R1, C1).bytes,
                           g_simplex_opted_in, warps, smem);
}

cudaError_t reduced_plan(int R, int C0, int* warps, size_t* smem,
                         ReducedKernel* fn) {
  if (R < 1 || C0 < 1) return cudaErrorInvalidValue;
  unsigned* opted_in = nullptr;
  *fn = reduced_kernel_for(R, C0, &opted_in);
  return plan<kReducedWarps>(*fn, ReducedSlot(R, C0).bytes, *opted_in,
                             warps, smem);
}

template <typename F>
int occupancy(F* fn, cudaError_t err, int warps, size_t smem, int* out) {
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, fn,
                                                        warps * kWarp, smem);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

int simplex_pivot_launch(double* tabs, const int* r, const int* j,
                         const unsigned char* mask, int B, int R1, int C1,
                         cudaStream_t stream) {
  if (B > 0) {
    int warps = 0;
    size_t smem = 0;
    const cudaError_t err = simplex_plan(R1, C1, &warps, &smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    simplex_pivot_kernel<<<(B + warps - 1) / warps, warps * kWarp, smem,
                           stream>>>(tabs, r, j, mask, B, R1, C1);
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
    int warps = 0;
    size_t smem = 0;
    ReducedKernel fn = nullptr;
    const cudaError_t err = reduced_plan(R, C0, &warps, &smem, &fn);
    if (err != cudaSuccess) return static_cast<int>(err);
    fn<<<(B + warps - 1) / warps, warps * kWarp, smem, stream>>>(
        A, c, Binv, xB, bas, use_bland, may_pivot, lane_ok, flags, B, R, C0,
        art_cost, tol);
  }
  return static_cast<int>(cudaGetLastError());
}

// Lanes per CTA, shared memory per CTA and CTAs per SM (the occupancy
// calculator) of each kernel at a shape: simplex_pivot for (R1, C1)
// tableaus, reduced_pivot for (R, C0) slabs.
int simplex_pivot_occupancy(int R1, int C1, int* warps, long long* smem,
                            int* ctas) {
  size_t bytes = 0;
  const cudaError_t err = simplex_plan(R1, C1, warps, &bytes);
  *smem = static_cast<long long>(bytes);
  return occupancy(simplex_pivot_kernel, err, *warps, bytes, ctas);
}

// The job count J of the compiled reduced_pivot instance that an (R, C0)
// slab takes, 0 for the generic instance.
int reduced_pivot_instance(int R, int C0) { return jobs_of(R, C0); }

int reduced_pivot_occupancy(int R, int C0, int* warps, long long* smem,
                            int* ctas) {
  size_t bytes = 0;
  ReducedKernel fn = nullptr;
  const cudaError_t err = reduced_plan(R, C0, warps, &bytes, &fn);
  *smem = static_cast<long long>(bytes);
  return occupancy(fn, err, *warps, bytes, ctas);
}

}  // extern "C"
