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
// is 4.09 GB, 1.22 ms at 3.35 TB/s; the walks' ~3 float operations per q
// are below the FP32 rate there, but not for a grid of hundreds of
// columns, whose walks are hundreds of q long.
//
// Every model reads the previous model's whole grid and writes another
// (ping-pong), so the cells of one model are independent of each other:
// no stage, and no barrier inside a model.  Two instances, chosen by the
// wrapper's `plan` from the shape and the card:
//
//   * Many lanes (`cckp_lanes_kernel`: three grids of a lane fit a
//     block's shared memory, and two lanes or more, or one small lane,
//     which one SM walks sooner than the split instance): persistent CTAs
//     that take lanes by an atomic ticket.  A copy warp loads the next
//     lane's grid by one bulk copy (`cp.async.bulk ... complete_tx`) into
//     the third buffer while sixteen warps walk the current lane between
//     the other two, and stores each final grid by a bulk store from
//     shared memory (`cp.async.bulk.global.shared::cta`; a lane's base is
//     only 4-byte aligned, so the enclosing 16-byte range is loaded and
//     the ragged head and tail of a store go by plain stores).  A thread walks
//     one row, its cells in registers (compiled for K1 <= 16: every (q,
//     k >= q) pair unrolled, the q * a of a q formed once); a warp's 32
//     rows of argmax counts are staged in shared memory and stored as
//     coalesced 128-byte runs.
//   * Split (`cckp_split_kernel`, any other shape: one large lane, or
//     grids too large for shared memory): a persistent grid of CTAs walks
//     units of one (model i, lane b, tile of rows x 32 columns),
//     model-major, from an atomic ticket.  Model i reads one grid in device memory (y, `out`
//     or a scratch grid) and writes the other, so a unit of model i + 1
//     waits only until the (lane, model i) count, published with release,
//     reaches the lane's tile count (acquire).  Tickets go out in order
//     and a CTA holds one unit at a time, so every earlier ticket belongs
//     to a running CTA: no deadlock.  A warp's lanes take consecutive
//     columns, so a q's reads of row t - q p are 32 consecutive floats from
//     L2 (the grids of a few lanes lie well inside its 50 MB), and each
//     thread keeps kRows (4, 2 or 1) rows of one column in registers,
//     walked q outer, so a q issues kRows independent loads.  Fewer rows
//     leave room for more CTAs an SM (6 at 4 rows against 4 at 8), and
//     more, smaller units shorten the tail of a model; the columns go out
//     from the right, the longest walks first.
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
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                   // warps of a split CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kLaneWarps = 16;              // walking warps, many-lane CTA
constexpr int kWalkers = 32 * kLaneWarps;
constexpr int kLaneThreads = kWalkers + 32; // and the copy warp
constexpr int kBuffers = 3;                 // two grids walked, one loading
constexpr int kMaxFixedK = 16;
constexpr int kPiece = 32768;               // bytes of one bulk copy
constexpr float kNeg = -1e30f;

enum Instance { kLanes = 0, kSplit = 1 };

#ifdef CCKP_STAMPS
// CCKP_STAMP_DECL
#endif

// ---- sizes (mirrored by ops.py) ------------------------------------------
// one buffer: a lane's grid and the up to 12 bytes before it that align
// its bulk copy, rounded up to 16 bytes
size_t buffer_bytes(int T1, int K1) {
  return (static_cast<size_t>(T1) * K1 * 4 + 12 + 15) / 16 * 16;
}

// the lanes instance: three buffers, each warp's stage of 32 rows of
// counts, four mbarriers and the three buffers' lane tickets
size_t lanes_smem_bytes(int T1, int K1) {
  return kBuffers * buffer_bytes(T1, K1)
         + static_cast<size_t>(kLaneWarps) * 32 * K1 * 4 + 4 * 8 + 16;
}

// ---- mbarriers and bulk copies ---------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// arrive once and add ``bytes`` to the phase's expected transactions
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// until the phase of ``parity`` has completed (no time limit: a trap would
// hold ptxas to the launch's register count)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
  }
}

// ``bytes`` (a multiple of 16, both addresses 16-byte aligned) from global
// to shared memory, completing on ``bar``
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// the same from shared to global memory, in this thread's bulk group
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until this thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// until this thread's bulk stores are complete
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// order this thread's generic-proxy accesses to shared memory before later
// bulk copies from or into it
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the kWalkers walking threads (named barrier 1; the copy warp is not in it)
__device__ __forceinline__ void walkers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kWalkers) : "memory");
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

// ---- the walks -----------------------------------------------------------
// Row t's cells with K1 == kK known at compile time: q outer, the row's
// cells in registers, every (q, k >= q) pair unrolled and free of branches,
// so that the loads of every q can issue ahead of the compares, and a q's
// q * a is formed once.  A q at or past q_cap reads row max(t - q p, 0),
// inside the grid, and adds -inf, which never wins: the reference's NEG +
// q * a == NEG never beats best >= NEG either.  Each cell still takes its q
// in increasing order.  p <= T1 (a larger p walks q = 0 alone), so q p
// stays below (kK - 1) T1 < 2^31.
template <int kK>
__device__ __forceinline__ void walk_row_fixed(const float* in, int t, int p,
                                               int q_cap, float ai,
                                               float (&best)[kK],
                                               int (&bq)[kK]) {
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    best[k] = kNeg;
    bq[k] = 0;
  }
#pragma unroll
  for (int q = 0; q < kK; ++q) {
    const float* const src = in + max(t - q * p, 0) * kK - q;
    const float w = q < q_cap ? __fmul_rn(static_cast<float>(q), ai)
                              : __int_as_float(0xff800000);     // -inf
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

// The same for any K1, cell by cell, into the output row and the count row.
__device__ __forceinline__ void walk_row(const float* in, int t, int K1,
                                         int stride, int q_cap, float ai,
                                         float* vrow, int* qrow) {
  for (int k = 0; k < K1; ++k) {
    const int q_end = min(q_cap, k + 1);             // k - q >= 0
    float best = kNeg;
    int bq = 0;
    const float* src = in + t * K1 + k;              // q = 0
    for (int q = 0; q < q_end; ++q, src -= stride) {
      const float v = __fadd_rn(*src, __fmul_rn(static_cast<float>(q), ai));
      if (v > best) {
        best = v;
        bq = q;
      }
    }
    vrow[k] = best;
    qrow[k] = bq;
  }
}

// q < q_cap for row t of a model of time p: the walk stops where t - q p
// turns negative (p == 0 never does); and the index stride of one q
__device__ __forceinline__ int row_cap(int t, int p, int n_steps) {
  return min(n_steps, p > 0 ? t / p + 1 : INT_MAX);
}

__device__ __forceinline__ int q_stride(int p, int T1, int K1) {
  return p <= T1 ? p * K1 + 1 : 0;         // q p <= t < T1 for every q walked
}

// ---- the many-lane instance ---------------------------------------------
// One model of the lane in `in` into `out` (shared memory, the lane's grid
// at the same offset in both), its counts into `table` (device memory)
// through the warp's `stage`.
template <int kK>
__device__ __forceinline__ void walk_lane_model(const float* in, float* out,
                                                int* stage, int* table,
                                                int T1, int K1, int p,
                                                float ai, int n_steps,
                                                int warp, int lane) {
  const int stride = q_stride(p, T1, K1);
  const int p_row = min(p, T1);
  for (int t0 = warp * 32; t0 < T1; t0 += kWalkers) {
    const int t = t0 + lane;
    if (t < T1) {
      const int q_cap = row_cap(t, p, n_steps);
      if constexpr (kK > 0) {
        float best[kK];
        int bq[kK];
        walk_row_fixed<kK>(in, t, p_row, q_cap, ai, best, bq);
#pragma unroll
        for (int k = 0; k < kK; ++k) {
          out[t * kK + k] = best[k];
          stage[lane * kK + k] = bq[k];
        }
      } else {
        walk_row(in, t, K1, stride, q_cap, ai, out + t * K1,
                 stage + lane * K1);
      }
    }
    __syncwarp();
    // the warp's rows t0 .. t0 + 31 are one run of the table
    const int n = (min(T1, t0 + 32) - t0) * K1;
    int* const dst = table + static_cast<size_t>(t0) * K1;
    for (int e = lane; e < n; e += 32) dst[e] = stage[e];
    __syncwarp();
  }
}

// Persistent CTAs of kWalkers walking threads and one copy warp.  p and a
// are (B, m); bestq is (m, B, T1, K1); ticket[0] is zeroed by the launcher.
// y and out are 16-byte aligned, so a lane's grid starts at the same
// offset from a 16-byte boundary in both.
// (one CTA an SM: ptxas then keeps every compiled walk in registers)
template <int kK>
__global__ void __launch_bounds__(kLaneThreads, 1)
cckp_lanes_kernel(const float* __restrict__ y, const int* __restrict__ p,
                  const float* __restrict__ a, float* __restrict__ out,
                  int* __restrict__ bestq, unsigned* ticket, int B, int T1,
                  int K1_arg, int m, int n_steps, int buf_bytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int K1 = kK > 0 ? kK : K1_arg;
  const int cells = T1 * K1;
  int* const stages = reinterpret_cast<int*>(smem + kBuffers * buf_bytes);
  uint64_t* const bars = reinterpret_cast<uint64_t*>(
      stages + kLaneWarps * 32 * K1);
  const uint32_t full0 = smem_addr(bars);    // full[s] = full0 + 8 s
  const uint32_t done = smem_addr(bars + kBuffers);
  int* const lane_of = reinterpret_cast<int*>(bars + kBuffers + 1);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kBuffers; ++s) mbar_init(full0 + 8 * s, 1);
    mbar_init(done, kWalkers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // lane b's grid in buffer s: the 16-byte-aligned range around it
  auto grid_in = [&](int s, int b) -> float* {
    const uintptr_t at = reinterpret_cast<uintptr_t>(
        y + static_cast<size_t>(b) * cells);
    return reinterpret_cast<float*>(smem + s * buf_bytes + (at & 15));
  };

  if (warp == kLaneWarps) {              // the copy warp: one thread
    if (lane != 0) return;
    const size_t lane_bytes = static_cast<size_t>(cells) * 4;
    // a ticket's lane into buffer s; false once the tickets are spent
    auto load = [&](int s) -> bool {
      const int b = static_cast<int>(atomicAdd(ticket, 1u));
      lane_of[s] = b;
      if (b >= B) {
        mbar_arrive(full0 + 8 * s);      // the phase completes: no lane
        return false;
      }
      const uintptr_t at = reinterpret_cast<uintptr_t>(
          y + static_cast<size_t>(b) * cells);
      const char* from = reinterpret_cast<const char*>(at & ~uintptr_t(15));
      const uint32_t bytes = static_cast<uint32_t>(
          ((at & 15) + lane_bytes + 15) / 16 * 16);
      const uint32_t dst = smem_addr(smem + s * buf_bytes);
      mbar_expect(full0 + 8 * s, bytes);
      for (uint32_t o = 0; o < bytes; o += kPiece)
        bulk_load(dst + o, from + o, min(bytes - o, uint32_t(kPiece)),
                  full0 + 8 * s);
      return true;
    };
    int in = 0, work = 1, spare = 2;
    bool more = load(in) && load(spare);
    for (uint32_t parity = 0; lane_of[in] < B; parity ^= 1) {
      mbar_wait(done, parity);           // the walkers are done with it
      const int b = lane_of[in];
      const int fin = m % 2 == 0 ? in : work;
      const float* const g = grid_in(fin, b);
      float* const dst = out + static_cast<size_t>(b) * cells;
      // head and tail by plain stores, the 16-byte-aligned middle in bulk
      const int head = min(cells, static_cast<int>(
          ((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) / 4));
      const int body = (cells - head) / 4 * 4;
      for (int e = 0; e < head; ++e) dst[e] = g[e];
      for (int e = head + body; e < cells; ++e) dst[e] = g[e];
      for (int o = 0; o < body * 4; o += kPiece)
        bulk_store(reinterpret_cast<char*>(dst + head) + o,
                   smem_addr(g + head) + o, min(body * 4 - o, kPiece));
      bulk_commit();
      const int other = fin == in ? work : in;
      in = spare;
      work = other;
      spare = fin;
      if (more) {
        bulk_wait_read();                // the store has read its buffer
        more = load(spare);
      }
    }
    bulk_wait();
    return;
  }

#ifdef CCKP_STAMPS
  const unsigned long long sn0 = stamp_ns(), sc0 = clock64();
  unsigned long long mark = sc0, ph[5] = {0, 0, 0, 0, 0}, n_lanes = 0;
#define CCKP_STAMP(f)                                   \
  do {                                                  \
    const unsigned long long x_ = clock64();            \
    ph[f] += x_ - mark;                                 \
    mark = x_;                                          \
  } while (0)
#else
#define CCKP_STAMP(f) do {} while (0)
#endif
  int* const stage = stages + warp * 32 * K1;
  int in = 0, work = 1, spare = 2;
  for (uint32_t parity = 0;;) {          // bit s: buffer s's full phase
    mbar_wait(full0 + 8 * in, (parity >> in) & 1);
    parity ^= 1u << in;
    CCKP_STAMP(0);
    const int b = lane_of[in];
    if (b >= B) break;
    for (int i = 0; i < m; ++i) {
      const int src = i % 2 == 0 ? in : work;
      walk_lane_model<kK>(grid_in(src, b), grid_in(src == in ? work : in, b),
                          stage,
                          bestq + (static_cast<size_t>(i) * B + b) * cells,
                          T1, K1, p[b * m + i], a[b * m + i], n_steps, warp,
                          lane);
      CCKP_STAMP(1);
      walkers_sync();                    // model i's grid is whole
      CCKP_STAMP(2);
    }
    fence_proxy_async();                 // the final grid, for the store
    mbar_arrive(done);
    CCKP_STAMP(4);
#ifdef CCKP_STAMPS
    ++n_lanes;
#endif
    const int fin = m % 2 == 0 ? in : work;
    const int other = fin == in ? work : in;
    in = spare;
    work = other;
    spare = fin;
  }
#ifdef CCKP_STAMPS
  if (threadIdx.x == 0)
    stamp_write(sn0, sc0, ph[0], ph[1], ph[2], ph[3], ph[4], n_lanes);
#endif
#undef CCKP_STAMP
}

// ---- the split instance ------------------------------------------------
// Units of (model i, lane b, tile): tile rb col_blocks + c covers rows
// [rb R, rb R + R) with R = kWarps kRows, warp w its kRows rows from rb R +
// w kRows, and the columns [32 cb, 32 cb + 32) of block cb = col_blocks - 1
// - c, thread `lane` column 32 cb + lane.  Model i
// writes `out` when m - 1 - i is even and `scratch` otherwise, so the last
// model writes `out`; model 0 reads y, model i > 0 what model i - 1 wrote.
// sync[0] is the ticket, sync[1 + b m + i] the tiles of (lane b, model i)
// done; the launcher zeroes them.  With m == 0 the units copy y into out.
template <int kRows>
__global__ void __launch_bounds__(kThreads)
cckp_split_kernel(const float* y, const int* __restrict__ p,
                  const float* __restrict__ a, float* out, float* scratch,
                  int* __restrict__ bestq, unsigned* sync, int B, int T1,
                  int K1, int m, int n_steps) {
  __shared__ int unit_of;
  constexpr int kR = kWarps * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int cells = T1 * K1;
  const int col_blocks = (K1 + 31) / 32;
  const int tiles = (T1 + kR - 1) / kR * col_blocks;
  const long long units = static_cast<long long>(max(m, 1)) * B * tiles;
  for (;;) {
    if (threadIdx.x == 0) unit_of = static_cast<int>(atomicAdd(sync, 1u));
    __syncthreads();
    const int u = unit_of;
    if (u >= units) break;
    const int i = u / (B * tiles);
    const int b = u / tiles % B;
    const int tile = u % tiles;
    // the columns from the right: the longest walks go out first
    const int k = (col_blocks - 1 - tile % col_blocks) * 32 + lane;
    const int t0 = tile / col_blocks * kR + warp * kRows;
    const size_t lane_at = static_cast<size_t>(b) * cells;
    if (m == 0) {                        // no model: the grid goes through
      for (int j = 0; j < kRows; ++j)
        if (t0 + j < T1 && k < K1)
          out[lane_at + (t0 + j) * K1 + k] = y[lane_at + (t0 + j) * K1 + k];
      __syncthreads();
      continue;
    }
    const bool to_out = (m - 1 - i) % 2 == 0;
    const float* const in =
        (i == 0 ? y : to_out ? scratch : out) + lane_at;
    float* const dst = (to_out ? out : scratch) + lane_at;
    if (i > 0 && threadIdx.x == 0) {     // model i - 1 of this lane, whole
      const unsigned* const ready = sync + 1 + b * m + i - 1;
      while (ld_acquire(ready) < static_cast<unsigned>(tiles)) {
      }
    }
    __syncthreads();
    if (k < K1) {
      const int pi = p[b * m + i];
      const float ai = a[b * m + i];
      const int stride = q_stride(pi, T1, K1);
      float best[kRows];
      int bq[kRows], q_cap[kRows];
      int q_end = 0;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        best[j] = kNeg;
        bq[j] = 0;
        q_cap[j] = t0 + j < T1 ? row_cap(t0 + j, pi, n_steps) : 0;
        q_end = max(q_end, q_cap[j]);
      }
      q_end = min(q_end, k + 1);                       // k - q >= 0
      const float* src = in + static_cast<ptrdiff_t>(t0) * K1 + k;
      for (int q = 0; q < q_end; ++q, src -= stride) {
        const float w = __fmul_rn(static_cast<float>(q), ai);
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          if (q < q_cap[j]) {
            const float v = __fadd_rn(src[j * K1], w);
            if (v > best[j]) {
              best[j] = v;
              bq[j] = q;
            }
          }
        }
      }
      int* const table =
          bestq + (static_cast<size_t>(i) * B + b) * cells;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (t0 + j < T1) {
          dst[(t0 + j) * K1 + k] = best[j];
          table[(t0 + j) * K1 + k] = bq[j];
        }
      }
    }
    __syncthreads();                     // the unit's cells are written
    if (threadIdx.x == 0) red_release_add(sync + 1 + b * m + i, 1u);
  }
}

// ---- instances, occupancy and launch -----------------------------------
using LanesFn = void (*)(const float*, const int*, const float*, float*,
                         int*, unsigned*, int, int, int, int, int, int);
using SplitFn = void (*)(const float*, const int*, const float*, float*,
                         float*, int*, unsigned*, int, int, int, int, int);

template <int kK>
LanesFn lanes_fixed(int K1) {
  if constexpr (kK > kMaxFixedK) {
    return cckp_lanes_kernel<0>;
  } else {
    return K1 == kK ? cckp_lanes_kernel<kK> : lanes_fixed<kK + 1>(K1);
  }
}

SplitFn split_kernel(int rows) {
  switch (rows) {
    case 1: return cckp_split_kernel<1>;
    case 2: return cckp_split_kernel<2>;
    case 4: return cckp_split_kernel<4>;
    default: return nullptr;
  }
}

// the kernel, its threads and its dynamic shared memory for an instance
cudaError_t kernel_of(int instance, int T1, int K1, int rows,
                      const void** fn, int* threads, size_t* smem) {
  if (instance == kLanes) {
    *fn = reinterpret_cast<const void*>(lanes_fixed<1>(K1));
    *threads = kLaneThreads;
    *smem = lanes_smem_bytes(T1, K1);
    return cudaFuncSetAttribute(*fn,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(*smem));
  }
  if (instance != kSplit || split_kernel(rows) == nullptr)
    return cudaErrorInvalidValue;
  *fn = reinterpret_cast<const void*>(split_kernel(rows));
  *threads = kThreads;
  *smem = 0;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Dynamic shared memory (bytes) of one CTA of an instance (0 the many-lane
// one, 1 the split one) for a (T1, K1) grid.
long long cckp_dp_smem_bytes(int instance, int T1, int K1) {
  return instance == kLanes
             ? static_cast<long long>(lanes_smem_bytes(T1, K1)) : 0;
}

// A block's opt-in shared memory on the current device.
int cckp_dp_max_shared(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<int>(err);
}

// CTAs of an instance that fit one SM for a (T1, K1) grid (``rows``: the
// split instance's rows a warp holds), as the occupancy calculator gives it.
int cckp_dp_occupancy(int instance, int T1, int K1, int rows, int* blocks) {
  const void* fn = nullptr;
  int threads = 0;
  size_t smem = 0;
  cudaError_t err = kernel_of(instance, T1, K1, rows, &fn, &threads, &smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, threads,
                                                        smem);
  return static_cast<int>(err);
}

// y (B, T1, K1) float32, 16-byte aligned; p, a (B, m) int32 / float32; out
// (B, T1, K1) float32, 16-byte aligned; bestq (m, B, T1, K1) int32, all
// contiguous.  scratch: a (B, T1, K1) float32 grid for the split instance
// when m >= 2 (else unused); sync: 1 + B m unsigned ints (the split
// instance) or 1 (the many-lane one), zeroed here.  ``ctas`` persistent
// CTAs of ``instance`` (0 many-lane, 1 split with ``rows`` rows a warp).
// T1 * K1 < 2^31.
int cckp_models_dp_launch(const float* y, const int* p, const float* a,
                          float* out, int* bestq, float* scratch,
                          unsigned* sync, int B, int T1, int K1, int m,
                          int n_steps, int instance, int rows, int ctas,
                          cudaStream_t stream) {
  if (B < 0 || T1 < 0 || K1 < 0 || m < 0 ||
      static_cast<long long>(T1) * K1 > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || static_cast<long long>(T1) * K1 == 0)
    return static_cast<int>(cudaGetLastError());
  if (ctas < 1) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = nullptr;
  int threads = 0;
  size_t smem = 0;
  cudaError_t err = kernel_of(instance, T1, K1, rows, &fn, &threads, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n_sync = instance == kLanes
                            ? 1 : 1 + static_cast<size_t>(B) * m;
  err = cudaMemsetAsync(sync, 0, sizeof(unsigned) * n_sync, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (instance == kLanes) {
    reinterpret_cast<LanesFn>(const_cast<void*>(fn))
        <<<ctas, threads, smem, stream>>>(
            y, p, a, out, bestq, sync, B, T1, K1, m, n_steps,
            static_cast<int>(buffer_bytes(T1, K1)));
  } else {
    reinterpret_cast<SplitFn>(const_cast<void*>(fn))
        <<<ctas, threads, 0, stream>>>(y, p, a, out, scratch, bestq, sync,
                                       B, T1, K1, m, n_steps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
