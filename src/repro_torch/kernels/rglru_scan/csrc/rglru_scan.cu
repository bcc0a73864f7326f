// RG-LRU linear recurrence for Hopper (sm_90a), float32.
//
// Replaces the Pallas kernel of src/repro/kernels/rglru_scan/rglru_scan.py
// (`rglru_scan_fwd`, body `_kernel`): for every batch row b and channel w
//
//     h[b, t, w] = a[b, t, w] * h[b, t - 1, w] + x[b, t, w],   h[b, -1, w] = 0
//
// over a, x and h of shape (B, S, W), contiguous.  The TPU kernel walks the
// sequence as a sequential grid axis and carries the (1, 512) state in VMEM
// scratch; here a loop inside the CTA takes the place of that axis.
//
// Bound.  The call is bound by bytes: 12 bytes per (token, channel), a and
// x read once and h written once, for 2 operations.  At recurrentgemma-9b's
// forward shape (2 x 4096 tokens x 4096 channels) that is 403 MB, 0.12 ms at
// the card's 3.35 TB/s.  To stream at that rate the card needs ~2.3 MB of
// loads in flight (Little's law at ~0.7 us of loaded latency), ~17 KB an SM.
//
// Design: one pass, a and x read once.
//   * A CTA owns one (batch row, group of C channels) and walks the sequence
//     in tiles of L steps x C channels.  The tiles stream through a ring of
//     kStages shared-memory slots filled by `cp.async` (16-byte copies where
//     W and the pointers allow, else 4-byte ones; steps past S and channels
//     past W are zero-filled): while tile n is scanned, tiles n + 1 ...
//     n + kStages - 1 are in flight.  At recurrentgemma-9b's shapes a tile
//     is C = 32 channels x L = 64 steps, 16 KB of a and x; with two or more
//     CTAs an SM two stages keep ~32 KB an SM in flight (deeper rings
//     measured slower there), a call of fewer CTAs takes four.
//   * Inside a tile the steps are split over the CTA's 256 threads: thread
//     (k, c) owns sub-chunk k (L / split steps, split = 256 / C) of channel
//     c.  It loads its steps from shared memory into registers and scans
//     them from 0, keeping (P_k = prod a, H_k = local h at the sub-chunk's
//     end).  After one barrier every thread folds the (P_j, H_j) of its
//     channel serially from the tile's incoming state, h <- P_j h + H_j over
//     j = 0 ... split - 1, taking its own incoming state at j = k and the
//     next tile's at the end; then it rescans its steps from that state in
//     registers and writes h with streaming stores (one 128-byte line a
//     warp and step at C = 32).  A tile's critical path is ~L / split + split
//     FMAs, short against its loads, so the loads set the pace.
//   * C by shape (`ops.launch_geometry`): 32 channels (whole 128-byte lines)
//     where B * W / 32 CTAs reach half the SMs, else 16, else 8 (whole
//     32-byte sectors), so that a narrow call still puts a CTA on most SMs,
//     with a deeper ring to keep more bytes in flight a CTA.  Below
//     32 the sub-chunks of a warp lie C floats apart in shared memory, so
//     their lanes hit distinct banks.
// Arithmetic: h_t is the serial recurrence restarted from its sub-chunk's
// incoming state, which comes from the fold above; every step is one
// `fmaf`, every product one multiply.  `ref.rglru_tiled_ref` associates
// exactly so.
//
// Interface: plain C, called through ctypes; the launcher returns
// cudaGetLastError() so the Python wrapper raises on a refused launch.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;        // opt-in shared memory of a CTA

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of kBytes (16: .cg, 4: .ca); n_src = 0 writes zeros
template <int kBytes>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int n_src) {
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(n_src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(dst), "l"(src), "n"(kBytes), "r"(n_src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// The shared-memory layout of one (L steps x C channels) tile of one array.
template <int C, int L>
struct Tile {
  static constexpr int kSplit = kThreads / C;        // sub-chunks
  static constexpr int kSub = L / kSplit;            // steps of a sub-chunk
  static constexpr int kPad = C < 32 ? C : 0;        // floats between them
  static constexpr int kSubStride = kSub * C + kPad;
  static constexpr int kFloats = kSplit * kSubStride;
  static_assert(C % 4 == 0 && kThreads % C == 0 && L % kSplit == 0,
                "tile shape");
  // float offset of (step t, channel c) inside the tile
  static __device__ __forceinline__ int at(int t, int c) {
    return (t / kSub) * kSubStride + (t % kSub) * C + c;
  }
};

// dynamic shared memory of a CTA: the ring (a and x) and the (P, H) pairs
template <int C, int L, int kStages>
constexpr size_t smem_bytes() {
  using T = Tile<C, L>;
  return sizeof(float) * (static_cast<size_t>(kStages) * 2 * T::kFloats
                          + 2 * T::kSplit * C);
}

template <int C, int L, int kStages>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ x,
                  float* __restrict__ h, int S, int W, int groups,
                  int vec16) {
  using T = Tile<C, L>;
  extern __shared__ __align__(16) float smem[];
  float* const pairs_p = smem + kStages * 2 * T::kFloats;  // (split, C)
  float* const pairs_h = pairs_p + T::kSplit * C;
  const int row = blockIdx.x / groups;
  const int c0 = (blockIdx.x - row * groups) * C;
  const int wc = min(C, W - c0);                 // channels of this CTA
  const size_t base = static_cast<size_t>(row) * S * W + c0;
  const int tid = threadIdx.x;
  const int k = tid / C, c = tid - (tid / C) * C;
  const int n_tiles = (S + L - 1) / L;

  // tile n into ring slot n % kStages: rows past S, channels past W zeroed
  auto load = [&](int n) {
    float* const sa = smem + (n % kStages) * 2 * T::kFloats;
    float* const sx = sa + T::kFloats;
    const int t0 = n * L;
    if (vec16) {                     // W % 4 == 0, so wc % 4 == 0
      constexpr int kRow = C / 4;
#pragma unroll
      for (int j = tid; j < L * kRow; j += kThreads) {
        const int t = j / kRow, cc = (j - t * kRow) * 4;
        const bool ok = t0 + t < S && cc < wc;
        const size_t off = ok ? base + static_cast<size_t>(t0 + t) * W + cc
                              : 0;
        const int o = T::at(t, cc);
        cp_async<16>(smem_addr(sa + o), a + off, ok ? 16 : 0);
        cp_async<16>(smem_addr(sx + o), x + off, ok ? 16 : 0);
      }
    } else {
#pragma unroll 4
      for (int j = tid; j < L * C; j += kThreads) {
        const int t = j / C, cc = j - t * C;
        const bool ok = t0 + t < S && cc < wc;
        const size_t off = ok ? base + static_cast<size_t>(t0 + t) * W + cc
                              : 0;
        const int o = T::at(t, cc);
        cp_async<4>(smem_addr(sa + o), a + off, ok ? 4 : 0);
        cp_async<4>(smem_addr(sx + o), x + off, ok ? 4 : 0);
      }
    }
  };

#pragma unroll
  for (int n = 0; n < kStages - 1; ++n) {
    if (n < n_tiles) load(n);
    cp_async_commit();               // one group a tile, empty past the end
  }
  float carry = 0.f;                 // h at the end of the previous tile
  const bool store_c = c < wc;
  for (int n = 0; n < n_tiles; ++n) {
    cp_async_wait<kStages - 2>();    // this thread's copies of tile n
    __syncthreads();                 // everyone's; tile n - 1 is consumed
    if (n + kStages - 1 < n_tiles) load(n + kStages - 1);
    cp_async_commit();
    const float* const sa = smem + (n % kStages) * 2 * T::kFloats;
    const float* const sx = sa + T::kFloats;
    const int o = k * T::kSubStride + c;
    float ar[T::kSub], xr[T::kSub];
#pragma unroll
    for (int i = 0; i < T::kSub; ++i) {
      ar[i] = sa[o + i * C];
      xr[i] = sx[o + i * C];
    }
    float p = 1.f, hl = 0.f;
#pragma unroll
    for (int i = 0; i < T::kSub; ++i) {
      hl = fmaf(ar[i], hl, xr[i]);
      p *= ar[i];
    }
    pairs_p[tid] = p;                // tid == k * C + c
    pairs_h[tid] = hl;
    __syncthreads();
    float s = carry, hin = carry;
#pragma unroll
    for (int j = 0; j < T::kSplit; ++j) {
      if (j == k) hin = s;
      s = fmaf(pairs_p[j * C + c], s, pairs_h[j * C + c]);
    }
    carry = s;
    const int t = n * L + k * T::kSub;
    float* const hp = h + base + static_cast<size_t>(t) * W + c;
#pragma unroll
    for (int i = 0; i < T::kSub; ++i) {
      hin = fmaf(ar[i], hin, xr[i]);
      if (store_c && t + i < S) __stcs(hp + static_cast<size_t>(i) * W, hin);
    }
  }
}

// Every compiled (C, L, stages); `ops.INSTANCES` lists the same.
#define RGLRU_INSTANCES(X)                                             \
  X(32, 64, 2) X(32, 64, 3) X(32, 64, 4)                               \
  X(32, 128, 2) X(32, 128, 3) X(32, 128, 4)                            \
  X(32, 256, 2) X(32, 256, 3)                                          \
  X(16, 128, 3) X(16, 128, 4) X(16, 256, 3) X(16, 256, 4)              \
  X(16, 256, 6) X(16, 512, 3)                                          \
  X(8, 128, 3) X(8, 128, 4) X(8, 256, 3) X(8, 256, 4) X(8, 256, 6)     \
  X(8, 512, 3) X(8, 512, 4)

struct Instance {
  int C, L, stages;
  const void* fn;
  size_t smem;
};

#define RGLRU_ENTRY(C, L, ST)                                          \
  {C, L, ST, reinterpret_cast<const void*>(&rglru_scan_kernel<C, L, ST>), \
   smem_bytes<C, L, ST>()},
const Instance kInstances[] = {RGLRU_INSTANCES(RGLRU_ENTRY)};
#undef RGLRU_ENTRY

static_assert(smem_bytes<32, 256, 3>() <= kMaxSmem, "ring too large");

const Instance* find(int C, int L, int stages) {
  for (const Instance& i : kInstances)
    if (i.C == C && i.L == L && i.stages == stages) return &i;
  return nullptr;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// 1 when (C, L, stages) is a compiled instance, else 0; *smem its dynamic
// shared memory (bytes) and *blocks its CTAs per SM on the current device.
int rglru_scan_occupancy(int C, int L, int stages, int* smem, int* blocks) {
  const Instance* inst = find(C, L, stages);
  if (inst == nullptr) return 0;
  *smem = static_cast<int>(inst->smem);
  if (cudaFuncSetAttribute(inst->fn,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(inst->smem)) != cudaSuccess
      || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             blocks, inst->fn, kThreads, inst->smem) != cudaSuccess) {
    cudaGetLastError();
    *blocks = -1;
  }
  return 1;
}

// a, x, h (B, S, W) float32, contiguous; (C, L, stages) one of the compiled
// instances; B * ceil(W / C) < 2^31.
int rglru_scan_fwd_launch(const void* a, const void* x, void* h, int B,
                          int S, int W, int C, int L, int stages,
                          cudaStream_t stream) {
  const Instance* inst = find(C, L, stages);
  if (inst == nullptr || B < 0 || S < 0 || W < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0 || W == 0)
    return static_cast<int>(cudaGetLastError());
  int groups = (W + C - 1) / C;
  const long long blocks = static_cast<long long>(B) * groups;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      inst->fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(inst->smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int vec16 = W % 4 == 0 && aligned16(a) && aligned16(x);
  const float* ap = static_cast<const float*>(a);
  const float* xp = static_cast<const float*>(x);
  float* hp = static_cast<float*>(h);
  void* args[] = {&ap, &xp, &hp, &S, &W, &groups, &vec16};
  err = cudaLaunchKernel(inst->fn, dim3(static_cast<unsigned>(blocks)),
                         dim3(kThreads), args, inst->smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
