// RG-LRU linear recurrence for Hopper (sm_90a), float32.
//
// Replaces the Pallas kernel of src/repro/kernels/rglru_scan/rglru_scan.py
// (`rglru_scan_fwd`, body `_kernel`): for every batch row b and channel w
//
//     h[b, t, w] = a[b, t, w] * h[b, t - 1, w] + x[b, t, w],   h[b, -1, w] = 0
//
// over a, x and h of shape (B, S, W), contiguous.
//
// Design.  The TPU kernel tiles (B, W / 512, S / 128) and walks the
// sequence as a sequential grid axis, carrying the (1, 512) state in VMEM
// scratch.  Here the channels are independent and the sequence is a
// dependent chain, so one thread owns one (batch, channel) and walks the
// whole sequence with h in a register; nothing carries between threads or
// CTAs.  A CTA is one warp of 32 consecutive channels, so every step's
// loads and stores are whole 128-byte lines, and the CTAs spread over all
// SMs (recurrentgemma-9b's forward: 2 x 4096 channels, 256 warps).  With
// so few warps a walk that waited on each load alone would be bound by
// memory latency: each thread first loads a block of kSteps steps of a and
// x into registers (2 kSteps independent loads in flight), then runs their
// kSteps dependent FMAs and streams the h values out.  Any S and W: the
// last block of steps and the last warp of channels are guarded, nothing
// is padded.
//
// Bound.  The call is bound by bytes: 12 bytes per (token, channel) (a and
// x read once, h written once) for 2 operations.  At recurrentgemma-9b's
// forward shape (2 x 4096 tokens x 4096 channels) that is 403 MB, 0.12 ms
// at the card's 3.35 TB/s.  The single walk per channel leaves only
// B * W / 32 warps in flight; a chunked two-pass scan (per-chunk
// (prod a, h_end) pairs, a short scan over chunks, then a fix-up pass)
// would put more in flight and is work for a later change.
//
// Interface: plain C, called through ctypes; the launcher returns
// cudaGetLastError() so the Python wrapper raises on a refused launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;            // channels of a CTA (one warp)
constexpr int kSteps = 32;              // steps loaded before their FMAs

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ x,
                  float* __restrict__ h, int S, int W, int wblocks) {
  const int row = blockIdx.x / wblocks;
  const int w = (blockIdx.x - row * wblocks) * kThreads + threadIdx.x;
  if (w >= W) return;
  const size_t base = static_cast<size_t>(row) * S * W + w;
  const float* const ap = a + base;
  const float* const xp = x + base;
  float* const hp = h + base;
  float state = 0.f;
  for (int t0 = 0; t0 < S; t0 += kSteps) {
    const int n = min(kSteps, S - t0);
    float ar[kSteps], xr[kSteps];
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const size_t off = static_cast<size_t>(t0 + i) * W;
      ar[i] = i < n ? __ldcs(ap + off) : 0.f;   // read once: streaming
      xr[i] = i < n ? __ldcs(xp + off) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      if (i < n) {
        state = fmaf(ar[i], state, xr[i]);
        __stcs(hp + static_cast<size_t>(t0 + i) * W, state);
      }
    }
  }
}

}  // namespace

extern "C" {

// a, x, h (B, S, W) float32, contiguous.  B * ceil(W / 32) < 2^31.
int rglru_scan_fwd_launch(const void* a, const void* x, void* h, int B,
                          int S, int W, cudaStream_t stream) {
  if (B < 0 || S < 0 || W < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0 || W == 0)
    return static_cast<int>(cudaGetLastError());
  const int wblocks = (W + kThreads - 1) / kThreads;
  const long long blocks = static_cast<long long>(B) * wblocks;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  rglru_scan_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(x),
      static_cast<float*>(h), S, W, wblocks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
