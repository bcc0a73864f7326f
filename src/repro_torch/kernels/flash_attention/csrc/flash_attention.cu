// Flash attention forward for Hopper (sm_90a), bfloat16 or float32 inputs.
//
// Replaces the Pallas kernel of src/repro/kernels/flash_attention/
// flash_attention.py (`flash_attention_fwd`, body `_kernel`): for every
// q-head row b and query i
//
//     o[b, i] = sum_j softmax_j(q[b, i] . k[b / group, j] scale) v[b / group, j]
//
// over the keys j that the index-derived mask leaves live: all of them
// ("none"), j <= i ("causal"), or i - window < j <= i ("window"), with
// positions 0 .. Sq-1 and 0 .. Sk-1.  GQA reads kv head b / group, so KV is
// never repeated in memory.  Scores are q.k accumulated in float32 times
// scale (D^-1/2 of the model's D); masked ones add nothing; p = exp(s - m) is
// rounded to the input type before the PV product (the Pallas kernel casts
// p to v's dtype), the row sum l adds the unrounded p, and the output is
// acc / max(l, 1e-30) (one reciprocal a row) rounded to the input type.
//
// Bound.  At the model path's shapes (D 64 to 256, S 2048 to 8192, causal,
// windowed or unmasked) attention is bound by operations: 4 D flops per
// live (query, key) pair against one read of Q, K, V and one write of O, so
// bfloat16 wants the tensor cores (989 TFLOP/s dense on the H100 SXM) and
// float32 the FP32 cores (67 TFLOP/s).
//
// Design, bfloat16 (`flash_wgmma_kernel`), in FlashAttention-3's shape.  The
// TPU kernel walks a sequential kv grid axis and carries (m, l, acc) in VMEM
// scratch from one grid step to the next; here a CTA loops over the kv tiles
// of a tile of 128 queries (64 where Sq <= 64) with warp-specialised roles:
//
//   * Warp group 0 is the producer: after `setmaxnreg.dec` one thread issues
//     TMA loads (`cp.async.bulk.tensor.3d`, tensor maps over (D, S, heads)
//     encoded on the host at each call): Q once a q tile, then K and V of
//     each kv tile into a ring of `kStages` stages in shared memory (4 at D
//     <= 80, 3 at 128, 2 at 256).  Q and the K and V of each stage have a
//     full and an empty `mbarrier`; the producer waits on a slot's empty
//     barrier (phase parity flips each lap of the ring) and arms its full
//     one with the tile's bytes.  Rows past Sq or Sk and columns past the
//     tensor's width come back as zeros from the TMA unit; masks decide
//     which scores are live.
//   * Warp groups 1 and 2 are consumers (`setmaxnreg.inc` to 240 registers),
//     each owning 64 query rows.  S = Q K^T is `wgmma.mma_async` with Q and
//     K both read from shared memory (K-major descriptors), accumulating in
//     float32 registers.  P is rounded to bf16 in registers and becomes the
//     register A operand of O += P V, whose B operand V is read through a
//     transposed (MN-major) descriptor: V is never copied into a transposed
//     layout.
//   * Softmax overlaps the tensor cores (FlashAttention-3's intra-warpgroup
//     pipelining): tile j's Q K^T and tile j-1's P V are issued together, and
//     tile j's softmax runs while P V is in flight.  A consumer releases a K
//     slot as soon as its scores are in, a V slot when P V is done, so the
//     producer reloads K a whole tile ahead of V.  p = 2^(s sl2 - m sl2) is
//     one `ffma` and one `ex2.approx` a score (sl2 = scale log2(e), m the
//     row's running max of the raw scores; relative error ~2^-22); masked
//     scores are -inf, so they add 0.  (The two consumers taking turns to
//     issue their products on named barriers, FlashAttention-3's ping-pong,
//     measured no faster here and is not used.)
//   * Persistent: one CTA an SM walks its share of the (q tile, head) work
//     tiles, longest first, in snake order (`work_of`); the ring runs on
//     across a CTA's tiles, so one tile's stores overlap the next one's
//     loads, and the CTAs' sums of band lengths come out even.
//   * Tiles by head dim (`Tiles`): 128 x 128 (queries x keys) at D 64, 80 and
//     128; 128 x 80 at D 256, where the 64 x 256 O accumulator takes 128
//     registers a thread.  A row of D lies in shared memory in slabs of 64
//     columns with the 128-byte swizzle, which each map's swizzle and each
//     wgmma descriptor's layout type agree on.  D 80 (160 bytes a row, no
//     multiple of 128) is loaded unpadded in five 16-column slabs with the
//     32-byte swizzle: its products do 80 / 128 of the tensor work that
//     padding to 128 did.
//   * Only the kv tiles inside the mask's band are visited (causal: up to the
//     tile's last query; window: from the tile holding its first query's
//     first key); element masks are applied only where a consumer's 64 rows
//     do not see the whole tile live (diagonal, window edge, ragged Sk).  The
//     wrapper refuses inputs where some query row has no live key.
//
// Float32 (`flash_fwd_kernel`) runs on the FP32 cores (TF32 would not hold
// the 1e-5 tolerance): 8 warps per 64 queries, 32-key blocks staged as
// float32, q tiles in reverse under a mask as above.
//
// Interface: plain C, called through ctypes; the launcher returns
// cudaGetLastError() so the Python wrapper raises on a refused launch, or
// kEncodeFailed + the driver's CUresult when a tensor map cannot be encoded.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kMaxD = 256;

// ---------------------------------------------------------------------------
// float32: the SIMT kernel
// ---------------------------------------------------------------------------
constexpr int kBQ = 64;                 // queries per CTA
constexpr int kBK = 32;                 // keys per block (one per lane)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kBQ / kWarps;     // query rows per warp

// kCols = ceil(D / 32) accumulator columns per lane; kReverse: q tiles
// launched last first
template <int kCols, bool kReverse>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int Sq,
                 int Sk, int D, int group, int mask_kind, int window,
                 float scale) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int ld = D + 4;                 // padded row of Q and K (floats)
  float* const Qs = smem;               // (kBQ, ld)
  float* const Ks = Qs + kBQ * ld;      // (kBK, ld)
  float* const Vs = Ks + kBK * ld;      // (kBK, D)
  float* const Ps = Vs + kBK * D;       // (kBQ, kBK)

  const int b = blockIdx.x;
  const int tile = kReverse ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = tile * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t q_base = static_cast<size_t>(b) * Sq * D;
  const size_t kv_base = static_cast<size_t>(b / group) * Sk * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D;
    const int d = e - r * D;
    const int qi = q0 + r;
    Qs[r * ld + d] = qi < Sq ? q[q_base + static_cast<size_t>(qi) * D + d]
                             : 0.f;
  }

  // the kv band any query of this block can see
  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int k_begin = mask_kind == 2 ? max(0, q0 - window + 1) : 0;
  const int k_end = mask_kind == 0 ? Sk : min(Sk, q_last + 1);

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();                    // Q staged, last block consumed
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D;
      const int d = e - r * D;
      const int kj = k0 + r;
      const size_t g = kv_base + static_cast<size_t>(kj) * D + d;
      const bool in = kj < Sk;
      Ks[r * ld + d] = in ? k[g] : 0.f;
      Vs[r * D + d] = in ? v[g] : 0.f;
    }
    __syncthreads();

    // scores of this warp's rows against key k0 + lane
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float4* k4 = reinterpret_cast<const float4*>(Ks + lane * ld);
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float4 kk = k4[d4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qq = reinterpret_cast<const float4*>(
            Qs + (warp + kWarps * r) * ld)[d4];
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }

    // online softmax, one row per (warp, r), one key per lane
    const int kj = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = warp + kWarps * r;
      const int qi = q0 + row;
      bool live = kj < Sk;
      if (mask_kind != 0) live = live && kj <= qi;
      if (mask_kind == 2) live = live && kj > qi - window;
      const float sv = live ? s[r] * scale : kNeg;
      float mx = sv;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      const float p = expf(sv - m_new);
      float ps = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[r] = l[r] * corr + ps;
      m[r] = m_new;
      Ps[row * kBK + lane] = p;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= corr;
    }
    __syncwarp();

    // acc[r][c] += sum_j P[row, j] V[j, lane + 32 c]
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < D ? Vs[j * D + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = Ps[(warp + kWarps * r) * kBK + j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + warp + kWarps * r;
    if (qi >= Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    float* row = o + q_base + static_cast<size_t>(qi) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (d < D) row[d] = acc[r][c] / den;
    }
  }
}

size_t simt_smem_bytes(int D) {
  const int ld = D + 4;
  return sizeof(float) *
         (static_cast<size_t>(kBQ) * ld + static_cast<size_t>(kBK) * ld +
          static_cast<size_t>(kBK) * D + static_cast<size_t>(kBQ) * kBK);
}

template <int kCols>
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* o,
                        int BH, int n_qtiles, int Sq, int Sk, int D,
                        int group, int mask_kind, int window, float scale,
                        int reverse, cudaStream_t stream) {
  const size_t smem = simt_smem_bytes(D);
  auto* fn = reverse ? flash_fwd_kernel<kCols, true>
                     : flash_fwd_kernel<kCols, false>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fn<<<dim3(BH, n_qtiles), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, D, group,
      mask_kind, window, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_simt(const void* q, const void* k, const void* v,
                          void* o, int BH, int n_qtiles, int Sq, int Sk,
                          int D, int group, int mask_kind, int window,
                          float scale, int reverse, cudaStream_t stream) {
  if (D <= 32)
    return launch_simt<1>(q, k, v, o, BH, n_qtiles, Sq, Sk, D, group,
                          mask_kind, window, scale, reverse, stream);
  if (D <= 64)
    return launch_simt<2>(q, k, v, o, BH, n_qtiles, Sq, Sk, D, group,
                          mask_kind, window, scale, reverse, stream);
  if (D <= 128)
    return launch_simt<4>(q, k, v, o, BH, n_qtiles, Sq, Sk, D, group,
                          mask_kind, window, scale, reverse, stream);
  return launch_simt<8>(q, k, v, o, BH, n_qtiles, Sq, Sk, D, group,
                        mask_kind, window, scale, reverse, stream);
}

// cudaFuncSetAttribute(MaxDynamicSharedMemorySize) once per kernel and
// device (a host call on every launch otherwise); bit d of ``done``, which
// each kernel instance keeps, marks device d as set
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

// ---------------------------------------------------------------------------
// bfloat16: wgmma, a TMA ring, a producer and consumer warp groups
// ---------------------------------------------------------------------------
namespace hop {

using bf16 = __nv_bfloat16;

constexpr int kGroup = 128;             // threads of a warp group

// The tiles of one instance: kD the head dim the tiles hold (64, 80, 128 or
// 256; a narrower D reads zeros past its width), kC consumer warp groups (1
// or 2) of 64 query rows each.  Shared memory: Q of each consumer, then
// kStages K tiles, kStages V tiles and the mbarriers; every tile is a run of
// slabs, a slab being the tile's rows x kW columns, kRowBytes a row, swizzled
// within each group of 8 rows.
template <int kD, int kC>
struct Tiles {
  static constexpr int kW = kD == 80 ? 16 : 64;        // columns of a slab
  static constexpr int kSlabs = kD / kW;
  static constexpr int kRowBytes = 2 * kW;             // 128 or 32: the swizzle
  static constexpr int kLayout = kW == 64 ? 1 : 3;     // wgmma: 128B, 32B
  static constexpr int kBM = 64 * kC;                  // queries of a CTA
  static constexpr int kBN = kD == 256 ? 80 : 128;     // keys of a kv tile
  static constexpr int kStages = kD <= 80 ? 4 : kD == 128 ? 3 : 2;
  static constexpr int kThreads = kGroup * (kC + 1);
  static constexpr int kQBytes = 64 * kD * 2;          // one consumer's Q
  static constexpr int kKVBytes = kBN * kD * 2;        // one K or V tile
  static constexpr int kTileBytes = kC * kQBytes + 2 * kStages * kKVBytes;
  static constexpr int kBarriers = 2 + 4 * kStages;
  // + 1024: the tiles start at the next 1024-byte boundary (the 128-byte
  // swizzle repeats every 8 rows of 128 bytes)
  static constexpr size_t kSmem = kTileBytes + 8 * kBarriers + 1024;
  static_assert(kD % kW == 0 && kQBytes % 1024 == 0 && kKVBytes % 1024 == 0,
                "slabs and tiles on swizzle boundaries");
  static_assert(kSmem <= 232448, "fits a CTA's shared memory");
};

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

// until the phase of parity `parity` has completed (no time limit: a
// `trap` on a time limit here makes ptxas hold the consumers to the
// launch's 168 registers, and they spill)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// box (c0 column, c1 row, c2 head) of `map` into shared memory at dst,
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

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kRegs));
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

// The compiler sees a wgmma write its accumulators when it is issued; these
// empty statements pin the registers' reads and writes to after the wait.
template <int kN>
__device__ __forceinline__ void keep(float (&r)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int kN>
__device__ __forceinline__ void keep(uint32_t (&r)[kN][4]) {
#pragma unroll
  for (int i = 0; i < kN; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e]) :: "memory");
}

// wgmma's shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), layout type (1: 128-byte swizzle, 3:
// 32-byte)
template <int kLayout>
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 |
         static_cast<uint64_t>(kLayout) << 62;
}

template <int kN>
__device__ __forceinline__ void wgmma_ss(float (&d)[kN / 2], uint64_t a,
                                         uint64_t b, int scale_d);
template <int kN>
__device__ __forceinline__ void wgmma_rs(float (&d)[kN / 2],
                                         const uint32_t (&a)[4], uint64_t b);

// d (64 x 80) = [d +] A B: A 64 x 16 and B^T 80 x 16 in shared memory,
// both K-major; d += A B where scale_d, else d = A B
template <>
__device__ __forceinline__ void wgmma_ss<80>(float (&d)[40], uint64_t a,
                                            uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 128) = [d +] A B: A 64 x 16 and B^T 128 x 16 in shared memory,
// both K-major; d += A B where scale_d, else d = A B
template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a,
                                            uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64) += A B: A 64 x 16 as bf16 fragments in registers, B 16 x
// 64 in shared memory, MN-major (transposed)
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
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

// d (64 x 80) += A B: A 64 x 16 as bf16 fragments in registers, B 16 x
// 80 in shared memory, MN-major (transposed)
template <>
__device__ __forceinline__ void wgmma_rs<80>(float (&d)[40],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128) += A B: A 64 x 16 as bf16 fragments in registers, B 16 x
// 128 in shared memory, MN-major (transposed)
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
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

// d (64 x 256) += A B: A 64 x 16 as bf16 fragments in registers, B 16 x
// 256 in shared memory, MN-major (transposed)
template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x (ex2.approx: relative error ~2^-22; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = Q K^T of one consumer: its 64 rows of Q at q, a K tile at k, one
// wgmma per 16 columns of D (a slab holds kW / 16 of them, 32 bytes apart)
template <int kD, int kC>
__device__ __forceinline__ void issue_qk(float (&s)[Tiles<kD, kC>::kBN / 2],
                                         uint32_t q, uint32_t k) {
  using T = Tiles<kD, kC>;
  constexpr uint32_t kSbo = 8 * T::kRowBytes;   // from 8 rows to the next 8
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int slab = kk * 16 / T::kW;
    const int off = (kk * 16 % T::kW) * 2;
    wgmma_ss<T::kBN>(
        s, desc<T::kLayout>(q + slab * 64 * T::kRowBytes + off, 16, kSbo),
        desc<T::kLayout>(k + slab * T::kBN * T::kRowBytes + off, 16, kSbo),
        kk > 0);
  }
  wgmma_commit();
}

// O += P V of one consumer: P in registers (one fragment per 16 keys), the
// V tile at v read MN-major: 16 keys are 16 rows of every slab, the slabs
// (kW columns of D each) kBN rows apart
template <int kD, int kC>
__device__ __forceinline__ void issue_pv(
    float (&acc)[kD / 2], const uint32_t (&p)[Tiles<kD, kC>::kBN / 16][4],
    uint32_t v) {
  using T = Tiles<kD, kC>;
#pragma unroll
  for (int kk = 0; kk < T::kBN / 16; ++kk)
    wgmma_rs<kD>(acc, p[kk],
                 desc<T::kLayout>(v + kk * 16 * T::kRowBytes,
                                  T::kBN * T::kRowBytes, 8 * T::kRowBytes));
  wgmma_commit();
}

// The scores of one kv tile in the accumulator layout (this thread holds
// rows row_a and row_b = row_a + 8, columns 8 j + 2 t4 + {0, 1}) to p =
// 2^(s sl2 - m sl2) in place, sl2 = scale log2(e), one `ffma` and one
// `ex2.approx` a score; masked scores (only where the tile is not wholly
// live: `full`) are -inf, so their p is 0, and a row whose running max is
// still -inf takes 0 for it.  m (the running max of the raw scores) and l
// updated; c0, c1 the factors the running output is to be rescaled by (1
// where the max held).  l stays a partial sum per lane until the end.
template <int kN>
__device__ __forceinline__ void softmax_tile(
    float (&s)[kN / 2], bool full, int k0, int row_a, int row_b, int t4,
    int Sk, int mask_kind, int window, float sl2, float& m0, float& m1,
    float& l0, float& l1, float& c0, float& c1) {
  if (!full) {
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + 8 * j + 2 * t4 + (e & 1);
        const int qi = e < 2 ? row_a : row_b;
        bool live = kj < Sk;
        if (mask_kind != 0) live = live && kj <= qi;
        if (mask_kind == 2) live = live && kj > qi - window;
        if (!live) s[4 * j + e] = -INFINITY;
      }
  }
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {     // a row lies in a quad
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float ms0 = mx0 == -INFINITY ? 0.f : mx0 * sl2;
  const float ms1 = mx1 == -INFINITY ? 0.f : mx1 * sl2;
  c0 = mx0 == m0 ? 1.f : ex2(fmaf(m0, sl2, -ms0));
  c1 = mx1 == m1 ? 1.f : ex2(fmaf(m1, sl2, -ms1));
  m0 = mx0;
  m1 = mx1;
  float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    s[4 * j] = ex2(fmaf(s[4 * j], sl2, -ms0));
    s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], sl2, -ms0));
    s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], sl2, -ms1));
    s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], sl2, -ms1));
    ls0 += s[4 * j] + s[4 * j + 1];
    ls1 += s[4 * j + 2] + s[4 * j + 3];
  }
  l0 = l0 * c0 + ls0;
  l1 = l1 * c1 + ls1;
}

// p rounded to bf16 as wgmma's A fragments: 16 keys (two 8-column blocks of
// the accumulator layout) a fragment
template <int kN>
__device__ __forceinline__ void to_p(uint32_t (&p)[kN / 16][4],
                                     const float (&s)[kN / 2]) {
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// One work tile: q-head row b, queries q0 .. q0 + kBM - 1, and the kv band
// any of its queries can see, from a kN-aligned key
struct Work {
  int b, q0, k_begin, n_tiles;
};

// The i-th work tile of CTA `cta` of `ctas`, or b = -1 past the last: in
// round i the CTAs take positions i ctas .. (i + 1) ctas - 1 of the order
// t = y BH + b (q-head row b, q tile y, reversed under `reverse` so that
// the longest come first), forwards in even rounds and backwards in odd
// ones, which evens out the CTAs' sums of tile lengths
template <int kBM, int kN>
__device__ __forceinline__ Work work_of(int i, int cta, int ctas, int BH,
                                        int n_qtiles, int Sq, int Sk,
                                        int mask_kind, int window,
                                        int reverse) {
  Work w;
  const int t = i * ctas + (i & 1 ? ctas - 1 - cta : cta);
  if (t >= BH * n_qtiles) {
    w.b = -1;
    return w;
  }
  const int y = t / BH;
  w.b = t - y * BH;
  w.q0 = (reverse ? n_qtiles - 1 - y : y) * kBM;
  const int q_last = min(w.q0 + kBM, Sq) - 1;
  w.k_begin = mask_kind == 2 ? max(0, w.q0 - window + 1) / kN * kN : 0;
  const int k_end = mask_kind == 0 ? Sk : min(Sk, q_last + 1);
  w.n_tiles = (k_end - w.k_begin + kN - 1) / kN;
  return w;
}

// Persistent: one CTA an SM runs the work tiles `work_of` gives it; the
// ring's stages and phases run on across a CTA's tiles, so the next tile's
// loads overlap this one's last products and its stores.  tq maps q (D,
// Sq, BH) in boxes of kW x 64, tk and tv map k and v (D, Sk, BH / group) in
// boxes of kW x kBN; o is (BH, Sq, D) with D <= the maps' width.
template <int kD, int kC>
__global__ void __launch_bounds__(Tiles<kD, kC>::kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   bf16* __restrict__ o, int BH, int n_qtiles, int Sq, int Sk,
                   int D, int group, int mask_kind, int window, float scale,
                   int reverse) {
  using T = Tiles<kD, kC>;
  constexpr int kN = T::kBN;
  constexpr int kS = T::kStages;
  extern __shared__ __align__(1024) unsigned char smem_hop[];
  const uint32_t sQ = (smem_addr(smem_hop) + 1023u) & ~1023u;
  const uint32_t sK = sQ + kC * T::kQBytes;
  const uint32_t sV = sK + kS * T::kKVBytes;
  // mbarriers: Q full and empty, then of each stage K full, V full, K
  // empty, V empty
  const uint32_t q_full = sV + kS * T::kKVBytes;
  const uint32_t q_empty = q_full + 8;
  const uint32_t k_full = q_empty + 8;
  const uint32_t v_full = k_full + 8 * kS;
  const uint32_t k_empty = v_full + 8 * kS;
  const uint32_t v_empty = k_empty + 8 * kS;
  const int wg = threadIdx.x / kGroup;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 4 * kC);              // lane 0 of each consumer warp
#pragma unroll
    for (int st = 0; st < kS; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(k_empty + 8 * st, 4 * kC);
      mbar_init(v_empty + 8 * st, 4 * kC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the ring's loads in flight ----
    if constexpr (kC == 2) setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      int it = 0;                            // kv tiles loaded
      for (int nq = 0;; ++nq) {              // q tiles loaded
        const Work w = work_of<T::kBM, kN>(nq, blockIdx.x, gridDim.x, BH,
                                           n_qtiles, Sq, Sk, mask_kind,
                                           window, reverse);
        if (w.b < 0) break;
        const int kvh = w.b / group;
        mbar_wait(q_empty, (nq & 1) ^ 1);   // the first passes
        mbar_expect_tx(q_full, kC * T::kQBytes);
        for (int c = 0; c < kC; ++c)
          for (int sl = 0; sl < T::kSlabs; ++sl)
            tma_load(sQ + c * T::kQBytes + sl * 64 * T::kRowBytes, &tq,
                     sl * T::kW, w.q0 + 64 * c, w.b, q_full);
        for (int j = 0; j < w.n_tiles; ++j, ++it) {
          const int st = it % kS;
          const uint32_t lap = (it / kS) & 1;
          const int k0 = w.k_begin + j * kN;
          const uint32_t kb = sK + st * T::kKVBytes;
          const uint32_t vb = sV + st * T::kKVBytes;
          mbar_wait(k_empty + 8 * st, lap ^ 1);
          mbar_expect_tx(k_full + 8 * st, T::kKVBytes);
          for (int sl = 0; sl < T::kSlabs; ++sl)
            tma_load(kb + sl * kN * T::kRowBytes, &tk, sl * T::kW, k0, kvh,
                     k_full + 8 * st);
          mbar_wait(v_empty + 8 * st, lap ^ 1);
          mbar_expect_tx(v_full + 8 * st, T::kKVBytes);
          for (int sl = 0; sl < T::kSlabs; ++sl)
            tma_load(vb + sl * kN * T::kRowBytes, &tv, sl * T::kW, k0, kvh,
                     v_full + 8 * st);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    if constexpr (kC == 2) setmaxnreg_inc<240>();
    const int c = wg - 1;
    const int tid = threadIdx.x % kGroup;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int t4 = lane & 3;
    const int r0 = 64 * c + 16 * warp + (lane >> 2);   // rows r0, r0 + 8
    // scores in log2 units: s scale log2(e), so p = 2^(x - m)
    const float sl2 = scale * 1.4426950408889634f;
    const uint32_t sQc = sQ + c * T::kQBytes;
    float acc[kD / 2];
    float s[kN / 2];
    uint32_t p[kN / 16][4];
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) s[i] = 0.f;
    int it = 0;                              // kv tiles consumed
    for (int nq = 0;; ++nq) {                // q tiles consumed
      const Work w = work_of<T::kBM, kN>(nq, blockIdx.x, gridDim.x, BH,
                                         n_qtiles, Sq, Sk, mask_kind, window,
                                         reverse);
      if (w.b < 0) break;
      const int q0c = w.q0 + 64 * c;
      const int row_a = w.q0 + r0;
      const int row_b = row_a + 8;
      // every (query, key) of this consumer's rows and the tile live
      auto full = [&](int k0) {
        return k0 + kN <= Sk &&
               (mask_kind == 0 ||
                (k0 + kN - 1 <= q0c &&
                 (mask_kind == 1 || k0 >= q0c + 64 - window)));
      };
#pragma unroll
      for (int i = 0; i < kD / 2; ++i) acc[i] = 0.f;
      float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, c0, c1;

      // the first kv tile: its scores alone
      int k0 = w.k_begin;
      int st = it % kS;
      uint32_t lap = (it / kS) & 1;
      mbar_wait(q_full, nq & 1);
      mbar_wait(k_full + 8 * st, lap);
      wgmma_fence();
      issue_qk<kD, kC>(s, sQc, sK + st * T::kKVBytes);
      wgmma_wait<0>();
      keep(s);
      if (lane == 0) {
        mbar_arrive(k_empty + 8 * st);
        if (w.n_tiles == 1) mbar_arrive(q_empty);
      }
      softmax_tile<kN>(s, full(k0), k0, row_a, row_b, t4, Sk, mask_kind,
                       window, sl2, m0, m1, l0, l1, c0, c1);
      to_p<kN>(p, s);

      // kv tile j's Q K^T and tile j-1's P V in flight together; tile j's
      // softmax while P V runs
      for (int j = 1; j < w.n_tiles; ++j) {
        const int pst = st;
        const uint32_t plap = lap;
        ++it;
        st = it % kS;
        lap = (it / kS) & 1;
        k0 += kN;
        mbar_wait(k_full + 8 * st, lap);
        mbar_wait(v_full + 8 * pst, plap);
          wgmma_fence();
        issue_qk<kD, kC>(s, sQc, sK + st * T::kKVBytes);
        issue_pv<kD, kC>(acc, p, sV + pst * T::kKVBytes);
          wgmma_wait<1>();                     // the scores are in
        keep(s);
        if (lane == 0) {
          mbar_arrive(k_empty + 8 * st);
          if (j == w.n_tiles - 1) mbar_arrive(q_empty);
        }
        softmax_tile<kN>(s, full(k0), k0, row_a, row_b, t4, Sk, mask_kind,
                         window, sl2, m0, m1, l0, l1, c0, c1);
        wgmma_wait<0>();                     // P V is done
        keep(acc);
        keep(p);
        if (lane == 0) mbar_arrive(v_empty + 8 * pst);
        if (!__all_sync(0xffffffffu, c0 == 1.f && c1 == 1.f)) {
#pragma unroll
          for (int i = 0; i < kD / 8; ++i) {
            acc[4 * i] *= c0;
            acc[4 * i + 1] *= c0;
            acc[4 * i + 2] *= c1;
            acc[4 * i + 3] *= c1;
          }
        }
        to_p<kN>(p, s);
      }
      mbar_wait(v_full + 8 * st, lap);
      wgmma_fence();
      issue_pv<kD, kC>(acc, p, sV + st * T::kKVBytes);
      wgmma_wait<0>();
      keep(acc);
      keep(p);
      if (lane == 0) mbar_arrive(v_empty + 8 * st);
      ++it;

      // l was summed per lane: add the quad's partial sums
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      const float inv0 = 1.f / fmaxf(l0, 1e-30f);
      const float inv1 = 1.f / fmaxf(l1, 1e-30f);
      bf16* const ob = o + static_cast<size_t>(w.b) * Sq * D;
#pragma unroll
      for (int i = 0; i < kD / 8; ++i) {
        const int d = 8 * i + 2 * t4;
        if (d >= D) continue;
        if (row_a < Sq)
          *reinterpret_cast<__nv_bfloat162*>(
              ob + static_cast<size_t>(row_a) * D + d) =
              __floats2bfloat162_rn(acc[4 * i] * inv0, acc[4 * i + 1] * inv0);
        if (row_b < Sq)
          *reinterpret_cast<__nv_bfloat162*>(
              ob + static_cast<size_t>(row_b) * D + d) =
              __floats2bfloat162_rn(acc[4 * i + 2] * inv1,
                                    acc[4 * i + 3] * inv1);
      }
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

// A map of a (heads, rows, width) bf16 tensor in boxes of box_cols x
// box_rows x 1; reads outside the tensor come back as zeros
int encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int width,
           int rows, int heads, int box_cols, int box_rows,
           CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {2ull * width, 2ull * width * rows};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1u};
  const cuuint32_t unit[3] = {1u, 1u, 1u};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                          const_cast<void*>(ptr), dims, strides, box, unit,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(res);
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

template <int kD, int kC>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int Sq, int Sk, int width, int D, int group, int mask_kind,
           int window, float scale, int n_qtiles, int reverse,
           cudaStream_t stream) {
  using T = Tiles<kD, kC>;
  EncodeTiled fn;
  int err = encoder(&fn);
  if (err != 0) return err;
  const CUtensorMapSwizzle swizzle =
      T::kW == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap tq, tk, tv;
  if ((err = encode(fn, &tq, q, width, Sq, BH, T::kW, 64, swizzle)) ||
      (err = encode(fn, &tk, k, width, Sk, BH / group, T::kW, T::kBN,
                    swizzle)) ||
      (err = encode(fn, &tv, v, width, Sk, BH / group, T::kW, T::kBN,
                    swizzle)))
    return err;
  auto* kernel = flash_wgmma_kernel<kD, kC>;
  static unsigned smem_set = 0;
  cudaError_t cerr = set_smem_once(kernel, T::kSmem, smem_set);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  int sms = 0;
  if ((cerr = sm_count(&sms)) != cudaSuccess) return static_cast<int>(cerr);
  const int n_work = BH * n_qtiles;
  kernel<<<n_work < sms ? n_work : sms, T::kThreads, T::kSmem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), BH, n_qtiles, Sq, Sk, D, group,
      mask_kind, window, scale, reverse);
  return static_cast<int>(cudaGetLastError());
}

template <int kD>
int launch_consumers(const void* q, const void* k, const void* v, void* o,
                     int BH, int Sq, int Sk, int width, int D, int group,
                     int mask_kind, int window, float scale, int n_qtiles,
                     int consumers, int reverse, cudaStream_t stream) {
  return consumers == 1
             ? launch<kD, 1>(q, k, v, o, BH, Sq, Sk, width, D, group,
                             mask_kind, window, scale, n_qtiles, reverse,
                             stream)
             : launch<kD, 2>(q, k, v, o, BH, Sq, Sk, width, D, group,
                             mask_kind, window, scale, n_qtiles, reverse,
                             stream);
}

int dispatch(const void* q, const void* k, const void* v, void* o, int BH,
             int Sq, int Sk, int width, int D, int group, int mask_kind,
             int window, float scale, int n_qtiles, int instance,
             int consumers, int reverse, cudaStream_t stream) {
  switch (instance) {
    case 64:
      return launch_consumers<64>(q, k, v, o, BH, Sq, Sk, width, D, group,
                                  mask_kind, window, scale, n_qtiles,
                                  consumers, reverse, stream);
    case 80:
      return launch_consumers<80>(q, k, v, o, BH, Sq, Sk, width, D, group,
                                  mask_kind, window, scale, n_qtiles,
                                  consumers, reverse, stream);
    case 128:
      return launch_consumers<128>(q, k, v, o, BH, Sq, Sk, width, D, group,
                                   mask_kind, window, scale, n_qtiles,
                                   consumers, reverse, stream);
    default:
      return launch_consumers<256>(q, k, v, o, BH, Sq, Sk, width, D, group,
                                   mask_kind, window, scale, n_qtiles,
                                   consumers, reverse, stream);
  }
}

}  // namespace hop

}  // namespace

extern "C" {

// q (BH, Sq, width), k and v (BH / group, Sk, width), o (BH, Sq, D), all
// contiguous and of one type (is_bf16: bfloat16, else float32); mask_kind
// 0 none, 1 causal, 2 window; scale multiplies q.k.  D must be a multiple
// of 4 in [4, 256].  float32: width == D, n_qtiles tiles of 64 queries.
// bfloat16: width a multiple of 8 in [D, instance] (q, k and v zero-padded
// past D), q, k and v 16-byte aligned, `instance` the tiles' head dim (64,
// 80, 128 or 256), `consumers` warp groups of 64 queries (1 or 2), n_qtiles
// tiles of 64 * consumers queries.  Tiles launch last first when reverse is
// set.  Returns a cudaError_t, or kEncodeFailed (10000) + the CUresult of a
// tensor map that cannot be encoded.
int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                               void* o, int BH, int Sq, int Sk, int width,
                               int D, int group, int mask_kind, int window,
                               float scale, int is_bf16, int n_qtiles,
                               int instance, int consumers, int reverse,
                               cudaStream_t stream) {
  if (D < 4 || D > kMaxD || D % 4 != 0 || group < 1 || BH % group != 0 ||
      mask_kind < 0 || mask_kind > 2 || Sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!is_bf16) {
    if (width != D || n_qtiles != (Sq + kBQ - 1) / kBQ)
      return static_cast<int>(cudaErrorInvalidValue);
    if (BH == 0 || Sq == 0) return static_cast<int>(cudaGetLastError());
    return static_cast<int>(dispatch_simt(q, k, v, o, BH, n_qtiles, Sq, Sk,
                                          D, group, mask_kind, window, scale,
                                          reverse, stream));
  }
  const int rows = 64 * consumers;
  if ((instance != 64 && instance != 80 && instance != 128 &&
       instance != 256) ||
      width % 8 != 0 || width < D || width > instance ||
      (consumers != 1 && consumers != 2) ||
      n_qtiles != (Sq + rows - 1) / rows ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (BH == 0 || Sq == 0) return static_cast<int>(cudaGetLastError());
  return hop::dispatch(q, k, v, o, BH, Sq, Sk, width, D, group, mask_kind,
                       window, scale, n_qtiles, instance, consumers, reverse,
                       stream);
}

}  // extern "C"
