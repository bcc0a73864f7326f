// Flash-decode attention for Hopper (sm_90a): one new token's G grouped
// q heads against a ring-buffer KV cache, float32, bfloat16 or
// float8_e4m3fn, in one launch.
//
// Replaces the Pallas kernel of src/repro/kernels/decode_attention/
// decode_attention.py (`decode_attention_fwd`, body `_kernel`): for every
// (batch, kv head) row r and q head g of its group
//
//     o[r, g] = sum_j softmax_j(q[r, g] . k[r, j] * D^-1/2) v[r, j]
//
// over the cache slots j with valid[r, j] != 0.  K and V are taken in q's
// type (the reference's wrapper casts the cache to it; a float8_e4m3fn
// element widens exactly, NaN staying NaN); scores are float32
// times D^-1/2; p = exp(s - m) is rounded to q's type before the PV product
// and l sums the unrounded p, as the Pallas kernel does; an invalid slot
// gets p = 0 by selection.  The output is acc / max(l, 1e-30) in q's type.
//
// Bound.  Decode is bound by bytes: each cache slot's K and V are read
// once (2 W D elements per row) for 4 D operations per (q head, slot),
// about one operation per byte where the card needs ~295 before its
// tensor cores bind.  At the generation path's shapes (4 sequences, D 256;
// gemma3-1b's 4 q heads over 512 or 1032 slots, recurrentgemma-9b's 16
// over 2048) a call moves 2-8 MB, one to a few microseconds at the card's
// memory rate, so what costs is the bytes in flight on each SM, the
// launches and the merge of the pieces the cache is cut into.
//
// Design.  The TPU kernel walks a sequential grid axis over the cache and
// carries (m, l, acc) in VMEM scratch.  Decode shapes have few (batch, kv
// head) rows, so here the cache of a row is cut across the SMs and the
// pieces are merged on chip, in one launch (`decode_attention_kernel`):
//
//   * One thread-block cluster of C CTAs per (row, block of 16 q heads):
//     every q head of a row with G <= 16, so each K and V row is read once
//     a call (G > 16 takes ceil(G / 16) clusters, each reading the row).
//     CTA r of the cluster takes the whole 64-key blocks [r nb / C, (r + 1)
//     nb / C) of the row's nb blocks, so no run is empty, and walks them in
//     tiles of kTK keys (64; 32 where q or the cache is float32).  The host
//     picks C (at most 16) so that rows x C is near the SM count and every
//     cluster is resident at once (`ops.plan`, from
//     cudaOccupancyMaxActiveClusters).
//   * A CTA is a producer warp and 4 consumer warps (8 with float32 q)
//     around a ring of kStages stages, each stage a K and a V tile with a
//     full and an empty `mbarrier`.  A tile lies in shared memory as 8
//     groups of kR = kTK / 8 rows, each group's rows back to back and 16
//     bytes of padding after it.  With one kv head (every model but the
//     GQA families) a group is one contiguous run of the cache, so the
//     producer fills a stage with 16 one-dimensional bulk asynchronous
//     copies (`cp.async.bulk ... mbarrier::complete_tx::bytes`, no tensor
//     map).  A row of a (B, W, KH, D) cache with KH > 1 is D contiguous
//     elements at a stride of KH D; such rows arrive in 16-byte `cp.async`
//     pieces, each lane's pieces signalling the full barrier
//     (`cp.async.mbarrier.arrive.noinc`).  Rows whose bytes are not a
//     multiple of 16, or a cache pointer not 16-byte aligned, take element
//     loads by the producer (the launcher decides per call).  Measured on
//     the card at recurrentgemma-9b's shape: one bulk copy per row into
//     padded rows cost ~7 us a call (the copy instruction is uniform, so a
//     warp issues its lanes' copies one at a time), a copy per group ~2.6
//     us; at the families' strided rows (D 128) a bulk copy per row cost
//     ~8.8 us.
//   * Bank conflicts.  The 8 rows an `ldmatrix` phase reads are the keys
//     i kR + c of the 8 groups i, 16 bytes apart modulo 128, so no phase
//     conflicts.
//   * Products.  With bfloat16 q, consumer warp w scores the 16 head rows
//     (zero rows past G) against the keys i kR + 2 w and i kR + 2 w + 1 of
//     every group i (16 of a 64-key tile) on the tensor cores
//     (`mma.sync.m16n8k16`, K by `ldmatrix`, or from a float32 cache
//     rounded to bfloat16 on the way) and writes them, times D^-1/2 log2 e
//     and -1e30 where invalid, to one of two S tiles.  After one barrier
//     among the consumers every warp runs the same online softmax over the
//     whole tile (a lane's 16 keys of a row, two shuffles; p by `ex2`),
//     keeps P in registers as the A operand of P V and adds P V (V by
//     `ldmatrix.trans`) over its own quarter of the columns: no warp
//     merges with another, and the stage is released when every warp has
//     read it.  Not `wgmma`: its tiles have 64 rows where a CTA has at most
//     16 q heads (4-16 on the model's paths, so 48-60 of the 64 rows would
//     be zeros), and the kernel is bound by bytes, not by the tensor cores.
//     With float32 q the products run on the CUDA cores with barriers
//     among the consumers: a lane owns a key and a warp the heads w, w +
//     8 below G for the scores, 8 threads take a head's softmax, and P V
//     runs with a thread per 2 columns and 8 heads.
//   * A float8_e4m3fn cache arrives as bytes by the same copies (half a
//     bfloat16 cache's bytes).  Under bfloat16 q each consumer warp widens
//     its K rows and its columns of V from the stage into a bfloat16 tile
//     (`cvt` e4m3x2 -> f16x2, exact; the same grouping), so that it reads
//     only what it widened, and releases the stage at once; under float32
//     q the products widen the bytes as they read them.
//   * Merge.  Each CTA leaves its (m, l, acc) in shared memory and, after
//     a cluster barrier, CTA r takes about D / C columns of every head, 4
//     at a time, reads every CTA's (m, l) and those columns of its acc
//     through distributed shared memory (`mapa`, `ld.shared::cluster`) in
//     one round, every load in flight at once, merges them with weights
//     exp(m_i - max_i m_i) (2^ with bfloat16 q) and writes its columns of
//     the output once.  A run without any valid slot ends with m = -1e30,
//     l = 0 and acc = 0 and weighs nothing.  A second cluster barrier keeps
//     every CTA's shared memory alive until the others have read it.  A
//     cluster of one CTA writes its output without the merge.  Measured
//     on the card: pushing the pieces to their owners (remote stores or
//     shared-to-shared bulk copies) after a tree merge of the warps' sums
//     cost 3-6 us more a call than this.
//
// Interface: plain C, called through ctypes; the launcher returns the
// launch's cudaError_t so the Python wrapper raises on a refused launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kHeads = 16;              // q heads of one cluster
constexpr int kBlockKeys = 64;          // a CTA's run is whole blocks of these
constexpr int kStages = 3;              // the bulk-copy ring
constexpr int kMaxCluster = 16;         // CTAs of a cluster (non-portable > 8)
constexpr size_t kSmemLimit = 232448;   // a block's opt-in shared memory
constexpr float kNeg = -1e30f;

using bf16 = __nv_bfloat16;
using fp8 = uint8_t;                    // float8_e4m3fn bits


template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// two float8_e4m3fn elements (the low byte first) as floats: exact, NaN
// (S.1111.111) staying NaN
__device__ __forceinline__ float2 e4m3x2_to_float2(uint32_t two) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(two & 0xffffu), __NV_E4M3);
  return __half22float2(__half2(h));
}

// 2^x by the special-function unit (the bf16 path: p is rounded to
// bfloat16, 2^-8, far coarser than its ~2^-22 relative error)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two consecutive float32 elements as a packed bf16 pair (rounded)
__device__ __forceinline__ uint32_t pair_bf16(const float* p) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  return pack_bf16(x.x, x.y);
}

// four consecutive cache elements of a shared-memory row, as floats
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
}
__device__ __forceinline__ void load4(const bf16* p, float (&x)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  x[0] = __low2float(lo); x[1] = __high2float(lo);
  x[2] = __low2float(hi); x[3] = __high2float(hi);
}
__device__ __forceinline__ void load4(const fp8* p, float (&x)[4]) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  const float2 lo = e4m3x2_to_float2(w), hi = e4m3x2_to_float2(w >> 16);
  x[0] = lo.x; x[1] = lo.y; x[2] = hi.x; x[3] = hi.y;
}
// two consecutive cache elements of a shared-memory row, as floats
__device__ __forceinline__ void load2(const float* p, float (&x)[2]) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  x[0] = t.x; x[1] = t.y;
}
__device__ __forceinline__ void load2(const bf16* p, float (&x)[2]) {
  const __nv_bfloat162 t = *reinterpret_cast<const __nv_bfloat162*>(p);
  x[0] = __low2float(t); x[1] = __high2float(t);
}
__device__ __forceinline__ void load2(const fp8* p, float (&x)[2]) {
  const float2 t =
      e4m3x2_to_float2(*reinterpret_cast<const unsigned short*>(p));
  x[0] = t.x; x[1] = t.y;
}
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers, bulk copies, clusters ------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// arrive once and add ``bytes`` to the phase's expected transactions
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// wait for the phase of ``parity`` to complete; a copy that never lands
// fails the launch (trap) rather than hang the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spins == (1u << 22)) __trap();
  }
}

// ``bytes`` (a multiple of 16, both addresses 16-byte aligned) from global
// to this CTA's shared memory, completing on ``bar``
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// order this thread's generic-proxy writes to shared memory before later
// bulk copies into it
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_ctas() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

// every thread of every CTA of the cluster; releases this CTA's shared
// memory writes to the others and acquires theirs
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the address of this CTA's shared ``addr`` in CTA ``rank`` of the cluster
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float x;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(x) : "r"(addr));
  return x;
}

__device__ __forceinline__ float4 ld_cluster4(uint32_t addr) {
  float4 x;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w) : "r"(addr));
  return x;
}

// ---- tensor-core fragments -----------------------------------------------
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16 x 16, row) b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The warps of a CTA: 4 consumer warps (8 with float32 q, whose
// products run on the CUDA cores and need the warps to hide shared-memory
// latency) and a producer warp.
template <typename Tq>
__host__ __device__ constexpr int consumers_of() {
  return sizeof(Tq) == 2 ? 128 : 256;
}

// Shared memory of one CTA (mirrored by ops.smem_bytes).  A K or V tile
// of kTK keys is 8 groups of kR = kTK / 8 rows, each group kR rows of kDp
// elements back to back and 16 bytes of padding, so that the 8 rows an
// `ldmatrix` phase reads (key i kR + c of each group i) fall on distinct
// banks, and a group of a (B, W, 1, D) cache is one bulk copy.  The ring's
// K and V tiles of every stage (the cache's type), the widened bfloat16
// tile (float8 cache under bfloat16 q; the same grouping), Q (rows padded
// by 16 bytes), the scores S (two tiles with bfloat16 q) and P (float32
// q), the per-head rescale and the stages' full and empty mbarriers.  The
// merge's floats (each head's acc in rows of kDp + 8, its m and l) reuse
// the ring once every tile is read.
template <typename Tq, typename Tg, int kDp>
struct Layout {
  static constexpr bool kMma = sizeof(Tq) == 2;
  static constexpr bool kWiden = kMma && sizeof(Tg) == 1;
  static constexpr int kTK = (sizeof(Tq) == 4 || sizeof(Tg) == 4) ? 32 : 64;
  static constexpr int kR = kTK / 8;                   // rows of a group
  static constexpr int kRowG = kDp * static_cast<int>(sizeof(Tg));
  static constexpr int kGroupG = kR * kRowG + 16;
  static constexpr int kRowW = kDp * static_cast<int>(sizeof(bf16));
  static constexpr int kGroupW = kR * kRowW + 16;
  static constexpr int kLdQ = kDp + 16 / static_cast<int>(sizeof(Tq));
  static constexpr int kLdS = kTK + 4;
  static constexpr int kLdA = kDp + 8;                 // a merge row
  static constexpr size_t kTile = 8 * static_cast<size_t>(kGroupG);
  static constexpr size_t kRing = 2 * kStages * kTile;
  static constexpr size_t kWide =
      kWiden ? 2 * 8 * static_cast<size_t>(kGroupW) : 0;
  static constexpr size_t kSP = 2 * sizeof(float) * kHeads * kLdS;
  static constexpr size_t oQ = kRing + kWide;
  static constexpr size_t oS = oQ + sizeof(Tq) * kHeads * kLdQ;
  static constexpr size_t oCorr = oS + kSP;
  static constexpr size_t oBar = oCorr + sizeof(float) * kHeads;
  static constexpr size_t kBytes = oBar + 16 * kStages;
  static constexpr size_t kMerge = sizeof(float) * kHeads * (kLdA + 2);
  static_assert(kMerge <= kRing, "the merge fits the ring");
  static_assert(kBytes <= kSmemLimit, "one CTA fits an SM");
  static_assert(oBar % 16 == 0, "aligned mbarriers");
  static_assert(!kMma || kTK == 64 || sizeof(Tg) == 4,
                "bf16 tiles are 64 keys (16 keys a warp)");
};

// byte offset of a tile's key j: group j / kR, row j % kR
template <int kR, int kRow>
__device__ __forceinline__ uint32_t row_off(int j) {
  return static_cast<uint32_t>((j / kR) * (kR * kRow + 16) + (j % kR) * kRow);
}

// float32 q: the products' order of a tile's keys.  P column (k-step c /
// 2, half c % 2, index i) holds key i kR + c, so a 4-key step of P V takes
// rows of 4 groups
template <int kR>
__device__ __forceinline__ int key_of_col(int pc) {
  const int kk = pc & 15;
  return (kk & 7) * kR + (pc >> 4) * 2 + (kk >> 3);
}

template <int kCount>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kCount) : "memory");
}

// cp.async of 16 bytes, completion tracked by the thread's next
// cp.async.mbarrier.arrive
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

// arrive on ``bar`` once this thread's cp.async copies have landed (the
// arrival counted in the barrier's initial count)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// kDp: D padded to 64, 128 or 256; Tg: the cache's element (float, bf16,
// or fp8 bits widened to Tq).  Grid (rows C, ceil(G / 16)), clusters of C
// along x; the consumer warps and a producer warp.  flags: bit 0, K and V
// by copies (else element loads); bit 1, q read in 16-byte pieces.
template <typename Tq, typename Tg, int kDp>
__global__ void __launch_bounds__(consumers_of<Tq>() + 32, 1)
decode_attention_kernel(const void* q_, const void* k_, const void* v_,
                        const int* __restrict__ valid, void* o_, int G,
                        int W, int D, int kh, int valid_stride, int n_blocks,
                        float scale, int flags) {
  using L = Layout<Tq, Tg, kDp>;
  constexpr int kTK = L::kTK;
  constexpr int kR = L::kR;
  constexpr bool kMma = L::kMma;
  constexpr bool kWiden = L::kWiden;
  constexpr bool kB16 = kMma && !std::is_same<Tg, float>::value;
  constexpr int kConsumers = consumers_of<Tq>();
  constexpr int kThreads = kConsumers + 32;
  constexpr int kWarps = kConsumers / 32;
  const Tq* __restrict__ q = static_cast<const Tq*>(q_);
  const Tg* __restrict__ k = static_cast<const Tg*>(k_);
  const Tg* __restrict__ v = static_cast<const Tg*>(v_);
  Tq* __restrict__ o = static_cast<Tq*>(o_);
  extern __shared__ __align__(128) unsigned char smem[];
  Tq* const Qs = reinterpret_cast<Tq*>(smem + L::oQ);               // (16, kLdQ)
  float* const Ss = reinterpret_cast<float*>(smem + L::oS);         // 2 (16, kLdS)
  float* const Ps = Ss + kHeads * L::kLdS;                          // (16, kLdS)
  float* const corr_s = reinterpret_cast<float*>(smem + L::oCorr);  // (16,)
  unsigned char* const Kw = smem + L::kRing;                        // widened
  unsigned char* const Vw = Kw + 8 * L::kGroupW;
  const uint32_t full0 = smem_addr(smem + L::oBar);
  const uint32_t empty0 = full0 + 8 * kStages;
  auto ring_k = [&](int s) { return smem + 2 * s * L::kTile; };
  auto ring_v = [&](int s) { return smem + (2 * s + 1) * L::kTile; };

  const int C = static_cast<int>(cluster_ctas());
  const int rank = static_cast<int>(cluster_rank());
  const int row = blockIdx.x / C;
  const int h0 = blockIdx.y * kHeads;
  const int nh = min(kHeads, G - h0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const bool copies = flags & 1;
  const size_t kstride = static_cast<size_t>(kh) * D;
  const size_t kbase =
      (static_cast<size_t>(row / kh) * W * kh + row % kh) * D;
  const int* const vrow = valid + static_cast<size_t>(valid_stride) * row;
  const int j_begin = (rank * n_blocks / C) * kBlockKeys;
  const int j_end = min(W, ((rank + 1) * n_blocks / C) * kBlockKeys);
  const int n_tiles = (j_end - j_begin + kTK - 1) / kTK;
  const int row_bytes = D * static_cast<int>(sizeof(Tg));
  // a (B, W, 1, kDp) cache: a group's rows are one contiguous run
  const bool grouped = copies && kh == 1 && D == kDp;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, grouped ? 1 : 32);
      mbar_init(empty0 + 8 * s, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (D < kDp) {        // the padded columns D .. kDp are never copied: zeros
    uint4* const r4 = reinterpret_cast<uint4*>(smem);
    for (int e = tid; e < static_cast<int>(L::kRing / 16); e += kThreads)
      r4[e] = make_uint4(0u, 0u, 0u, 0u);
    fence_proxy_async();
  }
  __syncthreads();

  // per consumer thread: the running (m, l) of its heads and acc
  constexpr int kNT = kMma ? kTK / 32 : 1;       // n-tiles of a warp's keys
  constexpr int kCw = kDp / 4;                   // bf16 q: a warp's columns
  constexpr int kAcc = kMma ? kCw / 8 : 8;       // accumulator rows
  constexpr int kAccW = kMma ? 4 : 2;
  float acc[kAcc][kAccW];
  float m_run[2] = {kNeg, kNeg}, l_run[2] = {0.f, 0.f};
  const int g = lane >> 2;
  const int t4 = lane & 3;

  if (warp == kWarps) {
    // ---- producer: tile t into stage t % kStages once it is free ------
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const int j0 = j_begin + t * kTK;
      const int n = min(kTK, j_end - j0);
      const uint32_t full = full0 + 8 * s;
      if (t >= kStages) mbar_wait(empty0 + 8 * s, (t / kStages - 1) & 1);
      const uint32_t kd = smem_addr(ring_k(s));
      const uint32_t vd = smem_addr(ring_v(s));
      if (grouped) {                    // one bulk copy a group of K or V
        if (lane == 0) mbar_expect(full, 2u * n * row_bytes);
        __syncwarp();
        const int gi = lane & 7;
        const int rows = min(kR, n - gi * kR);
        if (lane < 16 && rows > 0) {
          const size_t off = kbase + static_cast<size_t>(j0 + gi * kR) * D;
          bulk_copy((lane < 8 ? kd : vd) + gi * L::kGroupG,
                    (lane < 8 ? k : v) + off, rows * row_bytes, full);
        }
      } else if (copies) {              // strided rows: 16-byte pieces
        const int per = row_bytes / 16;           // pieces of a row
        if (per <= 32) {                          // a lane a fixed piece
          const int step = 32 / per;              // rows a round
          if (lane < step * per) {
            const int b = (lane % per) * 16;
            const unsigned char* ks = reinterpret_cast<const unsigned char*>(
                k + kbase + static_cast<size_t>(j0) * kstride) + b;
            const unsigned char* vs = reinterpret_cast<const unsigned char*>(
                v + kbase + static_cast<size_t>(j0) * kstride) + b;
            const size_t rs = kstride * sizeof(Tg);
            for (int r = lane / per; r < n; r += step) {
              const uint32_t at = row_off<kR, L::kRowG>(r) + b;
              cp_async16(kd + at, ks + r * rs);
              cp_async16(vd + at, vs + r * rs);
            }
          }
        } else {
          for (int c = lane; c < n * per; c += 32) {
            const int r = c / per;
            const int b = (c - r * per) * 16;
            const size_t off = kbase + static_cast<size_t>(j0 + r) * kstride;
            const uint32_t at = row_off<kR, L::kRowG>(r) + b;
            cp_async16(kd + at,
                       reinterpret_cast<const unsigned char*>(k + off) + b);
            cp_async16(vd + at,
                       reinterpret_cast<const unsigned char*>(v + off) + b);
          }
        }
        cp_async_arrive(full);
      } else {                          // element loads
        for (int e = lane; e < n * D; e += 32) {
          const int r = e / D;
          const int d = e - r * D;
          const size_t off = kbase + static_cast<size_t>(j0 + r) * kstride + d;
          const uint32_t at = row_off<kR, L::kRowG>(r);
          reinterpret_cast<Tg*>(ring_k(s) + at)[d] = k[off];
          reinterpret_cast<Tg*>(ring_v(s) + at)[d] = v[off];
        }
        mbar_arrive(full);
      }
    }
  } else {
    // ---- consumers ------------------------------------------------------
    // the first tile's validity, then q, every load in flight at once
    constexpr int kVal = kMma ? 2 * kNT : kTK / 8;     // slots of a thread
    auto slot_of = [&](int i) {         // a thread's i-th slot in a tile
      return kMma ? (2 * t4 + (i & 1)) * kR + kNT * warp + (i >> 1)
                  : (tid & 7) + 8 * i;
    };
    int okv[kVal];                      // the next tile's, a tile ahead
#pragma unroll
    for (int i = 0; i < kVal; ++i) {
      const int j = slot_of(i);
      okv[i] = j < j_end - j_begin ? vrow[j_begin + j] : 0;
    }
    // q heads h0 .. h0 + nh - 1 (zero rows and columns past them)
    const Tq* const qb = q + (static_cast<size_t>(row) * G + h0) * D;
    if (flags & 2) {                    // 16-byte pieces, all loads at once
      constexpr int kPer = 16 / static_cast<int>(sizeof(Tq));
      constexpr int kChunks = kHeads * kDp / kPer;
      constexpr int kEach = (kChunks + kConsumers - 1) / kConsumers;
      uint4 qv[kEach];
#pragma unroll
      for (int i = 0; i < kEach; ++i) {
        const int c = tid + i * kConsumers;
        const int h = c / (kDp / kPer);
        const int d = (c - h * (kDp / kPer)) * kPer;
        qv[i] = (c < kChunks && h < nh && d < D)
                    ? *reinterpret_cast<const uint4*>(qb + h * D + d)
                    : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int i = 0; i < kEach; ++i) {
        const int c = tid + i * kConsumers;
        const int h = c / (kDp / kPer);
        const int d = (c - h * (kDp / kPer)) * kPer;
        if (c < kChunks)
          *reinterpret_cast<uint4*>(Qs + h * L::kLdQ + d) = qv[i];
      }
    } else {
      for (int e = tid; e < kHeads * kDp; e += kConsumers) {
        const int h = e / kDp;
        const int d = e - h * kDp;
        Qs[h * L::kLdQ + d] =
            (h < nh && d < D) ? qb[h * D + d] : from_float<Tq>(0.f);
      }
    }
#pragma unroll
    for (int i = 0; i < kAcc; ++i)
#pragma unroll
      for (int e = 0; e < kAccW; ++e) acc[i][e] = 0.f;
    consumers_sync<kConsumers>();

    if constexpr (kMma) {
      // warp w scores the keys i kR + kNT w + n8 of every group i into S
      // (invalid ones -1e30); after one barrier every warp runs the same
      // online softmax over the whole tile, keeps P in registers as the A
      // operand of P V and adds P V over its own kDp / 4 columns
      const int cw = warp * kCw;        // this warp's first column
      const float scale2 = scale * 1.4426950408889634f;   // log2 e
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const int j0 = j_begin + it * kTK;
        const int n = min(kTK, j_end - j0);
        unsigned char* const Kg = ring_k(s);
        unsigned char* const Vg = ring_v(s);
        float* const Sx = Ss + (it & 1) * kHeads * L::kLdS;
        bool ok[kNT][2];                // slot i = 2 n8 + (e & 1)
#pragma unroll
        for (int i = 0; i < kVal; ++i) {
          ok[i >> 1][i & 1] = okv[i] != 0;
          const int j = slot_of(i) + kTK;
          okv[i] = j < j_end - j0 ? vrow[j0 + j] : 0;
        }
        mbar_wait(full0 + 8 * s, (it / kStages) & 1);
        if constexpr (kWiden) {
          // float8 to bfloat16 (rows past the run zero): this warp's K
          // rows and its columns of V, then the stage is released
          constexpr int kChK = kDp / 16;         // 16-byte pieces of a row
          constexpr int kChV = kCw / 16;
          constexpr int kK = 8 * kNT * kChK;
          for (int c = lane; c < kK + kTK * kChV; c += 32) {
            int j, d;
            bool is_v = c >= kK;
            if (!is_v) {
              const int rr = c / kChK;
              j = (rr / kNT) * kR + kNT * warp + rr % kNT;
              d = (c - rr * kChK) * 16;
            } else {
              j = (c - kK) / kChV;
              d = cw + ((c - kK) - j * kChV) * 16;
            }
            const uint4 w =
                j < n ? *reinterpret_cast<const uint4*>(
                            (is_v ? Vg : Kg) + row_off<kR, L::kRowG>(j) + d)
                      : make_uint4(0u, 0u, 0u, 0u);
            const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
            uint32_t b[8];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float2 lo = e4m3x2_to_float2(ws[i]);
              const float2 hi = e4m3x2_to_float2(ws[i] >> 16);
              b[2 * i] = pack_bf16(lo.x, lo.y);
              b[2 * i + 1] = pack_bf16(hi.x, hi.y);
            }
            uint4* const dst = reinterpret_cast<uint4*>(
                (is_v ? Vw : Kw) + row_off<kR, L::kRowW>(j) + 2 * d);
            dst[0] = make_uint4(b[0], b[1], b[2], b[3]);
            dst[1] = make_uint4(b[4], b[5], b[6], b[7]);
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(empty0 + 8 * s);
        } else if (n < kTK) {           // V rows past the run meet p = 0:
          constexpr int kCh = kCw * static_cast<int>(sizeof(Tg)) / 16;
          for (int c = lane; c < (kTK - n) * kCh; c += 32) {
            const int j = n + c / kCh;  // no stale NaN there (this warp's
            *reinterpret_cast<uint4*>(  // columns)
                Vg + row_off<kR, L::kRowG>(j) + cw * sizeof(Tg) +
                (c % kCh) * 16) = make_uint4(0u, 0u, 0u, 0u);
          }
          __syncwarp();
        }
        const unsigned char* const Kb = kWiden ? Kw : Kg;
        const unsigned char* const Vb = kWiden ? Vw : Vg;

        // S = Q K^T of the 16 heads and the warp's keys (two chains a
        // key n-tile: even and odd k-steps)
        float sacc[2][kNT][4];
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int n8 = 0; n8 < kNT; ++n8)
#pragma unroll
            for (int e = 0; e < 4; ++e) sacc[c][n8][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kDp / 16; ++kk) {
          uint32_t a[4];
          ldsm_x4(a, smem_addr(Qs + (lane & 15) * L::kLdQ + kk * 16 +
                               (lane >> 4) * 8));
          if constexpr (kB16) {                  // 16 keys: one ldmatrix
            const int m = lane >> 3;
            uint32_t bk[4];
            ldsm_x4(bk, smem_addr(Kb + (lane & 7) * L::kGroupW +
                                  (2 * warp + (m >> 1)) * L::kRowW +
                                  (kk * 16 + (m & 1) * 8) * 2));
            mma(sacc[kk & 1][0], a, bk[0], bk[1]);
            mma(sacc[kk & 1][1], a, bk[2], bk[3]);
          } else {                               // 8 keys from float32
            const float* kr = reinterpret_cast<const float*>(
                Kg + g * L::kGroupG + warp * L::kRowG) + kk * 16 + 2 * t4;
            mma(sacc[kk & 1][0], a, pair_bf16(kr), pair_bf16(kr + 8));
          }
        }
#pragma unroll
        for (int n8 = 0; n8 < kNT; ++n8)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            Sx[(g + (e >> 1) * 8) * L::kLdS +
               (2 * t4 + (e & 1)) * kR + kNT * warp + n8] =
                ok[n8][e & 1] ? (sacc[0][n8][e] + sacc[1][n8][e]) * scale2
                              : kNeg;
        consumers_sync<kConsumers>();

        // online softmax of heads g and g + 8 over the tile, in base 2 (S
        // holds s D^-1/2 log2 e): this lane holds the keys (2 t4 + a) kR +
        // b, a < 2, b < kR (contiguous in S), the others through two
        // shuffles; an invalid slot gets p = 0
        float sv[2][2 * kR];
        float mx[2] = {kNeg, kNeg};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int x = 0; x < 2 * kR; x += 4) {
            const float4 t = *reinterpret_cast<const float4*>(
                Sx + (g + 8 * r) * L::kLdS + 2 * t4 * kR + x);
            sv[r][x] = t.x; sv[r][x + 1] = t.y;
            sv[r][x + 2] = t.z; sv[r][x + 3] = t.w;
          }
#pragma unroll
          for (int x = 0; x < 2 * kR; ++x) mx[r] = fmaxf(mx[r], sv[r][x]);
        }
        float corr[2], ps[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m_run[r], mx[r]);
          corr[r] = ex2(m_run[r] - m_new);
          m_run[r] = m_new;
#pragma unroll
          for (int x = 0; x < 2 * kR; ++x) {
            sv[r][x] = sv[r][x] > 0.5f * kNeg ? ex2(sv[r][x] - m_new) : 0.f;
            ps[r] += sv[r][x];
          }
          ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 1);
          ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 2);
          l_run[r] = l_run[r] * corr[r] + ps[r];
        }
#pragma unroll
        for (int nt = 0; nt < kAcc; ++nt) {
          acc[nt][0] *= corr[0];
          acc[nt][1] *= corr[0];
          acc[nt][2] *= corr[1];
          acc[nt][3] *= corr[1];
        }
        // acc += P V over this warp's columns.  k-step ks: k-index x < 8 is
        // key x kR + 2 ks, x >= 8 key (x - 8) kR + 2 ks + 1; P rounded to
        // bf16 as the A operand
#pragma unroll
        for (int ks = 0; ks < kTK / 16; ++ks) {
          uint32_t pa[4];
          pa[0] = pack_bf16(sv[0][2 * ks], sv[0][kR + 2 * ks]);
          pa[1] = pack_bf16(sv[1][2 * ks], sv[1][kR + 2 * ks]);
          pa[2] = pack_bf16(sv[0][2 * ks + 1], sv[0][kR + 2 * ks + 1]);
          pa[3] = pack_bf16(sv[1][2 * ks + 1], sv[1][kR + 2 * ks + 1]);
#pragma unroll
          for (int dp = 0; dp < kCw / 16; ++dp) {
            if constexpr (kB16) {
              const int m = lane >> 3;
              uint32_t bv[4];
              ldsm_x4_t(bv, smem_addr(Vb + (lane & 7) * L::kGroupW +
                                      (2 * ks + (m & 1)) * L::kRowW +
                                      (cw + dp * 16 + (m >> 1) * 8) * 2));
              mma(acc[2 * dp], pa, bv[0], bv[1]);
              mma(acc[2 * dp + 1], pa, bv[2], bv[3]);
            } else {
              // float32 V: keys of groups 2 t4 and 2 t4 + 1, rows 2 ks and
              // 2 ks + 1, rounded to bf16 on the way
              const unsigned char* const r0 =
                  Vg + (2 * t4) * L::kGroupG + (2 * ks) * L::kRowG;
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int d = cw + dp * 16 + h * 8 + g;
                auto at = [&](int off) {
                  return reinterpret_cast<const float*>(r0 + off)[d];
                };
                mma(acc[2 * dp + h], pa, pack_bf16(at(0), at(L::kGroupG)),
                    pack_bf16(at(L::kRowG), at(L::kGroupG + L::kRowG)));
              }
            }
          }
        }
        if constexpr (!kWiden) {
          __syncwarp();
          if (lane == 0) mbar_arrive(empty0 + 8 * s);
        }
      }
    } else {
      // float32 q: the consumers share one online softmax, a barrier among
      // them between the products
      const int sh = tid >> 3;          // softmax: the first 128 threads
      constexpr int kPer = kTK / 8;
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const int j0 = j_begin + it * kTK;
        const int n = min(kTK, j_end - j0);
        unsigned char* const Kg = ring_k(s);
        unsigned char* const Vg = ring_v(s);
        bool ok[kPer];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          ok[i] = okv[i] != 0;
          const int j = slot_of(i) + kTK;
          okv[i] = j < j_end - j0 ? vrow[j0 + j] : 0;
        }
        mbar_wait(full0 + 8 * s, (it / kStages) & 1);
        if (n < kTK) {                  // V rows past the run: zeros
          constexpr int kChunks = L::kRowG / 16;
          for (int c = tid; c < (kTK - n) * kChunks; c += kConsumers) {
            const int j = n + c / kChunks;
            *reinterpret_cast<uint4*>(Vg + row_off<kR, L::kRowG>(j) +
                                      (c % kChunks) * 16) =
                make_uint4(0u, 0u, 0u, 0u);
          }
          consumers_sync<kConsumers>();
        }
        // scores: lane l takes key (l % 8) kR + l / 8 (the 8 keys of a load
        // phase lie in 8 groups), warp w the heads w, w + kWarps below nh,
        // its K row read once for them
        auto score = [&](auto heads) {  // heads w (and w + kWarps)
          constexpr int kHW = decltype(heads)::value;
          const int j = (lane & 7) * kR + (lane >> 3);
          const Tg* const kr =
              reinterpret_cast<const Tg*>(Kg + row_off<kR, L::kRowG>(j));
          const float* const qr =
              reinterpret_cast<const float*>(Qs) + warp * L::kLdQ;
          float sv[kHW] = {};
#pragma unroll 8
          for (int d = 0; d < kDp; d += 4) {
            float kv4[4];
            load4(kr + d, kv4);
#pragma unroll
            for (int x = 0; x < kHW; ++x) {
              const float4 qq = *reinterpret_cast<const float4*>(
                  qr + kWarps * x * L::kLdQ + d);
              sv[x] = fmaf(qq.x, kv4[0], sv[x]);
              sv[x] = fmaf(qq.y, kv4[1], sv[x]);
              sv[x] = fmaf(qq.z, kv4[2], sv[x]);
              sv[x] = fmaf(qq.w, kv4[3], sv[x]);
            }
          }
#pragma unroll
          for (int x = 0; x < kHW; ++x)
            Ss[(warp + kWarps * x) * L::kLdS + j] = sv[x] * scale;
        };
        static_assert(kHeads == 2 * kWarps, "two heads a warp at most");
        if (warp + kWarps < nh)
          score(std::integral_constant<int, 2>());
        else if (warp < nh)
          score(std::integral_constant<int, 1>());
        consumers_sync<kConsumers>();
        // online softmax of head sh over the tile, 8 threads a head (heads
        // past nh run on stale scores and are never read)
        if (tid < 8 * kHeads) {
          const int sub = tid & 7;
          float sv[kPer];
          float mx = kNeg;
#pragma unroll
          for (int i = 0; i < kPer; ++i) {
            sv[i] = ok[i] ? Ss[sh * L::kLdS + sub + 8 * i] : kNeg;
            mx = fmaxf(mx, sv[i]);
          }
#pragma unroll
          for (int off = 1; off < 8; off <<= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          const float m_new = fmaxf(m_run[0], mx);
          const float corr = expf(m_run[0] - m_new);
          float ps = 0.f;
#pragma unroll
          for (int i = 0; i < kPer; ++i) {
            const float pv = ok[i] ? expf(sv[i] - m_new) : 0.f;
            ps += pv;
            const int j = sub + 8 * i;  // its column in the products' order
            Ps[sh * L::kLdS + ((j % kR) >> 1) * 16 + ((j % kR) & 1) * 8 +
               j / kR] = pv;
          }
#pragma unroll
          for (int off = 1; off < 8; off <<= 1)
            ps += __shfl_xor_sync(0xffffffffu, ps, off);
          l_run[0] = l_run[0] * corr + ps;
          m_run[0] = m_new;
          if (sub == 0) corr_s[sh] = corr;
        }
        consumers_sync<kConsumers>();
        // acc = acc * corr + P V: the first 128 threads take heads 0-7,
        // the others 8-15, each for the 2 columns 2 (tid % 128), + 1, 4
        // keys a step (each P load serves 2 columns)
        const int hh = (tid >> 7) * 8;  // this thread's first head
        const int d2 = 2 * (tid & 127);
#pragma unroll
        for (int h = 0; h < 8; ++h) {
          const float c = corr_s[hh + h];
          acc[h][0] *= c;
          acc[h][1] *= c;
        }
        if (hh < nh && d2 < kDp) {      // rows past nh: finite, never read
#pragma unroll 2
          for (int pc = 0; pc < kTK; pc += 4) {
            float vv[4][2];
#pragma unroll
            for (int x = 0; x < 4; ++x)
              load2(reinterpret_cast<const Tg*>(
                        Vg + row_off<kR, L::kRowG>(key_of_col<kR>(pc + x))) +
                        d2,
                    vv[x]);
            float4 pv[8];
#pragma unroll
            for (int h = 0; h < 8; ++h)
              pv[h] = *reinterpret_cast<const float4*>(
                  Ps + (hh + h) * L::kLdS + pc);
#pragma unroll
            for (int h = 0; h < 8; ++h)
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                float a = acc[h][c];
                a = fmaf(pv[h].x, vv[0][c], a);
                a = fmaf(pv[h].y, vv[1][c], a);
                a = fmaf(pv[h].z, vv[2][c], a);
                a = fmaf(pv[h].w, vv[3][c], a);
                acc[h][c] = a;
              }
          }
        }
        consumers_sync<kConsumers>();   // stage, S and P free again
        if (lane == 0) mbar_arrive(empty0 + 8 * s);
      }
    }
  }

  // ---- merge of the cluster's runs -------------------------------------------
  // this CTA's (m, l, acc) over the ring: every copy has landed and been read
  __syncthreads();
  float* const accS = reinterpret_cast<float*>(smem);   // (16, kLdA)
  float* const mS = accS + kHeads * L::kLdA;            // (16,)
  float* const lS = mS + kHeads;                        // (16,)
  Tq* const ob = o + (static_cast<size_t>(row) * G + h0) * D;
  if constexpr (kMma) {
    if (warp < kWarps) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int h = g + 8 * r;
        if (h < nh) {
          if (warp == 0 && t4 == 0) {
            mS[h] = m_run[r];
            lS[h] = l_run[r];
          }
          // one run (C = 1): the output straight from the registers
          const float inv = 1.f / fmaxf(l_run[r], 1e-30f);
#pragma unroll
          for (int nt = 0; nt < kAcc; ++nt) {
            const int d = warp * kCw + nt * 8 + 2 * t4;
            if (C == 1) {
              if (d < D) ob[h * D + d] = from_float<Tq>(acc[nt][2 * r] * inv);
              if (d + 1 < D)
                ob[h * D + d + 1] = from_float<Tq>(acc[nt][2 * r + 1] * inv);
            } else {
              *reinterpret_cast<float2*>(accS + h * L::kLdA + d) =
                  make_float2(acc[nt][2 * r], acc[nt][2 * r + 1]);
            }
          }
        }
      }
    }
    if (C == 1) return;
  } else {
    if (warp < kWarps) {
      if (tid < 8 * kHeads && (tid & 7) == 0) {
        mS[tid >> 3] = m_run[0];
        lS[tid >> 3] = l_run[0];
      }
      const int hh = (tid >> 7) * 8;
      const int d2 = 2 * (tid & 127);
      if (d2 < kDp)
#pragma unroll
        for (int h = 0; h < 8; ++h)
          *reinterpret_cast<float2*>(accS + (hh + h) * L::kLdA + d2) =
              make_float2(acc[h][0], acc[h][1]);
    }
    if (C == 1) {                       // one run: nothing to merge
      __syncthreads();
      for (int e = tid; e < nh * D; e += kThreads) {
        const int h = e / D;
        const int d = e - h * D;
        ob[h * D + d] =
            from_float<Tq>(accS[h * L::kLdA + d] / fmaxf(lS[h], 1e-30f));
      }
      return;
    }
  }
  cluster_sync();

  // this CTA's columns [c0, c1) of every head, 4 at a time: every run's
  // (m, l) and acc read in one round (all loads in flight), weighed by
  // exp(m_i - max m) and written once
  const int width = ((D + 3) / 4 + C - 1) / C * 4;
  const int c0 = rank * width;
  const int nq = max(0, (min(D, c0 + width) - c0 + 3) / 4);
  for (int e = tid; e < nh * nq; e += kThreads) {
    const int h = e / nq;
    const int d = c0 + (e - h * nq) * 4;
    const uint32_t m_at = smem_addr(mS + h);
    const uint32_t l_at = smem_addr(lS + h);
    const uint32_t a_at = smem_addr(accS + h * L::kLdA + d);
    float mi[kMaxCluster], li[kMaxCluster];
    float4 ai[kMaxCluster];
#pragma unroll
    for (int i = 0; i < kMaxCluster; ++i)
      if (i < C) {
        mi[i] = ld_cluster(map_rank(m_at, i));
        li[i] = ld_cluster(map_rank(l_at, i));
        ai[i] = ld_cluster4(map_rank(a_at, i));
      }
    float mx = kNeg;
#pragma unroll
    for (int i = 0; i < kMaxCluster; ++i)
      if (i < C) mx = fmaxf(mx, mi[i]);
    float l = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < kMaxCluster; ++i)
      if (i < C) {
        const float w = kMma ? ex2(mi[i] - mx) : expf(mi[i] - mx);
        l = fmaf(w, li[i], l);
        a.x = fmaf(w, ai[i].x, a.x);
        a.y = fmaf(w, ai[i].y, a.y);
        a.z = fmaf(w, ai[i].z, a.z);
        a.w = fmaf(w, ai[i].w, a.w);
      }
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int x = 0; x < 4; ++x)
      if (d + x < D) ob[h * D + d + x] = from_float<Tq>(av[x] * inv);
  }
  cluster_sync();           // no CTA leaves while another reads its memory
}

using Kernel = void (*)(const void*, const void*, const void*, const int*,
                        void*, int, int, int, int, int, int, float, int);

// instance ((q_bf16 * 3 + kv_type) * 3 + width), kv_type 0 float32, 1
// bfloat16, 2 float8_e4m3fn; width 0, 1, 2 for D <= 64, 128, 256 (as
// ops.instance)
#define DECODE_INSTANCES(Tq)                                          \
  decode_attention_kernel<Tq, float, 64>,                             \
      decode_attention_kernel<Tq, float, 128>,                        \
      decode_attention_kernel<Tq, float, 256>,                        \
      decode_attention_kernel<Tq, bf16, 64>,                          \
      decode_attention_kernel<Tq, bf16, 128>,                         \
      decode_attention_kernel<Tq, bf16, 256>,                         \
      decode_attention_kernel<Tq, fp8, 64>,                           \
      decode_attention_kernel<Tq, fp8, 128>,                          \
      decode_attention_kernel<Tq, fp8, 256>
#define DECODE_SMEM(Tq)                                                       \
  Layout<Tq, float, 64>::kBytes, Layout<Tq, float, 128>::kBytes,              \
      Layout<Tq, float, 256>::kBytes, Layout<Tq, bf16, 64>::kBytes,           \
      Layout<Tq, bf16, 128>::kBytes, Layout<Tq, bf16, 256>::kBytes,           \
      Layout<Tq, fp8, 64>::kBytes, Layout<Tq, fp8, 128>::kBytes,              \
      Layout<Tq, fp8, 256>::kBytes

constexpr int kInstances = 18;
const Kernel kKernels[kInstances] = {DECODE_INSTANCES(float),
                                     DECODE_INSTANCES(bf16)};
constexpr size_t kSmem[kInstances] = {DECODE_SMEM(float), DECODE_SMEM(bf16)};
constexpr int kKvBytes[3] = {4, 2, 1};

cudaLaunchConfig_t launch_config(int instance, int cluster, dim3 grid,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(instance >= 9 ? 160 : 288, 1, 1);   // consumers_of + 32
  cfg.dynamicSmemBytes = kSmem[instance];
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

// A call's launch, made once per shape by ops._new_launch (ctypes mirror
// ops._PlanArgs): kernel instance, rows = B·KH, G, W, D, kh, the validity
// row stride (0: one row shared), 64-key blocks of a row, CTAs of a
// cluster, blocks of 16 q heads, and D^-1/2.
struct DecodePlan {
  int instance, rows, G, W, D, kh, valid_stride, n_blocks, cluster,
      head_blocks;
  float scale;
};

// Sets the instance's attributes on the current device (its dynamic
// shared memory; clusters above 8 CTAs) and reports its shared memory, its
// CTAs per SM and how many clusters of ``cluster`` CTAs can be resident at
// once.
int decode_attention_prepare(int instance, int cluster, int* smem,
                             int* per_sm, int* resident) {
  if (instance < 0 || instance >= kInstances || cluster < 1 ||
      cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const Kernel fn = kKernels[instance];
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem[instance]));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(instance, cluster, dim3(cluster, 1, 1), 0, &attr);
  int n = 0, blocks = 0;
  err = cudaOccupancyMaxActiveClusters(&n, fn, &cfg);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, fn, cfg.blockDim.x, kSmem[instance]);
  *smem = static_cast<int>(kSmem[instance]);
  *per_sm = blocks;
  *resident = n;
  return static_cast<int>(err);
}

// q (rows, G, D); k and v: row r's key j at ((r / kh) * W * kh + r % kh +
// j * kh) * D, i.e. a (rows / kh, W, kh, D) cache (kh = 1: (rows, W, D));
// valid: row r's slot j at valid[r * valid_stride + j] (int32, stride 0
// shares one row); o (rows, G, D) of q's type.  One launch; K and V by
// bulk copies when a row's bytes are a multiple of 16 and both cache
// pointers are 16-byte aligned, else by element loads; q in 16-byte pieces
// on the same terms.
int decode_attention_run(const DecodePlan* p, const void* q, const void* k,
                         const void* v, const void* valid, void* o,
                         cudaStream_t stream) {
  if (p->instance < 0 || p->instance >= kInstances || p->cluster < 1 ||
      p->cluster > kMaxCluster || p->D < 1 || p->D > 256 || p->G < 1 ||
      p->W < 1 || p->kh < 1 || p->rows % p->kh != 0 ||
      p->n_blocks != (p->W + kBlockKeys - 1) / kBlockKeys ||
      p->n_blocks < p->cluster ||
      p->head_blocks != (p->G + kHeads - 1) / kHeads ||
      p->D > 64 << (p->instance % 3))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p->rows == 0) return static_cast<int>(cudaGetLastError());
  const int kv_bytes = kKvBytes[p->instance / 3 % 3];
  const int q_bytes = p->instance >= 9 ? 2 : 4;
  const int flags =
      ((p->D * kv_bytes) % 16 == 0 &&
       ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) &
        15u) == 0) |
      ((p->D * q_bytes) % 16 == 0 &&
       (reinterpret_cast<uintptr_t>(q) & 15u) == 0) << 1;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(
      p->instance, p->cluster,
      dim3(static_cast<unsigned>(p->rows) * p->cluster, p->head_blocks, 1),
      stream, &attr);
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, kKernels[p->instance], q, k, v, static_cast<const int*>(valid),
      o, p->G, p->W, p->D, p->kh, p->valid_stride, p->n_blocks, p->scale,
      flags));
}

}  // extern "C"
