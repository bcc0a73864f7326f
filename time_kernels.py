"""One kernel of the port at its main paths' shapes, to compare two trees
of the port in one call.

    python3 time_kernels.py --kernel {flash,ssd,decode,cckp} [--src DIR]
        [--reps N] [--forward] [--step | --step-only] [--phases]

A harness beside `chip_smoke.py`, outside the port's package.  Imports
`repro_torch` from ``--src`` (default: this checkout's ``src``), so that
one file times another checkout's kernel; run it on each tree in turns
(A, B, B, A) within one call.  Inputs come from seeded generators on the
card; every row holds the kernel against the tree's plain version first.
Prints the library's ptxas report, one JSON line per row and a last line
with the card's name and power limit (``nvidia-smi``); exits 1 when a row
disagrees.

``flash``  bfloat16 flash attention at `chip_smoke.FLASH_SHAPES` and
           `FAMILY_FLASH_SHAPES` (2^-7 relative and absolute): the
           kernel's mean time over ``--reps`` launches after a warm one
           (CUDA events; ``ms_queued`` with the launches queued behind a
           device sleep, so that the device's time is read where the
           host's launch rate would set it), SDPA's time both ways (the
           yardstick, which the port never calls), the bound
           (`flash_work`, `bound_of` at the bf16 rate) and its share.
``ssd``    the SSD scan at `chip_smoke.SSD_SHAPES` in bfloat16 and
           float32 (`chip_smoke.ssd_row`: the float64 recurrence's bars,
           times, bound at the TF32 rate, each kernel's device time in
           one profiled call); ``--forward`` adds mamba2-130m's forward
           (`ssd_forward_row`).
``decode`` flash-decode at `chip_smoke.decode_cases()` through the model's
           entry (`chip_smoke.decode_row`: ``ms``, ``device_ms`` queued,
           ``host_us``, kernels a call, SDPA, plan, bound); ``--step``
           adds gemma3-1b's decode step (`decode_step_row`),
           ``--step-only`` times the step alone.
``cckp``   AMDP's DP (`models_dp`) at `chip_smoke.cckp_cases` (the fleet
           shape at m = 2 and 1, the example's B = 1 grids, the
           4 x 4001 x 301 grid), then serve's and `lm_serve`'s own calls
           (`chip_smoke.cckp_row`: values and every table bitwise, the
           time over ``--reps`` calls, the plain version's, the bound,
           the plan where the tree has one).  The two runs' calls are
           recorded once, by the first tree timed, into
           ``build/cckp_calls.pt``, and replayed from there by the others.
           ``--phases`` instead reads one CTA's phases at the fleet shape
           from ``%globaltimer`` and ``clock64`` stamps in a copy of the
           tree's source (`cckp_phases`).
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CCKP_CALLS = os.path.join(ROOT, "build", "cckp_calls.pt")
STAMP_DIR = os.path.join(ROOT, "build", "stamps")


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
def flash_rows(torch, cs, dev, src, args):
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    build_line("time_flash_build", cs, fa_ops, src)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(device=dev).manual_seed(5)
    failed = []
    for shape in cs.FLASH_SHAPES + cs.FAMILY_FLASH_SHAPES:
        name, B, Sq, Sk, H, KH, D, mask, window = shape
        q, k, v = (torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
                   for s in ((B * H, Sq, D), (B * KH, Sk, D),
                             (B * KH, Sk, D)))
        kw = dict(mask_kind=mask, window=window, group=H // KH)
        with torch.no_grad():
            got = fa_ops.flash_attention_fwd(q, k, v, **kw)
            want = fa_ref.attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ok = torch.allclose(got.float(), want.float(), rtol=2.0 ** -7,
                                atol=2.0 ** -7)
            del got, want
            qq, kk, vv = (t.view(B, t.shape[0] // B, t.shape[1], D)
                          for t in (q, k, v))
            live = (None if mask != "window"
                    else fa_ref.index_mask(mask, Sq, Sk, window, dev))

            def kernel():
                return fa_ops.flash_attention_fwd(q, k, v, **kw)

            def library():
                return sdpa(qq, kk, vv, attn_mask=live,
                            is_causal=mask == "causal", enable_gqa=True)

            ms, ms_queued, library_ms, library_ms_queued = (
                cs.cuda_ms(fn, [()] * args.reps, torch, warm_up=True,
                           ahead=ahead)
                for fn in (kernel, library) for ahead in (False, True))
        nbytes, flops = cs.flash_work(B, Sq, Sk, H, KH, D, mask, window, 2)
        bound_ms, bound_by = cs.bound_of(nbytes, flops, cs.BF16_FLOPS)
        print(json.dumps({"time_flash": dict(
            src=src, shape=name, ok=ok, max_abs_err=err, ms=ms,
            ms_queued=ms_queued, library_ms=library_ms,
            library_ms_queued=library_ms_queued, bound_ms=bound_ms,
            bound_by=bound_by,
            bound_share=bound_ms / ms, tflops=flops / ms * 1e-9)}),
            flush=True)
        del q, k, v, qq, kk, vv
        if not ok:
            failed.append(name)
    return failed


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------
def ssd_forward_row(torch, cs, dev):
    """mamba2-130m's forward at `chip_smoke.py`'s shape (8 x 2048 tokens,
    random weights from its seed, bfloat16): the best of three
    synchronised walls after a warm-up, and in one profiled forward the
    device seconds, the busy share and the SSD kernels' device time."""
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_params, logits_from_h
    cfg = get_config("mamba2_130m")
    params = init_params(cfg, cs.LM_SEED, device=dev)
    tokens = cs.lm_tokens(torch, dev, cfg, cs.SSM_BATCH, cs.SSM_SEQ)

    @torch.inference_mode()
    def run():
        return logits_from_h(params, forward(params, {"tokens": tokens},
                                             cfg, impl="pallas"), cfg)

    run()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    device_s, n_launch, top = cs.profiled(torch, run, keep=("ssd_",))
    ssd_ms = sum(d["ms"] for d in top if "ssd_" in d["name"])
    return dict(wall_s=min(walls), walls_s=walls, device_s=device_s,
                busy_share=device_s / min(walls), launches=n_launch,
                ssd_device_ms=ssd_ms,
                ssd_by_kernel={d["name"]: d["ms"] for d in top
                               if "ssd_" in d["name"]})


def ssd_rows(torch, cs, dev, src, args):
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    build_line("time_ssd_build", cs, ssd_ops, src)
    failed = []
    for shape, Bb, S, H in cs.SSD_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[-1]
            with torch.no_grad():
                row, errs, ok, per_kernel, _cum = cs.ssd_row(
                    torch, ssd_ops, ssd_ref, dev, Bb, S, H, dtype,
                    reps=args.reps)
            print(json.dumps({"time_ssd": dict(
                src=src, shape=shape, dtype=dname, ok=ok, errors=errs,
                device_us_by_kernel={d["name"]: d["ms"] * 1e3
                                     for d in per_kernel}, **row)}),
                flush=True)
            if not ok:
                failed.append((shape, dname))
    if args.forward:
        print(json.dumps({"time_ssd_forward": dict(
            src=src, **ssd_forward_row(torch, cs, dev))}), flush=True)
    return failed


# ---------------------------------------------------------------------------
# flash-decode
# ---------------------------------------------------------------------------
def decode_step_row(torch, cs, dev, steps=16):
    """gemma3-1b at full width from `chip_smoke`'s seed, bfloat16: a
    prefill of `GEN_BATCH` x `GEN_PROMPT` tokens, then ``steps``
    synchronised `decode_step` calls (their walls, and the host's mean
    microseconds inside the flash-decode entry), and one more step under
    `torch.profiler` (device seconds, kernel launches, the flash-decode
    kernels' calls and device time)."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, layers, prefill
    cfg = get_config("gemma3_1b")
    entry = layers.decode_attention
    inside = [0.0, 0]                   # host seconds in the entry, calls

    def timed_entry(*a, **k):
        t0 = time.perf_counter()
        out = entry(*a, **k)
        inside[0] += time.perf_counter() - t0
        inside[1] += 1
        return out

    params = init_params(cfg, cs.LM_SEED, device=dev)
    max_seq = cs.GEN_PROMPT + steps + 1
    tokens = cs.lm_tokens(torch, dev, cfg, cs.GEN_BATCH, max_seq)
    walls = []
    with torch.inference_mode():
        cache, _lg = prefill(params, {"tokens": tokens[:, :cs.GEN_PROMPT]},
                             cfg, max_seq)
        layers.decode_attention = timed_entry
        for t in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _lg, cache = decode_step(
                params, tokens[:, cs.GEN_PROMPT + t:cs.GEN_PROMPT + t + 1],
                cache, cfg)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        layers.decode_attention = entry
        device_s, n_launch, top = cs.profiled(torch, lambda: decode_step(
            params, tokens[:, -1:], cache, cfg), keep=("decode_",))
    decode = [d for d in top if "decode_" in d["name"]]
    return dict(walls_s=walls, median_s=sorted(walls)[steps // 2],
                min_s=min(walls), device_s=device_s, launches=n_launch,
                decode_kernels=decode,
                decode_device_ms=sum(d["ms"] for d in decode),
                entry_host_us=inside[0] / max(inside[1], 1) * 1e6,
                entry_calls=inside[1])


def decode_rows(torch, cs, dev, src, args):
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import ref as da_ref
    build_line("time_decode_build", cs, da_ops, src)
    g = torch.Generator(device=dev).manual_seed(23)
    failed = []
    for case in [] if args.step_only else cs.decode_cases():
        with torch.no_grad():
            row, ok = cs.decode_row(torch, da_ops, da_ref, dev, g, case,
                                    reps=args.reps)
        print(json.dumps({"time_decode": dict(
            src=src, shape=case[0], dtype=case[7], kv_dtype=case[8], ok=ok,
            **row)}), flush=True)
        if not ok:
            failed.append((case[0], case[7]))
    if args.step or args.step_only:
        print(json.dumps({"time_decode_step": dict(
            src=src, **decode_step_row(torch, cs, dev))}), flush=True)
    return failed


# ---------------------------------------------------------------------------
# AMDP's CCKP DP
# ---------------------------------------------------------------------------
def cckp_calls(torch, cs, dev):
    """Serve's and `lm_serve`'s own DP calls, recorded by the smoke's
    `phase_serve` and `phase_lm_serve` on the first use and kept in
    `CCKP_CALLS` for the other trees of the same call."""
    if os.path.exists(CCKP_CALLS):
        saved = torch.load(CCKP_CALLS, map_location=dev)
    else:
        saved = dict(serve=cs.phase_serve(torch, dev)[2],
                     lm_serve=cs.phase_lm_serve(torch, dev)[1])
        os.makedirs(os.path.dirname(CCKP_CALLS), exist_ok=True)
        torch.save(saved, CCKP_CALLS)
    return saved


def cckp_rows(torch, cs, dev, src, args):
    from repro_torch.kernels.cckp_dp import ops as cckp_ops
    build_line("time_cckp_build", cs, cckp_ops, src)
    if args.phases:
        y, p, a = cs.cckp_case(torch, dev)
        for m in (2, 1):
            print(json.dumps({"time_cckp_phases": dict(
                src=src, models=m, **cckp_phases(
                    torch, dev, cckp_ops, y, p[:, :m].contiguous(),
                    a[:, :m].contiguous(), cs.DP_K1))}), flush=True)
        return []
    for name, y, p, a, n_steps in cs.cckp_cases(torch, dev):
        cs.cckp_row(torch, dev, name, y, p, a, n_steps, args.reps, 1,
                    phase="time_cckp", src=src)
        del y
    saved = cckp_calls(torch, cs, dev)
    for run in ("serve", "lm_serve"):
        cs.cckp_replay(torch, dev, saved[run], f"time_cckp_{run}_calls",
                       reps=args.reps, src=src)
    return []


# The stamps of one CTA: %globaltimer at its start and end, clock64 at
# its start and end, its SM, then clock64 sums of its phases as thread 0
# sees them, and the lanes it walked.
STAMP_FIELDS = ("ns_start", "ns_end", "clk_start", "clk_end", "smid",
                "load", "walk", "barrier", "copy", "store", "lanes")
STAMP_CTAS = 16384
# (inserted inside the source's unnamed namespace: the C entries leave it)
STAMP_DECL = r"""
__device__ unsigned long long cckp_stamp_buf[16384 * 11];
__device__ __forceinline__ unsigned long long stamp_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void stamp_write(
    unsigned long long ns0, unsigned long long clk0, unsigned long long load,
    unsigned long long walk, unsigned long long bar, unsigned long long copy,
    unsigned long long store, unsigned long long lanes) {
  if (blockIdx.x >= 16384) return;
  unsigned smid;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
  unsigned long long* r = cckp_stamp_buf + 11ull * blockIdx.x;
  r[0] = ns0; r[1] = stamp_ns(); r[2] = clk0; r[3] = clock64(); r[4] = smid;
  r[5] = load; r[6] = walk; r[7] = bar; r[8] = copy; r[9] = store;
  r[10] = lanes;
}
}  // namespace
extern "C" int cckp_stamps_read(unsigned long long* host, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      host, cckp_stamp_buf, sizeof(unsigned long long) * n));
}
extern "C" int cckp_stamps_clear() {
  void* p = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&p, cckp_stamp_buf);
  if (err == cudaSuccess) err = cudaMemset(p, 0, sizeof(cckp_stamp_buf));
  return static_cast<int>(err);
}
namespace {
"""
# The staged design (one CTA a lane, each row block staged in place, the
# source before the ping-pong one): the stamps go in before and after
# these anchors of its source, each found once
STAGED_STAMPS = (
    ("constexpr float kNeg = -1e30f;\n", "", STAMP_DECL),
    ("  const int tid = threadIdx.x;\n", "",
     "  const unsigned long long sn0 = stamp_ns(), sc0 = clock64();\n"
     "  unsigned long long sc_mark = sc0, s_load = 0, s_walk = 0, "
     "s_bar = 0, s_copy = 0, s_store = 0, s_x;\n"),
    ("    __syncthreads();                     // the grid holds the "
     "model's input\n", "",
     "    s_x = clock64();\n"
     "    if (i == 0) s_load += s_x - sc_mark; else s_bar += s_x - sc_mark;\n"
     "    sc_mark = s_x;\n"),
    ("      __syncthreads();                   // every read of these rows "
     "done\n",
     "      s_x = clock64(); s_walk += s_x - sc_mark; sc_mark = s_x;\n",
     "      s_x = clock64(); s_bar += s_x - sc_mark; sc_mark = s_x;\n"),
    ("      __syncthreads();                   // the stage is free again\n",
     "", "      s_x = clock64(); s_copy += s_x - sc_mark; sc_mark = s_x;\n"),
    ("    for (int e = tid; e < cells; e += kThreads) dst[e] = grid[e];\n"
     "  }\n", "",
     "  s_x = clock64(); s_store = s_x - sc_mark;\n"
     "  if (tid == 0) stamp_write(sn0, sc0, s_load, s_walk, s_bar, s_copy, "
     "s_store, 1);\n"),
)


def stamped_source(text: str) -> str:
    """The tree's CCKP source with its stamps on: a source that carries
    its own (under ``CCKP_STAMPS``) takes `STAMP_DECL` at its
    ``// CCKP_STAMP_DECL`` line; the staged design takes them at
    `STAGED_STAMPS`' anchors."""
    if "CCKP_STAMPS" in text:
        return "#define CCKP_STAMPS 1\n" + text.replace(
            "// CCKP_STAMP_DECL\n", STAMP_DECL, 1)
    for at, before, after in STAGED_STAMPS:
        if text.count(at) != 1:
            raise RuntimeError(f"stamp anchor not found once: {at!r}")
        text = text.replace(at, before + at + after, 1)
    return text


def cckp_phases(torch, dev, cckp_ops, y, p, a, n_steps, reps=3):
    """One `models_dp` call at a stamped copy of the tree's source: the
    tree's wrapper launches it as usual (its own library swapped for the
    stamped one), the last of ``reps`` calls is read.  Returns the
    kernel's time, each phase's mean microseconds a CTA (thread 0's view;
    clock64 converted by each CTA's own globaltimer span), the CTAs
    resident on one SM at once (the most whose spans overlap), CTAs and
    lanes a CTA."""
    import numpy as np

    from repro_torch.kernels import _build
    lib_src = cckp_ops.LIBRARY.src
    text = stamped_source(lib_src.read_text())
    digest = hashlib.sha256(text.encode()).hexdigest()[:16]
    os.makedirs(STAMP_DIR, exist_ok=True)
    cu = os.path.join(STAMP_DIR, f"cckp_stamped_{digest}.cu")
    so = os.path.join(STAMP_DIR, f"libcckp_stamped_{digest}.so")
    with open(cu, "w") as f:
        f.write(text)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                   check=True, capture_output=True, text=True, timeout=600)
    lib = ctypes.CDLL(so)
    cckp_ops.LIBRARY._declare(lib)
    saved = cckp_ops.LIBRARY._lib
    cckp_ops.LIBRARY._lib = lib
    try:
        for _ in range(reps):
            if lib.cckp_stamps_clear() != 0:
                raise RuntimeError("cckp_stamps_clear failed")
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            cckp_ops.models_dp(y, p, a, n_steps)
            stop.record()
            torch.cuda.synchronize()
    finally:
        cckp_ops.LIBRARY._lib = saved
    n = len(STAMP_FIELDS)
    buf = (ctypes.c_ulonglong * (STAMP_CTAS * n))()
    if lib.cckp_stamps_read(buf, STAMP_CTAS * n) != 0:
        raise RuntimeError("cckp_stamps_read failed")
    rec = np.frombuffer(buf, dtype=np.uint64).reshape(STAMP_CTAS, n)
    rec = rec[rec[:, 1] > 0].astype(np.float64)
    f = {name: rec[:, i] for i, name in enumerate(STAMP_FIELDS)}
    ns_per_clk = (f["ns_end"] - f["ns_start"]) / np.maximum(
        f["clk_end"] - f["clk_start"], 1)
    us = {name: float(np.mean(f[name] * ns_per_clk) * 1e-3)
          for name in ("load", "walk", "barrier", "copy", "store")}
    resident = 0
    for sm in np.unique(f["smid"]):
        on = f["smid"] == sm
        ev = sorted([(t, 1) for t in f["ns_start"][on]]
                    + [(t, -1) for t in f["ns_end"][on]],
                    key=lambda e: (e[0], e[1]))
        live = 0
        for _t, d in ev:
            live += d
            resident = max(resident, live)
    span = f["ns_end"] - f["ns_start"]
    return dict(ms=start.elapsed_time(stop), ctas=int(len(rec)),
                lanes_per_cta=float(np.mean(f["lanes"])),
                cta_us=float(np.mean(span) * 1e-3),
                phase_us=us, ctas_resident_per_sm=resident,
                clock_ghz=float(np.mean(1.0 / ns_per_clk)))


# ---------------------------------------------------------------------------
def build_line(key, cs, ops, src):
    _path, log = ops.LIBRARY.build()
    print(json.dumps({key: {"src": src,
                            "instances": cs.ptxas_instances(log)}}),
          flush=True)


ROWS = dict(flash=flash_rows, ssd=ssd_rows, decode=decode_rows,
            cckp=cckp_rows)
REPS = dict(flash=20, ssd=20, decode=50, cckp=5)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", required=True, choices=sorted(ROWS))
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--reps", type=int, default=None,
                    help="timed calls a row (flash and ssd 20, decode 50, "
                         "cckp 5)")
    ap.add_argument("--forward", action="store_true",
                    help="ssd: also time mamba2-130m's forward")
    ap.add_argument("--step", action="store_true",
                    help="decode: also time gemma3-1b's decode step")
    ap.add_argument("--step-only", action="store_true",
                    help="decode: time gemma3-1b's decode step alone")
    ap.add_argument("--phases", action="store_true",
                    help="cckp: one CTA's phases from stamps, no rows")
    args = ap.parse_args(argv)
    if args.reps is None:
        args.reps = REPS[args.kernel]
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("time_kernels times the card: no CUDA card")
    import chip_smoke as cs
    dev = torch.device("cuda", 0)
    failed = ROWS[args.kernel](torch, cs, dev, src, args)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    if failed:
        print(f"time_kernels: {args.kernel} disagrees with the plain "
              f"version at {failed}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
