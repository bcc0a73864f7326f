#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure exits non-zero:

  1. env      torch / CUDA / nvcc versions and the card (nvidia-smi).
  2. build    compiles every kernel source under
              `src/repro_torch/kernels/*/csrc` (one nvcc each, all at once)
              and prints what ptxas reports (registers, shared memory,
              spills) for each.
  3. kernels  each kernel against its plain PyTorch version at the shapes
              its main path gives it: the simplex kernels at 16384 lanes,
              R = 14 rows, C0 = 38 columns (random, masked, degenerate and
              Bland lanes; integer outputs exact, floats to rtol/atol
              1e-12); the CCKP kernel on 16384 grids of 1201 x 13 cells,
              p and accuracies from the fleet's profiles, the grids from a
              real first-model pass (bitwise); the flash attention kernel
              at the LM path's shapes (paper_edge's ES model: 32 jobs x 64
              tokens, 8 heads on 4 KV heads, head_dim 64, causal;
              gemma3-1b: 2 x 2048 tokens, 4 heads on 1, head_dim 256,
              window 512 and causal) and a ragged unmasked one, each in
              bfloat16 and float32 (float32 to 1e-5, bfloat16 to 2^-7
              relative and absolute).  Kernel and plain times (CUDA
              events) beside each bound; for flash attention also the
              time of `scaled_dot_product_attention` on the same inputs
              (the library column, never on the port's path).
  4. rollout  the tensor engine's path: `EngineParams.from_fleet` ->
              `init_state` -> `rollout` of a 16384-device fleet for 8
              periods, once per LP method, with every kernel's launch
              counter set to 0 just before and read just after; the two
              methods must agree (integer metrics exact, float metrics to
              1e-9) with no unsolved lane.
  5. front    `repro_torch.api.solve(fp, policy="auto")` on a 16384-device
              `FleetProblem`, half identical-job rows, half heterogeneous
              rows: per-solver device counts, seconds, launches per kernel;
              AMR^2 rows within 2T, AMDP rows within T, and the first 256
              rows equal to the same solve on the CPU.
  6. serve    the host `FleetEngine` (`policy="auto"`) on 16384 devices of
              one job class for 8 periods, counters set to 0 before and
              read after: per period the AMDP and AMR^2 device counts
              (both > 0), backpressured devices and seconds; launches per
              kernel and peak memory over the run.  The engine's solves
              are strict: an unsolved lane raises.
  7. lm_forward  gemma3-1b at full width (26 layers, d 1152, GQA 4:1 at
              head_dim 256, vocabulary 262144): `init_params` on the card
              from a seed, 2 requests of 2048 `TokenPipeline` tokens,
              `forward` + `logits_from_h` in bfloat16 with the flash
              launch counter set to 0 just before and read just after (26
              per forward), tokens/s and peak memory; then the same
              forward with the plain dense attention (`attn_impl="dense"`)
              on the card, in bfloat16 and in float32, against the flash
              forward (tolerances at `LM_BF16_*` and `LM_F32_ATOL`).
  8. lm_serve `repro_torch.launch.serve.main` on the paper_edge ladder: 6
              periods of 24 jobs, an ES outage in period 2, every counter
              set to 0 before and read after; per period the policy,
              accuracy, predicted and wall makespan, violation and the
              replanned flag; no dropped job, period 2 replanned, the flash
              kernel launched.
  9. parity   the card-marked tests (`pytest -m gpu tests/test_torch_cuda.py`,
              in a child process): each kernel against its plain version,
              a 32-device rollout, a 64-device `FleetEngine` run and a
              2-layer LM forward on the card against the same runs on the
              CPU.
 10. timing   the 16384-device rollout again, in turns (tableau, revised,
              revised, tableau), for steady-state devices/s.
 11. profile  one rollout per LP method and one serve run under
              `torch.profiler`: device time by kernel name and the device's
              busy share of the wall time; one more serve run under
              cProfile: host seconds by pipeline stage.  (Phase 7 profiles
              one gemma3-1b forward the same way.)

Then the nvidia-smi line, the kernels line and, last, the result line.
Exits non-zero without a CUDA card, and when the repository's `src/` is
not beside this file.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data sheet (NVIDIA): HBM3 bandwidth, FP64 (non-tensor) peak, and
# the dense BF16 tensor rate used as the ES tier's FLOP/s in the fleet's
# roofline profiles
HBM_BYTES_S = 3.35e12
FP64_FLOPS = 34e12
FP32_FLOPS = 67e12
ES_PEAK_FLOPS = 989e12
D_FLEET, PERIODS, R, N_JOBS = 16384, 8, 14, 12
C0 = N_JOBS * 3 + 2
RTOL = ATOL = 1e-12
# AMDP's largest grid on the serve path: T = 1.2 s at 1 ms steps (T1 =
# 1200 + 1) and 12 local jobs (K1 = 12 + 1: a device in outage or in the
# ES-disabled replan offloads none)
T_BUDGET, DP_T1, DP_K1 = 1.2, 1201, 13
N_SERVERS = D_FLEET // 16
BF16_FLOPS = ES_PEAK_FLOPS
# flash attention at the LM path's shapes:
# (name, batch, Sq, Sk, heads, kv heads, head_dim, mask, window)
FLASH_SHAPES = (
    ("paper_edge_es", 32, 64, 64, 8, 4, 64, "causal", 0),
    ("gemma3_local", 2, 2048, 2048, 4, 1, 256, "window", 512),
    ("gemma3_global", 2, 2048, 2048, 4, 1, 256, "causal", 0),
    ("ragged_none", 3, 1000, 777, 4, 2, 128, "none", 0),
)
FLASH_LINE = ("gemma3_local", "bfloat16")    # the kernels line's shape
FLASH_SRC = ("src/repro_torch/kernels/flash_attention/csrc/"
             "flash_attention.cu")
FLASH_TPU = "src/repro/kernels/flash_attention/flash_attention.py:86"
# the gemma3-1b forward: 2 requests of 2048 tokens
LM_BATCH, LM_SEQ, LM_SEED = 2, 2048, 0


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True,
                          timeout=120).stdout.strip()


def bound_of(nbytes, flops, peak=FP64_FLOPS):
    """(bound_ms, bound_by): the larger of the memory time and the
    operations' time at ``peak`` FLOP/s of one call."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def cuda_ms(fn, inputs, torch) -> float:
    """Mean milliseconds of ``fn(*args)`` over ``inputs`` (one argument
    tuple per call, so in-place kernels never see their own output)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for args in inputs:
        fn(*args)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / len(inputs)


# --------------------------------------------------------------------------
# phase 3 inputs
# --------------------------------------------------------------------------
def tableau_case(torch, dev, g):
    """Random (D, R+1, C0+1) tableaus, 80% of lanes active; masked lanes
    carry out-of-range pivot coordinates."""
    D = D_FLEET
    tabs = torch.randn((D, R + 1, C0 + 1), generator=g, dtype=torch.float64)
    r = torch.randint(0, R, (D,), generator=g, dtype=torch.int32)
    j = torch.randint(0, C0, (D,), generator=g, dtype=torch.int32)
    mask = torch.rand((D,), generator=g) < 0.8
    lanes = torch.arange(D)
    piv = tabs[lanes, r.long(), j.long()]
    tabs[lanes, r.long(), j.long()] = piv + torch.sign(piv) * 0.5
    r[~mask] = 99
    return [t.to(dev) for t in (tabs, r, j, mask)]


def reduced_case(torch, dev, g):
    """Random revised-simplex lanes: a quarter degenerate (zero basic
    levels), a third on Bland's rule, some masked or not allowed to
    pivot."""
    D = D_FLEET
    A = torch.randn((D, R, C0), generator=g, dtype=torch.float64)
    c = torch.randn((D, C0), generator=g, dtype=torch.float64)
    Binv = torch.eye(R, dtype=torch.float64) + 0.3 * torch.randn(
        (D, R, R), generator=g, dtype=torch.float64)
    xB = 2.0 * torch.rand((D, R), generator=g, dtype=torch.float64)
    lanes = torch.arange(D)
    xB[(lanes % 4 == 1)[:, None] & (torch.arange(R) % 2 == 0)[None, :]] = 0.0
    basis = torch.argsort(torch.rand((D, C0 + R), generator=g),
                          dim=1)[:, :R].to(torch.int32).contiguous()
    use_bland = lanes % 3 == 0
    may_pivot = torch.rand((D,), generator=g) < 0.8
    lane_ok = torch.rand((D,), generator=g) < 0.9
    return [t.to(dev) for t in (A, c, Binv, xB, basis, use_bland, may_pivot,
                                lane_ok)]


def phase_kernels(torch, ops, ref, dev):
    g = torch.Generator().manual_seed(7)
    reps = 10
    rows = {}

    # ---- simplex_pivot ---------------------------------------------------
    tabs, r, j, mask = tableau_case(torch, dev, g)
    want = ref.pivot_update_ref(tabs, r, j, mask)
    got = tabs.clone()
    ops.pivot_update(got, r, j, mask)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check(torch.allclose(got, want, rtol=RTOL, atol=ATOL),
          f"simplex_pivot disagrees with its plain version (max {err})")
    copies = [(tabs.clone(), r, j, mask) for _ in range(reps)]
    ms = cuda_ms(ops.pivot_update, copies, torch)
    del copies
    plain_ms = cuda_ms(ref.pivot_update_ref, [(tabs, r, j, mask)] * 3, torch)
    # every lane reads its mask byte; an active lane also reads r, j and
    # its tableau and writes the tableau back
    active = int(mask.sum())
    lane_bytes = (R + 1) * (C0 + 1) * 8
    nbytes = D_FLEET + active * (2 * lane_bytes + 4 + 4)
    flops = active * ((R + 1) * (C0 + 1) * 2 + (C0 + 1))
    rows["simplex_pivot"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                 bytes=nbytes, flops=flops)

    # ---- reduced_pivot ---------------------------------------------------
    case = reduced_case(torch, dev, g)
    want = ref.reduced_pivot_ref(*case, art_cost=1.0, tol=1e-7)
    got = [t.clone() for t in case]
    flags = ops.reduced_pivot(*got, art_cost=1.0, tol=1e-7)
    torch.cuda.synchronize()
    err = max((got[2] - want[0]).abs().max().item(),
              (got[3] - want[1]).abs().max().item())
    check(torch.allclose(got[2], want[0], rtol=RTOL, atol=ATOL)
          and torch.allclose(got[3], want[1], rtol=RTOL, atol=ATOL),
          f"reduced_pivot factor disagrees with its plain version ({err})")
    check(torch.equal(got[4], want[2]), "reduced_pivot basis disagrees")
    for name, a, b in zip(("has_enter", "unbounded", "degenerate"), flags,
                          want[3:]):
        check(torch.equal(a, b), f"reduced_pivot flag {name} disagrees")
    has_enter, unbounded, degen = want[3:]
    check(bool(degen[has_enter].any()) and bool((~has_enter).any())
          and bool(case[5][has_enter].any()),
          "reduced_pivot inputs miss degenerate, Bland or no-entry lanes")
    pivoted = int((case[6] & has_enter & ~unbounded).sum())
    copies = [tuple(t.clone() if k in (2, 3, 4) else t
                    for k, t in enumerate(case)) for _ in range(reps)]
    ms = cuda_ms(lambda *a: ops.reduced_pivot(*a, art_cost=1.0, tol=1e-7),
                 copies, torch)
    del copies
    plain_ms = cuda_ms(
        lambda *a: ref.reduced_pivot_ref(*a, art_cost=1.0, tol=1e-7),
        [tuple(case)] * 3, torch)
    nbytes, flops = reduced_pivot_work(torch, ref, case, want)
    rows["reduced_pivot"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                 bytes=nbytes, flops=flops)
    for name, row in rows.items():
        row["bound_ms"], row["bound_by"] = bound_of(row["bytes"],
                                                         row["flops"])
        emit("kernels", kernel=name, **row)
    rows["cckp_model_dp"] = phase_cckp_kernel(torch, dev)
    return rows


def cckp_case(torch, dev):
    """AMDP's second-model step as the serve path meets it: per-lane p and
    accuracies of the fleet's class-512 profiles (p = ceil(p_ed / 1 ms)),
    and grids that came out of the first model's pass."""
    import numpy as np

    from repro_torch.core.amdp import _integerize
    from repro_torch.kernels.cckp_dp import ops as cckp_ops
    from repro_torch.kernels.cckp_dp.ref import NEG
    from repro_torch.serving.fleet import make_fleet
    specs = make_fleet(D_FLEET, classes=(512,), seed=11, horizon=1,
                       es_peak_flops=ES_PEAK_FLOPS, es_hbm_bw=HBM_BYTES_S)
    p_ed = np.stack([d.profile.p_ed[0] for d in specs])         # (D, 2)
    p_int, _ = _integerize(p_ed, np.full(D_FLEET, T_BUDGET), 1e-3)
    acc = np.stack([d.profile.acc[:2] for d in specs])
    p = torch.as_tensor(p_int.astype(np.int32), device=dev)
    a = torch.as_tensor(acc.astype(np.float32), device=dev)
    y0 = torch.full((D_FLEET, DP_T1, DP_K1), NEG, dtype=torch.float32,
                    device=dev)
    y0[:, :, 0] = 0.0
    y1, _ = cckp_ops.model_dp(y0, p[:, 0].contiguous(),
                              a[:, 0].contiguous(), DP_K1)
    del y0
    return y1, p[:, 1].contiguous(), a[:, 1].contiguous()


def cckp_work(torch, p, T1, K1, n_steps):
    """Bytes and float32 operations one `cckp_model_dp` call needs: each
    cell reads its grid value and writes its value and count (12 bytes);
    cell (t, k) of lane b evaluates the q whose source cell lies inside
    the grid, min(k + 1, c) of them with c = min(t // p_b + 1, n_steps),
    one multiply, one add and one compare each.  Summed over k < K1 that
    is c (c + 1) / 2 + c (K1 - c) per (b, t)."""
    t = torch.arange(T1, device=p.device, dtype=torch.int64)
    p64 = p.to(torch.int64)[:, None]
    c = torch.where(p64 > 0, t[None, :] // p64.clamp_min(1) + 1,
                    torch.full_like(p64, n_steps)).clamp_max(
                        min(n_steps, K1))                      # (B, T1)
    n_q = (c * (c + 1) // 2 + c * (K1 - c)).sum()
    return 12 * p.shape[0] * T1 * K1, 3 * int(n_q)


def phase_cckp_kernel(torch, dev):
    from repro_torch.kernels.cckp_dp import ops as cckp_ops
    from repro_torch.kernels.cckp_dp import ref as cckp_ref
    y, p, a = cckp_case(torch, dev)
    got_y, got_q = cckp_ops.model_dp(y, p, a, DP_K1)
    want_y, want_q = cckp_ref.cckp_model_dp_ref(y, p, a, DP_K1)
    torch.cuda.synchronize()
    err = (got_y - want_y).abs().max().item()
    check(torch.equal(got_y, want_y) and torch.equal(got_q, want_q),
          f"cckp_model_dp disagrees with its plain version (max {err})")
    check(bool((got_q > 0).any()) and bool((got_y > cckp_ref.NEG).any()),
          "cckp_model_dp inputs give no non-trivial cell")
    del got_y, got_q, want_y, want_q
    ms = cuda_ms(lambda: cckp_ops.model_dp(y, p, a, DP_K1), [()] * 5,
                 torch)
    plain_ms = cuda_ms(
        lambda: cckp_ref.cckp_model_dp_ref(y, p, a, DP_K1), [()] * 2, torch)
    nbytes, flops = cckp_work(torch, p, DP_T1, DP_K1, DP_K1)
    bound_ms, bound_by = bound_of(nbytes, flops, FP32_FLOPS)
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bytes=nbytes,
               flops=flops, bound_ms=bound_ms, bound_by=bound_by,
               shape=[D_FLEET, DP_T1, DP_K1])
    emit("kernels", kernel="cckp_model_dp", **row)
    return row


# --------------------------------------------------------------------------
# flash attention
# --------------------------------------------------------------------------
def live_pairs(Sq, Sk, mask, window):
    """(query, key) pairs the index-derived mask leaves live."""
    import numpy as np
    i = np.arange(Sq)
    if mask == "none":
        return Sq * Sk
    hi = np.minimum(i, Sk - 1)
    lo = np.maximum(0, i - window + 1) if mask == "window" else 0
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_work(B, Sq, Sk, H, KH, D, mask, window, itemsize):
    """Bytes and operations one call needs: q, k and v read once and o
    written once; 4 D operations (q.k and p.v, a multiply and an add
    each) per live (query, key) pair of each of the B H q-heads."""
    nbytes = itemsize * D * (2 * B * H * Sq + 2 * B * KH * Sk)
    return nbytes, 4 * D * B * H * live_pairs(Sq, Sk, mask, window)


def phase_flash_kernel(torch, dev):
    """Flash attention against its plain version at every shape of
    `FLASH_SHAPES`, in bfloat16 and float32, with kernel, plain and
    `scaled_dot_product_attention` times.  Returns the rows by (shape,
    dtype)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(device=dev).manual_seed(5)
    rows = {}
    for name, B, Sq, Sk, H, KH, D, mask, window in FLASH_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[-1]
            q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
                       for shape in ((B * H, Sq, D), (B * KH, Sk, D),
                                     (B * KH, Sk, D)))
            kw = dict(mask_kind=mask, window=window, group=H // KH)
            got = fa_ops.flash_attention_fwd(q, k, v, **kw)
            want = fa_ref.attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            rtol, atol = ((0.0, 1e-5) if dtype == torch.float32
                          else (2.0 ** -7, 2.0 ** -7))
            check(torch.allclose(got.float(), want.float(), rtol=rtol,
                                 atol=atol),
                  f"flash_attention_fwd {name} {dname} disagrees with its "
                  f"plain version (max {err})")
            del got, want
            ms = cuda_ms(lambda: fa_ops.flash_attention_fwd(q, k, v, **kw),
                         [()] * 10, torch)
            plain_ms = cuda_ms(lambda: fa_ref.attention_ref(q, k, v, **kw),
                               [()] * 3, torch)
            # the library's call on the same inputs: (B, H, S, D) views,
            # KV heads shared by enable_gqa, the mask as a boolean tensor
            qq, kk, vv = (t.view(B, t.shape[0] // B, t.shape[1], D)
                          for t in (q, k, v))
            live = (None if mask != "window"
                    else fa_ref.index_mask(mask, Sq, Sk, window, dev))

            def library():
                return sdpa(qq, kk, vv, attn_mask=live,
                            is_causal=mask == "causal", enable_gqa=True)

            lib_err = (library().reshape(q.shape).float()
                       - fa_ref.attention_ref(q, k, v, **kw).float()
                       ).abs().max().item()
            library_ms = cuda_ms(library, [()] * 10, torch)
            nbytes, flops = flash_work(B, Sq, Sk, H, KH, D, mask, window,
                                       q.element_size())
            bound_ms, bound_by = bound_of(
                nbytes, flops,
                BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS)
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       library_ms=library_ms, library_max_abs_err=lib_err,
                       bytes=nbytes, flops=flops, bound_ms=bound_ms,
                       bound_by=bound_by)
            emit("kernels", kernel="flash_attention_fwd", shape=name,
                 dtype=dname, dims=dict(B=B, Sq=Sq, Sk=Sk, H=H, KH=KH, D=D,
                                        mask=mask, window=window), **row)
            rows[(name, dname)] = row
            del q, k, v, qq, kk, vv
    return rows


def reduced_pivot_work(torch, ref, case, want):
    """Bytes and FP64 operations one `reduced_pivot` call needs on these
    inputs, lane by lane:

    * every lane reads `lane_ok`, its factor `Binv`, `xB` and `basis`,
      and writes its three flags;
    * a lane with `lane_ok` False enters no column: its flags come from the
      ratio test on column 0 alone (R values of A, one FTRAN);
    * a lane with `lane_ok` True prices the columns that decide its
      entering index — all C0 under Dantzig or when none enters, columns
      0..j under Bland — reading them from A and c, plus c at its basic
      labels;
    * a lane that enters a column reads `use_bland`, and `may_pivot` too
      when its ratio test is bounded;
    * a lane that pivots writes `Binv`, `xB` and one basis label."""
    A, c, Binv, xB, basis, use_bland, may_pivot, lane_ok = case
    has_enter, unbounded = want[3], want[4]
    D = A.shape[0]
    rc = ref.price_reduced_ref(A, c, Binv, basis, 1.0)
    enter = (rc < -1e-7) & lane_ok[:, None]
    j_bland = enter.to(torch.uint8).argmax(dim=1)
    cols = torch.where(use_bland & has_enter, j_bland + 1, C0)
    cols = torch.where(lane_ok, cols, 0)
    col_idx = torch.arange(C0, device=A.device)
    basic = (basis[:, :, None] == col_idx) & lane_ok[:, None, None]
    c_read = (col_idx[None, :] < cols[:, None]) | basic.any(dim=1)
    n_cols = int(cols.sum())
    n_ok = int(lane_ok.sum())
    pivoted = int((may_pivot & has_enter & ~unbounded).sum())
    nbytes = (D * (1 + R * R * 8 + R * 8 + R * 4 + 3)
              + (D - n_ok) * R * 8                      # column 0
              + n_cols * R * 8 + int(c_read.sum()) * 8  # priced columns
              + int(has_enter.sum())                    # use_bland
              + int((has_enter & ~unbounded).sum())     # may_pivot
              + pivoted * (R * R * 8 + R * 8 + 4))
    flops = (n_ok * 2 * R * R + n_cols * (2 * R + 1)    # BTRAN, pricing
             + D * (2 * R * R + R)                      # FTRAN, ratios
             + pivoted * 2 * R * (R + 1))               # eta update
    return nbytes, flops


# --------------------------------------------------------------------------
# phases 4 to 7: the engine
# --------------------------------------------------------------------------
def build_params(dev):
    """The 16384-device fleet's params, one per LP method, from one fleet
    and one replayed arrival trace."""
    from repro_torch.api import engine as E
    from repro_torch.serving.fleet import make_fleet
    from repro_torch.serving.queue import RequestQueue
    devices = make_fleet(D_FLEET, seed=7, horizon=PERIODS,
                         es_peak_flops=ES_PEAK_FLOPS, es_hbm_bw=HBM_BYTES_S)
    queue = RequestQueue(D_FLEET, (128, 512, 1024), rate=10.0,
                         batch_max=N_JOBS, seed=7)
    return {m: E.EngineParams.from_fleet(
        devices, queue, T=1.2, n_servers=D_FLEET // 16, horizon=PERIODS,
        lp_method=m, device=dev) for m in ("tableau", "revised")}


def compare_metrics(E, torch, a, b, what):
    for f in E.METRIC_FIELDS:
        x, y = getattr(a, f).cpu(), getattr(b, f).cpu()
        check(tuple(x.shape) == (PERIODS,), f"{what}: {f} shape {x.shape}")
        if x.is_floating_point():
            check(bool(torch.isfinite(x).all()), f"{what}: {f} not finite")
            d = (x - y).abs().max().item()
            check(d <= 1e-9, f"{what}: {f} differs by {d}")
        else:
            check(torch.equal(x, y), f"{what}: {f} {x.tolist()} vs "
                                     f"{y.tolist()}")


def phase_rollout(torch, ops, dev, params):
    from repro_torch.api import engine as E
    counters = {"tableau": ("simplex_pivot", ops.pivot_update),
                "revised": ("reduced_pivot", ops.reduced_pivot)}
    out, launches = {}, {}
    for method, (kname, counter) in counters.items():
        state = E.init_state(params[method], device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        _final, metrics = E.rollout(state, params[method], PERIODS,
                                    device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches[kname] = counter.launches
        check(counter.launches > 0, f"{kname} never launched on the "
                                    f"{method} path")
        n_unsolved = int(metrics.n_unsolved.sum())
        check(n_unsolved == 0, f"{method}: {n_unsolved} unsolved lanes")
        out[method] = metrics
        emit("rollout", lp_method=method, devices=D_FLEET, periods=PERIODS,
             seconds=seconds, devices_per_s=D_FLEET * PERIODS / seconds,
             peak_mem_bytes=torch.cuda.max_memory_allocated(),
             launches={kname: counter.launches},
             launches_per_period=counter.launches / PERIODS,
             n_jobs=int(metrics.n_jobs.sum()),
             n_backpressured=int(metrics.n_backpressured.sum()),
             mean_job_accuracy=float(metrics.mean_job_accuracy.mean()))
    compare_metrics(E, torch, out["revised"], out["tableau"],
                    "revised vs tableau")
    return launches


def kernel_launches():
    """The launch counters of every kernel, by kernel name."""
    from repro_torch.kernels.cckp_dp import ops as cckp_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.simplex_pivot import ops
    return {"simplex_pivot": ops.pivot_update.launches,
            "reduced_pivot": ops.reduced_pivot.launches,
            "cckp_model_dp": cckp_ops.model_dp.launches,
            "flash_attention_fwd": fa_ops.flash_attention_fwd.launches}


def reset_launches():
    from repro_torch.kernels.cckp_dp import ops as cckp_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.simplex_pivot import ops
    ops.reset_launches()
    cckp_ops.reset_launches()
    fa_ops.reset_launches()


def front_problem():
    """16384 devices of 12 jobs: even rows `identical_instance`s (m = 2,
    T = 1.2 s), odd rows heterogeneous jobs drawn from `make_fleet`
    profiles of the three paper classes."""
    import numpy as np

    from repro_torch.api import FleetProblem
    from repro_torch.core.instances import identical_instance
    from repro_torch.serving.fleet import make_fleet
    half = D_FLEET // 2
    specs = make_fleet(half, seed=13, horizon=1, es_peak_flops=ES_PEAK_FLOPS,
                       es_hbm_bw=HBM_BYTES_S)
    rng = np.random.default_rng(13)
    het = [s.profile.instance(rng.choice((128, 512, 1024), N_JOBS), T_BUDGET)
           for s in specs]
    ident = [identical_instance(N_JOBS, 2, T_BUDGET, seed=s)
             for s in range(half)]
    insts = [x for pair in zip(ident, het) for x in pair]
    return FleetProblem(p_ed=np.stack([i.p_ed for i in insts]),
                        p_es=np.stack([i.p_es for i in insts]),
                        acc=np.stack([i.acc for i in insts]),
                        T=np.full(D_FLEET, T_BUDGET),
                        real_mask=np.ones((D_FLEET, N_JOBS), bool))


def phase_front(torch, dev):
    import numpy as np

    from repro_torch import api
    fp = front_problem()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = api.solve(fp, policy="auto", device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernel_launches()
    tags = np.asarray(sol.solver).astype(str)
    counts = {t: int((tags == t).sum()) for t in sorted(set(tags))}
    check(counts.get("amdp", 0) > 0 and counts.get("amr2", 0) > 0,
          f"front: policy='auto' did not split the fleet: {counts}")
    check(launches["cckp_model_dp"] > 0 and launches["simplex_pivot"] > 0,
          f"front: a kernel never launched: {launches}")
    check(sol.assignment.shape == (D_FLEET, N_JOBS)
          and bool(np.isfinite(sol.accuracy).all()), "front: bad output")
    ok = sol.status == 0
    amr2, amdp = ok & (tags == "amr2"), ok & (tags == "amdp")
    check(bool((sol.makespan[amr2] <= 2 * T_BUDGET + 1e-9).all()),
          "front: an AMR^2 plan exceeds 2T (Theorem 1)")
    check(bool((sol.violation[amdp] <= 1e-9).all()),
          "front: an AMDP plan exceeds T")
    # the first 256 rows again on the CPU (the kernels' plain versions):
    # statuses and tags exact, each device's accuracy and makespan to 1e-9
    cpu = api.solve(fp.take(np.arange(256)), policy="auto", device="cpu")
    check(np.array_equal(cpu.status, sol.status[:256])
          and np.array_equal(np.asarray(cpu.solver).astype(str), tags[:256])
          and np.allclose(cpu.accuracy, sol.accuracy[:256], rtol=0,
                          atol=1e-9)
          and np.allclose(cpu.makespan, sol.makespan[:256], rtol=0,
                          atol=1e-9),
          "front: the card's plan differs from the CPU's on 256 rows")
    emit("front", devices=D_FLEET, solver_counts=counts, seconds=seconds,
         launches=launches, statuses=np.bincount(sol.status).tolist(),
         mean_accuracy=float(sol.accuracy.mean()))


def serve_engine(dev):
    """The periodic-sensing fleet: every device sends one frame class
    (512), up to 12 a period, 1024 ES servers."""
    from repro_torch.serving.fleet import FleetEngine, make_fleet
    from repro_torch.serving.queue import RequestQueue
    devices = make_fleet(D_FLEET, classes=(512,), seed=7, horizon=PERIODS,
                         es_peak_flops=ES_PEAK_FLOPS, es_hbm_bw=HBM_BYTES_S)
    queue = RequestQueue(D_FLEET, (512,), rate=12.0, batch_max=N_JOBS,
                         seed=7)
    return FleetEngine(devices, queue, T=T_BUDGET, n_servers=N_SERVERS,
                       policy="auto", device=dev)


def phase_serve(torch, dev):
    import math
    engine = serve_engine(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    periods = []
    t_all = time.perf_counter()
    for _ in range(PERIODS):
        t0 = time.perf_counter()
        stats = engine.run_period()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        log = engine.solver_log[-1]
        row = dict(period=stats.period, seconds=seconds,
                   amdp=log["plan"]["amdp"], amr2=log["plan"]["amr2"],
                   replan=dict(log["replan"]),
                   n_backpressured=stats.n_backpressured,
                   n_jobs=stats.n_jobs, n_straggler_updates=
                   stats.n_straggler_updates,
                   mean_job_accuracy=stats.mean_job_accuracy,
                   es_utilization=stats.es_utilization)
        check(row["amdp"] > 0 and row["amr2"] > 0,
              f"serve: period {stats.period} did not use both solvers: "
              f"{dict(log['plan'])}")
        check(stats.n_jobs > 0 and all(
            math.isfinite(getattr(stats, f)) for f in
            ("total_accuracy", "worst_violation", "es_utilization",
             "realized_makespan")), f"serve: bad stats {stats}")
        check(0.3 < stats.mean_job_accuracy < 0.8,
              f"serve: mean job accuracy {stats.mean_job_accuracy}")
        periods.append(row)
        emit("serve", **row)
    seconds = time.perf_counter() - t_all
    launches = kernel_launches()
    for name in ("cckp_model_dp", "simplex_pivot"):
        check(launches[name] > 0, f"serve: {name} never launched")
    emit("serve", devices=D_FLEET, periods=PERIODS, seconds=seconds,
         devices_per_s=D_FLEET * PERIODS / seconds, launches=launches,
         launches_per_period={k: v / PERIODS for k, v in launches.items()},
         peak_mem_bytes=torch.cuda.max_memory_allocated(),
         summary=engine.summary())
    return launches, seconds


# --------------------------------------------------------------------------
# phases 7 and 8: the LM forward and the serving runtime
# --------------------------------------------------------------------------
# the flash forward of gemma3-1b against the same forward with the plain
# dense attention, on the card.  float32: both run their products in full
# float32 (TF32 off), so they differ by summation order over 26 layers.
# bfloat16: the flash kernel rounds p to bfloat16 against a running max
# per 32-key block, the dense path the normalised p; those roundings feed
# 26 residual layers of an untrained model whose runner-up logits are
# close.  Bounds on logits of scale ~1-5:
LM_F32_ATOL = 1e-3
LM_BF16_ATOL, LM_BF16_MEAN, LM_BF16_TOP1 = 0.5, 0.05, 0.9


def phase_lm_forward(torch, dev):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import forward, init_params, logits_from_h
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("gemma3_1b")
    params = init_params(cfg, LM_SEED, device=dev)
    tokens = torch.as_tensor(TokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=LM_SEQ, global_batch=LM_BATCH,
        seed=LM_SEED)).batch_at(0)["tokens"], device=dev)

    @torch.inference_mode()
    def run(c):
        return logits_from_h(params, forward(params, {"tokens": tokens}, c),
                             c)

    run(cfg)                                     # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    logits = run(cfg)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    check(launches["flash_attention_fwd"] == cfg.num_layers,
          f"lm_forward: {launches['flash_attention_fwd']} flash launches "
          f"for {cfg.num_layers} layers")
    V = cfg.vocab_size
    check(tuple(logits.shape) == (LM_BATCH, LM_SEQ, cfg.padded_vocab)
          and bool(torch.isfinite(logits[..., :V]).all()),
          f"lm_forward: bad logits {tuple(logits.shape)}")
    steady = []
    for _ in range(3):
        t0 = time.perf_counter()
        run(cfg)
        torch.cuda.synchronize()
        steady.append(time.perf_counter() - t0)

    device_s, n_launch, top = profiled(torch, lambda: run(cfg))
    emit("profile", path="lm_forward", device_seconds=device_s,
         wall_seconds=min(steady), busy_share=device_s / min(steady),
         n_kernel_launches=n_launch, top=top)

    def compare(a, b):
        d = (a[..., :V] - b[..., :V]).abs()
        top1 = (a[..., :V].argmax(-1) == b[..., :V].argmax(-1))
        return (d.max().item(), d.mean().item(), top1.float().mean().item())

    plain = run(dataclasses.replace(cfg, attn_impl="dense"))
    bf16 = compare(logits, plain)
    scale = logits[..., :V].abs().max().item()
    del logits, plain
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    flash32 = run(cfg32)
    f32 = compare(flash32, run(dataclasses.replace(cfg32, attn_impl="dense")))
    del flash32
    emit("lm_forward", model=cfg.name, params=cfg.param_count(),
         batch=LM_BATCH, seq=LM_SEQ, seconds=seconds, steady_seconds=steady,
         tokens_per_s=LM_BATCH * LM_SEQ / min(steady),
         peak_mem_bytes=peak, launches=launches,
         launches_per_forward=launches["flash_attention_fwd"],
         logit_scale=scale,
         bf16_vs_dense=dict(max_abs=bf16[0], mean_abs=bf16[1],
                            top1_agree=bf16[2]),
         f32_vs_dense=dict(max_abs=f32[0], mean_abs=f32[1],
                           top1_agree=f32[2]))
    check(f32[0] <= LM_F32_ATOL,
          f"lm_forward: float32 flash vs dense logits differ by {f32[0]}")
    check(bf16[0] <= LM_BF16_ATOL and bf16[1] <= LM_BF16_MEAN
          and bf16[2] >= LM_BF16_TOP1,
          f"lm_forward: bfloat16 flash vs dense logits (max, mean, top-1) "
          f"{bf16}")
    del params
    torch.cuda.empty_cache()


def phase_lm_serve(torch, dev):
    """The port's launcher on the paper_edge ladder; returns the flash
    launches of the run."""
    from repro_torch.launch import serve
    periods, fail = 6, 2
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    history = serve.main(["--periods", str(periods), "--n", "24",
                          "--fail-period", str(fail), "--device", str(dev)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernel_launches()
    check(len(history) == periods, "lm_serve: missing periods")
    for period, s in enumerate(history):
        emit("lm_serve", period=period, policy=s.policy,
             total_accuracy=s.total_accuracy,
             predicted_makespan=s.predicted_makespan,
             wall_makespan=s.wall_makespan, violation=s.violation,
             replanned=s.replanned, profile_updated=s.profile_updated,
             n_dropped=s.n_dropped, plan_seconds=s.plan_seconds)
        check(s.n_dropped == 0, f"lm_serve: period {period} dropped "
                                f"{s.n_dropped} jobs")
    check(history[fail].replanned,
          f"lm_serve: the ES outage of period {fail} was not replanned")
    check(launches["flash_attention_fwd"] > 0,
          "lm_serve: the flash kernel never launched")
    emit("lm_serve", periods=periods, jobs_per_period=24, seconds=seconds,
         launches=launches,
         flash_launches_per_period=launches["flash_attention_fwd"] / periods)
    return launches["flash_attention_fwd"]


def phase_parity():
    """The card-marked tests, in a child process: the kernels against their
    plain versions, and a small rollout on the card against the CPU."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, (os.path.join(ROOT, "src"),
                      os.environ.get("PYTHONPATH")))))
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-m", "gpu", os.path.join("tests", "test_torch_cuda.py")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    tail = proc.stdout.strip().splitlines()[-1:] or [""]
    check(proc.returncode == 0 and "skipped" not in tail[0],
          f"card-marked tests failed:\n{proc.stdout[-4000:]}"
          f"{proc.stderr[-2000:]}")
    emit("parity", tests="tests/test_torch_cuda.py -m gpu", result=tail[0],
         seconds=time.perf_counter() - t0)


def phase_timing(torch, dev, params):
    from repro_torch.api import engine as E
    seconds = {"tableau": [], "revised": []}
    for method in ("tableau", "revised", "revised", "tableau"):
        state = E.init_state(params[method], device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        E.rollout(state, params[method], PERIODS, device=dev)
        torch.cuda.synchronize()
        seconds[method].append(time.perf_counter() - t0)
    for method, ts in seconds.items():
        emit("timing", lp_method=method, seconds=ts,
             devices_per_s=[D_FLEET * PERIODS / t for t in ts])
    return seconds


def profiled(torch, run):
    """``run()`` under `torch.profiler`: (device seconds, kernel launches,
    the ten largest device items by name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            us = ev.time_range.elapsed_us()
            n, t = by_name.get(ev.name, (0, 0.0))
            by_name[ev.name] = (n + 1, t + us)
    device_s = sum(t for _n, t in by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return (device_s, sum(n for n, _t in by_name.values()),
            [dict(name=k[:80], calls=n, ms=t / 1e3) for k, (n, t) in top])


def phase_profile(torch, dev, params, seconds, serve_seconds):
    """Device time of one rollout per method and of one serve run, summed
    over the kernels the profiler saw, against the best unprofiled wall
    time of phases 8 and 6."""
    from repro_torch.api import engine as E
    for method, p in params.items():
        state = E.init_state(p, device=dev)
        device_s, n, top = profiled(
            torch, lambda: E.rollout(state, p, PERIODS, device=dev))
        wall = min(seconds[method])
        emit("profile", path="rollout", lp_method=method,
             device_seconds=device_s, wall_seconds=wall,
             busy_share=device_s / wall if device_s else None,
             n_kernel_launches=n, top=top)
    engine = serve_engine(dev)
    device_s, n, top = profiled(torch, lambda: engine.run(PERIODS))
    emit("profile", path="serve", device_seconds=device_s,
         wall_seconds=serve_seconds,
         busy_share=device_s / serve_seconds if device_s else None,
         n_kernel_launches=n, top=top)
    emit("profile", path="serve", host=serve_host_breakdown(torch, dev))


# the serve path's stages, by the function that runs each
SERVE_STAGES = {
    "queue.poll": ("queue.py", "poll"),
    "assemble": ("fleet.py", "_assemble"),
    "solve (plan + replan)": ("front.py", "solve"),
    "amdp_arrays": ("amdp.py", "amdp_arrays"),
    "cckp_counts (DP + backtrack)": ("amdp.py", "cckp_counts"),
    "amr2_batch_arrays": ("amr2.py", "amr2_batch_arrays"),
    "simplex_batch_core": ("lp.py", "simplex_batch_core"),
    "round_relaxation_batch": ("amr2.py", "round_relaxation_batch"),
    "admit_mask": ("fleet.py", "admit_mask"),
    "identical_mask": ("problem.py", "identical_mask"),
}


def serve_host_breakdown(torch, dev):
    """Host seconds of one serve run (fresh engine, 8 periods) by stage,
    under cProfile: each stage's cumulative time, and the whole run's."""
    import cProfile
    import pstats
    engine = serve_engine(dev)
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    engine.run(PERIODS)
    torch.cuda.synchronize()
    prof.disable()
    out = {"total (profiled)": time.perf_counter() - t0}
    stats = pstats.Stats(prof).stats
    for stage, (fname, func) in SERVE_STAGES.items():
        out[stage] = sum(v[3] for (f, _line, name), v in stats.items()
                         if f.endswith(fname) and name == func)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.cckp_dp import ops as cckp_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.simplex_pivot import ops, ref

    dev = torch.device("cuda", torch.cuda.current_device())
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), nvidia_smi=smi,
         nvcc=run([_build.nvcc(), "--version"]).splitlines()[-1])

    t0 = time.perf_counter()
    libs = [ops.LIBRARY, cckp_ops.LIBRARY, fa_ops.LIBRARY]
    built = _build.build_many(libs)
    for lib in libs:
        lib.load()
    for lib, (path, log) in zip(libs, built):
        ptxas = [ln.strip() for ln in log.splitlines()
                 if re.search(r"registers|spill|Compiling entry", ln)]
        emit("build", source=os.path.relpath(lib.src, ROOT),
             library=os.path.relpath(path, ROOT), ptxas=ptxas)
    emit("build", seconds=time.perf_counter() - t0)

    rows = phase_kernels(torch, ops, ref, dev)
    flash_rows = phase_flash_kernel(torch, dev)
    params = build_params(dev)
    launches = phase_rollout(torch, ops, dev, params)
    phase_front(torch, dev)
    serve_launches, serve_seconds = phase_serve(torch, dev)
    launches["cckp_model_dp"] = serve_launches["cckp_model_dp"]
    phase_lm_forward(torch, dev)
    launches["flash_attention_fwd"] = phase_lm_serve(torch, dev)
    rows["flash_attention_fwd"] = flash_rows[FLASH_LINE]
    phase_parity()
    seconds = phase_timing(torch, dev, params)
    phase_profile(torch, dev, params, seconds, serve_seconds)

    simplex_src = "src/repro_torch/kernels/simplex_pivot/csrc/simplex_pivot.cu"
    simplex_tpu = "src/repro/kernels/simplex_pivot/simplex_pivot.py"
    source = {"simplex_pivot": simplex_src, "reduced_pivot": simplex_src,
              "cckp_model_dp":
                  "src/repro_torch/kernels/cckp_dp/csrc/cckp_dp.cu",
              "flash_attention_fwd": FLASH_SRC}
    replaces = {"simplex_pivot": f"{simplex_tpu}:57",
                "reduced_pivot": f"{simplex_tpu}:146",
                "cckp_model_dp": "src/repro/kernels/cckp_dp/cckp_dp.py:57",
                "flash_attention_fwd": FLASH_TPU}
    kernels = [dict(name=name, route="cuda", source=source[name],
                    replaces=replaces[name], launches=launches[name],
                    max_abs_err=row["max_abs_err"], ms=row["ms"],
                    plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                    bound_by=row["bound_by"],
                    library_ms=row.get("library_ms"))
               for name, row in rows.items()]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
