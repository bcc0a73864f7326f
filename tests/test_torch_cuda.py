"""The port on a CUDA card: each kernel against its plain version, a
small rollout, a small host `FleetEngine` run, a 2-layer LM forward,
recurrentgemma's 2-cycle SMOKE forward and the SMOKE models' generation
on the card against the same runs on the CPU; the batched dual against
the CPU exactly, Poisson arrivals by their distribution, a delegated
`FleetEngine` run against `rollout` on the card bit for bit (chaos
armed too); the chaos and mobility rollouts against the CPU under one
replayed trace (drawn on
the card, copied to the CPU), and the segmented admission bit for bit
against the CPU, across two card runs and, in its admitted set, against
the sequential oracle; the one-pool admission bit for bit against the
CPU; the HI rollout of each rule against the CPU under one trace drawn
on the card (and replay == fold on the card); the differentiable
rollout's value and gradients against the CPU's, and the implicit
gradient's backward (`kkt_vjp_ref`) against the CPU; `rollout_sharded`
on two gloo ranks on the card against the unsharded card rollout; the
other LM families' SMOKE models (MoE, h2o's window, whisper's
cross-attention, internvl2's float8 KV cache) on the card against the
CPU, and flash-decode widening every float8_e4m3fn byte exactly.

Every test here is marked ``gpu`` and skips (with the reason) where no
card is visible.  The file imports no JAX — it compares the port with
itself, not with the reference — so it also runs on a card machine
without jax:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Tolerances: integer outputs and metrics exact; floats to rtol/atol 1e-12
for a single simplex kernel call, 1e-9 for rollout and fleet metrics (the
card reduces in another order than the CPU); the CCKP kernel bitwise
(float32 values and argmax counts), since it rounds exactly as its plain
version does; the flash attention kernel to 1e-5 in float32 (the
card sums scores and the PV product in another order) and 2^-7
relative and absolute in bfloat16 (p is rounded to bfloat16 against a
running max per 32-key block instead of the row's max; one bfloat16
ulp is 2^-8); the LM forward's float32 logits to 1e-4 (matrix products
of 64-wide rows summed in other orders on the card).  The SSD scan
kernel, y and state alike, to 1e-5 plus twice its plain version's own
error against the float64 recurrence, and so to 1e-5 plus three times it
against the plain version: the plain version's float32 error grows with
the chunk's cumulative decay, which it sums in float32, while the kernels
sum it in float64 and take their products on the tensor cores in split
TF32 (~2^-22 of each product); the flash-decode kernel as the flash
kernel (1e-5 in float32, 2^-7 in bfloat16: p is rounded
against a running max per 32-key block; a float8 cache is widened
exactly on both sides, so the same bars hold, and a lone valid slot
gives its V row bit for bit); the small generation run's
float32 logits to 1e-4, as the forward's; the RG-LRU recurrence kernel
and its plain log-step scan each to 1e-5 max(1, max |h|) of the float64
recurrence, and to that of each other (0 < a < 1: the recurrence is
contractive, so float32 stays within a few roundings of |h|), and the
kernel to its own order recomputed on the CPU (`rglru_tiled_ref`) within
5% of that (a few ulps: the oracle's fused multiply-add rounds twice on a
float32 halfway case).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs, convert
from repro_torch.api import engine as E
from repro_torch.kernels.cckp_dp import ops as cckp_ops
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import ref as da_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.rglru_scan import ops as rg_ops
from repro_torch.kernels.rglru_scan import ref as rg_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.models import (decode_step, forward, init_params,
                                logits_from_h, prefill)
from repro_torch.kernels.cckp_dp import ref as cckp_ref
from repro_torch.kernels.simplex_pivot import ops, ref
from repro_torch.core.dual import dual_one_batch
from repro_torch.serving.fleet import FleetConfig, FleetEngine, make_fleet
from repro_torch.serving.queue import RequestQueue

RTOL = ATOL = 1e-12
B, R, C0 = 256, 14, 38                      # the fleet's R and C0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (see README: PyTorch / H100 port)")
    return torch.device("cuda", torch.cuda.current_device())


def _fail_if_called(*_a, **_k):
    raise AssertionError("a CUDA tensor reached the plain version")


def _tableau_case(seed, lanes=B, rows=R, cols=C0, kind="random"):
    g = torch.Generator().manual_seed(seed)
    tabs = torch.randn((lanes, rows + 1, cols + 1), generator=g,
                       dtype=torch.float64)
    r = torch.randint(0, rows, (lanes,), generator=g, dtype=torch.int32)
    j = torch.randint(0, cols, (lanes,), generator=g, dtype=torch.int32)
    mask = torch.rand((lanes,), generator=g) < 0.7
    mask[0] = kind != "all_masked"
    if kind == "all_masked":
        mask[:] = False
    return tabs, r, j, mask


def _reduced_case(seed, lanes=B, rows=R, cols=C0, kind="random"):
    """Revised-simplex lanes: a quarter degenerate, a third on Bland's rule,
    every tenth with lane_ok False; ``kind`` shapes the whole batch (see
    `REDUCED_CASES`).  Lane 0 may pivot unless the kind forbids it."""
    g = torch.Generator().manual_seed(seed)
    A = torch.randn((lanes, rows, cols), generator=g, dtype=torch.float64)
    c = torch.randn((lanes, cols), generator=g, dtype=torch.float64)
    Binv = torch.eye(rows, dtype=torch.float64) + 0.3 * torch.randn(
        (lanes, rows, rows), generator=g, dtype=torch.float64)
    xB = 2.0 * torch.rand((lanes, rows), generator=g, dtype=torch.float64)
    xB[::4, ::2] = 0.0                                  # degenerate lanes
    basis = torch.argsort(torch.rand((lanes, cols + rows), generator=g),
                          dim=1)[:, :rows].to(torch.int32).contiguous()
    idx = torch.arange(lanes)
    may_pivot = torch.rand((lanes,), generator=g) < 0.8
    lane_ok = idx % 10 != 5
    may_pivot[0] = lane_ok[0] = True
    if kind == "no_pivot":
        may_pivot[:] = False
    elif kind == "all_idle":
        lane_ok[:] = False
    elif kind == "identical_columns":       # pairs price to equal costs
        A[:, :, 1::2] = A[:, :, 0:cols - 1:2]
        c[:, 1::2] = c[:, 0:cols - 1:2]
    elif kind == "tied_ratios":             # rows 0, 2, 4, ... tie exactly
        Binv = torch.eye(rows, dtype=torch.float64).repeat(lanes, 1, 1)
        A = A.abs()
        A[:, 2::2, :] = A[:, :1, :]
        xB = 0.5 + xB
        xB[:, 2::2] = xB[:, :1]
    elif kind == "nan_ratio":               # every third lane: one NaN level
        xB[::3, 1] = float("nan")
    return [A, c, Binv.contiguous(), xB, basis, idx % 3 == 0, may_pivot,
            lane_ok]


# (lanes, R, C0, kind): the fleet shape; a lane wider than a warp; a tiny
# lane; one lane; a batch that is no multiple of a CTA's lanes
SHAPE_CASES = [(B, R, C0, "random"), (64, 40, 70, "random"),
               (64, 2, 3, "random"), (1, R, C0, "random"),
               (257, R, C0, "random")]
PIVOT_CASES = SHAPE_CASES + [(B, R, C0, "all_masked")]
# reduced_pivot also at the LP of 1 and of 16 jobs (R = J + 2, C0 = 3J + 2),
# the ends of its compiled instances
REDUCED_CASES = SHAPE_CASES + [(B, 3, 5, "random"), (B, 18, 50, "random")] + [
    (B, R, C0, kind) for kind in ("no_pivot", "all_idle",
                                  "identical_columns", "tied_ratios",
                                  "nan_ratio")]


def _case_id(case):
    return "-".join(map(str, case))


@pytest.mark.gpu
@pytest.mark.parametrize("case", PIVOT_CASES, ids=_case_id)
def test_cuda_pivot_kernel_matches_plain_version(cuda_device, monkeypatch,
                                                 case):
    lanes, rows, cols, kind = case
    tabs, r, j, mask = _tableau_case(3, lanes, rows, cols, kind)
    want = ref.pivot_update_ref(tabs, r, j, mask)
    monkeypatch.setattr(ops, "pivot_update_ref", _fail_if_called)
    ops.reset_launches()
    t = tabs.to(cuda_device)
    ops.pivot_update(t, r.to(cuda_device), j.to(cuda_device),
                     mask.to(cuda_device))
    torch.cuda.synchronize()
    assert ops.pivot_update.launches == 1
    np.testing.assert_allclose(t.cpu().numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("case", REDUCED_CASES, ids=_case_id)
def test_cuda_reduced_kernel_matches_plain_version(cuda_device,
                                                   monkeypatch, case):
    lanes, rows, cols, kind = case
    case = _reduced_case(4, lanes, rows, cols, kind)
    want = ref.reduced_pivot_ref(*case, art_cost=1.0, tol=1e-7)
    pivots = case[6] & want[3] & ~want[4]
    if kind in ("random", "identical_columns", "tied_ratios", "nan_ratio"):
        assert bool(pivots.any())           # the inputs exercise the update
    monkeypatch.setattr(ops, "reduced_pivot_ref", _fail_if_called)
    ops.reset_launches()
    dev = [x.to(cuda_device) for x in case]
    flags = ops.reduced_pivot(*dev, art_cost=1.0, tol=1e-7)
    torch.cuda.synchronize()
    assert ops.reduced_pivot.launches == 1
    for got, w in ((dev[2], want[0]), (dev[3], want[1])):
        np.testing.assert_allclose(got.cpu().numpy(), w.numpy(), rtol=RTOL,
                                   atol=ATOL)
    assert torch.equal(dev[4].cpu(), want[2])
    for got, w in zip(flags, want[3:]):
        assert torch.equal(got.cpu(), w)


@pytest.mark.gpu
def test_cuda_reduced_instances_cover_the_job_counts(cuda_device):
    for jobs in range(1, 17):
        assert ops.reduced_instance(jobs + 2, 3 * jobs + 2) == jobs
    for shape in ((2, 3), (19, 53), (40, 70), (R, C0 + 1), (R + 1, C0)):
        assert ops.reduced_instance(*shape) == 0


@pytest.mark.gpu
def test_cuda_wrappers_check_their_inputs(cuda_device):
    tabs, r, j, mask = (x.to(cuda_device) for x in _tableau_case(5))
    with pytest.raises(TypeError, match="int32"):
        ops.pivot_update(tabs, r.long(), j, mask)
    with pytest.raises(ValueError, match="contiguous"):
        ops.pivot_update(tabs.transpose(1, 2), r, j, mask)
    with pytest.raises(ValueError, match="expected"):
        ops.pivot_update(tabs, r.cpu(), j, mask)
    # a lane whose tile exceeds a block's shared memory is refused
    big = torch.zeros((1, 200, 200), dtype=torch.float64, device=cuda_device)
    with pytest.raises(RuntimeError, match="simplex_pivot"):
        ops.pivot_update(big, r[:1], j[:1], mask[:1])


@pytest.mark.gpu
@pytest.mark.parametrize("lp_method", ["tableau", "revised"])
def test_cuda_rollout_matches_cpu_rollout(cuda_device, lp_method):
    """Through the CUDA kernels on the card, through the plain versions on
    the CPU.  The audit threshold is 1.4: at 1.5 a 3x straggler's audits
    tie it exactly, and the card and the CPU sum in different orders
    (ROADMAP §3)."""
    D, P = 32, 6
    devices = make_fleet(D, seed=11, horizon=P, es_peak_flops=989e12,
                         es_hbm_bw=3.35e12)
    queue = RequestQueue(D, (128, 512, 1024), rate=10.0, batch_max=12,
                         seed=11)
    cpu = E.EngineParams.from_fleet(devices, queue, T=1.2, n_servers=4,
                                    horizon=P, lp_method=lp_method,
                                    straggler_threshold=1.4, device="cpu")
    gpu = convert.params_from_numpy(
        {**{f: getattr(cpu, f).numpy() for f in E.PARAM_ARRAYS},
         **{f: getattr(cpu, f) for f in E.PARAM_CONFIG}}, cuda_device)
    _, mc = E.rollout(E.init_state(cpu, device="cpu"), cpu, P, device="cpu")
    ops.reset_launches()
    _, mg = E.rollout(E.init_state(gpu, device=cuda_device), gpu, P,
                      device=cuda_device)
    counter = ops.pivot_update if lp_method == "tableau" \
        else ops.reduced_pivot
    assert counter.launches > 0
    for f in E.METRIC_FIELDS:
        a, b = getattr(mg, f).cpu(), getattr(mc, f)
        if a.is_floating_point():
            assert (a - b).abs().max().item() <= 1e-9, f
        else:
            assert torch.equal(a, b), f


def _cckp_case(seed, T1=257, K1=16, lanes=64):
    """Value grids of the DP's kinds — its start, random (whose sums an
    FMA would round otherwise) — with per-lane p from 0 past the grid's
    height, and accuracies in (0.3, 0.99)."""
    g = torch.Generator().manual_seed(seed)
    y = torch.randn((lanes, T1, K1), generator=g, dtype=torch.float32)
    y[::2] = cckp_ref.NEG
    y[::2, :, 0] = 0.0
    p = torch.randint(0, 40, (lanes,), generator=g, dtype=torch.int32)
    p[0], p[1], p[2] = 0, T1, T1 + 9
    a = 0.3 + 0.69 * torch.rand((lanes,), generator=g)
    return y, p, a


def _single_rounding(y, p, a, n_steps):
    """The DP's values with ``s + q*a`` rounded once, as an FMA would:
    formed in float64 (the float32 product is exact there), then rounded
    to float32."""
    B, T1, K1 = y.shape
    best = torch.full_like(y, cckp_ref.NEG)
    lanes = torch.arange(B)[:, None]
    for q in range(min(n_steps, K1)):
        rows = torch.arange(T1)[None, :] - q * p.long()[:, None]  # (B, T1)
        src = torch.full_like(y, cckp_ref.NEG)
        src[:, :, q:] = torch.where((rows >= 0)[:, :, None],
                                    y[lanes, rows.clamp_min(0), :K1 - q],
                                    cckp_ref.NEG)
        val = (src.double() + q * a.double()[:, None, None]).float()
        best = torch.where(val > best, val, best)
    return best


@pytest.mark.gpu
@pytest.mark.parametrize("K1", [16, 1])
def test_cuda_cckp_kernel_matches_plain_version_bitwise(cuda_device,
                                                        monkeypatch, K1):
    """With K1 > 1 the inputs must hold cells where one rounding of
    ``s + q*a`` differs from two, so a kernel that nvcc contracted into an
    FMA fails; with K1 = 1 only q = 0 exists and there is no product."""
    y, p, a = _cckp_case(6, K1=K1)
    want = cckp_ref.cckp_model_dp_ref(y, p, a, K1)
    if K1 > 1:
        assert (_single_rounding(y, p, a, K1) != want[0]).any()
    monkeypatch.setattr(cckp_ops, "cckp_model_dp_ref", _fail_if_called)
    monkeypatch.setattr(cckp_ops, "cckp_models_dp_ref", _fail_if_called)
    cckp_ops.reset_launches()
    got = cckp_ops.model_dp(y.to(cuda_device), p.to(cuda_device),
                            a.to(cuda_device), K1)
    torch.cuda.synchronize()
    assert cckp_ops.models_dp.launches == 1
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


# (T1, K1, lanes): the shared instance compiled for its K1 (K1 <= 16), the
# shared instance for any K1, and a grid too large for shared memory
MODELS_DP_CASES = [(257, 13, 64), (300, 21, 16), (2000, 40, 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("case", MODELS_DP_CASES)
def test_cuda_models_dp_matches_plain_version_bitwise(cuda_device,
                                                      monkeypatch, case, m):
    """All m models in one launch, in the shared-memory and the
    global-memory instance, values and every table bitwise against the
    plain version chained on the CPU."""
    T1, K1, lanes = case
    y, p1, a1 = _cckp_case(8 + m, T1=T1, K1=K1, lanes=lanes)
    g = torch.Generator().manual_seed(T1 + m)
    p = torch.randint(0, 40, (lanes, m), generator=g, dtype=torch.int32)
    p[:, 0] = p1
    a = 0.3 + 0.69 * torch.rand((lanes, m), generator=g)
    a[:, 0] = a1
    want = cckp_ref.cckp_models_dp_ref(y, p, a, K1)
    monkeypatch.setattr(cckp_ops, "cckp_model_dp_ref", _fail_if_called)
    monkeypatch.setattr(cckp_ops, "cckp_models_dp_ref", _fail_if_called)
    shared = cckp_ops.uses_shared(T1, K1, K1, cuda_device)
    assert shared == (T1 * K1 * 4 < 200_000)
    assert cckp_ops.library().cckp_dp_smem_bytes(T1, K1, K1, int(shared)) \
        == cckp_ops.smem_bytes(T1, K1, K1, shared)
    cckp_ops.reset_launches()
    got = cckp_ops.models_dp(*(t.to(cuda_device) for t in (y, p, a)), K1)
    torch.cuda.synchronize()
    assert cckp_ops.models_dp.launches == 1
    assert got[1].shape == (m, lanes, T1, K1)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.gpu
def test_cuda_cckp_wrapper_checks_its_inputs(cuda_device):
    y, p, a = (x.to(cuda_device) for x in _cckp_case(7))
    with pytest.raises(TypeError, match="int32"):
        cckp_ops.model_dp(y, p.long(), a, 16)
    with pytest.raises(TypeError, match="float32"):
        cckp_ops.model_dp(y.double(), p, a, 16)
    with pytest.raises(ValueError, match="contiguous"):
        cckp_ops.model_dp(y.transpose(1, 2), p, a, 16)
    with pytest.raises(ValueError, match="expected"):
        cckp_ops.model_dp(y, p.cpu(), a, 16)


@pytest.mark.gpu
def test_cuda_fleet_engine_matches_cpu_run(cuda_device, monkeypatch):
    """The host `FleetEngine` under policy="auto" at the default audit
    threshold: 64 devices of one job class, so every period plans with
    both AMDP (the CCKP kernel) and AMR^2 (the simplex kernel) and bumps
    devices into the ES-disabled replan.  On the card no plain version
    may run."""
    D, P = 64, 4

    def run(device):
        engine = FleetEngine(
            make_fleet(D, classes=(512,), seed=7, horizon=P,
                       es_peak_flops=989e12, es_hbm_bw=3.35e12),
            RequestQueue(D, (512,), rate=12.0, batch_max=12, seed=7),
            T=1.2, n_servers=4, policy="auto", device=device)
        return engine, engine.run(P)

    cpu_engine, want = run("cpu")
    for mod, name in ((cckp_ops, "cckp_model_dp_ref"),
                      (cckp_ops, "cckp_models_dp_ref"),
                      (ops, "pivot_update_ref"),
                      (ops, "reduced_pivot_ref")):
        monkeypatch.setattr(mod, name, _fail_if_called)
    cckp_ops.reset_launches()
    ops.reset_launches()
    gpu_engine, got = run(cuda_device)
    assert cckp_ops.models_dp.launches > 0 and ops.pivot_update.launches > 0
    for log in gpu_engine.solver_log:
        assert log["plan"]["amdp"] > 0 and log["plan"]["amr2"] > 0
    for w, g in zip(want, got):
        for f in dataclasses.fields(w):
            if f.name == "plan_seconds":
                continue
            a, b = getattr(w, f.name), getattr(g, f.name)
            if isinstance(a, float):
                assert abs(a - b) <= 1e-9, (w.period, f.name, a, b)
            else:
                assert a == b, (w.period, f.name, a, b)
    for dc, dg in zip(cpu_engine.devices, gpu_engine.devices):
        assert dc.n_updates == dg.n_updates


FLASH_CASES = [  # (B*KH, G, Sq, Sk, D, mask_kind, window)
    (4, 2, 100, 100, 64, "causal", 0),
    (2, 4, 130, 130, 256, "window", 33),
    (3, 1, 70, 45, 16, "none", 0),
    (2, 2, 96, 96, 128, "window", 200),
    (2, 16, 200, 200, 256, "window", 64),    # recurrentgemma: 16 q on 1 KV
    (1, 16, 130, 130, 256, "causal", 0),
    # the 64 x 64 tiles' edges: ragged Sq and Sk, D padded to 32 and 128,
    # a window straddling two kv tiles, group 16 causal, Sq > Sk unmasked
    (2, 2, 129, 191, 64, "none", 0),
    (2, 2, 129, 191, 128, "causal", 0),
    (2, 1, 77, 77, 20, "causal", 0),
    (1, 4, 150, 150, 100, "window", 40),
    (2, 2, 200, 200, 64, "window", 65),
    (1, 16, 300, 300, 256, "causal", 0),
    (2, 2, 191, 129, 64, "none", 0),
    # the LM families' shapes: groups 3 (granite-moe-3b), 6 (internlm2), 7
    # (deepseek-coder) and 8 (internvl2); h2o-danube's D of 80 padded to
    # 128 under a window; whisper's cross-attention, unmasked, of one
    # query (a decode step) and of 448 against 1500 encoder frames
    (2, 3, 130, 130, 64, "causal", 0),
    (1, 6, 100, 100, 128, "causal", 0),
    (1, 7, 150, 150, 128, "causal", 0),
    (1, 8, 70, 70, 128, "causal", 0),
    (2, 4, 150, 150, 80, "window", 64),
    (8, 1, 1, 1500, 64, "none", 0),
    (2, 1, 448, 1500, 64, "none", 0),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_cuda_flash_kernel_matches_plain_version(cuda_device, monkeypatch,
                                                 case, dtype):
    BKH, G, Sq, Sk, D, mask_kind, window = case
    g = torch.Generator().manual_seed(Sq + D)
    q, k, v = (torch.randn(shape, generator=g).to(dtype)
               for shape in ((BKH * G, Sq, D), (BKH, Sk, D), (BKH, Sk, D)))
    want = fa_ref.attention_ref(q, k, v, mask_kind=mask_kind, window=window,
                                group=G)
    monkeypatch.setattr(fa_ops, "attention_ref", _fail_if_called)
    fa_ops.reset_launches()
    got = fa_ops.flash_attention_fwd(
        q.to(cuda_device), k.to(cuda_device), v.to(cuda_device),
        mask_kind=mask_kind, window=window, group=G)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention_fwd.launches == 1
    assert got.dtype == dtype and got.shape == q.shape
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().numpy(),
                               rtol=0 if dtype == torch.float32 else tol,
                               atol=tol)


@pytest.mark.gpu
def test_cuda_flash_wrapper_checks_its_inputs(cuda_device):
    q = torch.zeros((4, 8, 64), device=cuda_device)
    k = torch.zeros((2, 8, 64), device=cuda_device)
    with pytest.raises(TypeError, match="takes"):
        fa_ops.flash_attention_fwd(q.double(), k.double(), k.double(),
                                   mask_kind="causal", group=2)
    with pytest.raises(ValueError, match="head_dim"):
        fa_ops.flash_attention_fwd(q[..., :62].contiguous(),
                                   k[..., :62].contiguous(),
                                   k[..., :62].contiguous(),
                                   mask_kind="causal", group=2)
    with pytest.raises(ValueError, match="contiguous"):
        fa_ops.flash_attention_fwd(q.transpose(1, 2).contiguous()
                                   .transpose(1, 2), k, k,
                                   mask_kind="causal", group=2)
    with pytest.raises(ValueError, match="expected"):
        fa_ops.flash_attention_fwd(q, k.cpu(), k, mask_kind="causal",
                                   group=2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_lm_forward_matches_cpu_forward(cuda_device, monkeypatch,
                                             dtype):
    """paper_edge's 2-layer SMOKE model through the flash kernel on the
    card against the plain version on the CPU, same parameters and
    tokens: one kernel launch per layer.  bfloat16 logits (scale ~4) to
    0.25 and top-1 on 85% of positions, as the CPU parity tests bound the
    two frameworks."""
    cfg = dataclasses.replace(configs.get_smoke_config("paper_edge"),
                              dtype=dtype, attn_impl="auto")
    cpu_params = init_params(cfg, 3, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (4, 48),
                           generator=torch.Generator().manual_seed(3))
    want = logits_from_h(cpu_params, forward(cpu_params, {"tokens": tokens},
                                             cfg), cfg)
    monkeypatch.setattr(fa_ops, "attention_ref", _fail_if_called)
    params = convert.model_params_from_numpy(_numpy_tree(cpu_params),
                                             cuda_device)
    fa_ops.reset_launches()
    got = logits_from_h(params, forward(params, {"tokens": tokens}, cfg),
                        cfg).cpu()
    assert fa_ops.flash_attention_fwd.launches == cfg.num_layers
    V = cfg.vocab_size
    err = (got[..., :V] - want[..., :V]).abs()
    if dtype == "float32":
        assert err.max().item() <= 1e-4, err.max().item()
    else:
        top1 = (got[..., :V].argmax(-1) == want[..., :V].argmax(-1))
        assert err.max().item() <= 0.25 and \
            top1.float().mean().item() >= 0.85
    assert torch.equal(got[..., V:], want[..., V:])


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_numpy_tree(v) for v in tree)
    return tree.numpy()


# ---------------------------------------------------------------------------
# generation: the SSD scan and flash-decode kernels
# ---------------------------------------------------------------------------
SSD_CASES = [  # (B, S, H, P, N, chunk, dt scale)
    (2, 1000, 3, 64, 128, 256, 1.0),     # mamba2-130m's P, N, Q; S % Q != 0
    (1, 300, 2, 64, 128, 256, 1.0),      # one sequence
    (2, 96, 2, 4, 8, 64, 8.0),           # cumulative decay past -88
    (2, 40, 3, 32, 16, 8, 1.0),          # the SMOKE model's P, N, chunk
    # the chunk-parallel kernels' structure: one head (C·Bᵀ for one row)
    # over 32 chunks (a long start-state pass), mamba2-130m's 24 heads
    # sharing each batch row's C·Bᵀ, a single chunk shorter than the
    # chunk size, and P, N below the 64 x 128 tiles over a ragged chunk
    (1, 8192, 1, 64, 128, 256, 1.0),
    (2, 512, 24, 64, 128, 256, 1.0),
    (1, 200, 2, 64, 128, 256, 1.0),
    (2, 300, 3, 50, 100, 64, 1.0),
    (1, 37, 2, 3, 5, 16, 1.0),           # P N odd: one state value a load
]


def _ssd_case(B, S, H, P, N, scale, seed=0):
    g = torch.Generator().manual_seed(seed + S)
    x = torch.randn(B, S, H, P, generator=g)
    dt = scale * torch.nn.functional.softplus(torch.randn(B, S, H,
                                                          generator=g))
    A = -torch.exp(0.2 * torch.randn(H, generator=g))
    B_ = torch.randn(B, S, N, generator=g)
    C_ = torch.randn(B, S, N, generator=g)
    return x, dt, A, B_, C_


def _ssd_exact(x, dt, A, B_, C_):
    """The recurrence in float64 on the CPU: (y, final state)."""
    x, dt, A, B_, C_ = (t.double() for t in (x, dt, A, B_, C_))
    h = torch.zeros(x.shape[0], x.shape[2], x.shape[3], B_.shape[-1],
                    dtype=torch.float64)
    ys = []
    for t in range(x.shape[1]):
        h = h * torch.exp(dt[:, t] * A)[..., None, None] + torch.einsum(
            "bh,bn,bhp->bhpn", dt[:, t], B_[:, t], x[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", h, C_[:, t]))
    return torch.stack(ys, dim=1), h


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SSD_CASES)
def test_cuda_ssd_kernel_matches_plain_version(cuda_device, monkeypatch,
                                               case, dtype):
    B, S, H, P, N, chunk, scale = case
    x, dt, A, B_, C_ = _ssd_case(B, S, H, P, N, scale)
    x, B_, C_ = (t.to(dtype) for t in (x, B_, C_))
    want = ssd_ops.ssd_scan(x, dt, A, B_, C_, chunk)        # plain, CPU
    exact = _ssd_exact(x.float(), dt, A, B_.float(), C_.float())
    monkeypatch.setattr(ssd_ops, "ssd_chunked_ref", _fail_if_called)
    ssd_ops.reset_launches()
    got = ssd_ops.ssd_scan(*(t.to(cuda_device) for t in (x, dt, A, B_, C_)),
                           chunk)
    torch.cuda.synchronize()
    assert ssd_ops.ssd_scan_fwd.launches == 1
    for g, w, e in zip(got, want, exact):
        g = g.cpu()
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert torch.isfinite(g).all()
        own = (w.double() - e).abs().max().item()
        assert (g.double() - e).abs().max().item() <= 1e-5 + 2.0 * own
        assert (g - w).abs().max().item() <= 1e-5 + 3.0 * own


@pytest.mark.gpu
def test_cuda_ssd_wrapper_checks_its_inputs(cuda_device):
    x, dt, A, B_, C_ = (t.to(cuda_device) for t in _ssd_case(1, 16, 2, 8,
                                                             4, 1.0))
    xf, d, a = ssd_ops.kernel_layout(x, dt, A)
    with pytest.raises(TypeError, match="takes"):
        ssd_ops.ssd_scan_fwd(xf.double(), d, a, B_.double(), C_.double(),
                             heads=2)
    with pytest.raises(ValueError, match="P <= 64"):
        big = torch.zeros(2, 16, 65, device=cuda_device)
        ssd_ops.ssd_scan_fwd(big, d, a, B_, C_, heads=2)
    with pytest.raises(ValueError, match="expected"):
        ssd_ops.ssd_scan_fwd(xf, d.cpu(), a, B_, C_, heads=2)


DECODE_CASES = [  # (rows, W, G, D, q dtype, kv dtype)
    (4, 512, 4, 256, torch.bfloat16, torch.bfloat16),   # gemma3-1b local
    (4, 1032, 4, 256, torch.float32, torch.float32),    # gemma3-1b global
    (4, 1032, 4, 256, torch.float32, torch.bfloat16),   # f32 model, bf16 KV
    (3, 100, 6, 16, torch.bfloat16, torch.float32),
    (3, 64, 1, 64, torch.float32, torch.float32),
    (1, 7, 9, 96, torch.bfloat16, torch.bfloat16),
    (4, 2048, 16, 256, torch.bfloat16, torch.bfloat16),  # recurrentgemma
    (4, 2048, 16, 256, torch.float32, torch.float32),    # local, group 16
    # groups 1, 5, 16 and 32, W no multiple of the 64-key split, bfloat16
    # q over a float32 cache
    (2, 1000, 1, 256, torch.bfloat16, torch.bfloat16),
    (3, 300, 5, 128, torch.bfloat16, torch.float32),
    (4, 777, 16, 256, torch.bfloat16, torch.float32),
    (2, 130, 32, 64, torch.bfloat16, torch.bfloat16),
    (2, 130, 32, 64, torch.float32, torch.float32),
    (1, 4100, 5, 256, torch.float32, torch.bfloat16),
    # the LM families: internvl2's float8_e4m3fn cache (group 8, D 128;
    # 16-, 8-, 4-byte and single-byte reads: D 128, 80, 20, 66); groups
    # 6 and 7 (internlm2, deepseek-coder); h2o-danube's D 80
    (4, 1000, 8, 128, torch.bfloat16, torch.float8_e4m3fn),
    (3, 300, 8, 128, torch.float32, torch.float8_e4m3fn),
    (2, 130, 6, 80, torch.bfloat16, torch.float8_e4m3fn),
    (2, 77, 3, 20, torch.bfloat16, torch.float8_e4m3fn),
    (2, 99, 2, 66, torch.float32, torch.float8_e4m3fn),
    (4, 1000, 6, 128, torch.bfloat16, torch.bfloat16),
    (4, 1000, 7, 128, torch.bfloat16, torch.bfloat16),
    (1, 4096, 4, 80, torch.bfloat16, torch.bfloat16),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", DECODE_CASES)
def test_cuda_decode_kernel_matches_plain_version(cuda_device, monkeypatch,
                                                  case):
    rows, W, G, D, qdt, kvdt = case
    g = torch.Generator().manual_seed(W + D)
    q = torch.randn(rows, G, D, generator=g).to(qdt)
    k, v = (torch.randn(rows, W, D, generator=g).to(kvdt) for _ in range(2))
    valid = (torch.rand(rows, W, generator=g) > 0.3).to(torch.int32)
    valid[:, -1] = 1
    want = da_ref.decode_attention_ref(q, k, v, valid)
    monkeypatch.setattr(da_ops, "decode_attention_ref", _fail_if_called)
    da_ops.reset_launches()
    got = da_ops.decode_attention_fwd(*(t.to(cuda_device)
                                        for t in (q, k, v, valid)))
    torch.cuda.synchronize()
    assert da_ops.decode_attention_fwd.launches == 1
    assert got.dtype == qdt and got.shape == q.shape
    tol = 1e-5 if qdt == torch.float32 else 2.0 ** -7
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().numpy(),
                               rtol=0 if qdt == torch.float32 else tol,
                               atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
def test_cuda_decode_widens_every_float8_value_exactly(cuda_device,
                                                      monkeypatch, qdt):
    """A float8_e4m3fn V holding all 256 byte patterns (4 rows x 64
    columns), each row with one valid slot and q = 0: p = 1 on that slot,
    so the output is that slot's V row widened to q's type, bit for bit,
    NaN (0x7f, 0xff) as NaN."""
    rows, W, D = 4, 64, 64
    slot = torch.tensor([0, 17, 40, 63])
    vb = torch.zeros(rows, W, D, dtype=torch.uint8)
    vb[torch.arange(rows), slot] = torch.arange(256, dtype=torch.uint8
                                                ).view(rows, D)
    v = vb.view(torch.float8_e4m3fn)
    k = torch.randn(rows, W, D, generator=torch.Generator().manual_seed(1)
                    ).to(torch.float8_e4m3fn)
    valid = torch.zeros(rows, W, dtype=torch.int32)
    valid[torch.arange(rows), slot] = 1
    q = torch.zeros(rows, 2, D, dtype=qdt)
    want = da_ref.decode_attention_ref(q, k, v, valid)
    assert torch.isnan(want).sum().item() == 2 * 2
    monkeypatch.setattr(da_ops, "decode_attention_ref", _fail_if_called)
    got = da_ops.decode_attention_fwd(*(t.to(cuda_device)
                                        for t in (q, k, v, valid))).cpu()
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.gpu
@pytest.mark.parametrize("kvdt", [torch.float32, torch.float8_e4m3fn])
@pytest.mark.parametrize("B,KH,G", [(1, 1, 4), (2, 2, 2), (2, 1, 16)])
def test_cuda_decode_model_entry_reads_the_cache_in_place(cuda_device,
                                                         monkeypatch, B,
                                                         KH, G, kvdt):
    """(B, W, KH, D) ring caches read where they lie, before and after the
    ring wraps and with a window, against the CPU entry."""
    W, D = 40, 32
    g = torch.Generator().manual_seed(B * KH)
    q = torch.randn(B, 1, KH * G, D, generator=g)
    ck, cv = (torch.randn(B, W, KH, D, generator=g).to(kvdt)
              for _ in range(2))
    cases = ((7, 0), (45, 0), (45, 16), (99, 40))
    want = [da_ops.decode_attention(q, ck, cv, i, window=w)
            for i, w in cases]
    monkeypatch.setattr(da_ops, "decode_attention_ref", _fail_if_called)
    da_ops.reset_launches()
    dq, dk, dv = (t.to(cuda_device) for t in (q, ck, cv))
    for (i, w), ref_o in zip(cases, want):
        got = da_ops.decode_attention(dq, dk, dv, i, window=w).cpu()
        torch.testing.assert_close(got, ref_o, rtol=0, atol=1e-5)
    assert da_ops.decode_attention_fwd.launches == len(cases)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["gemma3_1b", "mamba2_130m",
                                  "recurrentgemma_9b"])
def test_cuda_generate_matches_cpu_generate(cuda_device, monkeypatch, arch):
    """The SMOKE model's prefill of 12 tokens and 4 decode steps on the
    card (the flash, flash-decode, SSD and RG-LRU kernels) against the
    same on the CPU (their plain versions), float32 with a float32 KV
    cache: one flash-decode launch per attention layer and step, one SSD
    or RG-LRU launch per such layer and prefill, none per decode step."""
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              dtype="float32", kv_cache_dtype="float32",
                              attn_impl="auto")
    cpu_params = init_params(cfg, 3, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(3))

    def run(params, device):
        toks = tokens.to(device)
        cache, lg = prefill(params, {"tokens": toks[:, :12]}, cfg,
                            max_seq=16)
        out = [lg.cpu()]
        counts = [_generate_launches()]
        for t in range(4):
            lg, cache = decode_step(params, toks[:, 12 + t:13 + t], cache,
                                    cfg)
            out.append(lg.cpu())
            counts.append(_generate_launches())
        return out, counts

    want, _ = run(cpu_params, "cpu")
    for mod, name in ((da_ops, "decode_attention_ref"),
                      (ssd_ops, "ssd_chunked_ref"),
                      (fa_ops, "attention_ref"),
                      (rg_ops, "rglru_scan_ref")):
        monkeypatch.setattr(mod, name, _fail_if_called)
    params = convert.model_params_from_numpy(_numpy_tree(cpu_params),
                                             cuda_device)
    for mod in (da_ops, ssd_ops, rg_ops):
        mod.reset_launches()
    got, counts = run(params, cuda_device)
    mixers = [cfg.layer_kind(i)[0] for i in range(cfg.num_layers)]
    n_ssd, n_rg = mixers.count("ssd"), mixers.count("rglru")
    n_attn = cfg.num_layers - n_ssd - n_rg
    assert counts == [(n_attn * t, n_ssd, n_rg) for t in range(5)]
    V = cfg.vocab_size
    for g, w in zip(got, want):
        assert (g[..., :V] - w[..., :V]).abs().max().item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m", "whisper_base",
                                  "internvl2_76b", "h2o_danube_1_8b"])
def test_cuda_lm_families_generate_matches_cpu(cuda_device, monkeypatch,
                                               arch):
    """The other LM families' SMOKE models on the card against the CPU,
    float32: forward, prefill of 12 tokens (whisper's 16 encoder frames,
    internvl2's 4 patch embeddings) and 4 decode steps.  internvl2 keeps
    its float8_e4m3fn KV cache (`cast_kv` on both devices, widened by the
    flash-decode kernel on the card), the others a float32 one; MoE with
    capacity_factor 8.  Launches: flash per attention layer (whisper: 2
    encoder + 2 self + 2 cross a forward, 2 cross a step), flash-decode
    per self-attention layer and step."""
    cfg = configs.get_smoke_config(arch)
    kv = cfg.kv_cache_dtype if "float8" in cfg.kv_cache_dtype else "float32"
    cfg = dataclasses.replace(cfg, dtype="float32", kv_cache_dtype=kv,
                              attn_impl="auto", capacity_factor=8.0)
    cpu_params = init_params(cfg, 3, device="cpu")
    g = torch.Generator().manual_seed(4)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16),
                                     generator=g)}
    if cfg.num_patches:
        batch["patch_embeds"] = torch.randn(2, cfg.num_patches, cfg.d_model,
                                            generator=g)
    if cfg.is_encdec:
        batch["audio_feats"] = torch.randn(2, cfg.encoder_seq, cfg.d_model,
                                           generator=g)

    def run(params, device):
        b = {k: t.to(device) for k, t in batch.items()}
        out = [logits_from_h(params, forward(params, b, cfg), cfg).cpu()]
        counts = [(fa_ops.flash_attention_fwd.launches,
                   da_ops.decode_attention_fwd.launches)]
        cache, lg = prefill(params, dict(b, tokens=b["tokens"][:, :12]),
                            cfg, max_seq=16)
        out.append(lg.cpu())
        for t in range(4):
            lg, cache = decode_step(params, b["tokens"][:, 12 + t:13 + t],
                                    cache, cfg)
            out.append(lg.cpu())
        counts.append((fa_ops.flash_attention_fwd.launches,
                       da_ops.decode_attention_fwd.launches))
        return out, counts

    want, _ = run(cpu_params, "cpu")
    for mod, name in ((da_ops, "decode_attention_ref"),
                      (fa_ops, "attention_ref")):
        monkeypatch.setattr(mod, name, _fail_if_called)
    params = convert.model_params_from_numpy(_numpy_tree(cpu_params),
                                             cuda_device)
    fa_ops.reset_launches()
    da_ops.reset_launches()
    got, counts = run(params, cuda_device)
    L, cross = cfg.num_layers, cfg.num_layers if cfg.is_encdec else 0
    fwd = L + cfg.encoder_layers + cross
    assert counts == [(fwd, 0), (2 * fwd + 4 * cross, 4 * L)]
    V = cfg.vocab_size
    for g_, w in zip(got, want):
        assert (g_[..., :V] - w[..., :V]).abs().max().item() <= 1e-4


def _generate_launches():
    return (da_ops.decode_attention_fwd.launches,
            ssd_ops.ssd_scan_fwd.launches, rg_ops.rglru_scan_fwd.launches)


# ---------------------------------------------------------------------------
# recurrentgemma: the RG-LRU recurrence kernel
# ---------------------------------------------------------------------------
RGLRU_CASES = [  # (B, S, W, a's lower end); geometry: `launch_geometry`
    (2, 1000, 256, 0.0),
    (1, 1, 64, 0.0),                     # one step
    (1, 333, 77, 0.9),                   # ragged S and W, slow decay
    (3, 40, 4096, 0.0),                  # recurrentgemma-9b's width
    (1, 2100, 33, 0.99),
    # 32 channels a CTA, tiles of L = 64 steps in sub-chunks of 8: S at
    # L - 1, L, L + 1 and 3 tiles + 5 sub-chunks; W no multiple of 32, odd
    # (4-byte copies); one prompt of 4096 channels (the deeper ring)
    (2, 63, 4100, 0.0),
    (3, 64, 4096, 0.5),
    (1, 65, 4096, 0.0),
    (2, 3 * 64 + 5 * 8, 4097, 0.9),
    # 16 channels (L 256, sub-chunks of 16) and 8 (L 512, sub-chunks of
    # 16): the narrow groups of small B * W, aligned and not
    (1, 2 * 256 + 3 * 16, 1100, 0.99),
    (1, 511, 40, 0.0),
    (1, 2 * 512 + 1, 999, 0.9),
    (1, 512 + 3 * 16, 1000, 0.0),
    (6, 257, 4096, 0.0),                 # 768 CTAs: more than one wave
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", RGLRU_CASES)
def test_cuda_rglru_kernel_matches_plain_version(cuda_device, monkeypatch,
                                                 case):
    """The kernel against the plain log-step scan (on the CPU) and the
    float64 recurrence, both within 1e-5 max(1, max |h|): one launch."""
    B, S, W, lo = case
    g = torch.Generator().manual_seed(S + W)
    a = lo + (1.0 - lo) * torch.rand(B, S, W, generator=g)
    b = torch.randn(B, S, W, generator=g)
    want = rg_ops.rglru_scan_fwd(a, b)
    exact = rg_ref.rglru_sequential_ref(a, b)
    monkeypatch.setattr(rg_ops, "rglru_scan_ref", _fail_if_called)
    rg_ops.reset_launches()
    got = rg_ops.rglru_scan_fwd(a.to(cuda_device), b.to(cuda_device))
    torch.cuda.synchronize()
    assert rg_ops.rglru_scan_fwd.launches == 1
    got = got.cpu()
    assert got.dtype == torch.float32 and got.shape == (B, S, W)
    tol = 1e-5 * max(1.0, exact.abs().max().item())
    assert (got.double() - exact).abs().max().item() <= tol
    assert (got - want).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("case", RGLRU_CASES)
def test_cuda_rglru_kernel_is_its_own_order(cuda_device, monkeypatch, case):
    """The kernel against `rglru_tiled_ref`, its association recomputed on
    the CPU with one rounding a step, in the geometry the wrapper picks:
    equal but for the float64 sum's second rounding in `ref._fma` (a few
    ulps at most), so within 5% of the 1e-5 max(1, max |h|) tolerance;
    the largest difference is printed as a share of it."""
    B, S, W, lo = case
    g = torch.Generator().manual_seed(S * 3 + W)
    a = lo + (1.0 - lo) * torch.rand(B, S, W, generator=g)
    b = torch.randn(B, S, W, generator=g)
    geo = rg_ops.launch_geometry(B, S, W)
    want = rg_ref.rglru_tiled_ref(a, b, tile=geo.steps, split=geo.split)
    monkeypatch.setattr(rg_ops, "rglru_scan_ref", _fail_if_called)
    rg_ops.reset_launches()
    got = rg_ops.rglru_scan_fwd(a.to(cuda_device), b.to(cuda_device)).cpu()
    assert rg_ops.rglru_scan_fwd.launches == 1
    tol = 1e-5 * max(1.0, want.abs().max().item())
    share = (got - want).abs().max().item() / tol
    print(f"rglru {case} {tuple(geo)[:4]}: {share:.3g} of the tolerance")
    assert share <= 0.05


@pytest.mark.gpu
@pytest.mark.parametrize("inst", rg_ops.INSTANCES)
def test_cuda_rglru_every_instance(cuda_device, monkeypatch, inst):
    """Each compiled (C, L, stages), chosen by shape or not, against its
    own order on the CPU at ragged S (past 3 tiles, inside a sub-chunk)
    and W (past 3 channel groups; odd, then a multiple of 4 for the
    16-byte copies), one launch a call; its shared memory as
    `geometry_of` counts it, at least one CTA an SM."""
    C, L, _stages = inst
    monkeypatch.setattr(rg_ops, "rglru_scan_ref", _fail_if_called)
    for W in (3 * C + 5, 3 * C + 8):
        B, S = 2, 3 * L + L // 2 + 1
        g = torch.Generator().manual_seed(W)
        a = 0.9 + 0.1 * torch.rand(B, S, W, generator=g)
        b = torch.randn(B, S, W, generator=g)
        geo = rg_ops.geometry_of(B, W, *inst)
        want = rg_ref.rglru_tiled_ref(a, b, tile=L, split=geo.split)
        rg_ops.reset_launches()
        got = rg_ops.rglru_scan_fwd(a.to(cuda_device), b.to(cuda_device),
                                    geometry=geo).cpu()
        assert rg_ops.rglru_scan_fwd.launches == 1
        tol = 1e-5 * max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= 0.05 * tol
    occ = rg_ops.occupancy(geo)
    assert occ["smem"] == geo.smem and occ["ctas_per_sm"] >= 1


@pytest.mark.gpu
def test_cuda_rglru_wrapper_checks_its_inputs(cuda_device, monkeypatch):
    """Refused inputs raise before a launch; a launcher error raises and
    leaves the counter as it was."""
    a = torch.rand(2, 8, 4, device=cuda_device)
    rg_ops.reset_launches()
    with pytest.raises(TypeError, match="float32"):
        rg_ops.rglru_scan_fwd(a.bfloat16(), a.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        rg_ops.rglru_scan_fwd(a.transpose(1, 2).contiguous()
                              .transpose(1, 2), a)
    with pytest.raises(ValueError, match="expected"):
        rg_ops.rglru_scan_fwd(a, a.cpu())
    assert rg_ops.rglru_scan_fwd(a[:, :0], a[:, :0]).shape == (2, 0, 4)
    assert rg_ops.rglru_scan_fwd.launches == 0
    rg_ops.rglru_scan_fwd(a, a)
    assert rg_ops.rglru_scan_fwd.launches == 1

    not_compiled = rg_ops.Geometry(32, 96, 3, 2, 2, 0)
    with pytest.raises(RuntimeError, match="rglru_scan_fwd launch failed"):
        rg_ops.rglru_scan_fwd(a, a, geometry=not_compiled)
    assert rg_ops.rglru_scan_fwd.launches == 1

    class Refusing:
        @staticmethod
        def rglru_scan_fwd_launch(*_args):
            return 1                              # cudaErrorInvalidValue

    monkeypatch.setattr(rg_ops, "library", lambda: Refusing)
    with pytest.raises(RuntimeError, match="rglru_scan_fwd launch failed"):
        rg_ops.rglru_scan_fwd(a, a)
    assert rg_ops.rglru_scan_fwd.launches == 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_recurrentgemma_forward_matches_cpu_forward(cuda_device,
                                                         monkeypatch, dtype):
    """recurrentgemma's 2-cycle SMOKE model (6 RG-LRU and 2 local
    attention layers, 4 q heads on 1 KV head) through the RG-LRU and flash
    kernels on the card against the plain versions on the CPU: one launch
    per layer of each kind.  float32 logits to 1e-4 as the other forwards;
    bfloat16 (scale ~4) to 0.25 and top-1 on 85% of positions."""
    cfg = dataclasses.replace(configs.get_smoke_config("recurrentgemma_9b"),
                              dtype=dtype, attn_impl="auto")
    cpu_params = init_params(cfg, 3, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 40),
                           generator=torch.Generator().manual_seed(3))
    want = logits_from_h(cpu_params, forward(cpu_params, {"tokens": tokens},
                                             cfg), cfg)
    monkeypatch.setattr(fa_ops, "attention_ref", _fail_if_called)
    monkeypatch.setattr(rg_ops, "rglru_scan_ref", _fail_if_called)
    params = convert.model_params_from_numpy(_numpy_tree(cpu_params),
                                             cuda_device)
    fa_ops.reset_launches()
    rg_ops.reset_launches()
    got = logits_from_h(params, forward(params, {"tokens": tokens}, cfg),
                        cfg).cpu()
    assert (rg_ops.rglru_scan_fwd.launches,
            fa_ops.flash_attention_fwd.launches) == (6, 2)
    V = cfg.vocab_size
    err = (got[..., :V] - want[..., :V]).abs()
    if dtype == "float32":
        assert err.max().item() <= 1e-4, err.max().item()
    else:
        top1 = (got[..., :V].argmax(-1) == want[..., :V].argmax(-1))
        assert err.max().item() <= 0.25 and \
            top1.float().mean().item() >= 0.85
    assert torch.equal(got[..., V:], want[..., V:])


def _dual_lanes(lanes, n, seed):
    """Paper-like lanes: 2 local models, times and budgets drawn apart,
    every fourth lane with a phantom (p = 0) slot."""
    rng = np.random.default_rng(seed)
    p_ed = np.sort(rng.uniform(0.02, 0.4, (lanes, n, 2)), axis=2)
    p_es = rng.uniform(0.05, 0.5, (lanes, n))
    acc = np.sort(rng.uniform(0.3, 0.95, (lanes, 3)), axis=1)
    T = rng.uniform(0.1, 1.5, lanes)
    if n > 1:
        p_ed[::4, -1], p_es[::4, -1] = 0.0, 0.0
    return [torch.as_tensor(x) for x in (p_ed, p_es, acc, T)]


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 12, 16])
def test_cuda_dual_batch_equals_cpu_exactly(cuda_device, n):
    """The bisection on the card equals the CPU's, assignment and status,
    on 4096 lanes (the prefix loads are sums in another order on the
    card; no decision here lands within rounding of a boundary)."""
    cpu = _dual_lanes(4096, n, seed=n)
    want_a, want_s = dual_one_batch(*cpu)
    got_a, got_s = dual_one_batch(*(x.to(cuda_device) for x in cpu))
    assert got_a.is_cuda
    assert torch.equal(got_a.cpu(), want_a)
    assert torch.equal(got_s.cpu(), want_s)
    assert 0 < int(want_s.sum()) < 4096          # both statuses occur


@pytest.mark.gpu
def test_cuda_dual_rollout_matches_cpu_rollout(cuda_device):
    """The dual rollout of 2048 roofline-heavy devices (their ES times
    repeat exactly, so many devices' demands tie in exact arithmetic) on
    the card against the CPU: integer metrics exact, floats to 1e-9.
    Demands sum in slot order on both, so admission breaks those ties
    alike; the audit threshold is 1.4 (ROADMAP §3)."""
    D, P = 2048, 6
    devices = make_fleet(D, seed=5, horizon=P, es_peak_flops=989e12,
                         es_hbm_bw=3.35e12, roofline_frac=0.8)
    queue = RequestQueue(D, (128, 512, 1024), rate=10.0, batch_max=12,
                         seed=5)
    cpu = E.EngineParams.from_fleet(devices, queue, T=1.2, n_servers=D // 16,
                                    horizon=P, policy="dual",
                                    straggler_threshold=1.4, device="cpu")
    gpu = convert.params_from_numpy(
        {**{f: getattr(cpu, f).numpy() for f in E.PARAM_ARRAYS},
         **{f: getattr(cpu, f) for f in E.PARAM_CONFIG}}, cuda_device)
    sc, mc = E.rollout(E.init_state(cpu, device="cpu"), cpu, P,
                       device="cpu")
    sg, mg = E.rollout(E.init_state(gpu, device=cuda_device), gpu, P,
                       device=cuda_device)
    for f in E.METRIC_FIELDS:
        a, b = getattr(mg, f).cpu(), getattr(mc, f)
        if a.is_floating_point():
            assert (a - b).abs().max().item() <= 1e-9, f
        else:
            assert torch.equal(a, b), f
    assert torch.equal(sg.n_updates.cpu(), sc.n_updates)
    assert int(mc.n_backpressured.sum()) > 0


def _poisson_params(device, D=2048, rate=6.0, batch_max=8):
    cfg = FleetConfig(n_devices=D, T=1.2, n_servers=D // 16, policy="amr2",
                      rate=rate, batch_max=batch_max, horizon=2, seed=1,
                      straggler_frac=0.0, class_probs=(0.2, 0.5, 0.3),
                      es_peak_flops=989e12, es_hbm_bw=3.35e12)
    return E.EngineParams.from_config(cfg, arrivals="poisson",
                                      device=device)


@pytest.mark.gpu
def test_cuda_poisson_arrivals_follow_their_distribution(cuda_device):
    params = _poisson_params(cuda_device)
    state = E.init_state(params, seed=4, device=cuda_device)
    counts, classes = [], []
    for t in range(16):
        g = E._generator(4, t, 0, cuda_device)
        counts.append(torch.poisson(params.rate, generator=g))
        ci, take, _p, _h = E._arrivals(state, params, t)
        assert ci.is_cuda and int(take.max()) <= params.batch_max
        classes.append(ci.reshape(-1))
    counts = torch.stack(counts).double()
    assert abs(counts.mean().item() - 6.0) <= 5 * np.sqrt(6.0 /
                                                          counts.numel())
    classes = torch.cat(classes)
    freq = torch.bincount(classes, minlength=3).double() / classes.numel()
    for k, p in enumerate((0.2, 0.5, 0.3)):
        assert abs(freq[k].item() - p) <= 5 * np.sqrt(
            p * (1 - p) / classes.numel()), freq.tolist()
    # a short rollout conserves jobs; a seed repeats bit for bit
    small = _poisson_params(cuda_device, D=64)
    runs = [E.rollout(E.init_state(small, seed=4, device=cuda_device),
                      small, 4, device=cuda_device) for _ in range(2)]
    (s, m), (_s2, m2) = runs
    assert torch.equal(m.n_jobs, m2.n_jobs) and torch.equal(m.backlog,
                                                            m2.backlog)
    drawn = sum(int(torch.poisson(small.rate, generator=E._generator(
        4, t, 0, cuda_device)).sum()) for t in range(4))
    assert int(m.n_jobs.sum()) + int(s.pending.sum()) == drawn
    zero = _poisson_params(cuda_device, D=64, rate=0.0)
    _, mz = E.rollout(E.init_state(zero, device=cuda_device), zero, 3,
                      device=cuda_device)
    assert int(mz.n_jobs.sum()) == 0 and int(mz.backlog.sum()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("policy,lp_method", [("amr2", "tableau"),
                                              ("amr2", "revised"),
                                              ("dual", "tableau")])
def test_cuda_delegated_run_equals_rollout(cuda_device, policy, lp_method):
    """A 64-device `FleetConfig`: `FleetEngine.run` through the delegated
    period core on the card equals `rollout` on the card bit for bit."""
    P = 6
    cfg = FleetConfig(n_devices=64, T=1.2, n_servers=4, policy=policy,
                      rate=10.0, batch_max=12, horizon=P + 2, seed=3,
                      lp_method=lp_method, es_peak_flops=989e12,
                      es_hbm_bw=3.35e12)
    eng = FleetEngine.from_config(cfg, device=cuda_device)
    assert eng._v2_params is not None
    params = E.EngineParams.from_config(cfg, horizon=P + 2,
                                        device=cuda_device)
    ops.reset_launches()
    state, metrics = E.rollout(E.init_state(params, device=cuda_device),
                               params, P, device=cuda_device)
    launched = ops.pivot_update.launches + ops.reduced_pivot.launches
    assert (launched > 0) == (policy == "amr2")
    stats = eng.run(P)
    for i, st in enumerate(stats):
        for f in E.METRIC_FIELDS:
            if hasattr(st, f):
                assert getattr(metrics, f)[i].item() == getattr(st, f), \
                    (i, f)
    beliefs = np.stack([d.profile.p_ed for d in eng.devices])
    np.testing.assert_array_equal(state.p_ed.cpu().numpy(),
                                  beliefs[:, eng._v2_lut, :])
    if policy == "amr2":
        np.testing.assert_array_equal(state.warm_basis.cpu().numpy(),
                                      eng._groups[0].warm_basis)
    else:
        assert (state.warm_basis == -1).all()



@pytest.mark.gpu
def test_cuda_delegated_chaos_run_equals_rollout(cuda_device):
    """Chaos armed: the delegated `FleetEngine.run` threads the ES belief
    and draws each period's faults on the card as `rollout` does, bit for
    bit."""
    from repro_torch.core.faults import FaultModel
    P = 6
    cfg = FleetConfig(n_devices=64, T=1.2, n_servers=4, policy="amr2",
                      rate=10.0, batch_max=12, horizon=P + 2, seed=3,
                      lp_method="revised", es_peak_flops=989e12,
                      es_hbm_bw=3.35e12, fault_seed=11,
                      faults=FaultModel.make(
                          es_crash_prob=0.08, link_degrade_prob=0.25,
                          link_degrade_mag=0.6, straggler_prob=0.2,
                          straggler_mult=1.8, loss_rate=0.15))
    eng = FleetEngine.from_config(cfg, device=cuda_device)
    assert eng._v2_params.chaos
    params = E.EngineParams.from_config(cfg, horizon=P + 2,
                                        device=cuda_device)
    state, metrics = E.rollout(E.init_state(params, device=cuda_device),
                               params, P, device=cuda_device)
    stats = eng.run(P)
    for i, st in enumerate(stats):
        for f in E.METRIC_FIELDS:
            if hasattr(st, f):
                assert getattr(metrics, f)[i].item() == getattr(st, f), \
                    (i, f)
    assert torch.equal(eng._v2_es_belief, state.p_es_belief)
    assert int(metrics.n_retries.sum()) > 0

# ---------------------------------------------------------------------------
# the chaos and mobility scenarios: the card against the CPU
# ---------------------------------------------------------------------------
def _scenario_params(device, D, periods, **kw):
    """A roofline-heavy fleet (tied ES demands) with 16 servers a cell's
    worth of pool, audited at 1.4 (ROADMAP §3 item 1)."""
    devices = make_fleet(D, seed=6, horizon=periods, es_peak_flops=989e12,
                         es_hbm_bw=3.35e12, roofline_frac=0.8)
    queue = RequestQueue(D, (128, 512, 1024), rate=10.0, batch_max=12,
                         seed=6)
    return E.EngineParams.from_fleet(devices, queue, T=1.2,
                                     n_servers=D // 16, horizon=periods,
                                     straggler_threshold=1.4, device=device,
                                     **kw)


def _assert_rollouts_equal(mg, mc, sg, sc):
    for f in E.METRIC_FIELDS:
        a, b = getattr(mg, f).cpu(), getattr(mc, f)
        if a.is_floating_point():
            assert (a - b).abs().max().item() <= 1e-9, f
        else:
            assert torch.equal(a, b), (f, a.tolist(), b.tolist())
    for f in ("n_updates", "cell", "pending", "head"):
        assert torch.equal(getattr(sg, f).cpu(), getattr(sc, f)), f
    for f in ("p_ed", "p_es_belief", "pos", "cell_load"):
        d = (getattr(sg, f).cpu() - getattr(sc, f)).abs().max().item()
        assert d <= 1e-9, (f, d)


@pytest.mark.gpu
@pytest.mark.parametrize("lp_method", ["tableau", "revised"])
def test_cuda_chaos_rollout_matches_cpu_under_one_trace(cuda_device,
                                                        lp_method):
    """The reference bench's harsh model: the fault trace drawn once on
    the card, replayed on the card and, copied, on the CPU."""
    from repro_torch.core.faults import FaultModel, sample_trace
    D, P = 1024, 6
    fm = FaultModel.make(es_crash_prob=0.08, link_degrade_prob=0.25,
                         link_degrade_mag=0.6, straggler_prob=0.2,
                         straggler_mult=1.8, loss_rate=0.15)
    gpu = _scenario_params(cuda_device, D, P, lp_method=lp_method)
    trace = sample_trace(11, fm, D, 12, 3, P, device=cuda_device)
    gpu = gpu.with_faults(fm, fault_seed=11, fault_trace=trace)
    cpu = gpu.to("cpu")
    ops.reset_launches()
    sg, mg = E.rollout(E.init_state(gpu, device=cuda_device), gpu, P,
                       device=cuda_device)
    assert ops.pivot_update.launches + ops.reduced_pivot.launches > 0
    sc, mc = E.rollout(E.init_state(cpu, device="cpu"), cpu, P,
                       device="cpu")
    _assert_rollouts_equal(mg, mc, sg, sc)
    assert int(mc.n_es_audit_updates.sum()) > 0
    assert torch.equal(mc.n_offload_samples, mc.n_offload_ok
                       + mc.n_fallback_local + mc.n_dropped)


def _grid_mobility(D, periods, seed=0):
    """The reference bench's geometry: 16 cells on a 4 x 4 grid of pitch
    20, radius 30, link_alpha 0.2; positions home cell + normal(6)."""
    from repro_torch.core.mobility import MobilityModel
    cxy = np.array([[20.0 * i, 20.0 * j] for i in range(4)
                    for j in range(4)])
    rng = np.random.default_rng(seed)
    home = rng.integers(0, 16, D)
    trace = cxy[home][None] + rng.normal(scale=6.0, size=(periods, D, 2))
    return MobilityModel.make(cell_xy=cxy, trace=trace, radius=30.0,
                              link_alpha=0.2)


@pytest.mark.gpu
@pytest.mark.parametrize("routing", ["nearest", "min_time"])
def test_cuda_mobility_rollout_matches_cpu(cuda_device, routing):
    D, P = 1024, 6
    gpu = _scenario_params(cuda_device, D, P, mobility=_grid_mobility(D, P),
                           routing=routing, lp_method="revised")
    cpu = gpu.to("cpu")
    sg, mg = E.rollout(E.init_state(gpu, device=cuda_device), gpu, P,
                       device=cuda_device)
    sc, mc = E.rollout(E.init_state(cpu, device="cpu"), cpu, P,
                       device="cpu")
    _assert_rollouts_equal(mg, mc, sg, sc)
    assert int(mc.n_handover.sum()) > 0 and int(mc.n_backpressured.sum())


@pytest.mark.gpu
@pytest.mark.parametrize("n_cells,k", [(16, 64), (3, 5), (1, 8)])
def test_cuda_segmented_admission_is_bitwise_and_deterministic(
        cuda_device, n_cells, k):
    """Tie-heavy demands over 16384 devices (running loads in the
    thousands of seconds on a one-cell pool): the card's admitted set and
    per-server loads equal the CPU's bit for bit, and two card runs are
    equal; the admitted set equals the sequential oracle's."""
    from repro_torch.core.mobility import (admit_mask_cells_np,
                                           admit_mask_segmented)
    D = 16384
    rng = np.random.default_rng(n_cells)
    demands = rng.choice([0.0, 0.1, 0.2, 0.25, 0.3, 0.45, 0.7], D)
    cell = rng.integers(0, n_cells, D).astype(np.int32)
    cell[rng.uniform(size=D) < 0.05] = -1
    T = 0.6 * D / n_cells * 0.3 / k
    args = (torch.as_tensor(demands), torch.as_tensor(cell),
            torch.tensor(T, dtype=torch.float64))
    want = admit_mask_segmented(*args, n_cells, k)
    runs = [admit_mask_segmented(*(a.to(cuda_device) for a in args),
                                 n_cells, k) for _ in range(2)]
    for got in runs:
        assert got[0].is_cuda
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])
    oracle, _ = admit_mask_cells_np(demands, cell, T, n_cells, k)
    np.testing.assert_array_equal(want[0].numpy(), oracle)
    assert oracle.any() and not oracle.all()


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 3, 1024])
def test_cuda_pool_admission_is_bitwise(cuda_device, k):
    """The one-pool admission's running loads (one `cumsum` down the round
    axis) equal the CPU's bit for bit on tie-heavy demands, inc included."""
    from repro_torch.core.mobility import admit_mask_pool
    D = 16384
    rng = np.random.default_rng(k)
    demands = rng.choice([0.0, 0.1, 0.2, 0.25, 0.3, 0.45, 0.7], D)
    T = torch.tensor(0.3 * D * 0.3 / k, dtype=torch.float64)
    want = admit_mask_pool(torch.as_tensor(demands), T, k)
    got = admit_mask_pool(torch.as_tensor(demands, device=cuda_device),
                          T.to(cuda_device), k)
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g.cpu(), w)
    assert bool(want[0].any()) and not bool(want[0].all())


@pytest.mark.gpu
@pytest.mark.parametrize("rule", ["fixed", "threshold", "ucb", "exp3"])
def test_cuda_hi_rollout_matches_cpu_under_one_trace(cuda_device, rule):
    """Online hierarchical inference: the confidence and arm streams drawn
    once on the card, replayed on the card and, copied, on the CPU
    (integers exact, floats and the learner to 1e-9); on the card the
    replayed rollout equals the drawn one bit for bit."""
    from repro_torch.core.hi import (HI_STATE_FIELDS, HIModel,
                                     draw_arm_uniforms, presample_stream)
    D, P = 1024, 6
    base = _scenario_params(cuda_device, D, P)
    tr = presample_stream(5, D, 12, P, device=cuda_device)
    arms = torch.stack([draw_arm_uniforms(5, t, D, cuda_device)
                        for t in range(P)])
    fold = base.with_hi(HIModel.make(), rule=rule, n_arms=5, hi_seed=5)
    gpu = base.with_hi(HIModel.make(conf_trace=tr), rule=rule, n_arms=5,
                       stream="replay", hi_seed=5, hi_arm_trace=arms)
    cpu = gpu.to("cpu")
    sf, mf = E.rollout(E.init_state(fold, device=cuda_device), fold, P,
                       device=cuda_device)
    sg, mg = E.rollout(E.init_state(gpu, device=cuda_device), gpu, P,
                       device=cuda_device)
    for f in E.METRIC_FIELDS:
        assert torch.equal(getattr(mf, f), getattr(mg, f)), f
    sc, mc = E.rollout(E.init_state(cpu, device="cpu"), cpu, P,
                       device="cpu")
    _assert_rollouts_equal(mg, mc, sg, sc)
    for f in HI_STATE_FIELDS:
        a, b = getattr(sg.hi, f).cpu(), getattr(sc.hi, f)
        if a.is_floating_point():
            assert (a - b).abs().max().item() <= 1e-9, f
        else:
            assert torch.equal(a, b), f
    assert torch.equal(mc.n_hi_offloaded + mc.n_hi_local_final, mc.n_jobs)


@pytest.mark.gpu
@pytest.mark.parametrize("lp_method", ["tableau", "revised"])
def test_cuda_rollout_grad_matches_cpu(cuda_device, lp_method):
    """`rollout_value_and_grad` (soft relaxation) on the card: the forward
    launches the pivot kernel of its method, and the value and every
    gradient equal the CPU's within rtol 1e-9."""
    D, P = 256, 3
    gpu = _scenario_params(cuda_device, D, P, lp_method=lp_method)
    gpu = gpu.with_differentiable(smooth_mode="soft")
    cpu = gpu.to("cpu")
    wrt = ("p_es", "T", "acc", "base_p_ed")
    ops.reset_launches()
    vg, gg = E.rollout_value_and_grad(E.init_state(gpu, device=cuda_device),
                                      gpu, P, wrt=wrt, device=cuda_device)
    kernel = (ops.pivot_update if lp_method == "tableau"
              else ops.reduced_pivot)
    assert kernel.launches > 0
    vc, gc = E.rollout_value_and_grad(E.init_state(cpu, device="cpu"), cpu,
                                      P, wrt=wrt, device="cpu")
    assert abs(vg.item() - vc.item()) <= 1e-9 * abs(vc.item())
    for f in wrt:
        scale = max(gc[f].abs().max().item(), 1e-30)
        assert (gg[f].cpu() - gc[f]).abs().max().item() <= 1e-9 * scale, f
    assert gc["p_es"].abs().sum().item() > 0


@pytest.mark.gpu
def test_cuda_kkt_vjp_matches_cpu(cuda_device):
    """The implicit gradient's backward (two batched (R, R) solves a lane)
    on the card against the CPU, at the fleet LP's shape."""
    from repro_torch.core.amr2 import build_lp_arrays_torch
    from repro_torch.core.lp import simplex_batch_core
    from repro_torch.kernels.simplex_pivot.ref import kkt_vjp_ref
    g = torch.Generator().manual_seed(3)
    Bn, n, m = 512, 12, 2
    p_ed = torch.rand((Bn, n, m), generator=g, dtype=torch.float64) * 0.3
    p_es = torch.rand((Bn, n), generator=g, dtype=torch.float64) * 0.4
    acc = torch.sort(torch.rand((Bn, m + 1), generator=g,
                                dtype=torch.float64), dim=1).values
    A, b, c = build_lp_arrays_torch(p_ed, p_es, acc,
                                    torch.full((Bn,), 1.2,
                                               dtype=torch.float64))
    nv = n * (m + 1)
    out = simplex_batch_core(A, b, c, None, nv=nv, maxiter=512)
    gx = torch.randn((Bn, nv), generator=g, dtype=torch.float64)
    gfun = torch.randn((Bn,), generator=g, dtype=torch.float64)
    valid = out[2] == 0
    want = kkt_vjp_ref(A, b, c, out[4], gx, gfun, valid, nv=nv)
    got = kkt_vjp_ref(*(x.to(cuda_device) for x in (A, b, c, out[4], gx,
                                                    gfun, valid)), nv=nv)
    for a, w in zip(got, want):
        assert a.is_cuda
        scale = max(w.abs().max().item(), 1.0)
        assert (a.cpu() - w).abs().max().item() <= 1e-10 * scale


@pytest.mark.gpu
def test_cuda_rollout_sharded_matches_unsharded(cuda_device):
    """`rollout_sharded` on 2 gloo ranks computing on this card (the
    collectives' operands through the host) against the unsharded card
    rollout: replay under both LP methods and chaos with the outage flip,
    metrics and carried state exact (a tableau warm basis may differ only
    as a certified tie: `smoke_shard_rollout.tied_basis_failures`), floats
    to 1e-9."""
    from repro_torch.scripts import smoke_shard_rollout as SR
    res = SR.run_legs(("tableau", "revised", "chaos"), shards=2,
                      devices=512, periods=4, backend="gloo",
                      device="cuda")
    for leg, r in res.items():
        assert not r["failures"], "\n".join(r["failures"])
        assert r["info"]["collectives_per_period"] == 4, leg
    assert res["chaos"]["info"]["ladder"] > 0


# ---------------------------------------------------------------------------
# training: the backward on the card
# ---------------------------------------------------------------------------
def _counts():
    return (fa_ops.flash_attention_fwd.launches,
            ssd_ops.ssd_scan_fwd.launches, rg_ops.rglru_scan_fwd.launches,
            da_ops.decode_attention_fwd.launches)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["paper_edge", "gemma3_1b", "mamba2_130m",
                                  "recurrentgemma_9b",
                                  "granite_moe_1b_a400m", "whisper_base"])
def test_cuda_backward_through_forward_matches_cpu(cuda_device, arch):
    """`loss_fn`'s gradient through `forward` (``attn_impl="auto"``) on
    the card against the CPU's, float32, same parameters and tokens: the
    loss to 1e-5 relative, each gradient leaf to 1e-4 of its largest |g|
    (the CPU parity bars), no port kernel launched (autograd takes the
    plain paths); then the eval step on the card launches the kernels of
    a forward."""
    from repro_torch import _tree
    from repro_torch.launch import steps
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              dtype="float32", attn_impl="auto")
    cpu_params = init_params(cfg, 7, device="cpu")
    g = torch.Generator().manual_seed(7)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 40),
                                     generator=g)}
    if cfg.is_encdec:
        batch["audio_feats"] = torch.randn(
            (2, cfg.encoder_seq, cfg.d_model), generator=g)
    want_l, want_g = steps.value_and_grad(cpu_params, batch, cfg)
    params = convert.model_params_from_numpy(_numpy_tree(cpu_params),
                                             cuda_device)
    card = {k: v.to(cuda_device) for k, v in batch.items()}
    before = _counts()
    got_l, got_g = steps.value_and_grad(params, card, cfg)
    assert _counts() == before
    assert abs(float(got_l) - float(want_l)) <= 1e-5 * abs(float(want_l))
    for a, w in zip(_tree.leaves(got_g), _tree.leaves(want_g)):
        assert a.is_cuda
        scale = max(w.abs().max().item(), 1e-30)
        assert (a.cpu() - w).abs().max().item() <= 1e-4 * scale
    ev = steps.make_eval_step(cfg)(params, card)
    assert abs(float(ev) - float(want_l)) <= 1e-4 * abs(float(want_l))
    launched = [a - b for a, b in zip(_counts(), before)]
    assert launched[0] == sum(
        1 for i in range(cfg.num_layers)
        if cfg.layer_kind(i)[0] not in ("ssd", "rglru")) + (
        cfg.encoder_layers + cfg.num_layers if cfg.is_encdec else 0)
    assert launched[1] == sum(1 for i in range(cfg.num_layers)
                              if cfg.layer_kind(i)[0] == "ssd")
    assert launched[2] == sum(1 for i in range(cfg.num_layers)
                              if cfg.layer_kind(i)[0] == "rglru")
