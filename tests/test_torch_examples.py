"""The port's examples (`repro_torch.examples`) and smokes
(`repro_torch.scripts`) at a tiny size on the CPU: each `main([...,
"--device", "cpu"])` runs, and what it asserts holds (a smoke returns 0;
an example's verdict or numbers are checked here).  Without ``--device``
they default to the card and raise where there is none.  The LM
examples are held to the reference: `quickstart`'s losses (on weights
carried over by `convert`, float32, to the train step's 1e-5), its
decode index, its plan's summary and counts; `serve_offload`'s T sweep
row by row on fixed profiles (the reference's rows built with
`repro.api.solve`)."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as ref_api
import repro.core as ref_core
import repro.models as ref_models
import repro.serving as ref_serving
from repro.launch import steps as ref_steps
from repro.optim import adamw_init as ref_adamw_init
from repro_torch import convert
from repro_torch.examples import (amdp_identical, capacity_plan, fleet_sim,
                                  hi_sim, mobility_sim, quickstart,
                                  serve_offload)
from repro_torch.serving import TierProfile
from repro_torch.scripts import (smoke_chaos, smoke_fleet_api, smoke_grad,
                                 smoke_hi, smoke_mobility,
                                 smoke_shard_rollout)

import test_torch_lm_util as U
from test_torch_parity_util import reference_x64

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]


@pytest.mark.parametrize("argv", [
    ["--devices", "8", "--periods", "3", "--servers", "1"],
    ["--devices", "8", "--periods", "2", "--policy", "dual"],
    ["--devices", "8", "--periods", "3", "--policy", "amr2", "--chaos"],
], ids=["auto", "dual", "chaos"])
def test_fleet_sim_serves_every_period(argv, capsys):
    summ = fleet_sim.main(argv + CPU)
    out = capsys.readouterr().out
    periods = int(argv[3])
    assert out.count("[fleet] t=") == periods
    assert summ["periods"] == periods and summ["jobs"] > 0
    assert 0.0 < summ["mean_job_accuracy"] < 1.0
    if "--chaos" in argv:
        assert "retry=" in out


def test_fleet_sim_rollout_equals_the_delegated_loop(capsys):
    """``--rollout`` runs the tensor engine; under amr2 its per-period
    accuracy equals the delegated `FleetEngine` loop's on the same
    replayed trace."""
    argv = ["--devices", "8", "--periods", "3", "--policy", "amr2"] + CPU
    m = fleet_sim.main(argv + ["--rollout"])
    loop = fleet_sim.main(argv)
    assert int(m["n_jobs"].sum()) == loop["jobs"]
    np.testing.assert_allclose(
        float(m["total_accuracy"].sum()) / loop["jobs"],
        loop["mean_job_accuracy"], rtol=1e-12)
    assert "engine-v2 rollout" in capsys.readouterr().out


def test_mobility_sim_routes_and_hands_over():
    res = mobility_sim.main(["--devices", "16", "--periods", "4"] + CPU)
    assert res["single-pool (off)"]["handovers"] == 0
    assert res["min response time"]["handovers"] > 0
    assert sum(res["routed"]["attached"]) + res["routed"]["uncovered"] \
        == 16


def test_hi_sim_clairvoyant_floor_and_learner():
    assert hi_sim.main(["--devices", "16", "--periods", "16"] + CPU) == 0


def test_capacity_plan_gradient_beats_grid():
    assert capacity_plan.main(["--devices", "16", "--periods", "3",
                               "--budget", "16"] + CPU) == 0


def test_amdp_identical_optimal_and_kernel_path(capsys):
    out = amdp_identical.main(["--sizes", "30:2.0,60:3.0"] + CPU)
    for row in out["sweep"]:
        assert row["amdp"] >= row["greedy"] - 1e-9
    a, b = out["brute_force"]
    assert abs(a - b) < 1e-9
    assert out["dp"]["device"] == out["dp"]["cpu"]
    assert out["dp"]["launches"] == 0          # the plain version on CPU
    assert "hetero-comm" in capsys.readouterr().out


@pytest.mark.parametrize("smoke, argv", [
    (smoke_chaos, ["--devices", "16", "--periods", "4"]),
    (smoke_hi, ["--devices", "16", "--periods", "16"]),
    (smoke_grad, ["--devices", "16", "--periods", "3"]),
    (smoke_fleet_api, []),
    (smoke_mobility, ["--devices", "16", "--periods", "4",
                      "--shards", "2"]),
    (smoke_shard_rollout, ["--shards", "2", "--devices", "8",
                           "--periods", "2", "--local-devices", "8",
                           "--legs", "revised,local_by_cell"]),
], ids=["chaos", "hi", "grad", "fleet_api", "mobility", "shard_rollout"])
def test_smoke_passes(smoke, argv):
    assert smoke.main(argv + CPU) == 0


@pytest.mark.parametrize("main", [
    fleet_sim.main, mobility_sim.main, hi_sim.main, capacity_plan.main,
    amdp_identical.main, quickstart.main, serve_offload.main, smoke_chaos.main, smoke_hi.main, smoke_grad.main,
    smoke_fleet_api.main, smoke_mobility.main, smoke_shard_rollout.main])
def test_default_device_is_the_card(main, monkeypatch):
    """Without ``--device`` each entry point asks for the card, and raises
    where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        main([])


def test_smoke_runs_as_a_module():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.scripts.smoke_shard_rollout",
         "--shards", "2", "--devices", "8", "--periods", "2",
         "--legs", "tableau", "--device", "cpu"],
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")),
        capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "[shard-smoke] ok" in proc.stdout


def test_quickstart_matches_the_reference():
    """The tour on the reference's weights and tokens, float32: three
    losses to the train step's 1e-5, the cache index after 24 + 4 tokens,
    and the plan's summary and counts exactly."""
    rcfg, cfg = U.cfgs("internlm2_20b", "float32")
    rp = ref_models.init_params(rcfg, jax.random.key(0))
    params = convert.model_params_from_numpy(jax.tree.map(np.asarray, rp),
                                             device="cpu")
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 32)).astype(np.int32)
    batch = {"tokens": jnp.asarray(tokens)}
    step = jax.jit(ref_steps.make_train_step(rcfg, lr=1e-2))
    opt, want = ref_adamw_init(rp), []
    for _ in range(3):
        rp, opt, loss = step(rp, opt, batch)
        want.append(float(loss))
    cache, logits = ref_models.prefill(rp, {"tokens": batch["tokens"][
        :, :24]}, rcfg, max_seq=32)
    toks = jnp.argmax(logits, -1)
    for _ in range(4):
        logits, cache = ref_models.decode_step(rp, toks, cache, rcfg)
        toks = jnp.argmax(logits, -1)
    with reference_x64():
        sched = ref_api.solve(ref_core.paper_instance(
            30, T=2.0, seed=0)).to_schedule()

    got = quickstart.main(CPU, cfg=cfg, params=params,
                          tokens=torch.as_tensor(tokens))
    np.testing.assert_allclose(got["losses"], want, rtol=1e-5)
    assert got["losses"][-1] < got["losses"][0]
    assert got["index"] == int(cache["index"]) == 28
    assert got["decoded"].shape == (4, 5)
    assert got["summary"] == sched.summary()
    np.testing.assert_array_equal(got["counts"], sched.counts())


PROFILES = {
    "ordered": dict(p_ed=[[0.010, 0.021]], p_es=[0.034],
                    acc=[0.31, 0.48, 0.66]),
    "ladder": dict(p_ed=[[0.0232, 0.0210]], p_es=[0.0365],
                   acc=[0.208, 0.062, 0.17]),
}


@pytest.mark.parametrize("n", [8, 24])
@pytest.mark.parametrize("name", sorted(PROFILES))
def test_serve_offload_sweep_equals_the_reference(name, n):
    """Every row of the T sweep on a fixed profile: solver names and
    jobs per model exact, accuracies and the LP bound to 1e-9."""
    kw = dict(PROFILES[name], classes=[64])
    prof = TierProfile(name=name, **{k: np.array(v) if k != "classes"
                                     else v for k, v in kw.items()})
    ref_prof = ref_serving.TierProfile(
        name=name, **{k: np.array(v) if k != "classes" else v
                      for k, v in kw.items()})
    rows = serve_offload.t_sweep(prof, n, device="cpu")
    assert len(rows) == len(serve_offload.SWEEP_FACTORS)
    base_T = n * ref_prof.p_ed[0, 1]
    with reference_x64():
        for row, tf in zip(rows, serve_offload.SWEEP_FACTORS):
            inst = ref_prof.instance(np.full(n, 64), base_T * tf)
            p = ref_api.solve(inst, policy="amr2")
            g = ref_api.solve(inst, policy="greedy")
            d = ref_api.solve(inst, policy="dual")
            assert row["T"] == base_T * tf
            assert row["solver"] == p.solver
            assert row["counts"] == p.to_schedule().counts().tolist()
            for key, want in (("accuracy", p.accuracy),
                              ("lp_accuracy", float(p.lp_accuracy or 0)),
                              ("greedy_accuracy", g.accuracy),
                              ("dual_accuracy", d.accuracy)):
                assert abs(row[key] - want) <= 1e-9, (key, row[key], want)


def test_serve_offload_period_loop_replans_the_es_outage():
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = serve_offload.main(["--n", "8", "--periods", "3",
                                  "--train-steps", "2", "--iters", "2"]
                                 + CPU)
    finally:
        torch.set_num_threads(n_threads)
    periods = out["periods"]
    assert len(periods) == 3 and len(out["sweep"]) == 4
    assert [p.replanned for p in periods] == [False, False, True]
    assert all(p.n_jobs == 8 and p.n_dropped == 0 for p in periods)
    assert all(np.isfinite(p.wall_makespan) for p in periods)
