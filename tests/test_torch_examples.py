"""The port's planner examples (`repro_torch.examples`) and smokes
(`repro_torch.scripts`) at a tiny size on the CPU: each `main([...,
"--device", "cpu"])` runs, and what it asserts holds (a smoke returns 0;
an example's verdict or numbers are checked here).  Without ``--device``
they default to the card and raise where there is none."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.examples import (amdp_identical, capacity_plan, fleet_sim,
                                  hi_sim, mobility_sim)
from repro_torch.scripts import (smoke_chaos, smoke_fleet_api, smoke_grad,
                                 smoke_hi, smoke_mobility,
                                 smoke_shard_rollout)

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
    amdp_identical.main, smoke_chaos.main, smoke_hi.main, smoke_grad.main,
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
