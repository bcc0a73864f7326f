"""CPU tests of the port's benchmark harness: data files found by name,
generators that repeat from the seed, the frozen counts, the result
line, and no JAX in a run's process."""
from __future__ import annotations

import json
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from helpers import HERE, ROOT, TINY, run_tiny, tiny_copy
from portbench import common, fleetgen, lmgen, work

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    here = tiny_copy(tmp_path)
    cfg = json.loads((here / "configs" / "fleet-scale-102k.json")
                     .read_text())
    (here / "configs" / "fleet-other.json").write_text(
        json.dumps(dict(cfg, name="fleet-other", n_devices=32)))
    (here / "traffic" / "replay-slow.json").write_text(json.dumps(
        dict(common.load_json("traffic", "replay", here), rate=4.0)))
    (here / "metrics" / "periods.seen.py").write_text(
        "def read(ctx):\n    return ctx.get('periods')\n")
    bench = common.load_benchmark(tmp_path)
    bench["configs"].append(dict(bench["configs"][0], name="fleet-other"))
    bench["workloads"].append({"name": "fleet-other.slow",
                               "config": "fleet-other",
                               "traffic": "replay-slow", "chips": 1,
                               "why": "a cell added by data alone"})
    bench["per_layer"].append({
        "name": "periods.seen", "unit": "periods", "better": "higher",
        "source": "program_counter", "layer": "engine entry",
        "moves": "devices_per_s", "workloads": ["fleet-other.slow"]})
    bench["end_to_end"] = [dict(m, workloads=m["workloads"]
                                + ["fleet-other.slow"])
                           if "devices_per_s" == m["name"] else m
                           for m in bench["end_to_end"]]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = common.cell(common.load_benchmark(tmp_path), "fleet-other.slow")
    assert [m["name"] for m in cell["per_layer"]] == ["periods.seen"]
    assert common.load_json("configs", cell["config"], here)[
        "n_devices"] == 32
    assert common.load_json("traffic", cell["traffic"], here)["rate"] == 4.0
    got = common.read_metrics(cell["per_layer"], {"periods": 7}, here)
    assert got == {"periods.seen": {"value": 7.0, "unit": "periods"}}
    # a reader that finds nothing leaves its metric out
    assert common.read_metrics(cell["per_layer"], {}, here) == {}


def test_every_declared_cell_has_its_files():
    bench = common.load_benchmark(ROOT)
    for w in bench["workloads"]:
        cell = common.cell(bench, w["name"])
        common.load_json("configs", cell["config"])
        traffic = common.load_json("traffic", cell["traffic"])
        assert (HERE / "drivers" / f"{traffic['driver']}.py").is_file()
        for m in cell["per_layer"]:
            assert hasattr(common.load_module("metrics", m["name"]), "read")


def test_fleet_arrays_repeat_from_the_seed():
    cfg = dict(common.load_json("configs", "fleet-scale-102k"),
               **TINY["fleet-scale-102k"])
    traffic = common.load_json("traffic", "replay")
    seed = common.stream_seed(2 ** 31 + 12345, 0)
    a = fleetgen.make_arrays(cfg, traffic, seed)
    b = fleetgen.make_arrays(cfg, traffic, seed)
    c = fleetgen.make_arrays(cfg, traffic, common.stream_seed(-4, 0))
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert not np.array_equal(a["counts"], c["counts"])
    D, H = cfg["n_devices"], cfg["horizon"]
    assert a["counts"].shape == (H, D)
    assert a["stream"].shape[1] >= a["counts"].sum(axis=0).max()
    assert a["stream"].max() < len(cfg["classes"])


def test_lm_inputs_repeat_from_the_seed():
    cfg = dict(common.load_json("configs", "granite-moe-3b-a800m"),
               **TINY["granite-moe-3b-a800m"])
    cpu = torch.device("cpu")
    p1 = lmgen.make_params(cfg, common.stream_seed(9, 0), cpu)
    p2 = lmgen.make_params(cfg, common.stream_seed(9, 0), cpu)
    p3 = lmgen.make_params(cfg, common.stream_seed(10, 0), cpu)
    assert torch.equal(p1["blocks"][0]["we_gate"], p2["blocks"][0]["we_gate"])
    assert not torch.equal(p1["embed"], p3["embed"])
    assert float(p1["final_norm"].abs().max()) == 0.0
    t1 = lmgen.token_pool(2, 16, 250, common.stream_seed(9, 1), cpu)
    t2 = lmgen.token_pool(2, 16, 250, common.stream_seed(9, 1), cpu)
    assert torch.equal(t1, t2) and int(t1.max()) < 250
    # the parameter count of the published widths: 3.37 B
    full = common.load_json("configs", "granite-moe-3b-a800m")
    n = sum(math.prod(s) for _n, s, _sc in lmgen.leaves(full))
    assert 3.36e9 < n < 3.38e9


def test_frozen_counts_match_hand_worked_shapes():
    assert work.live_pairs(4, 4, "causal") == 10
    assert work.live_pairs(1, 9, "causal") == 9
    assert work.live_pairs(3, 5, "none") == 15
    assert work.live_pairs(4, 4, "window", 2) == 7
    nb, fl = work.flash_work(2, 4, 4, 6, 2, 8, "causal", 0, 2)
    assert nb == 2 * 8 * (2 * 2 * 6 * 4 + 2 * 2 * 2 * 4)
    assert fl == 4 * 8 * 2 * 6 * 10
    nb, fl = work.decode_work(3, 6, 2, 8, 11, 2, 1)
    assert nb == 2 * 2 * 3 * 6 * 8 + 1 * 2 * 3 * 2 * 11 * 8
    assert fl == 4 * 8 * 3 * 6 * 11
    full = common.load_json("configs", "granite-moe-3b-a800m")
    d, L = 1536, 32
    per_layer = d * 1536 * 2 + d * 512 * 2 + d * 40 + 8 * 3 * d * 512
    assert work.lm_matmul_flops_per_token(full) == 2 * (
        L * per_layer + d * 49280)
    assert work.lm_attention_flops(full, 2, 3, 3) == 4 * 64 * 24 * 2 * L * 6
    assert work.bound_s(3.35e12, 0, 1) == pytest.approx(1.0)


def test_reduced_pivot_work_by_hand():
    # one lane, R = 2 rows, C0 = 3 columns, Dantzig (all columns priced),
    # a pivot: every byte term of the docstring
    A = torch.tensor([[[1.0, 2.0, 0.0], [0.0, 1.0, 1.0]]], dtype=torch.float64)
    c = torch.tensor([[-1.0, -3.0, 0.0]], dtype=torch.float64)
    Binv = torch.eye(2, dtype=torch.float64)[None]
    basis = torch.tensor([[0, 2]], dtype=torch.int32)
    t, f = torch.tensor([True]), torch.tensor([False])
    nb, fl = work.reduced_pivot_work(A, c, Binv, basis, f, t, t, t, f,
                                     art_cost=0.0, tol=1e-9)
    R, C0 = 2, 3
    assert nb == ((1 + R * R * 8 + R * 8 + R * 4 + 3) + C0 * R * 8
                  + C0 * 8 + 1 + 1 + (R * R * 8 + R * 8 + 4))
    assert fl == 2 * R * R + C0 * (2 * R + 1) + (2 * R * R + R) \
        + 2 * R * (R + 1)


@pytest.mark.parametrize("workload", ["fleet102k-replay",
                                      "granite3b-es-offload",
                                      "granite3b-es-decode"])
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_has_exactly_the_contract_keys(tmp_path, workload,
                                                    trace):
    line = run_tiny(tmp_path, workload, trace=trace)
    assert list(line)[:5] == KEYS
    assert set(line) == set(KEYS) | {"checks"} | (
        {"breakdown"} if trace else set())
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    cell = common.cell(common.load_benchmark(ROOT), workload)
    if not trace:
        assert set(line["metrics"]) == {m["name"]
                                        for m in cell["end_to_end"]}
    else:
        assert set(line["metrics"]) <= {m["name"] for m in cell["per_layer"]}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "window_s" in line["device"] and "busy_s" in line["device"]


@pytest.mark.parametrize("workload", ["fleet102k-replay",
                                      "granite3b-es-offload",
                                      "granite3b-es-decode"])
def test_a_cell_loads_no_jax_and_no_jax_package(workload):
    """Each cell's driver, its generators and its reference, imported in a
    fresh process: no module whose top-level name is ``jax``, ``jaxlib``,
    ``flax`` or ``repro`` (compared whole; ``repro_torch`` is the
    port)."""
    code = (
        "import sys, importlib\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        "from portbench import common\n"
        f"cell = common.cell(common.load_benchmark(), {workload!r})\n"
        "t = common.load_json('traffic', cell['traffic'])\n"
        "importlib.import_module('portbench.drivers.' + t['driver'])\n"
        "import portbench.run, portbench.control, portbench.trace\n"
        "for m in cell['per_layer']:\n"
        "    common.load_module('metrics', m['name'])\n"
        "import repro_torch.api.engine, repro_torch.models\n"
        "print(common.forbidden_loaded())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout
    assert common.forbidden_loaded({"repro_torch": 1, "reprox": 1}) == []
    assert common.forbidden_loaded({"repro.core": 1, "jax.numpy": 1}) == [
        "jax.numpy", "repro.core"]


def test_run_refuses_without_a_card(tmp_path):
    """No result and a non-zero exit where no card is visible (as here),
    and in a folder that holds only the benchmark's files."""
    import shutil
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "fleet102k-replay", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""
