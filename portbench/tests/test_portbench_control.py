"""The comparison's control: the plain reference one precision below the
configuration's, put in the program's place, judged by the cells' own
comparison.  At tiny sizes on the CPU the fleet's float32 control must
fail the cells' limits while the program passes them.  The limits of the
model's cells are the card's, set from `portbench/control.py`'s readings
at the cells' own sizes, where the float8 control reads about ten times
the program's mean gap; at a tiny size both read lower, so there the
control must read at least three times the program's, and the card's
readings, judged by the same comparison, must fail for the control and
pass for the program."""
from __future__ import annotations

import importlib
import time

import pytest
import torch

from helpers import tiny_copy
from portbench import common, control


def _driver(tmp_path, workload, seed):
    here = tiny_copy(tmp_path)
    cell = common.cell(common.load_benchmark(tmp_path), workload)
    traffic = common.load_json("traffic", cell["traffic"], here)
    mod = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    drv = mod.Driver(common.load_json("configs", cell["config"], here),
                     traffic, seed, torch.device("cpu"))
    common.timed_window(0.5, drv.step, time.perf_counter)
    drv.release()
    return mod, drv


@pytest.mark.parametrize("workload", ["fleet102k-replay", "fleet102k-chaos"])
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_fleet_float32_control_fails_the_limits(tmp_path, workload, seed):
    mod, drv = _driver(tmp_path, workload, seed)
    program, low = control.fleet_readings(drv)
    assert all(c["ok"] for c in program["checks"]), program
    assert not all(c["ok"] for c in low["checks"]), low
    assert [c["name"] for c in low["checks"]] == list(mod.LIMITS)


@pytest.mark.parametrize("workload", ["granite3b-es-offload",
                                      "granite3b-es-decode"])
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_lm_float8_control_reads_far_above_the_program(tmp_path, workload,
                                                       seed):
    mod, drv = _driver(tmp_path, workload, seed)
    program, low = control.lm_readings(drv, mod.LIMITS)
    assert all(c["ok"] for c in program["checks"]), program
    assert low["mean"] > 3 * program["mean"], (program, low)


# the card's readings of the mean gap at the cells' own sizes (PERF.md
# section 2): the program's largest over its seeds, the control's least
CARD_READINGS = {
    "granite3b-es-offload": {"program": 0.00466, "control": 0.0395},
    "granite3b-es-decode": {"program": 0.00385, "control": 0.0384},
}


@pytest.mark.parametrize("workload", sorted(CARD_READINGS))
def test_lm_card_readings_judged_by_the_cells_comparison(workload):
    from portbench.reference import lm_ref
    cell = common.cell(common.load_benchmark(), workload)
    traffic = common.load_json("traffic", cell["traffic"])
    limits = importlib.import_module(
        f"portbench.drivers.{traffic['driver']}").LIMITS
    reading = CARD_READINGS[workload]
    for side, ok in (("program", True), ("control", False)):
        checks = lm_ref.judge(torch.tensor([reading[side]]), limits)
        assert all(c["ok"] for c in checks) is ok, (side, checks)
