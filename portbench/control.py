"""Readings that the limits of the benchmark's comparison are set from:
the program's compared numbers and the control's, for a cell, seed
after seed, in one process.

    python3 portbench/control.py --workload <name> --seeds 1 2 3 \
        [--seconds 5]

The control is the plain reference one precision below the
configuration's in the program's place: the fleet's period in float32
(for float64), the model with every product's operands in float8 e4m3
(for bfloat16).  Each seed runs the cell's driver for ``--seconds``,
then reads the compared numbers of the program and of the control on
the same checked answers, and judges both by the cell's own comparison
(``checks``: each number beside its limit); one JSON line per seed on
standard output.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def fleet_readings(drv):
    """Program and control readings of every checked period."""
    import numpy as np
    import torch
    from portbench import common
    from portbench.drivers import fleet
    from portbench.reference import fleet_ref
    arr = {k: torch.as_tensor(np.asarray(v), device=drv.device)
           for k, v in drv.arrays.items()}
    checks = drv.check()
    program = dict({c["name"]: c["value"] for c in checks}, checks=checks)
    picks = dict(drv.kept)
    i, before, after, m = drv.last
    picks[i] = (before, after, m)
    worst = {k: 0.0 for k in fleet.LIMITS}
    for i, (before, _after, _m) in sorted(picks.items()):
        args = (arr, before, i % drv.H, drv.cfg, drv.traffic)
        low = fleet_ref.period(*args, dtype=torch.float32)
        ref = fleet_ref.period(*args, verdicts={
            "ed": low["ed_updated"], "es": low["es_updated"]})
        as_state = type("S", (), {
            "pending": low["pending"], "head": low["head"],
            "p_ed": low["p_ed"].double(),
            "p_es_belief": low["p_es_belief"].double()})
        as_metrics = type("M", (), {k: low[k] for k in low})
        worst = fleet.worst_of(worst, fleet.compare(ref, as_state,
                                                    as_metrics))
    control = dict(worst, checks=[common.compared(k, worst[k],
                                                  fleet.LIMITS[k])
                                  for k in fleet.LIMITS])
    return program, control


def lm_readings(drv, limits):
    """Gaps of the program's answers and of the control's at the same
    positions, with their spread (max, 99.9th and 99th percentiles,
    mean, share of positions off the reference's best)."""
    import torch
    from portbench.reference import lm_ref

    def stats(g):
        g = g.float()
        return {"max": float(g.max()),
                "p999": float(torch.quantile(g, 0.999)),
                "p99": float(torch.quantile(g, 0.99)),
                "mean": float(g.mean()),
                "off": float((g > 0).float().mean())}
    prog, ctrl, each = [], [], []
    for tok, answers, kw in drv.checked_batches():
        with torch.no_grad():
            ref = lm_ref.forward_logits(drv.params, tok, drv.cfg, **kw)
            prog.append(lm_ref.gaps(ref, answers).flatten())
            low = lm_ref.forward_logits(drv.params, tok, drv.cfg,
                                        quant=True, **kw)
            ctrl.append(lm_ref.gaps(ref, low.argmax(-1)).flatten())
            each.append({"answers": int(answers.numel()),
                         "distinct": int(answers.unique().numel()),
                         "program_mean": float(prog[-1].mean()),
                         "control_mean": float(ctrl[-1].mean())})
            del ref, low
    program, control = stats(torch.cat(prog)), stats(torch.cat(ctrl))
    program["checks"] = lm_ref.judge(torch.cat(prog), limits)
    control["checks"] = lm_ref.judge(torch.cat(ctrl), limits)
    program["batches"] = each
    return program, control


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    for path in (str(ROOT / "src"), str(ROOT)):
        if path not in sys.path:
            sys.path.insert(0, path)
    import importlib
    import torch
    from portbench import common
    cell = common.cell(common.load_benchmark(ROOT), args.workload)
    config = common.load_json("configs", cell["config"])
    traffic = common.load_json("traffic", cell["traffic"])
    mod = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        drv = mod.Driver(config, traffic, seed, device)
        common.timed_window(args.seconds, drv.step, time.perf_counter)
        drv.release()
        if traffic["driver"] == "fleet":
            program, control = fleet_readings(drv)
        else:
            program, control = lm_readings(drv, mod.LIMITS)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": program, "control": control,
                          "seconds": time.perf_counter() - t0}), flush=True)
        del drv
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
