"""What every driver of the port's benchmark shares: finding a cell's
files by name, the chip check, the module check, percentiles, and the
result line.

Everything a cell needs is found by the names in ``BENCHMARK.json``:

* ``configs/<config>.json``: the configuration, as it is run;
* ``traffic/<traffic>.json``: the traffic mix, whose ``driver`` names the
  module ``drivers/<driver>.py`` that runs it;
* ``metrics/<metric>.py``: one reader per per-layer metric, whose
  ``read(ctx)`` returns the metric or None when the cell gives it
  nothing to read.

So a later change adds a configuration, a mix, a driver or a metric by
adding files and entries, and edits none.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# top-level module names that may not be loaded in a run's process: the
# JAX package and JAX itself, compared whole (the port's name begins with
# the JAX package's)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(kind: str, name: str, here: Path = HERE) -> Dict[str, Any]:
    """``<here>/<kind>/<name>.json``: a configuration or a traffic mix."""
    path = here / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str, here: Path = HERE):
    """``<here>/<kind>/<name>.py`` as a module (names may hold dots, so it
    is loaded by its path, not imported by name)."""
    path = here / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(bench: Dict[str, Any], workload: str) -> Dict[str, Any]:
    """The cell ``workload`` with its configuration, traffic, end-to-end
    and per-layer metric declarations."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r}; BENCHMARK.json has "
                       f"{sorted(cells)}")
    w = cells[workload]

    def applies(metric):
        return workload in metric.get("workloads", [workload])
    return dict(w, end_to_end=[m for m in bench["end_to_end"] if applies(m)],
                per_layer=[m for m in bench["per_layer"] if applies(m)])


def forbidden_loaded(modules=None) -> List[str]:
    """Names in ``sys.modules`` whose top-level name is forbidden."""
    modules = sys.modules if modules is None else modules
    return sorted({name for name in modules
                   if name.split(".", 1)[0] in FORBIDDEN_MODULES})


def quantile(values: Sequence[float], q: float) -> float:
    """The ``q`` quantile (0 < q < 1) by linear interpolation between
    order statistics (numpy's default rule)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def stream_seed(seed: int, stream: int) -> int:
    """A 64-bit seed for one stream of draws of a run, from the run's
    ``--seed`` (any whole number, negative and large ones too)."""
    import numpy as np
    return int(np.random.SeedSequence(
        [int(seed) % (1 << 64), stream]).generate_state(1, np.uint64)[0])


def read_metrics(per_layer: Sequence[Dict[str, Any]], ctx: Dict[str, Any],
                 here: Path = HERE) -> Dict[str, Dict[str, Any]]:
    """Each declared per-layer metric from its reader; a reader that finds
    nothing to read returns None and the metric is left out."""
    out = {}
    for m in per_layer:
        value = load_module("metrics", m["name"], here).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(*, correct: bool, attempted: int, failed: int,
                metrics: Dict[str, Dict[str, Any]], device: Dict[str, Any],
                breakdown: Optional[Dict[str, Any]],
                checks: List[Dict[str, Any]]) -> str:
    """The last line of standard output; ``checks`` (each number compared
    beside its limit) comes last."""
    line: Dict[str, Any] = {"correct": bool(correct), "attempted": attempted,
                            "failed": failed, "metrics": metrics,
                            "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    return json.dumps(line)


def check_lines(checks: List[Dict[str, Any]]) -> List[str]:
    """The compared numbers as lines for standard error."""
    return [f"check {c['name']}: {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['ok'] else 'FAILED'}" for c in checks]


def compared(name: str, value: float, limit: float) -> Dict[str, Any]:
    """One number held to its upper limit (NaN fails)."""
    value = float(value)
    return {"name": name, "value": value, "limit": limit,
            "ok": bool(value <= limit)}


def timed_window(seconds: float, step: Callable[[int], None],
                 clock: Callable[[], float]) -> List[float]:
    """Run ``step(i)`` back to back until ``seconds`` have passed on
    ``clock``; each step ends synchronised.  Returns every step's
    duration (the window is their sum)."""
    times: List[float] = []
    start = clock()
    end = start + seconds
    t = start
    i = 0
    while t < end:
        step(i)
        now = clock()
        times.append(now - t)
        t = now
        i += 1
    return times
