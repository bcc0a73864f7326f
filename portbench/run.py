"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds ``src/repro_torch``.  The run
sets up the cell (counted as ``setup_s``), measures for ``--seconds``,
then, with ``--trace 1``, profiles a few more steps for the per-layer
metrics; once the program's state is freed, it works a sample of the
window's answers out again with the plain reference and prints every
compared number beside its limit, on standard error and as the last key
of the result, the last line of standard output.  It exits non-zero,
printing no result, when the card is missing, when a module of JAX or of
the JAX package is loaded, or when the program cannot be imported.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    """Caches inside the checkout at fixed paths; no JAX behind a
    library's back; one host thread for the CPU's own kernels, so that
    the process launching the card's work is the only load it makes."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for path in (str(ROOT / "src"), str(ROOT)):
        if path not in sys.path:
            sys.path.insert(0, path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    _environment()
    from portbench import common
    bench = common.load_benchmark(ROOT)
    cell = common.cell(bench, args.workload)
    import torch
    torch.set_num_threads(1)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < int(cell["chips"]):
        print(f"needs {cell['chips']} CUDA card(s); {cards} visible",
              file=sys.stderr)
        return 3
    try:
        import repro_torch  # noqa: F401
    except ImportError as err:
        print(f"the program is not in this checkout: {err}", file=sys.stderr)
        return 4
    line = run_cell(cell, args, torch.device("cuda", 0), t_start)
    found = common.forbidden_loaded()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 5
    print(line)
    return 0


def run_cell(cell, args, device, t_start: float, here=None) -> str:
    """Set up, measure, trace, check; the result line.  ``device`` is the
    card, or the CPU in the harness's own tests (``here``: the folder
    whose files are read)."""
    import importlib
    import torch
    from portbench import common, trace
    here = common.HERE if here is None else here
    config = common.load_json("configs", cell["config"], here)
    traffic = common.load_json("traffic", cell["traffic"], here)
    driver_mod = importlib.import_module(
        f"portbench.drivers.{traffic['driver']}")
    card = device.type == "cuda"
    t_imported = time.perf_counter()
    if card:
        torch.cuda.init()
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    t_card = time.perf_counter()
    drv = driver_mod.Driver(config, traffic, args.seed, device)
    if card:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    print(f"set-up: {setup_s!r} s: imports {t_imported - t_start!r}, card "
          f"{t_card - t_imported!r}, inputs and warm-up "
          f"{t_start + setup_s - t_card!r}", file=sys.stderr)
    times = common.timed_window(args.seconds, drv.step, time.perf_counter)
    print(f"window: {len(times)} steps in {sum(times)!r} s; step ms "
          f"median {common.quantile(times, 0.5) * 1e3!r}, 5th "
          f"{common.quantile(times, 0.05) * 1e3!r}, 95th "
          f"{common.quantile(times, 0.95) * 1e3!r}, max "
          f"{max(times) * 1e3!r}", file=sys.stderr)
    attempted, failed = drv.outcome()
    e2e = dict(drv.end_to_end(times), setup_s=setup_s)
    breakdown = None
    dev_info = {"platform": "gpu" if card else "cpu",
                "kind": torch.cuda.get_device_name(device) if card else "cpu",
                "count": 1}
    if args.trace:
        ctx = drv.layer_context(times)
        summary, extra = drv.traced(lambda run: trace.profile(run, torch))
        ctx.update(extra, trace=summary)
        metrics = common.read_metrics(cell["per_layer"], ctx, here)
        dev_info.update(busy_s=summary["busy_s"],
                        window_s=summary["window_s"])
        breakdown = {"device_ops": summary["device_ops"],
                     "idle_gaps": summary["idle_gaps"]}
    else:
        metrics = {m["name"]: {"value": float(e2e[m["name"]]),
                               "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    dev_info["memory_peak_bytes"] = (
        int(torch.cuda.max_memory_allocated(device)) if card else 0)
    drv.release()
    if card:
        torch.cuda.empty_cache()
    checks = drv.check()
    for text in common.check_lines(checks):
        print(text, file=sys.stderr)
    return common.result_line(
        correct=all(c["ok"] for c in checks), attempted=attempted,
        failed=failed, metrics=metrics, device=dev_info,
        breakdown=breakdown, checks=checks)


if __name__ == "__main__":
    sys.exit(main())
