"""Tiny cells for the harness's CPU tests: a copy of the benchmark's files
in a temporary folder, its configurations cut to sizes the CPU runs in
seconds, and runs of `run.run_cell` on the CPU."""
from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

TINY = {
    "fleet-scale-102k": dict(n_devices=96, n_servers=6),
    "granite-moe-3b-a800m": dict(
        num_hidden_layers=2, hidden_size=128, num_attention_heads=4,
        num_key_value_heads=2, intermediate_size=64, num_local_experts=16,
        num_experts_per_tok=4, vocab_size=1000),
}
TINY_TRAFFIC = {
    "es_offload": dict(classes=[8, 16, 32], tokens_per_step=64),
    "es_decode": dict(batch=4, prompt_len=32, max_seq=2048),
}


def tiny_copy(tmp: Path) -> Path:
    """A checkout-like folder: ``BENCHMARK.json`` and ``portbench/`` with
    tiny configurations and traffic; returns the copy of ``portbench``."""
    dst = tmp / "portbench"
    shutil.copytree(HERE, dst, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for kind, cuts in (("configs", TINY), ("traffic", TINY_TRAFFIC)):
        for name, cut in cuts.items():
            path = dst / kind / f"{name}.json"
            data = json.loads(path.read_text())
            data.update(cut)
            path.write_text(json.dumps(data))
    return dst


def run_tiny(tmp: Path, workload: str, *, seed: int = 3,
             seconds: float = 0.5, trace: int = 0) -> dict:
    """One run of a tiny cell on the CPU; the parsed result line."""
    import torch
    from portbench import common, run
    here = tiny_copy(tmp)
    bench = common.load_benchmark(tmp)
    cell = common.cell(bench, workload)
    args = SimpleNamespace(seed=seed, seconds=seconds, trace=trace)
    line = run.run_cell(cell, args, torch.device("cpu"), time.perf_counter(),
                        here=here)
    return json.loads(line)
