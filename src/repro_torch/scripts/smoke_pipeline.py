"""Pipeline smoke: `distributed.pipeline.pipeline_apply` over S ranks
must equal the sequential loop (port of the reference's pipeline check in
`tests/test_distributed.py`).

    python -m repro_torch.scripts.smoke_pipeline --stages 4 \\
        --microbatches 4 --device cpu

Spawns ``--stages`` gloo ranks (`distributed.ranks.run_ranks`) with a
1-D ``("stage",)`` mesh; stage s applies ``tanh(h @ W[s])`` to a (B, D)
batch in ``--microbatches`` microbatches.  Every rank's result must equal
``x -> tanh(x @ W[0]) -> ... -> tanh(. @ W[S-1])`` to `ATOL`, after
M + S - 1 ticks.  W and x come from ``--seed`` (NumPy).  Prints one JSON
line, then the verdict; returns 0 or 1.
"""
from __future__ import annotations

import argparse
import json
from typing import Any, Dict

import numpy as np

ATOL = 1e-5


def stage_fn(W, h):
    import torch
    return torch.tanh(h @ W)


def inputs(stages: int, batch: int, width: int, seed: int):
    """(W (S, D, D) * 0.3, x (B, D)), float32, from a NumPy seed."""
    rng = np.random.default_rng(seed)
    W = (rng.standard_normal((stages, width, width)) * 0.3).astype(
        np.float32)
    return W, rng.standard_normal((batch, width)).astype(np.float32)


def sequential(W: np.ndarray, x: np.ndarray) -> np.ndarray:
    import torch
    h = torch.as_tensor(x)
    for s in range(W.shape[0]):
        h = stage_fn(torch.as_tensor(W[s]), h)
    return h.numpy()


def pipeline_rank(rank: int, world: int, W: np.ndarray, x: np.ndarray,
                  microbatches: int, device: str = "cpu") -> Dict[str, Any]:
    """One stage: (the pipeline's result on this rank, its stats)."""
    import torch

    from ..distributed.pipeline import pipeline_apply
    from ..launch.mesh import make_mesh
    mesh = make_mesh((world,), ("stage",))
    stats: Dict[str, Any] = {}
    y = pipeline_apply(stage_fn, torch.as_tensor(W, device=device),
                       torch.as_tensor(x, device=device), mesh=mesh,
                       microbatches=microbatches, stats=stats)
    return {"y": y.cpu().numpy(), "stats": stats}


def main(argv=None) -> int:
    from ..distributed.ranks import run_ranks
    ap = argparse.ArgumentParser()
    ap.add_argument("--stages", type=int, default=4)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--width", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu (gloo ranks); the card's run is "
                         "chip_smoke.py's pipeline phase")
    args = ap.parse_args(argv)
    if args.device != "cpu":
        raise RuntimeError("the ranks of this smoke run on the CPU (gloo); "
                           "pass --device cpu")
    W, x = inputs(args.stages, args.batch, args.width, args.seed)
    want = sequential(W, x)
    ranks = run_ranks(pipeline_rank, args.stages,
                      args=(W, x, args.microbatches))
    errs = [float(np.abs(r["y"] - want).max()) for r in ranks]
    ticks = ranks[0]["stats"]["ticks"]
    ok = max(errs) <= ATOL and ticks == args.microbatches + args.stages - 1
    print(json.dumps({"smoke_pipeline": {
        "stages": args.stages, "microbatches": args.microbatches,
        "ticks": ticks, "max_abs_err": errs,
        "sends": [r["stats"]["sends"] for r in ranks]}}), flush=True)
    print("[pipeline-smoke] " + ("ok" if ok else "FAILED"))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
