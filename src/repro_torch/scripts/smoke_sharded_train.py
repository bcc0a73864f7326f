"""Sharded train step smoke: `launch.steps.make_train_step` on parameters
distributed over a ("data", "model") `DeviceMesh` by the base rules must
equal the same step unsharded (ROADMAP §1 item 13).

    python -m repro_torch.scripts.smoke_sharded_train --ranks 8 \\
        --mesh 4x2 --arch internlm2_20b --steps 3 --device cpu

Spawns ``--ranks`` gloo ranks (`distributed.ranks.run_ranks`); each
builds the mesh (`launch.mesh.make_mesh`), the SMOKE model's parameters
from ``--seed`` (the same on every rank), distributes them with
`tree_shardings(param_axes(cfg), mesh, base_rules())`, and runs
``--steps`` AdamW steps at ``--lr`` on one float32 batch of
``--batch`` x ``--seq`` tokens inside `sharding_context` (the optimizer
state follows the parameters' placements).  This process runs the same
steps unsharded.  Each rank's losses and gradient norms must equal the
unsharded ones to rtol `LOSS_RTOL`, and so must the loss on the final
parameters (the last update's check); those parameters (gathered) must
be within `PARAM_ATOL_LR` times the learning rate of them, and the loss
must fall.  Prints one JSON
line, then the verdict; returns 0 or 1.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Dict, Optional

import numpy as np

LOSS_RTOL = 1e-5
# every parameter within lr / 10 of the unsharded step's: an Adam step on
# an element whose gradient is within rounding of zero takes another
# size (internlm2's SMOKE, 3 steps at lr 1e-2 on a 4 x 2 mesh: at most
# 3.5e-4 under torch 2.13, 7.3e-4 under 2.11), so the last update is held
# by the loss on the final parameters, to LOSS_RTOL
PARAM_ATOL_LR = 1 / 10


def run_steps(cfg, params, batch, steps: int, lr: float, *, mesh=None,
              rules=None) -> Dict[str, Any]:
    """``steps`` train steps from fresh AdamW state: losses, the gradients'
    global norms, the loss on the final parameters (``final_loss``, the
    train step's own path), the final parameters and optimizer state.  With a
    ``mesh`` the parameters are distributed by ``rules`` (the base rules
    by default) and the steps run inside `sharding_context`."""
    import contextlib

    from ..distributed import sharding as sh
    from ..launch.steps import make_train_step, value_and_grad
    from ..models import param_axes
    from ..optim import adamw_init, global_norm
    norms = []

    def keep(g):
        norms.append(global_norm(g))
        return g
    ctx = contextlib.nullcontext()
    if mesh is not None:
        rules = rules or sh.base_rules()
        params = sh.distribute_tree(
            params, sh.tree_shardings(param_axes(cfg), mesh, rules))
        ctx = sh.sharding_context(mesh, rules)
    step = make_train_step(cfg, lr=lr, grad_tx=keep)
    losses = []
    with ctx:
        opt = adamw_init(params)
        for _ in range(steps):
            params, opt, loss = step(params, opt, batch)
            losses.append(loss)
        final, _ = value_and_grad(params, batch, cfg)
    return {"losses": [float(sh.whole(x)) for x in losses],
            "grad_norms": [float(sh.whole(x)) for x in norms],
            "final_loss": [float(sh.whole(final))],
            "params": params, "opt": opt}


def to_numpy(tree):
    """A tree's tensors, DTensors gathered whole, as NumPy arrays."""
    from .. import _tree
    from ..distributed.sharding import whole
    return _tree.tree_map(lambda t: whole(t).detach().cpu().numpy(), tree)


def smoke_config(arch: str, dtype: str = "float32", **overrides):
    from ..configs import get_smoke_config
    return dataclasses.replace(get_smoke_config(arch), dtype=dtype,
                               **overrides)


def sharded_rank(rank: int, world: int, mesh_shape, arch: str, params_np,
                 tokens: np.ndarray, steps: int, lr: float,
                 overrides: Optional[Dict[str, Any]] = None,
                 shard_batch: bool = False) -> Dict[str, Any]:
    """One gloo rank of the smoke: its losses, gradient norms and final
    loss; rank 0 also the final parameters, gathered, as NumPy.
    ``overrides`` replace fields of the SMOKE config.  With
    ``shard_batch`` the tokens are a DTensor split over "batch" by the
    base rules, as the dry run hands them over; else every rank is given
    them whole."""
    import torch

    from ..convert import model_params_from_numpy
    from ..distributed import sharding as sh
    from ..launch.mesh import make_mesh
    cfg = smoke_config(arch, **(overrides or {}))
    mesh = make_mesh(mesh_shape, ("data", "model"))
    params = model_params_from_numpy(params_np, device="cpu")
    batch = {"tokens": torch.as_tensor(tokens)}
    if shard_batch:
        batch = sh.distribute_tree(batch, sh.tree_shardings(
            {"tokens": ("batch", "seq")}, mesh, sh.base_rules()))
    t0 = time.perf_counter()
    out = run_steps(cfg, params, batch, steps, lr, mesh=mesh)
    seconds = time.perf_counter() - t0
    full = to_numpy(out["params"])
    return {"losses": out["losses"], "grad_norms": out["grad_norms"],
            "final_loss": out["final_loss"], "seconds": seconds,
            "params": full if rank == 0 else None}


def compare(got: Dict[str, Any], want: Dict[str, Any], lr: float
            ) -> Optional[str]:
    """None when ``got`` (a rank's) equals ``want`` (the unsharded run's)
    within the smoke's bars, else what differs."""
    from .. import _tree
    for key in ("losses", "grad_norms", "final_loss"):
        g, w = np.asarray(got[key]), np.asarray(want[key])
        if g.shape != w.shape or not np.allclose(g, w, rtol=LOSS_RTOL,
                                                 atol=0.0):
            return f"{key} {g.tolist()} against {w.tolist()}"
    if got.get("params") is not None:
        d = [np.abs(a - b) for a, b in zip(_tree.leaves(got["params"]),
                                           _tree.leaves(want["params"]))]
        worst = max(float(x.max()) for x in d)
        loose = sum(int((x > 1e-5).sum()) for x in d)
        total = sum(x.size for x in d)
        if worst > PARAM_ATOL_LR * lr:
            return (f"parameters differ by up to {worst}, {loose} of "
                    f"{total} by more than 1e-5")
    return None


def main(argv=None) -> int:
    import torch

    from ..convert import model_params_from_numpy
    from ..distributed.ranks import run_ranks
    from ..models import init_params
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--mesh", default="4x2", help="data x model")
    ap.add_argument("--arch", default="internlm2_20b")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu (gloo ranks); the card's run is "
                         "chip_smoke.py's lm_sharded phase")
    args = ap.parse_args(argv)
    if args.device != "cpu":
        raise RuntimeError("the ranks of this smoke run on the CPU (gloo); "
                           "pass --device cpu")
    mesh_shape = tuple(int(n) for n in args.mesh.split("x"))
    cfg = smoke_config(args.arch)
    params = init_params(cfg, args.seed, device="cpu")
    params_np = to_numpy(params)
    tokens = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (args.batch, args.seq)).astype(np.int32)
    want = run_steps(cfg, model_params_from_numpy(params_np, "cpu"),
                     {"tokens": torch.as_tensor(tokens)}, args.steps,
                     args.lr)
    want["params"] = to_numpy(want["params"])
    ranks = run_ranks(sharded_rank, args.ranks,
                      args=(mesh_shape, args.arch, params_np, tokens,
                            args.steps, args.lr))
    faults = {r: compare(res, want, args.lr) for r, res in enumerate(ranks)}
    faults = {r: f for r, f in faults.items() if f}
    if want["losses"][-1] >= want["losses"][0]:
        faults["loss"] = f"did not fall: {want['losses']}"
    print(json.dumps({"smoke_sharded_train": {
        "arch": args.arch, "mesh": args.mesh, "ranks": args.ranks,
        "losses": want["losses"], "grad_norms": want["grad_norms"],
        "rank_seconds": [r["seconds"] for r in ranks],
        "faults": faults}}), flush=True)
    print("[sharded-train-smoke] " + ("ok" if not faults else "FAILED"))
    return 0 if not faults else 1


if __name__ == "__main__":
    raise SystemExit(main())
