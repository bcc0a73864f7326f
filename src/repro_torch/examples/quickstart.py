"""Quickstart tour: model -> train step -> prefill/decode -> offload plan
(port of `examples/quickstart.py`).

    python -m repro_torch.examples.quickstart [--device cpu] [--seed 0]

1. internlm2's SMOKE model (the 20B's code path at a reduced width);
2. three AdamW train steps at lr 1e-2 on one batch of 4 x 32 tokens;
3. prefill of the batch's first 24 tokens, then 4 greedy decode steps;
4. the paper's planner: `solve(paper_instance(30, T=2.0, seed=0))`
   through the registry's front door (policy "auto"), with the plan's
   `summary()` and jobs per model (`counts()`).

The weights and tokens come from ``--seed`` (torch's generator: other
numbers than the reference's `jax.random` draws); `main` also takes
carried-over ``params`` and ``tokens`` (and a ``cfg``), which is how a
test holds the tour to the reference's.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Optional

import torch


def main(argv=None, *, cfg=None, params=None,
         tokens: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """Run the tour; returns the losses, the decoded tokens and index, the
    plan's solver, summary and counts."""
    from .._device import resolve_device
    from ..api import solve
    from ..configs import get_smoke_config
    from ..core import paper_instance
    from ..launch.steps import make_train_step
    from ..models import decode_step, init_params, prefill
    from ..optim import adamw_init

    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. a reduced internlm2-family model (same code path as the 20B)
    cfg = cfg or get_smoke_config("internlm2_20b")
    if params is None:
        params = init_params(cfg, args.seed, device=dev)
    print(f"model: {cfg.name}  params={cfg.param_count():,} (analytic, "
          f"full config would be {cfg.param_count():,})")

    # 2. a couple of train steps
    step = make_train_step(cfg, lr=1e-2)
    opt = adamw_init(params)
    if tokens is None:
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        tokens = torch.randint(0, cfg.vocab_size, (4, 32), generator=gen,
                               device=dev)
    batch = {"tokens": torch.as_tensor(tokens, device=dev)}
    losses = []
    for i in range(3):
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))
        print(f"train step {i}: loss {losses[-1]:.4f}")

    # 3. prefill + a few decode steps
    cache, logits = prefill(params, {"tokens": batch["tokens"][:, :24]},
                            cfg, max_seq=32)
    toks = torch.argmax(logits, -1)
    decoded = [toks]
    for _ in range(4):
        logits, cache = decode_step(params, toks, cache, cfg)
        toks = torch.argmax(logits, -1)
        decoded.append(toks)
    print(f"decoded to index {int(cache['index'])}")

    # 4. the paper: plan a batch of 30 inference jobs under a 2 s budget
    inst = paper_instance(30, T=2.0, seed=0)
    sol = solve(inst, device=dev)       # registry front door, policy="auto"
    sched = sol.to_schedule()
    print(f"offload plan [{sol.solver}]: {sched.summary()}")
    print(f"jobs per model: {sched.counts()}  (last = offloaded to ES tier)")
    return {"losses": losses, "index": int(cache["index"]),
            "decoded": torch.cat(decoded, dim=1).cpu(),
            "solver": sol.solver, "summary": sched.summary(),
            "counts": sched.counts()}


if __name__ == "__main__":
    main()
