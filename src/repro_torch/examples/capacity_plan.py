"""Gradient-based capacity planning against grid search, on the same
budget (port of `examples/capacity_plan.py`).

    python -m repro_torch.examples.capacity_plan [--devices 64]
        [--periods 6] [--slo-margin 1.02] [--budget 49] [--seed 0]
        [--device cpu]

The operator question: how much edge-server capacity (and how aggressive
a model-ladder mix) does this fleet need to meet an accuracy SLO?  Two
knobs reparameterize the engine's continuous leaves:

  * ``log_cap``: server-capacity scale, ``p_es * exp(-log_cap)`` (a larger
    knob is a faster ES, more admitted offloads);
  * ``mix``: ladder-mix logit, ``acc * 2 * sigmoid(mix)`` rescales the
    accuracy ladder.

Both planners search the same 2-D space for the cheapest point meeting
the SLO (mean served accuracy per device-period):

  * *grid search*: a lattice scan within the budget, one rollout a point;
  * *gradient descent*: Adam (`torch.optim.Adam`) on a penalized SLO loss,
    fed by `rollout_value_and_grad` (`EngineParams.with_differentiable`):
    the epoch differentiates in one backward sweep through the
    implicit-gradient simplex (the pivot kernels forward, the KKT adjoint
    backward), the smoothed rounding and the sigmoid-relaxed admission.
    Straight-through mode reports the hard rollout's value, so the SLO is
    met on the real metric.

Prints both trajectories and exits 1 unless the gradient planner meets
the SLO in fewer rollout evaluations than the grid scan.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np


def sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def main(argv=None) -> int:
    import torch

    from .._device import resolve_device
    from ..api import engine as E
    from ..serving.fleet import H100_ES, FleetConfig

    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=64)
    ap.add_argument("--periods", type=int, default=6)
    ap.add_argument("--slo-margin", type=float, default=1.02,
                    help="SLO = margin * base mean accuracy")
    ap.add_argument("--budget", type=int, default=49,
                    help="rollout-eval budget (grid points)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu, or cuda (the default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = FleetConfig(n_devices=args.devices, T=1.2,
                      n_servers=max(1, args.devices // 16), policy="amr2",
                      rate=9.0, batch_max=8, horizon=args.periods + 2,
                      seed=args.seed, straggler_frac=0.25, outage_frac=0.1,
                      **H100_ES)
    base = E.EngineParams.from_config(cfg, horizon=args.periods + 2,
                                      device=dev)
    armed = base.with_differentiable(smooth_mode="st")
    base_es, base_acc = base.p_es, base.acc
    N = args.devices * args.periods

    def at_knobs(log_cap, mix, p=None):
        return dataclasses.replace(
            p if p is not None else base,
            p_es=base_es * float(np.exp(-log_cap)),
            acc=base_acc * float(2.0 * sigmoid(mix)))

    def mean_acc(log_cap, mix):
        p = at_knobs(log_cap, mix)
        _, m = E.rollout(E.init_state(p, device=dev), p, args.periods,
                         device=dev)
        return float(m.total_accuracy.sum()) / N

    base_acc_mean = mean_acc(0.0, 0.0)
    slo = args.slo_margin * base_acc_mean
    # capacity is not free: the penalty keeps both planners looking for
    # the cheapest feasible point instead of maxing the knob
    lam = 0.02 * slo

    def objective(log_cap, mix, acc_mean):
        short = max(0.0, slo - acc_mean)
        return short * short / (slo * slo) + lam * max(0.0, log_cap) / slo

    print(f"fleet: {args.devices} devices x {args.periods} periods on "
          f"{dev}, base mean acc {base_acc_mean:.4f}, SLO {slo:.4f} "
          f"({args.slo_margin:.2f}x)")

    # ---- grid search ----------------------------------------------------
    side = max(2, int(round(args.budget ** 0.5)))
    caps = np.linspace(0.0, 0.5, side)
    mixes = np.linspace(-1.0, 1.0, side)
    grid_evals, grid_hit, grid_best = 0, None, (np.inf, None)
    for lc in caps:                       # cheapest capacity first
        for mx in mixes:
            acc = mean_acc(float(lc), float(mx))
            grid_evals += 1
            obj = objective(float(lc), float(mx), acc)
            if obj < grid_best[0]:
                grid_best = (obj, (float(lc), float(mx), acc))
            if acc >= slo and grid_hit is None:
                grid_hit = grid_evals
                print(f"[grid] SLO met at eval {grid_evals}: "
                      f"log_cap={lc:.3f} mix={mx:.3f} acc={acc:.4f}")
        if grid_hit is not None:
            break
    if grid_hit is None:
        grid_hit = grid_evals + 1         # never met within budget
        print(f"[grid] SLO not met in {grid_evals} evals; best acc "
              f"{grid_best[1][2]:.4f}")

    # ---- gradient descent -----------------------------------------------
    knobs = torch.zeros(2, dtype=torch.float64)     # (log_cap, mix)
    opt = torch.optim.Adam([knobs], lr=0.12)
    gd_evals, gd_hit = 0, None
    for _ in range(args.budget):
        log_cap, mix = knobs.tolist()
        p = at_knobs(log_cap, mix, armed)
        val, g = E.rollout_value_and_grad(
            E.init_state(p, device=dev), p, args.periods,
            wrt=("p_es", "acc"), device=dev)
        gd_evals += 1
        acc = float(val) / N
        # knob-space chain rule through the two reparameterizations
        d_cap = float((g["p_es"] * base_es).sum()) * -np.exp(-log_cap)
        s = sigmoid(mix)
        d_mix = float((g["acc"] * base_acc).sum()) * 2.0 * s * (1.0 - s)
        short = max(0.0, slo - acc)
        dv = -2.0 * short / (slo * slo * N)       # d(objective)/d(value)
        print(f"[grad] eval {gd_evals}: log_cap={log_cap:.3f} "
              f"mix={mix:.3f} acc={acc:.4f}"
              + (" (SLO met)" if acc >= slo else ""))
        if acc >= slo:
            gd_hit = gd_evals
            break
        knobs.grad = torch.tensor(
            [dv * d_cap + (lam / slo if log_cap > 0 else 0.0), dv * d_mix],
            dtype=torch.float64)
        opt.step()

    # ---- verdict --------------------------------------------------------
    print(f"\ngrid search:      SLO at eval {grid_hit} "
          f"(budget {args.budget})")
    print(f"gradient descent: SLO at eval {gd_hit if gd_hit else '-'}")
    if gd_hit is None:
        print("FAIL: gradient planner did not reach the SLO")
        return 1
    if gd_hit >= grid_hit:
        print("FAIL: gradient planner needed no fewer evals than grid")
        return 1
    print(f"OK: gradient planner reached the SLO in {gd_hit} rollout evals "
          f"vs {grid_hit} for grid search ({grid_hit / gd_hit:.1f}x fewer)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
