"""Online hierarchical inference: threshold learners against the
clairvoyant (port of `examples/hi_sim.py`).

    python -m repro_torch.examples.hi_sim [--devices 64] [--periods 64]
        [--offload-cost 0.15] [--hi-seed 11] [--seed 0] [--device cpu]

The paper's AMR^2 plans offloading from a known accuracy table; the
online twin (Moothedath & Champati, arXiv 2304.00891) must learn when to
consult the edge server per sample, from calibrated local-model
confidences alone.  This rolls the same fleet (heterogeneous per-device
ES accuracies, one shared confidence stream) under every decision rule
of the engine:

  * ``fixed``: a shared constant threshold (theta0 = 0.5);
  * ``threshold``: the online-gradient threshold learner;
  * ``ucb`` / ``exp3``: bandits over a grid of thresholds;
  * the *clairvoyant*: rule "fixed" at the per-device optimum ``theta* =
    clip(acc_es - beta, 0, 1)``, which accrues exactly zero pseudo-regret.

It prints a cumulative-regret table and exits 1 unless (a) the
clairvoyant's regret is exactly 0, (b) the learner beats the fixed
baseline it starts from, and (c) the learner's regret grows sublinearly
(second-half increment below the first half's).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np


def main(argv=None) -> int:
    import torch

    from .._device import resolve_device
    from ..api import engine as E
    from ..core.hi import HIModel
    from ..serving.fleet import H100_ES, FleetConfig

    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=64)
    ap.add_argument("--periods", type=int, default=64)
    ap.add_argument("--offload-cost", type=float, default=0.15)
    ap.add_argument("--hi-seed", type=int, default=11)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu, or cuda (the default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    beta = args.offload_cost

    cfg = FleetConfig(n_devices=args.devices, T=1.2,
                      n_servers=max(1, args.devices // 16), policy="amr2",
                      rate=9.0, batch_max=8, horizon=args.periods + 2,
                      seed=args.seed, straggler_frac=0.25, outage_frac=0.1,
                      **H100_ES)
    base = E.EngineParams.from_config(cfg, horizon=args.periods + 2,
                                      device=dev)
    acc = base.acc.clone()
    acc[:, base.m] = torch.as_tensor(
        np.random.default_rng(7).uniform(0.65, 0.92, args.devices),
        device=dev)
    het = dataclasses.replace(base, acc=acc)
    theta_star = (acc[:, base.m] - beta).clamp(0.0, 1.0)

    def roll(rule, theta0=0.5):
        hm = HIModel.make(theta0=theta0, offload_cost=beta)
        p = het.with_hi(hm, rule=rule, hi_seed=args.hi_seed)
        state, m = E.rollout(E.init_state(p, device=dev), p, args.periods,
                             device=dev)
        jobs = int(m.n_jobs.sum())
        return {"regret": m.hi_regret.cpu().numpy(),
                "acc": float(m.total_accuracy.sum()) / max(jobs, 1),
                "off": int(m.n_hi_offloaded.sum()) / max(jobs, 1),
                "theta": state.hi.theta}

    runs = {
        "fixed(0.5)": roll("fixed"),
        "threshold": roll("threshold"),
        "ucb": roll("ucb"),
        "exp3": roll("exp3"),
        "clairvoyant": roll("fixed", theta0=theta_star),
    }

    marks = sorted({p for p in (8, 16, 32, args.periods)
                    if p <= args.periods})
    acc_es = acc[:, base.m]
    print(f"fleet: {args.devices} devices x {args.periods} periods on "
          f"{dev}, beta={beta}, acc_es in [{float(acc_es.min()):.2f}, "
          f"{float(acc_es.max()):.2f}], stream seed {args.hi_seed} (shared "
          f"by every rule)\n")
    print("cumulative regret".ljust(14) + "".join(
        f"@{p}".rjust(11) for p in marks) + "  acc/job  offload%")
    for name, r in runs.items():
        row = name.ljust(14) + "".join(
            f"{r['regret'][p - 1]:11.1f}" for p in marks)
        print(f"{row}  {r['acc']:.4f}   {100 * r['off']:5.1f}%")
    err = (runs["threshold"]["theta"] - theta_star).abs()
    print(f"\nlearner |theta - theta*|: mean {float(err.mean()):.3f}, "
          f"max {float(err.max()):.3f}")

    failures = []
    if runs["clairvoyant"]["regret"][-1] != 0.0:
        failures.append(
            f"clairvoyant regret {runs['clairvoyant']['regret'][-1]} != 0")
    reg_l = runs["threshold"]["regret"]
    if not reg_l[-1] < runs["fixed(0.5)"]["regret"][-1]:
        failures.append("learner did not beat the fixed(0.5) baseline")
    half = args.periods // 2 - 1
    if not reg_l[-1] - reg_l[half] < reg_l[half] - reg_l[0]:
        failures.append("learner regret growth is not sublinear")
    if failures:
        print("\nFAIL:", "; ".join(failures))
        return 1
    print("\nOK: clairvoyant floor exact, learner beat the fixed baseline "
          "with sublinear regret")
    return 0


if __name__ == "__main__":
    sys.exit(main())
