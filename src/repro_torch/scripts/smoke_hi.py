"""Online hierarchical inference smoke: the confidence-gated path must be
armed, learning, and bit-for-bit invisible when disarmed (port of
`scripts/smoke_hi.py`).

    python -m repro_torch.scripts.smoke_hi --device cpu

Three gates on a ``--devices`` fleet (default 64) over ``--periods``
(default 64), HI seed 11:

  1. *disarm parity*: params round-tripped through ``with_hi(...)`` and
     ``with_hi(None)`` reproduce the default rollout bit for bit, the HI
     counters exact zeros;
  2. *the learner learns*: with per-device ES accuracies drawn in [0.65,
     0.92], the threshold learner's cumulative pseudo-regret undercuts
     the fixed threshold it starts from (theta0 = 0.5), and grows
     sublinearly (second-half increment below the first half's);
  3. *accounting closes*: ``n_hi_offloaded + n_hi_local_final == n_jobs``
     every period, and the armed rollout is deterministic.

Exits 1 on any failure.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Optional, Sequence

import numpy as np


def main(argv: Optional[Sequence[str]] = None) -> int:
    import torch

    from .._device import resolve_device
    from ..api import engine as E
    from ..core.hi import HIModel
    from ..serving.fleet import H100_ES, FleetConfig

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=64)
    ap.add_argument("--periods", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="cpu, or cuda (the default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n_devices, periods = args.devices, args.periods
    beta, hi_seed = 0.15, 11
    cfg = FleetConfig(n_devices=n_devices, T=1.2,
                      n_servers=max(1, n_devices // 16), policy="amr2",
                      rate=9.0, batch_max=8, horizon=periods + 2, seed=0,
                      **H100_ES)
    base = E.EngineParams.from_config(cfg, horizon=periods + 2, device=dev)
    acc = base.acc.clone()
    acc[:, base.m] = torch.as_tensor(
        np.random.default_rng(7).uniform(0.65, 0.92, n_devices),
        device=dev)
    het = dataclasses.replace(base, acc=acc)
    failures = []

    def roll(p):
        return E.rollout(E.init_state(p, device=dev), p, periods,
                         device=dev)[1]

    # gate 1: disarm parity ----------------------------------------------
    m0 = roll(base)
    off = base.with_hi(HIModel.make(), rule="threshold").with_hi(None)
    m1 = roll(off)
    for f in E.METRIC_FIELDS:
        if not torch.equal(getattr(m0, f), getattr(m1, f)):
            failures.append(f"disarm parity broken on {f}")
    for f in ("n_hi_offloaded", "n_hi_local_final", "hi_regret"):
        if float(getattr(m0, f).sum()) != 0:
            failures.append(f"disarmed rollout booked nonzero {f}")

    # gate 2: the learner beats the fixed threshold it starts from -------
    fixed = het.with_hi(HIModel.make(offload_cost=beta), rule="fixed",
                        hi_seed=hi_seed)
    learn = het.with_hi(HIModel.make(offload_cost=beta), rule="threshold",
                        hi_seed=hi_seed)
    mf, ml = roll(fixed), roll(learn)
    reg_f = float(mf.hi_regret[-1])
    reg_l = ml.hi_regret.cpu().numpy()
    if not reg_l[-1] < reg_f:
        failures.append(f"threshold learner regret {reg_l[-1]:.1f} did not "
                        f"undercut the fixed baseline {reg_f:.1f}")
    first = reg_l[periods // 2 - 1] - reg_l[0]
    second = reg_l[-1] - reg_l[periods // 2 - 1]
    if not second < first:
        failures.append(f"regret growth not sublinear: second half "
                        f"{second:.1f} >= first half {first:.1f}")

    # gate 3: accounting closes, and determinism -------------------------
    for tag, m in (("fixed", mf), ("threshold", ml)):
        closed = m.n_hi_offloaded + m.n_hi_local_final == m.n_jobs
        if not bool(closed.all()):
            failures.append(f"{tag}: serving identity broken in period(s) "
                            f"{torch.nonzero(~closed)[:, 0].tolist()}")
    ml2 = roll(learn)
    for f in ("total_accuracy", "n_hi_offloaded", "hi_regret"):
        if not torch.equal(getattr(ml, f), getattr(ml2, f)):
            failures.append(f"armed rollout not deterministic on {f}")

    if failures:
        print("FAIL: hi smoke:", file=sys.stderr)
        for f in failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    n_off = int(ml.n_hi_offloaded.sum())
    n_jobs = int(ml.n_jobs.sum())
    print(f"[hi-smoke] ok: {n_devices} devices x {periods} periods: "
          f"disarm bitwise parity, learner regret {reg_l[-1]:.1f} < fixed "
          f"{reg_f:.1f} (sublinear: {second:.1f} < {first:.1f}), "
          f"accounting closed ({n_off}/{n_jobs} samples offloaded), "
          f"deterministic under hi_seed={hi_seed}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
