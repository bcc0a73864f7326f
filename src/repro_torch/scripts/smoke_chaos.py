"""Chaos smoke: the fault-injection path must be armed, deterministic and
bit-for-bit invisible when null (port of `scripts/smoke_chaos.py`).

    python -m repro_torch.scripts.smoke_chaos --device cpu

Three gates on a ``--devices`` fleet (default 64) over ``--periods``
(default 8), fault seed 11:

  1. *armed-null parity*: ``chaos=True`` with the all-zero `FaultModel`
     reproduces the fault-free rollout bit for bit;
  2. *the ladder fires*: a harsh fault model gives nonzero retry,
     fallback and drop-or-miss counters;
  3. *accounting closes*: ``n_offload_samples == n_offload_ok +
     n_fallback_local + n_dropped`` every period, the realized makespan
     within ``2T + backoff_cap + one retransmission``, and the armed
     rollout deterministic under its fault seed.

Exits 1 on any failure.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    import torch

    from .._device import resolve_device
    from ..api import engine as E
    from ..serving import FaultModel
    from ..serving.fleet import H100_ES, FleetConfig

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=64)
    ap.add_argument("--periods", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cpu, or cuda (the default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n_devices, periods, T = args.devices, args.periods, 1.2
    cfg = FleetConfig(n_devices=n_devices, T=T,
                      n_servers=max(1, n_devices // 16), policy="amr2",
                      rate=9.0, batch_max=8, horizon=periods + 2, seed=0,
                      fault_seed=11, **H100_ES)
    base = E.EngineParams.from_config(cfg, horizon=periods + 2, device=dev)
    failures = []

    def roll(p):
        return E.rollout(E.init_state(p, device=dev), p, periods,
                         device=dev)[1]

    # gate 1: armed-null bitwise parity ----------------------------------
    m0 = roll(base)
    m1 = roll(dataclasses.replace(base, faults=FaultModel.none(),
                                  chaos=True))
    for f in E.METRIC_FIELDS:
        if not torch.equal(getattr(m0, f), getattr(m1, f)):
            failures.append(f"armed-null parity broken on {f}: "
                            f"{getattr(m1, f).tolist()} != "
                            f"{getattr(m0, f).tolist()}")

    # gates 2 + 3: the harsh model fires and accounts for every sample ---
    fm = FaultModel.make(es_crash_prob=0.08, link_degrade_prob=0.25,
                         link_degrade_mag=0.6, straggler_prob=0.2,
                         straggler_mult=1.8, loss_rate=0.15)
    params = base.with_faults(fm, fault_seed=11)
    M = roll(params)
    fired = {k: int(getattr(M, k).sum()) for k in (
        "n_retries", "n_fallback_local", "n_dropped", "n_deadline_miss")}
    if sum(fired.values()) == 0:
        failures.append("harsh fault model never fired (vacuous smoke)")
    closed = M.n_offload_samples == (M.n_offload_ok + M.n_fallback_local
                                     + M.n_dropped)
    if not bool(closed.all()):
        failures.append(f"offload accounting identity broken in period(s) "
                        f"{torch.nonzero(~closed)[:, 0].tolist()}")
    demand_cap = float(base.p_es.max()) * base.batch_max
    bound = 2.0 * T + fm.backoff_cap + demand_cap * (1.0
                                                      + fm.link_degrade_mag)
    worst = float(M.realized_makespan.max())
    if worst > bound + 1e-9:
        failures.append(f"realized makespan {worst:.3f} exceeds the ladder "
                        f"bound {bound:.3f}")
    M2 = roll(params)
    for f in ("total_accuracy", "n_retries", "n_dropped",
              "realized_makespan"):
        if not torch.equal(getattr(M, f), getattr(M2, f)):
            failures.append(f"chaos rollout not deterministic on {f}")

    if failures:
        print("FAIL: chaos smoke:", file=sys.stderr)
        for f in failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    acc0 = float(m0.total_accuracy.sum())
    acc = float(M.total_accuracy.sum())
    print(f"[chaos-smoke] ok: {n_devices} devices x {periods} periods: "
          f"armed-null bitwise parity, ladder fired (retries="
          f"{fired['n_retries']}, fallback={fired['n_fallback_local']}, "
          f"dropped={fired['n_dropped']}, miss={fired['n_deadline_miss']}), "
          f"accounting closed, accuracy {acc / max(acc0, 1e-12):.4f}x "
          f"fault-free")
    return 0


if __name__ == "__main__":
    sys.exit(main())
