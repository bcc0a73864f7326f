"""Multi-cell mobility smoke: routing determinism, the one-cell bitwise
reduction, and sharded parity on a geographically local replayed fleet
(port of `scripts/smoke_mobility.py`).

    python -m repro_torch.scripts.smoke_mobility --device cpu [--shards 4]

Three legs on ``--devices`` devices (default 32) over ``--periods``
(default 8); exit 1 on any failure:

  * *determinism*: two rollouts of the same replayed multi-cell params are
    bit for bit equal, handovers fire, and every period's routed cell lies
    within the coverage radius;
  * *one-cell reduction*: one cell at the origin with an infinite radius
    reproduces the single-pool engine bit for bit;
  * *sharded*: a fleet whose devices each roam one cell pair, regrouped so
    that each shard's block holds whole pairs, run on ``--shards`` spawned
    gloo ranks (`smoke_shard_rollout`) under plain sharding (admission on
    the gathered demand) and under ``shard_by_cell`` (each shard admits
    its own cells, the per-cell loads summed), each against the unsharded
    rollout.  ``--shards 0`` skips it.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np

# 8 cells in 4 close pairs (spacing 10 within a pair, 40 between)
N_CELLS = 8
LOCAL_KW = dict(radius=25.0, link_alpha=0.3)


def pair_geometry(n_devices: int, periods: int):
    """``(cell_xy (8, 2), trace (periods + 2, D, 2), order (D,))``: device
    d roams around the midpoint of pair d mod 4 (so handovers happen
    within a pair); ``trace[:, order]`` regroups the fleet pair-major, so
    that a block of D/4 consecutive devices roams one pair."""
    S = N_CELLS
    rng = np.random.default_rng(1)
    cxy = np.stack([40.0 * (np.arange(S) // 2) + 10.0 * (np.arange(S) % 2),
                    np.zeros(S)], axis=1)
    mid = 0.5 * (cxy[0::2] + cxy[1::2])              # (4, 2) pair centres
    home = mid[np.arange(n_devices) % 4]
    trace = rng.normal(scale=6.0, size=(periods + 2, n_devices, 2)) + home
    order = np.argsort(np.arange(n_devices) % 4, kind="stable")
    return cxy, trace, order


def main(argv: Optional[Sequence[str]] = None) -> int:
    import torch

    from .._device import resolve_device
    from ..api import engine as E
    from ..core.mobility import MobilityModel, route_cells
    from ..serving.fleet import H100_ES, FleetConfig
    from .smoke_shard_rollout import run_legs

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=32)
    ap.add_argument("--periods", type=int, default=8)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="cpu, or cuda (the default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n_devices, periods = args.devices, args.periods
    failures = []

    def check(tag, got, want):
        if not torch.equal(got, want):
            failures.append(f"{tag}: {got.flatten()[:8].tolist()} != "
                            f"{want.flatten()[:8].tolist()}")

    cfg = FleetConfig(n_devices=n_devices, T=1.2, n_servers=8,
                      policy="amr2", rate=8.0, batch_max=8,
                      horizon=periods + 2, seed=0, **H100_ES)
    params = E.EngineParams.from_config(cfg, horizon=periods + 2,
                                        device=dev)
    cxy, trace, _order = pair_geometry(n_devices, periods)
    mob = MobilityModel.make(cell_xy=cxy, trace=trace, **LOCAL_KW)
    armed = params.with_mobility(mob, routing="min_time")

    # --- leg 1: routing determinism ------------------------------------
    s_a, m_a = E.rollout(E.init_state(armed, device=dev), armed, periods,
                         device=dev)
    s_b, m_b = E.rollout(E.init_state(armed, device=dev), armed, periods,
                         device=dev)
    for f in E.METRIC_FIELDS:
        check(f"determinism/{f}", getattr(m_a, f), getattr(m_b, f))
    for f in E.STATE_FIELDS:
        check(f"determinism/state/{f}", getattr(s_a, f), getattr(s_b, f))
    n_handover = int(m_a.n_handover.sum())
    if n_handover == 0:
        failures.append("no handovers fired (vacuous mobility smoke)")
    mob_t = mob.to(dev)
    zeros = torch.zeros(N_CELLS, dtype=torch.float64, device=dev)
    for t in range(periods):
        pos = mob_t.trace[t]
        cell, covered, _ = route_cells(pos, mob_t, zeros, "min_time")
        dist = torch.linalg.norm(pos[:, None] - mob_t.cell_xy[None], dim=2)
        ok = covered.nonzero()[:, 0]
        if not bool((dist[ok, cell[ok].long()] <= mob_t.radius).all()):
            failures.append(f"period {t}: a device was routed to a cell "
                            f"outside the coverage radius")
            break

    # --- leg 2: the one-cell / infinite-radius bitwise reduction --------
    null_mob = MobilityModel.make(cell_xy=np.zeros((1, 2)),
                                  trace=np.zeros((periods + 2, n_devices,
                                                  2)))
    reduced = params.with_mobility(null_mob)
    s_off, m_off = E.rollout(E.init_state(params, device=dev), params,
                             periods, device=dev)
    s_red, m_red = E.rollout(E.init_state(reduced, device=dev), reduced,
                             periods, device=dev)
    for f in E.METRIC_FIELDS:
        check(f"one_cell/{f}", getattr(m_red, f), getattr(m_off, f))
    for f in ("p_ed", "pending", "head", "warm_basis", "n_updates"):
        check(f"one_cell/state/{f}", getattr(s_red, f), getattr(s_off, f))

    # --- leg 3: sharded and sharded-by-cell parity ----------------------
    if args.shards:
        res = run_legs(("local", "local_by_cell"), shards=args.shards,
                       devices=n_devices, local_devices=n_devices,
                       periods=periods, backend="gloo", device=dev.type)
        failures += [x for r in res.values() for x in r["failures"]]
    else:
        print("[mobility-smoke] --shards 0: sharded leg skipped")

    if failures:
        print("FAIL: mobility smoke:", file=sys.stderr)
        for f in failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    acc = float(m_a.total_accuracy.sum())
    print(f"[mobility-smoke] ok: {n_devices} devices x {periods} periods, "
          f"{N_CELLS} cells, {n_handover} handovers; determinism + one-cell "
          f"reduction + sharded parity on {args.shards} shards hold (total "
          f"accuracy {acc:.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
