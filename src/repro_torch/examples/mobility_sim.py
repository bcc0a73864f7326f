"""Multi-cell mobility demo: a fleet roaming a 4-cell grid, planned by the
tensor engine with routing, per-cell segmented admission and handover
(cold bases, ES belief reset) (port of `examples/mobility_sim.py`).

Three runs over the same replayed trace:

  * single-pool baseline: mobility off;
  * nearest-cell routing: devices attach to the closest covered cell;
  * min-response-time routing: cells are load- and link-aware, so a
    congested or slow-linked cell sheds devices to its neighbours.

Also shows the `routed` registry policy: the host-level one-shot planner
that routes a `FleetProblem`'s lanes by position before amr2.

    python -m repro_torch.examples.mobility_sim [--devices 64]
        [--periods 16] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    from .. import api
    from .._device import resolve_device
    from ..api import engine as E
    from ..core.instances import paper_instance
    from ..core.mobility import MobilityModel
    from ..core.types import InstanceBatch
    from ..serving.fleet import H100_ES, FleetConfig

    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=64)
    ap.add_argument("--periods", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cpu, or cuda (the default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    D, periods = args.devices, args.periods
    cfg = FleetConfig(n_devices=D, T=1.2, n_servers=8, policy="amr2",
                      rate=9.0, batch_max=8, horizon=periods + 2, seed=0,
                      **H100_ES)
    params = E.EngineParams.from_config(cfg, horizon=periods + 2,
                                        device=dev)

    # a 2x2 grid of cells, 30 apart; devices random-walk around homes
    # drawn near cell centres, so coverage edges and handovers both occur
    rng = np.random.default_rng(7)
    cxy = 30.0 * np.array([[0., 0.], [1., 0.], [0., 1.], [1., 1.]])
    home = cxy[rng.integers(0, 4, D)]
    steps = rng.normal(scale=5.0, size=(periods + 2, D, 2)).cumsum(axis=0)
    trace = home + steps - steps[:1]                    # start at home
    mob = MobilityModel.make(cell_xy=cxy, trace=trace,
                             cell_rate=np.array([1.0, 0.7, 1.3, 1.0]),
                             radius=28.0, link_alpha=0.6)
    results = {}

    def run(tag, p):
        _, m = E.rollout(E.init_state(p, device=dev), p, periods,
                         device=dev)
        acc = float(m.total_accuracy.sum())
        jobs = int(m.n_jobs.sum())
        results[tag] = dict(acc_per_job=acc / max(jobs, 1),
                            offloading=int(m.n_offloading.sum()),
                            handovers=int(m.n_handover.sum()),
                            outage_periods=int(m.n_outage.sum()))
        r = results[tag]
        print(f"  {tag:<22} acc/job {r['acc_per_job']:.4f}   "
              f"offloading {r['offloading']:4d}   "
              f"handovers {r['handovers']:4d}   "
              f"outage-periods {r['outage_periods']:4d}")

    print(f"{D} devices x {periods} periods, 4 cells "
          f"(rates {mob.cell_rate.tolist()}, radius 28) on {dev}:")
    run("single-pool (off)", params)
    run("nearest cell", params.with_mobility(mob, routing="nearest"))
    run("min response time", params.with_mobility(mob, routing="min_time"))

    # ---- the `routed` registry policy: one-shot host-level planning ----
    fp = api.FleetProblem.from_batch(InstanceBatch.stack(
        [paper_instance(8, T=1.2, seed=s) for s in range(D)]))
    sol = api.get_solver("routed").solve_fleet(
        fp, positions=trace[0], mobility=mob, routing="nearest",
        device=dev)
    att = np.bincount(sol.cell[sol.cell >= 0], minlength=4)
    print(f"\nrouted policy (one-shot): cells {att.tolist()} attached, "
          f"{int((sol.cell < 0).sum())} uncovered (local-only); "
          f"accuracy {float(sol.accuracy.sum()):.2f}")
    results["routed"] = dict(attached=att.tolist(),
                             uncovered=int((sol.cell < 0).sum()))
    return results


if __name__ == "__main__":
    main()
