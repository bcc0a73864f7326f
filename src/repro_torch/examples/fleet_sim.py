"""Fleet serving demo: N edge devices, a small ES pool, Poisson traffic
(port of `examples/fleet_sim.py`).

    python -m repro_torch.examples.fleet_sim --devices 64 --periods 20 \\
        [--servers 2] [--rate 10] [--batch-max 12] [--t 1.2] [--seed 0] \\
        [--policy auto] [--rollout] [--chaos [LOSS_RATE]] [--fault-seed 0] \\
        [--device cpu]

One `FleetConfig` describes the run (`FleetEngine.from_config`, the ES
tier an H100): every period the fleet is planned by a few batched solves
(`repro_torch.api.solve` on each shape group's `FleetProblem`); devices
that lose the ES admission race replan onto their local models in one
batched ES-disabled solve, drifting devices trigger the EMA straggler
audit, and per-device ES-link outages are planned around.  A one-group
fleet under amr2 or dual hands each period to the tensor engine's period
core (the delegation).

``--rollout`` runs the same epoch through the tensor engine
(`repro_torch.serving.engine_v2.rollout`): the periods in one Python loop
on the device.  Under ``--policy amr2`` or ``dual`` its trajectory equals
the loop's on the replayed arrival trace; ``auto`` resolves to amr2 there
(the loop's auto also gives identical-job devices the exact DP).

``--chaos [LOSS_RATE]`` arms fault injection (the delegated or rollout
engine): ES crashes, link degradation, injected stragglers and per-sample
offload loss, resolved by the degradation ladder (retry with capped
backoff, then the largest local model fitting the residual 2T deadline,
then drop).  The per-period lines grow retry, fallback, drop and miss
counters and the realized makespan; faults are drawn from
``--fault-seed``, so runs are reproducible.
"""
from __future__ import annotations

import argparse


def _fault_model(args):
    """The demo fault mix: the requested offload-loss rate plus moderate
    crash, link-degradation and straggler probabilities."""
    from ..serving import FaultModel
    if args.chaos is None:
        return None
    return FaultModel.make(loss_rate=args.chaos, es_crash_prob=0.05,
                           link_degrade_prob=0.2, link_degrade_mag=0.5,
                           straggler_prob=0.15, straggler_mult=2.0)


def _chaos_cols(retries, fallback, dropped, miss, makespan, T):
    return (f"retry={retries:>3} fb={fallback:>2} drop={dropped:>2} "
            f"miss={miss:>2} realized={makespan / T:4.2f}T ")


def _config(args):
    from ..serving.fleet import H100_ES, FleetConfig
    return FleetConfig(
        n_devices=args.devices, T=args.t, n_servers=args.servers,
        policy=args.policy, rate=args.rate, batch_max=args.batch_max,
        horizon=max(args.periods, 2), seed=args.seed,
        faults=_fault_model(args), fault_seed=args.fault_seed, **H100_ES)


def _main_rollout(args, dev):
    from ..api.engine import METRIC_FIELDS
    from ..serving import engine_v2

    params = engine_v2.EngineParams.from_config(
        _config(args), horizon=args.periods, device=dev)
    _state, m = engine_v2.rollout(engine_v2.init_state(params, device=dev),
                                  params, args.periods, device=dev)
    m = {f: getattr(m, f).cpu() for f in METRIC_FIELDS}
    chaos_tag = (f", chaos armed: loss={args.chaos:g} "
                 f"fault_seed={args.fault_seed}" if params.chaos else "")
    print(f"[fleet] engine-v2 rollout: {args.periods} periods over "
          f"{args.devices} devices on {dev} (policy {params.policy}"
          f"{chaos_tag})")
    for i in range(args.periods):
        chaos_cols = "" if not params.chaos else _chaos_cols(
            int(m["n_retries"][i]), int(m["n_fallback_local"][i]),
            int(m["n_dropped"][i]), int(m["n_deadline_miss"][i]),
            float(m["realized_makespan"][i]), args.t)
        print(f"[fleet] t={i:>3} jobs={int(m['n_jobs'][i]):>4} "
              f"acc/job={float(m['mean_job_accuracy'][i]):.3f} "
              f"offload={int(m['n_offloading'][i]):>3} "
              f"bumped={int(m['n_backpressured'][i]):>3} "
              f"outage={int(m['n_outage'][i]):>2} "
              f"straggler_upd={int(m['n_straggler_updates'][i])} "
              f"es_util={float(m['es_utilization'][i]):4.0%} "
              f"viol={int(m['n_violations'][i]):>2} "
              f"{chaos_cols}"
              f"backlog={int(m['backlog'][i])}")
    jobs = int(m["n_jobs"].sum())
    acc = float(m["total_accuracy"].sum())
    chaos_sum = "" if not params.chaos else (
        f"retries={int(m['n_retries'].sum())}, "
        f"fallback_local={int(m['n_fallback_local'].sum())}, "
        f"dropped={int(m['n_dropped'].sum())}, "
        f"deadline_miss={int(m['n_deadline_miss'].sum())}, "
        f"worst_makespan="
        f"{float(m['realized_makespan'].max()) / args.t:.2f}T, ")
    viol = int(m["n_violations"].sum()) / (args.periods * args.devices)
    print(f"[fleet] done: {jobs} jobs, acc/job={acc / max(jobs, 1):.3f}, "
          f"violation_rate={viol:.1%}, {chaos_sum}"
          f"final_backlog={int(m['backlog'][-1])}")
    return m


def main(argv=None):
    from .._device import resolve_device
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=64)
    ap.add_argument("--periods", type=int, default=20)
    ap.add_argument("--servers", type=int, default=2)
    ap.add_argument("--rate", type=float, default=10.0)
    ap.add_argument("--batch-max", type=int, default=12)
    ap.add_argument("--t", type=float, default=1.2, help="period budget T")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--policy", default="auto")
    ap.add_argument("--rollout", action="store_true",
                    help="run the epoch through the tensor engine")
    ap.add_argument("--chaos", type=float, nargs="?", const=0.1,
                    default=None, metavar="LOSS_RATE",
                    help="arm fault injection at this offload-loss rate "
                    "(default 0.1 when the flag is given bare)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="fault seed (chaos runs are reproducible under a "
                    "fixed seed)")
    ap.add_argument("--device", default=None,
                    help="cpu, or cuda (the default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.chaos is not None and args.policy == "auto":
        # fault injection needs the engine's period core; "auto" in the
        # loop engine routes identical-job devices to the host DP path
        args.policy = "amr2"

    if args.rollout:
        return _main_rollout(args, dev)

    from ..serving import FleetEngine

    engine = FleetEngine.from_config(_config(args), device=dev)
    specs = [st.spec for st in engine.devices]
    print(f"[fleet] {args.devices} devices "
          f"({sum(1 for s in specs if s.drift is not None)} stragglers, "
          f"{sum(1 for s in specs if s.outage is not None)} flaky links) | "
          f"{args.servers} ES servers | T={args.t}s | {dev}")
    chaos = args.chaos is not None
    for _ in range(args.periods):
        s = engine.run_period()
        chaos_cols = "" if not chaos else _chaos_cols(
            s.n_retries, s.n_fallback_local, s.n_dropped,
            s.n_deadline_miss, s.realized_makespan, args.t)
        print(f"[fleet] t={s.period:>3} jobs={s.n_jobs:>4} "
              f"acc/job={s.mean_job_accuracy:.3f} "
              f"offload={s.n_offloading:>3} bumped={s.n_backpressured:>3} "
              f"outage={s.n_outage:>2} straggler_upd={s.n_straggler_updates} "
              f"es_util={s.es_utilization:4.0%} viol={s.n_violations:>2} "
              f"{chaos_cols}"
              f"plan={s.plan_seconds * 1e3:6.1f}ms backlog={s.backlog}")
    summ = engine.summary()
    print(f"[fleet] done: {summ['jobs']} jobs, "
          f"acc/job={summ['mean_job_accuracy']:.3f}, "
          f"violation_rate={summ['violation_rate']:.1%}, "
          f"backpressure_rate={summ['backpressure_rate']:.1%}, "
          f"planning throughput={summ['devices_per_second']:.0f} devices/s")
    return summ


if __name__ == "__main__":
    main()
