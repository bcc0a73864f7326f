"""End-to-end tiered serving, the paper's experiment (§VII) on a model
ladder (port of `examples/serve_offload.py`): two reduced-width LM
variants as the ED tier (the MobileNet-alpha analogue) and the full
model as the ES tier (the ResNet50 analogue), with measured latencies
and per-job top-1 next-token accuracy.

    python -m repro_torch.examples.serve_offload [--periods 6] [--n 24] \\
        [--train-steps 30] [--iters 10] [--device cpu]

It prints the shape of the paper's Figs 3-6: the job assignment against
T (Fig 3), the total accuracy of AMR^2 beside its LP bound, Greedy-RRA
and the dual (Figs 4/5) — the T sweep, `t_sweep`, a function of the
profile and n — and the predicted against the wall makespan and its
violation (Fig 6) in the period loop, with an ES outage in period 2
(replanned onto the ED ladder) and stragglers from period 4 (the
profile re-measured).  The ladder is `launch.serve`'s `build_models` /
`make_apply` (the reference's, ported there).
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Sequence

import numpy as np

SWEEP_FACTORS = (0.3, 0.6, 1.0, 1.6)
JOB_CLASS = 64


def t_sweep(profile, n: int, factors: Sequence[float] = SWEEP_FACTORS,
            device=None) -> List[Dict[str, Any]]:
    """One row per budget T = n · p_ed[0, 1] · factor (the reference's
    ``base_T = n * lats[1]``) over n jobs of the profile's one class:
    AMR^2's solver name, accuracy, LP bound and jobs per model, and the
    accuracies of Greedy-RRA and the dual on the same instance."""
    from ..api import solve
    base_T = n * float(profile.p_ed[0, 1])
    rows = []
    for tf in factors:
        T = base_T * tf
        inst = profile.instance(np.full(n, JOB_CLASS), T)
        p = solve(inst, policy="amr2", device=device)
        g = solve(inst, policy="greedy", device=device)
        d = solve(inst, policy="dual", device=device)
        rows.append(dict(T=T, solver=p.solver, accuracy=p.accuracy,
                         lp_accuracy=float(p.lp_accuracy or 0),
                         greedy_accuracy=g.accuracy, dual_accuracy=d.accuracy,
                         counts=p.to_schedule().counts().tolist()))
    return rows


def main(argv=None) -> Dict[str, Any]:
    """Returns the ladder's accuracies and latencies, the sweep's rows
    and each period's `PeriodStats`."""
    from .._device import resolve_device
    from ..configs.paper_edge import CONFIG as ES_CFG
    from ..data.pipeline import DataConfig, TokenPipeline
    from ..launch.serve import LADDER, build_models, make_apply
    from ..serving import ServingRuntime, TierProfile, measure_latency

    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=24)
    ap.add_argument("--periods", type=int, default=6)
    ap.add_argument("--train-steps", type=int, default=30)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("== training the model ladder (ED x2 + ES) ==")
    models = build_models(LADDER, seed=0, device=dev,
                          train_steps=args.train_steps)
    applies = [make_apply(c, p) for c, p in models]

    # measured test accuracy per model (Table I analogue)
    pipe = TokenPipeline(DataConfig(vocab_size=ES_CFG.vocab_size, seq_len=64,
                                    global_batch=16, seed=99))
    test_jobs = [pipe.batch_at(0)["tokens"][i] for i in range(16)]
    accs = [float(np.mean(app(test_jobs))) for app in applies]
    print(f"ladder accuracies (a_1..a_m, a_es): "
          f"{[round(a, 3) for a in accs]}")

    # measured per-job latency (Table II analogue): single size class
    lats = [measure_latency(lambda b=app: b(test_jobs[:1]), (),
                            iters=args.iters) for app in applies]
    comm = 0.2 * lats[-1]          # payload upload ~ fraction of ES compute
    print(f"ladder latencies (s/job): {[round(lat, 4) for lat in lats]}, "
          f"comm {comm:.4f}")
    profile = TierProfile(
        name="lm-ladder", p_ed=np.array([[lats[0], lats[1]]]),
        p_es=np.array([lats[2] + comm]), acc=np.array(accs),
        classes=[JOB_CLASS])

    # a T sweep: job assignment (Fig 3) + accuracy vs policies (Fig 4)
    n = args.n
    print(f"\n== T sweep (n={n}) ==")
    print(f"{'T':>8} {'policy':>7} {'A_pred':>7} {'A_LP':>7} "
          f"{'A_greedy':>8} {'A_dual':>7}  jobs/model")
    rows = t_sweep(profile, n, device=dev)
    for r in rows:
        print(f"{r['T']:8.3f} {r['solver']:>7} {r['accuracy']:7.2f} "
              f"{r['lp_accuracy']:7.2f} {r['greedy_accuracy']:8.2f} "
              f"{r['dual_accuracy']:7.2f}  {r['counts']}")

    # the serving loop with failures + stragglers (Fig 6 + fault story)
    print("\n== period-T serving loop ==")
    base_T = n * lats[1]
    rt = ServingRuntime(profile, applies[:2], applies[2], T=base_T * 0.8,
                        policy="auto", device=dev)
    for period in range(args.periods):
        jobs = [pipe.batch_at(100 + period)["tokens"][i] for i in range(n)]
        if period == 4:
            # inject a straggler: wrap ED applies with a delay
            rt.apply_ed = [
                lambda js, a=a: (time.sleep(0.05 * len(js)), a(js))[1]
                for a in applies[:2]]
        stats = rt.run_period(jobs, np.full(n, JOB_CLASS),
                              es_fail=period == 2)
        print(f"period {period}: policy={stats.policy} "
              f"A={stats.total_accuracy:.2f} "
              f"pred={stats.predicted_makespan:.3f}s "
              f"wall={stats.wall_makespan:.3f}s "
              f"viol={100 * stats.violation:.0f}% "
              f"plan={1e3 * stats.plan_seconds:.1f}ms "
              f"{'ES-FAIL->replanned ' if stats.replanned else ''}"
              f"{'profile-updated' if stats.profile_updated else ''}")
    print("done.")
    return {"accuracies": accs, "latencies": lats, "sweep": rows,
            "periods": rt.history}


if __name__ == "__main__":
    main()
