"""The fleet planner's cells: `api.engine.step` period after period on the
whole fleet (the replayed trace, AMR² on the revised LP), starting over
from the initial state at the end of each horizon, each period
synchronised.

The answers are the periods' plans.  Once the window has closed, a
sample of its periods drawn from the seed (and its last) is worked out
again by the plain reference (`reference/fleet_ref.py`) from the
program's own state at that period: the released jobs, the backlog and
stream cursors, the plan's fleet numbers and the audited beliefs must
agree.  Where an audit's ratio ties its threshold, the program's verdict
stands (their count is printed)."""
from __future__ import annotations

import sys
from typing import Any, Dict, List

import numpy as np
import torch

from portbench import common, fleetgen, work
from portbench.reference import fleet_ref

# the fleet numbers compared exactly, by their names in the port's
# `PeriodMetrics` and in the reference's result
EXACT = ("n_jobs", "n_violations", "n_offloading", "n_backpressured",
         "n_outage", "n_straggler_updates", "n_unsolved", "backlog",
         # the chaos ladder's counters, where the reference has them
         "n_offload_samples", "n_offload_ok", "n_retries",
         "n_fallback_local", "n_dropped", "n_deadline_miss",
         "n_es_audit_updates")
# each compared number's limit (see PERF.md for the readings they were
# set from)
LIMITS = {"int_mismatch": 0, "acc_rel_gap": 1e-10, "util_rel_gap": 1e-10,
          "belief_rel_gap": 1e-10, "es_belief_rel_gap": 1e-10,
          "viol_gap": 1e-10}


class Driver:
    """One run of a fleet cell: set-up in the constructor, then `step` for
    each period of the window, `traced` for the profiled periods, and
    `check` once the window has closed."""

    def __init__(self, config: Dict[str, Any], traffic: Dict[str, Any],
                 seed: int, device: torch.device):
        from repro_torch.api import engine as E
        from repro_torch.kernels.simplex_pivot import ops as pivot_ops
        self.E, self.pivot_ops = E, pivot_ops
        self.cfg, self.traffic, self.device = config, traffic, device
        self.arrays = fleetgen.make_arrays(config, traffic,
                                           common.stream_seed(seed, 0))
        self.params = E.params_from_arrays(
            self.arrays, device, policy=config["policy"],
            arrivals="replay", n_servers=int(config["n_servers"]),
            batch_max=int(config["batch_max"]),
            straggler_threshold=float(config["straggler_threshold"]),
            ema=float(config["ema"]), lp_method=config["lp_method"])
        if traffic.get("faults"):
            from repro_torch.core.faults import FaultModel, FaultRealization
            draw = fleetgen.fault_trace(config, traffic,
                                        common.stream_seed(seed, 2))
            self.arrays.update({"fault_" + k: v for k, v in draw.items()})
            self.params = self.params.with_faults(
                FaultModel.make(**traffic["faults"]),
                max_retries=int(traffic["max_retries"]),
                fault_trace=FaultRealization(**{
                    k: torch.as_tensor(v, device=device)
                    for k, v in draw.items()}))
        self.initial = E.state_from_arrays(
            fleetgen.initial_state(self.arrays, int(config["batch_max"])),
            device)
        self.D = int(config["n_devices"])
        self.H = int(config["horizon"])
        rng = np.random.default_rng(common.stream_seed(seed, 1))
        self.sample = sorted(set(rng.choice(
            self.H, size=int(traffic["check_periods"]), replace=False)))
        self.kept: Dict[int, tuple] = {}
        self.metrics: List[Any] = []
        self.state = self.initial
        for i in range(int(traffic["warmup_periods"])):
            self._period(i, keep=False)
        self.state = self.initial
        self.pivots0 = pivot_ops.reduced_pivot.launches

    def _period(self, i: int, keep: bool = True):
        if i % self.H == 0:
            self.state = self.initial
        before = self.state
        self.state, m = self.E.step(self.state, self.params,
                                    device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if keep:
            self.metrics.append(m)
            if i in self.sample and i not in self.kept:
                self.kept[i] = (before, self.state, m)
            self.last = (i, before, self.state, m)

    def step(self, i: int) -> None:
        self._period(i)

    def end_to_end(self, times: List[float]) -> Dict[str, float]:
        return {"devices_per_s": self.D * len(times) / sum(times),
                "period_p95_ms": common.quantile(times, 0.95) * 1e3}

    def outcome(self):
        """(attempted, failed): periods planned in the window, and those
        that left an LP lane unsolved (recovered by the greedy fill)."""
        unsolved = torch.stack([m.n_unsolved for m in self.metrics]).cpu()
        return len(self.metrics), int((unsolved > 0).sum())

    def layer_context(self, times: List[float]) -> Dict[str, Any]:
        return {"kind": "fleet", "periods": len(times),
                "window_s": sum(times),
                "pivots": self.pivot_ops.reduced_pivot.launches
                - self.pivots0}

    def traced(self, trace_fn):
        """Profile ``trace_periods`` periods from the initial state, then
        replay the same periods unprofiled with every ``reduced_pivot``
        call's bytes and operations counted (the periods repeat bit for
        bit from the same state)."""
        n = int(self.traffic["trace_periods"])
        self.state = self.initial

        def run():
            for i in range(n):
                self._period(i, keep=False)
        summary = trace_fn(run)
        ops = self.pivot_ops
        real = ops.reduced_pivot
        tally = {"bytes": 0, "flops": 0, "calls": 0}

        def counted(A, c_phase, Binv, xB, basis, use_bland, may_pivot,
                    lane_ok, *, art_cost, tol):
            saved = (Binv.clone(), basis.clone())
            flags = real(A, c_phase, Binv, xB, basis, use_bland, may_pivot,
                         lane_ok, art_cost=art_cost, tol=tol)
            nb, fl = work.reduced_pivot_work(
                A, c_phase, saved[0], saved[1], use_bland, may_pivot,
                lane_ok, flags[0], flags[1], art_cost=art_cost, tol=tol)
            tally["bytes"] += nb
            tally["flops"] += fl
            tally["calls"] += 1
            return flags
        # the kernel's wrapper counts its launches on the module's name
        counted.launches = real.launches
        ops.reduced_pivot = counted
        try:
            self.state = self.initial
            run()
        finally:
            ops.reduced_pivot = real
            real.launches = counted.launches
        return summary, {"periods_traced": n, "pivot_work": tally}

    def release(self) -> None:
        self.state = None

    def check(self) -> List[Dict[str, Any]]:
        """The sampled periods and the last one, each worked out again by
        the reference from the program's state before it."""
        arr = {k: torch.as_tensor(np.asarray(v), device=self.device)
               for k, v in self.arrays.items()}
        picks = dict(self.kept)
        i, before, after, m = self.last
        picks[i] = (before, after, m)
        worst = {k: 0.0 for k in LIMITS}
        tied = flipped = 0
        for i, (before, after, m) in sorted(picks.items()):
            ref = fleet_ref.period(arr, before, i % self.H, self.cfg,
                                   self.traffic,
                                   verdicts=verdicts(before, after))
            worst = worst_of(worst, compare(ref, after, m))
            tied += ref["n_tied"]
            flipped += ref["n_tied_flipped"]
        print(f"audit ties: {tied} device audits of the {len(picks)} "
              f"checked periods tied the threshold and took the program's "
              f"verdict, {flipped} of them against the reference's rounding",
              file=sys.stderr)
        return [common.compared(k, worst[k], LIMITS[k]) for k in LIMITS]


def verdicts(before, after) -> Dict[str, torch.Tensor]:
    """Which devices' audits updated their beliefs in the period from
    state ``before`` to state ``after``: the straggler audit counts its
    updates, and an ES audit's factor is above 1."""
    return {"ed": after.n_updates != before.n_updates,
            "es": (after.p_es_belief != before.p_es_belief).any(dim=1)}


def _rel(a, b) -> float:
    """The largest relative gap of ``a`` from the reference ``b``."""
    return float(((a - b).abs() / b.abs().clamp_min(1e-300)).max())


def compare(ref, after, m) -> Dict[str, float]:
    """This period's gaps between the program (its next state ``after``
    and metrics ``m``) and the reference ``ref``."""
    mism = int((after.pending != ref["pending"]).sum()
               + (after.head != ref["head"]).sum())
    mism += sum(int(getattr(m, k)) != int(ref[k]) for k in EXACT
                if k in ref)
    return {
        "int_mismatch": mism,
        "acc_rel_gap": _rel(m.total_accuracy, ref["total_accuracy"]),
        "util_rel_gap": _rel(m.es_utilization, ref["es_utilization"]),
        "belief_rel_gap": _rel(after.p_ed, ref["p_ed"]),
        "es_belief_rel_gap": _rel(after.p_es_belief, ref["p_es_belief"]),
        "viol_gap": abs(float(m.worst_violation)
                        - float(ref["worst_violation"])),
    }


def worst_of(a: Dict[str, float], b: Dict[str, float]) -> Dict[str, float]:
    return {k: max(a[k], b[k]) for k in a}
