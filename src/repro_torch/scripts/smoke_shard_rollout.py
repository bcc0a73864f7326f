"""Sharded engine smoke: `step_sharded` / `rollout_sharded` over N ranks
must equal the unsharded engine (port of `scripts/smoke_shard_rollout.py`).

    python -m repro_torch.scripts.smoke_shard_rollout --shards 4 --device cpu
    python -m repro_torch.scripts.smoke_shard_rollout --shards 4 \\
        --backend gloo --device cuda --devices 16384 --legs chaos

Spawns ``--shards`` processes (`torch.multiprocessing`), each one rank of
a fresh process group (``--backend gloo`` or ``nccl``) that meets through
a ``file://`` store in a temporary directory, so no port can collide.
CPU ranks need gloo; ranks on the card compute on card ``rank`` under
NCCL (one card each) and all on the current card under gloo, which moves
the collectives' operands through the host.  Every rank builds the same
``--devices`` fleet, runs it unsharded, then `shard`s it over
`fleet_mesh` and runs `step_sharded` and `rollout_sharded` for
``--periods``.  Legs (``--legs``, default all):

  * ``tableau``, ``revised``: replayed arrivals under each LP method;
  * ``chaos``: the reference's ``SHARD_SMOKE_CHAOS=1`` leg, faults drawn
    from fault seed 3 and the outage schedule of every 4th device flipped
    from mid-horizon on (the ladder must fire);
  * ``chaos_trace``: the same faults replayed from a ``fault_trace``;
  * ``poisson``: Poisson arrivals;
  * ``walk``: random-walk mobility over 8 cells, admission on the
    gathered demand;
  * ``local``, ``local_by_cell``: `smoke_mobility`'s geographically local
    replayed fleet (each shard's devices roam only its cell pairs) of
    ``--local-devices`` (default 32, the reference smoke's size) under
    plain sharding and under ``shard_by_cell`` (needs ``--shards`` 1, 2
    or 4).  The leg counts the device-periods the unsharded run routes
    to another shard's cells: such a stray makes ``shard_by_cell`` admit
    otherwise once capacity binds (at 64 devices in period 6, in the
    reference as here), and a failure then names the first one.

The bar is the reference's: integer metrics, ``warm_basis``, ``pending``,
``head``, ``n_updates``, ``cell`` and ``cell_load`` exact; float metrics,
``p_ed``, ``pos`` and ``p_es_belief`` within rtol 1e-9 / atol 1e-12 (the
global sums reassociate).  Each rank holds its block of the final state
against its rows of the unsharded one.  One exception (`BATCH_ROUNDED`):
on the card the tableau LP's batched matrix products (cuBLAS) round a
lane's sums by the number of lanes in the call, so a tied LP of a shard
may carry another optimal basis than the same lane in the whole fleet's
call.  There a ``warm_basis`` row may differ only as a tie
(`tied_basis_failures`): at most `MAX_TIED_SHARE` of a shard's rows, and
each one the same LP in both runs (the last plan, recorded by
`primary_lps`), both bases optimal in their run's status, primal
feasible to `FEAS_TOL` and of the same objective to rtol 1e-9 / atol
1e-12, recomputed from the basis (`basis_certificate`).  Every metric and
every other state field is still held exactly.
Prints one JSON line per leg (walls, collectives and bytes a period,
pivot launches a period), then the verdict; exits 1 on any parity
failure.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

LEGS = ("tableau", "revised", "chaos", "chaos_trace", "poisson", "walk",
        "local", "local_by_cell")
LOCAL_LEGS = ("local", "local_by_cell")
CHAOS_FAULTS = dict(loss_rate=0.1, straggler_prob=0.15, straggler_mult=2.0,
                    link_degrade_prob=0.2, link_degrade_mag=0.5,
                    es_crash_prob=0.05)
RTOL, ATOL = 1e-9, 1e-12
EXACT_STATE = ("period", "pending", "head", "warm_basis", "n_updates",
               "cell", "cell_load", "seed")
CLOSE_STATE = ("p_ed", "pos", "p_es_belief")
# a rank waits this long for the others in a collective before failing
RANK_TIMEOUT_S = 300
# (device type, lp_method) whose warm bases depend on the call's lane count
BATCH_ROUNDED = {("cuda", "tableau")}
# the most of a shard's rows whose basis may differ there as a tie: the card
# showed 1,013-1,390 of 4,096 (25-34%) on the tableau and chaos legs
MAX_TIED_SHARE = 0.5
# a recomputed basic level below -FEAS_TOL, or a basic artificial above it,
# is infeasible (the simplex's own warm-start feasibility bar)
FEAS_TOL = 1e-9


# --------------------------------------------------------------------------
# ranks: one process per shard over a fresh group
# --------------------------------------------------------------------------
def _rank_device(rank: int, backend: str, device: str):
    import torch
    if device == "cpu":
        return torch.device("cpu")
    index = rank % torch.cuda.device_count() if backend == "nccl" \
        else torch.cuda.current_device()
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def _fleet_rank(rank: int, world: int, backend: str, fn: Callable,
                device: str, args: tuple):
    from ..api import engine as E
    return fn(rank, E.fleet_mesh(world), _rank_device(rank, backend, device),
              *args)


def spawn_ranks(fn: Callable, shards: int, *, backend: str = "gloo",
                device: str = "cpu", args: tuple = ()) -> List:
    """Run ``fn(rank, mesh, device, *args)`` on ``shards`` fresh processes,
    one rank each of a ``backend`` group (`distributed.ranks.run_ranks`)
    with the fleet mesh over it; returns each rank's result in rank
    order.  ``fn`` must be a module-level function.  A rank that raises
    raises here."""
    from ..distributed.ranks import run_ranks
    if device == "cpu" and backend != "gloo":
        raise ValueError(f"CPU ranks need the gloo backend; got {backend!r}")
    return run_ranks(_fleet_rank, shards, backend=backend,
                     args=(backend, fn, device, args),
                     timeout=RANK_TIMEOUT_S)


# --------------------------------------------------------------------------
# the legs' fleets
# --------------------------------------------------------------------------
def leg_params(leg: str, n_devices: int, periods: int, device):
    """The leg's whole-fleet `EngineParams` on ``device``."""
    from ..api import engine as E
    from ..core.faults import FaultModel, sample_trace
    from ..core.mobility import MobilityModel
    from ..serving.fleet import H100_ES, FleetConfig
    from .smoke_mobility import pair_geometry, LOCAL_KW
    mobile = leg == "walk" or leg in LOCAL_LEGS
    cfg = FleetConfig(
        n_devices=n_devices, T=1.2,
        n_servers=8 if mobile else max(1, n_devices // 16), policy="amr2",
        rate=8.0, batch_max=8, horizon=periods + 2, seed=0, **H100_ES)
    params = E.EngineParams.from_config(
        cfg, horizon=periods + 2,
        arrivals="poisson" if leg == "poisson" else "replay",
        lp_method="revised" if leg == "revised" else "tableau",
        device=device)
    if leg in ("chaos", "chaos_trace"):
        # mid-horizon outage flip on every 4th device: the stale-basis cold
        # start must agree across shards with the fault path armed
        outage = params.outage.clone()
        h = max(1, periods // 2)
        outage[::4, h:] = ~outage[::4, h:]
        params = dataclasses.replace(params, outage=outage)
        fm = FaultModel.make(**CHAOS_FAULTS)
        trace = (sample_trace(3, fm, n_devices, params.batch_max,
                              params.max_retries + 1, periods,
                              device=device)
                 if leg == "chaos_trace" else None)
        params = params.with_faults(fm, fault_seed=3, fault_trace=trace)
    if mobile:
        cxy, trace, order = pair_geometry(n_devices, periods)
        if leg == "walk":
            mob = MobilityModel.make(cell_xy=cxy, trace=trace[:1],
                                     walk_sigma=3.0, **LOCAL_KW)
            params = params.with_mobility(mob, mode="walk",
                                          routing="min_time",
                                          mobility_seed=5)
        else:
            mob = MobilityModel.make(cell_xy=cxy, trace=trace[:, order],
                                     **LOCAL_KW)
            params = params.with_mobility(
                mob, routing="min_time",
                shard_by_cell=leg == "local_by_cell")
    return params


def leg_problem(leg: str, n_devices: int, shards: int) -> Optional[str]:
    """Why the leg cannot run at this size, or None."""
    if n_devices % shards:
        return f"{n_devices} devices do not split into {shards} shards"
    if leg in LOCAL_LEGS and (4 % shards or n_devices % 4):
        return (f"{n_devices} devices on {shards} shards are no whole cell "
                f"pairs a shard (needs 1, 2 or 4 shards, devices % 4 == 0)")
    return None


# --------------------------------------------------------------------------
# one rank's checks
# --------------------------------------------------------------------------
def _compare(failures: list, tag: str, got, want, exact: bool) -> None:
    import torch
    got, want = got.detach().cpu(), want.detach().cpu()
    ok = got.shape == want.shape and (
        torch.equal(got, want) if exact or not got.is_floating_point()
        else torch.allclose(got, want, rtol=RTOL, atol=ATOL))
    if ok:
        return
    if got.shape != want.shape or got.dim() == 0:
        failures.append(f"{tag}: sharded {got.tolist()} != unsharded "
                        f"{want.tolist()}")
        return
    bad = (got != want).reshape(got.shape[0], -1).any(dim=1).nonzero()[:, 0]
    i = int(bad[0])
    failures.append(f"{tag}: {bad.numel()} of {got.shape[0]} rows differ; "
                    f"row {i}: sharded {got[i].tolist()} != unsharded "
                    f"{want[i].tolist()}")


@contextlib.contextmanager
def primary_lps(engine):
    """Record the engine's warm-started plan solves while the block runs:
    yields a dict that holds the last one's ``A``, ``b``, ``c``,
    ``status`` and ``basis`` (the lanes' bases the state carries; the
    backpressure replan starts cold and its bases are dropped)."""
    real = engine.simplex_batch_core
    rec: Dict = {}

    def solve(A, b, c_full, basis0, **kw):
        out = real(A, b, c_full, basis0, **kw)
        if basis0 is not None:
            rec.update(A=A, b=b, c=c_full, status=out[2], basis=out[4])
        return out

    engine.simplex_batch_core = solve
    try:
        yield rec
    finally:
        engine.simplex_batch_core = real


def basis_certificate(A, b, c, basis):
    """Each lane's vertex of ``basis`` recomputed from the LP ``A`` (L, R,
    C0), ``b`` (L, R), ``c`` (L, C0) in float64 on the host (a label
    ``>= C0`` is the virtual artificial of row ``label - C0``):
    ``(objective (L,), infeasibility (L,))``, the infeasibility the most a
    basic level falls below 0 or a basic artificial rises above it (inf
    for a singular basis)."""
    import torch
    A, b, c = (x.detach().cpu().to(torch.float64) for x in (A, b, c))
    basis = basis.detach().cpu().long()
    L, R, C0 = A.shape
    cols = torch.cat([A, torch.eye(R, dtype=A.dtype).expand(L, R, R)], 2)
    Bmat = torch.gather(cols, 2, basis[:, None, :].expand(L, R, R))
    xB, info = torch.linalg.solve_ex(Bmat, b)
    art = basis >= C0
    cB = torch.where(art, 0.0, torch.gather(c, 1, basis.clamp(max=C0 - 1)))
    infeas = torch.maximum(torch.clamp_min(-xB, 0.0).amax(dim=1),
                           torch.where(art, xB.abs(), 0.0).amax(dim=1))
    infeas = torch.where(info == 0, infeas, torch.inf)
    return (cB * xB).sum(dim=1), infeas


def tied_basis_failures(tag: str, lp_s: Dict, lp_u: Dict, rows: slice
                        ) -> tuple:
    """The `BATCH_ROUNDED` bar on a shard's carried bases: the rows of the
    sharded run's last plan (``lp_s``, `primary_lps`) whose basis differs
    from the unsharded run's (``lp_u``, its ``rows``) must be at most
    `MAX_TIED_SHARE` of the shard, hold the same LP to rtol 1e-9 / atol
    1e-12, be optimal in both runs' status, and each basis must be primal
    feasible to `FEAS_TOL` with the objectives equal to rtol 1e-9 / atol
    1e-12.  Returns ``(failures, rows differing, largest objective gap)``."""
    import torch
    from ..core.lp import OPTIMAL
    L = lp_s["basis"].shape[0]
    u = {k: v[rows] for k, v in lp_u.items()}
    differ = (lp_s["basis"] != u["basis"]).any(dim=1)
    idx = differ.nonzero()[:, 0]
    n = idx.numel()
    failures = []
    if n > MAX_TIED_SHARE * L:
        failures.append(f"{tag}: {n} of {L} warm_basis rows differ, above "
                        f"the tie share {MAX_TIED_SHARE}")
    if not n:
        return failures, 0, 0.0
    s_, u_ = ({k: v[idx].cpu() for k, v in lp.items()} for lp in (lp_s, u))

    def first(bad, what):
        if bool(bad.any()):
            i = int(bad.nonzero()[0, 0])
            failures.append(f"{tag}: {int(bad.sum())} of the {n} differing "
                            f"warm_basis rows {what}; shard row "
                            f"{int(idx[i])}: bases {s_['basis'][i].tolist()}"
                            f" vs {u_['basis'][i].tolist()}")

    same = torch.ones(n, dtype=torch.bool)
    for k in ("A", "b", "c"):
        close = torch.isclose(s_[k], u_[k], rtol=RTOL, atol=ATOL)
        same &= close.reshape(n, -1).all(dim=1)
    first(~same, "are not the same LP in both runs")
    first((s_["status"] != OPTIMAL) | (u_["status"] != OPTIMAL),
          "are not optimal in both runs")
    obj_s, inf_s = basis_certificate(s_["A"], s_["b"], s_["c"], s_["basis"])
    obj_u, inf_u = basis_certificate(u_["A"], u_["b"], u_["c"], u_["basis"])
    first(torch.maximum(inf_s, inf_u) > FEAS_TOL,
          f"are primal infeasible beyond {FEAS_TOL}")
    first(~torch.isclose(obj_s, obj_u, rtol=RTOL, atol=ATOL),
          "reach other objectives")
    gap = float((obj_s - obj_u).abs().max())
    return failures, n, gap


def _strays(state, params, periods: int, shards: int, dev):
    """``(device-periods routed to another shard's cells, the first as
    text)`` in the unsharded run of a local leg (shard r of n holds the
    cell pairs [4r/n, 4(r+1)/n), cells 2·pair and 2·pair + 1)."""
    from ..api import engine as E
    D = params.n_devices
    home = np.arange(D) // (D // shards)
    n, first, s = 0, "", state
    for t in range(periods):
        s, _m = E.step(s, params, device=dev)
        cell = s.cell.cpu().numpy()
        owner = (cell // 2) * shards // 4
        stray = np.nonzero((cell >= 0) & (owner != home))[0]
        if stray.size and not first:
            d = stray[0]
            first = (f"device {d} routes to cell {cell[d]} of shard "
                     f"{owner[d]} in period {t}")
        n += stray.size
    return n, first


def _pivot_launches() -> int:
    from ..kernels.simplex_pivot import ops
    return ops.pivot_update.launches + ops.reduced_pivot.launches


def _timed(fn, dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    n0, t0 = _pivot_launches(), time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0, _pivot_launches() - n0


def check_leg(rank: int, mesh, dev, leg: str, n_devices: int,
              periods: int) -> Dict:
    """One leg on this rank: ``{"failures": [...], "info": {...}}``."""
    import torch

    from .. import _mesh
    from ..api import engine as E
    failures: list = []
    params = leg_params(leg, n_devices, periods, dev)
    state = E.init_state(params, device=dev)
    sstate, sparams = E.shard(state, params, mesh)
    rows = slice(rank * sparams.n_devices, (rank + 1) * sparams.n_devices)
    tag = f"{leg}/rank {rank}"

    _u1, mu = E.step(state, params, device=dev)
    _s1, ms = E.step_sharded(sstate, sparams, mesh, device=dev)
    for f in E.METRIC_FIELDS:
        _compare(failures, f"{tag}/step/{f}", getattr(ms, f), getattr(mu, f),
                 exact=False)

    with primary_lps(E) as lp_u:
        (uf, MU), u_s, u_piv = _timed(
            lambda: E.rollout(state, params, periods, device=dev), dev)
    strays = (_strays(state, params, periods, mesh.size(), dev)
              if leg in LOCAL_LEGS else (0, ""))
    _mesh.reset_stats()
    with primary_lps(E) as lp_s:
        (sf, MS), s_s, s_piv = _timed(
            lambda: E.rollout_sharded(sstate, sparams, periods, mesh,
                                      device=dev), dev)
    stats = dict(_mesh.STATS)
    for f in E.METRIC_FIELDS:
        _compare(failures, f"{tag}/rollout/{f}", getattr(MS, f),
                 getattr(MU, f), exact=False)
    rounded = (dev.type, params.lp_method) in BATCH_ROUNDED
    for f in EXACT_STATE + CLOSE_STATE:
        want = getattr(uf, f)
        if want.dim() and f != "cell_load":
            want = want[rows]
        if f == "warm_basis" and rounded:
            continue
        _compare(failures, f"{tag}/final/{f}", getattr(sf, f), want,
                 exact=f in EXACT_STATE)
    for name, lp, final in (("unsharded", lp_u, uf), ("sharded", lp_s, sf)):
        if not ("basis" in lp and torch.equal(lp["basis"].to(torch.int32),
                                              final.warm_basis)):
            failures.append(f"{tag}: the {name} run's last recorded plan "
                            f"is not the one its state carries")
    basis_rows = int((sf.warm_basis != uf.warm_basis[rows]).any(dim=1)
                     .sum())
    gap = 0.0
    if rounded and not failures:
        tied, basis_rows, gap = tied_basis_failures(tag, lp_s, lp_u, rows)
        failures += tied
    if leg.startswith("chaos") and int(
            (MU.n_retries + MU.n_fallback_local + MU.n_dropped).sum()) == 0:
        failures.append(f"{tag}: chaos armed but the ladder never fired "
                        f"(vacuous parity)")
    if (leg == "walk" or leg in LOCAL_LEGS) and \
            int(MU.n_handover.sum()) == 0:
        failures.append(f"{tag}: no handover fired (vacuous mobility leg)")
    if failures and strays[0]:
        failures.append(f"{tag}: the fleet is not local ({strays[0]} stray "
                        f"device-periods; {strays[1]}): shard_by_cell needs "
                        f"each shard's devices in its own cells")
    return {"failures": failures, "info": dict(
        devices=n_devices, local_devices=sparams.n_devices, periods=periods,
        unsharded_s=u_s, sharded_s=s_s,
        collectives_per_period=stats["collectives"] / periods,
        bytes_gathered_per_period=stats["bytes_gathered"] / periods,
        bytes_reduced_per_period=stats["bytes_reduced"] / periods,
        pivot_launches_per_period=s_piv / periods,
        unsharded_pivot_launches_per_period=u_piv / periods,
        total_accuracy=float(MU.total_accuracy.sum()),
        handovers=int(MU.n_handover.sum()), stray_device_periods=strays[0],
        warm_basis_rows_differing=basis_rows, tied_objective_gap=gap,
        ladder=int((MU.n_retries + MU.n_fallback_local
                    + MU.n_dropped).sum()))}


def _rank_legs(rank: int, mesh, dev, plan: Sequence, periods: int) -> Dict:
    return {leg: check_leg(rank, mesh, dev, leg, n, periods)
            for leg, n in plan}


def run_legs(legs: Sequence[str], *, shards: int, devices: int,
             periods: int, local_devices: int = 32, backend: str = "gloo",
             device: str = "cpu") -> Dict[str, Dict]:
    """Every leg on ``shards`` spawned ranks, on fleets of ``devices``
    (``local_devices`` for the local legs): ``{leg: {"failures": [...]
    of every rank, "info": rank 0's numbers, "seconds": the wall of the
    whole spawn}}``.  A leg that cannot run at its size fails with the
    reason."""
    out, plan = {}, []
    for leg in legs:
        n = local_devices if leg in LOCAL_LEGS else devices
        why = leg_problem(leg, n, shards)
        if why:
            out[leg] = {"failures": [f"{leg}: {why}"], "info": {}}
        else:
            plan.append((leg, n))
    runnable = [leg for leg, _n in plan]
    if plan:
        t0 = time.perf_counter()
        ranks = spawn_ranks(_rank_legs, shards, backend=backend,
                            device=device, args=(plan, periods))
        seconds = time.perf_counter() - t0
        for leg in runnable:
            out[leg] = {"failures": [x for r in ranks
                                     for x in r[leg]["failures"]],
                        "info": ranks[0][leg]["info"], "seconds": seconds}
    return out


def _rank_rollout(rank: int, mesh, dev, fields: Dict, periods: int) -> Dict:
    from .. import convert
    from ..api import engine as E
    params = convert.params_from_numpy(fields, dev)
    sstate, sparams = E.shard(E.init_state(params, device=dev), params, mesh)
    final, m = E.rollout_sharded(sstate, sparams, periods, mesh, device=dev)
    return {"metrics": {f: getattr(m, f).tolist() for f in E.METRIC_FIELDS},
            "state": {f: getattr(final, f).tolist()
                      for f in E.STATE_FIELDS}}


def rollout_on_ranks(fields: Dict, periods: int, *, shards: int,
                     backend: str = "gloo", device: str = "cpu"):
    """`rollout_sharded` of the params `convert.params_from_numpy(fields)`
    describes (the reference engine's fields, as NumPy arrays and
    scalars), from a fresh state, on ``shards`` spawned ranks:
    ``(metrics, final state)`` as dicts of NumPy arrays, the metrics rank
    0's (every rank holds the same) and each per-device state field the
    ranks' blocks concatenated."""
    ranks = spawn_ranks(_rank_rollout, shards, backend=backend,
                        device=device, args=(fields, periods))
    metrics = {f: np.asarray(v) for f, v in ranks[0]["metrics"].items()}
    state = {}
    for f, v in ranks[0]["state"].items():
        parts = [np.asarray(r["state"][f]) for r in ranks]
        state[f] = (parts[0] if parts[0].ndim == 0 or f == "cell_load"
                    else np.concatenate(parts))
    return metrics, state


def _build_kernels(device: str) -> None:
    """Compile the pivot kernels once before the ranks start, so they do
    not all build the same library."""
    if device != "cpu":
        from ..kernels.simplex_pivot import ops
        ops.LIBRARY.build()


def main(argv: Optional[Sequence[str]] = None) -> int:
    from .._device import resolve_device
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--devices", type=int, default=64)
    ap.add_argument("--local-devices", type=int, default=32)
    ap.add_argument("--periods", type=int, default=8)
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--device", default=None,
                    help="cpu, or cuda (the default: the card)")
    ap.add_argument("--legs", default=",".join(LEGS),
                    help=f"comma-separated subset of {','.join(LEGS)}")
    args = ap.parse_args(argv)
    device = resolve_device(args.device).type
    legs = [x for x in args.legs.split(",") if x]
    unknown = sorted(set(legs) - set(LEGS))
    if unknown:
        ap.error(f"unknown legs {unknown}; choose from {LEGS}")
    _build_kernels(device)
    results = run_legs(legs, shards=args.shards, devices=args.devices,
                       periods=args.periods,
                       local_devices=args.local_devices,
                       backend=args.backend, device=device)
    failures = [x for r in results.values() for x in r["failures"]]
    print(json.dumps({"smoke_shard_rollout": {
        "shards": args.shards, "backend": args.backend, "device": device,
        "legs": {k: dict(v["info"], spawn_seconds=v.get("seconds"))
                 for k, v in results.items()}}}), flush=True)
    if failures:
        print("FAIL: sharded engine diverged from unsharded:",
              file=sys.stderr)
        for f in failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    acc = sum(r["info"]["total_accuracy"] for r in results.values())
    print(f"[shard-smoke] ok: {args.devices} devices x {args.periods} "
          f"periods on a {args.shards}-shard {args.backend} mesh match the "
          f"unsharded engine on legs {','.join(legs)} (total accuracy "
          f"{acc:.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
