"""The sharded engine (`repro_torch.api.engine` `fleet_mesh`, `shard`,
`step_sharded`, `rollout_sharded`, ``shard_by_cell``) against the
unsharded engine and against the reference's sharded rollout.

Inside the port: `repro_torch.scripts.smoke_shard_rollout` spawns 2 and 4
gloo ranks on the CPU and holds every leg (replay under both LP methods,
chaos with the outage flip, drawn and replayed, Poisson arrivals, the
walk, the local replayed fleet plainly sharded and sharded by cell)
against the unsharded rollout: integer metrics and carried state exact,
floats within rtol 1e-9 / atol 1e-12.  Across packages: the reference's
`rollout_sharded` on 4 host-platform jax devices (a subprocess: the XLA
flag must precede jax's import) against the port's on 4 ranks, the same
replayed fleet carried across, audit threshold 1.4 (ROADMAP §3 item 1),
metrics and state but not the carried bases (item 2).
"""
import datetime
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import _mesh, convert
from repro_torch.api import engine as PE
from repro_torch.core.faults import FaultModel, sample_trace
from repro_torch.core.mobility import MobilityModel
from repro_torch.scripts import smoke_shard_rollout as SR
from repro_torch.serving.fleet import H100_ES, FleetConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
# (shards, devices, local-leg devices, periods) of the two spawned runs
RUNS = {2: (16, 16, 4), 4: (32, 32, 4)}


@pytest.fixture(scope="module")
def legs():
    """Every leg on 2 and on 4 gloo ranks: one spawn per rank count."""
    return {shards: SR.run_legs(SR.LEGS, shards=shards, devices=d,
                                local_devices=dl, periods=p,
                                backend="gloo", device="cpu")
            for shards, (d, dl, p) in RUNS.items()}


@pytest.mark.parametrize("leg", SR.LEGS)
@pytest.mark.parametrize("shards", sorted(RUNS))
def test_rollout_sharded_equals_rollout(legs, shards, leg):
    res = legs[shards][leg]
    assert not res["failures"], "\n".join(res["failures"])
    info = res["info"]
    assert info["local_devices"] * shards == info["devices"]
    assert info["warm_basis_rows_differing"] == 0
    if leg.startswith("chaos"):
        assert info["ladder"] > 0
    if leg in ("walk", "local", "local_by_cell"):
        assert info["handovers"] > 0


@pytest.mark.parametrize("shards", sorted(RUNS))
def test_four_collectives_a_period(legs, shards):
    """One gather (or, by cell, one all-reduce of the per-cell loads) and
    three packed metric reductions a period, whatever the scenario; the
    gather moves the fleet's (D,) float64 demand, with the cell beside
    it when admission is per cell."""
    for leg, res in legs[shards].items():
        info = res["info"]
        D = info["devices"]
        assert info["collectives_per_period"] == 4, leg
        gathered = {"walk": 16 * D, "local": 16 * D,
                    "local_by_cell": 0}.get(leg, 8 * D)
        assert info["bytes_gathered_per_period"] == gathered, leg


def test_chaos_drawn_equals_replayed_trace(legs):
    """The chaos leg's faults drawn per shard from (fault seed, period)
    and the same faults replayed from `sample_trace` give one rollout."""
    for shards in RUNS:
        a, b = (legs[shards][k]["info"] for k in ("chaos", "chaos_trace"))
        assert a["total_accuracy"] == b["total_accuracy"]
        assert a["ladder"] == b["ladder"]


# --------------------------------------------------------------------------
# the tie bar the card's tableau bases are held to (`BATCH_ROUNDED`)
# --------------------------------------------------------------------------
# minimize -x0 - x1 subject to x0 + x1 + s == 1: x0 and x1 are tied optima
# (objective -1), the slack a feasible vertex of objective 0, and the row's
# artificial (label 3) basic at level 1 infeasible
_TIE_A = torch.tensor([[[1.0, 1.0, 1.0]]], dtype=torch.float64)
_TIE_B = torch.tensor([[1.0]], dtype=torch.float64)
_TIE_C = torch.tensor([[-1.0, -1.0, 0.0]], dtype=torch.float64)


def _tie_lps(bases, status=0):
    L = len(bases)
    return {"A": _TIE_A.expand(L, 1, 3).clone(),
            "b": _TIE_B.expand(L, 1).clone(),
            "c": _TIE_C.expand(L, 3).clone(),
            "status": torch.full((L,), status, dtype=torch.int32),
            "basis": torch.tensor(bases, dtype=torch.int32)[:, None]}


def test_basis_certificate_recomputes_each_vertex():
    obj, infeas = SR.basis_certificate(
        _TIE_A.expand(4, 1, 3), _TIE_B.expand(4, 1), _TIE_C.expand(4, 3),
        torch.tensor([[0], [1], [2], [3]]))
    assert obj.tolist() == [-1.0, -1.0, 0.0, 0.0]
    assert infeas.tolist() == [0.0, 0.0, 0.0, 1.0]


@pytest.mark.parametrize("case", ["tied", "suboptimal", "infeasible",
                                  "share", "other_lp", "status"])
def test_tied_basis_failures(case):
    """Bases that differ between the sharded and the unsharded run pass
    only as ties: the same LP, optimal in both, feasible, of one
    objective, and at most `MAX_TIED_SHARE` of the shard."""
    unsharded = _tie_lps([1, 1, 0, 0, 0, 1])
    sharded = {"tied": [0, 1, 0, 0], "suboptimal": [0, 2, 0, 0],
               "infeasible": [0, 3, 0, 0], "share": [0, 1, 1, 0],
               "other_lp": [0, 1, 0, 0], "status": [0, 1, 0, 0]}[case]
    lp_s = _tie_lps(sharded, status=2 if case == "status" else 0)
    if case == "other_lp":
        lp_s["c"][0, 0] = -1.5
    failures, n, gap = SR.tied_basis_failures("t", lp_s, unsharded,
                                              slice(1, 5))
    want = {"tied": None, "suboptimal": "other objectives",
            "infeasible": "primal infeasible", "share": "tie share",
            "other_lp": "not the same LP", "status": "not optimal"}[case]
    if want is None:
        assert failures == [] and n == 2 and gap == 0.0
    else:
        assert any(want in f for f in failures), failures


# --------------------------------------------------------------------------
# a shard's draws are its rows of the whole fleet's draw
# --------------------------------------------------------------------------
class _StubMesh:
    """Rank ``rank`` of a ``size``-rank CPU mesh, for code that reads the
    axis and issues no collective."""

    device_type = "cpu"

    def __init__(self, rank, size):
        self.rank, self.n = rank, size

    def get_group(self, _name):
        return None

    def get_local_rank(self, _name):
        return self.rank

    def size(self):
        return self.n


def _fleet(n_devices=12, arrivals="replay"):
    cfg = FleetConfig(n_devices=n_devices, T=1.2, n_servers=2, rate=8.0,
                      batch_max=8, horizon=6, seed=0, **H100_ES)
    return PE.EngineParams.from_config(cfg, arrivals=arrivals, device=CPU)


@pytest.mark.parametrize("rank", [0, 1, 2])
def test_shard_draws_are_rows_of_the_fleet_draw(rank):
    """Poisson counts and classes, drawn faults and walk steps of a shard
    (rank of 3) equal its rows of the unsharded draws of every period."""
    rng = np.random.default_rng(0)
    p = _fleet(12, "poisson").with_faults(
        FaultModel.make(loss_rate=0.3, straggler_prob=0.4,
                        link_degrade_prob=0.5, link_degrade_mag=0.5),
        fault_seed=4)
    mob = MobilityModel.make(cell_xy=np.zeros((2, 2)) + [[0, 0], [5, 0]],
                             trace=rng.normal(size=(1, 12, 2)),
                             walk_sigma=2.0)
    p = p.with_mobility(mob, mode="walk", mobility_seed=9)
    state = PE.init_state(p, seed=3, device=CPU)
    mesh = _StubMesh(rank, 3)
    ls, lp = PE.shard(state, p, mesh)
    axis = _mesh.FleetAxis.of(mesh, CPU)
    rows = slice(4 * rank, 4 * rank + 4)
    assert lp.n_devices == 4 and lp.rate.shape == (12,)
    for t in range(3):
        whole = PE._arrivals(state, p, t)
        part = PE._arrivals(ls, lp, t, axis)
        for w, x in zip(whole[:3], part[:3]):
            assert torch.equal(w[rows], x)
        rw, rx = PE._realization(p, t), PE._realization(lp, t, axis)
        assert torch.equal(rw.es_crash, rx.es_crash)
        for w, x in zip(rw[1:], rx[1:]):
            assert torch.equal(w[rows], x)
        assert torch.equal(PE._positions(state, p, t)[rows],
                           PE._positions(ls, lp, t, axis))


def test_shard_splits_per_device_leaves_only():
    p = _fleet(12)
    fm = FaultModel.make(loss_rate=0.2)
    p = p.with_faults(fm, fault_trace=sample_trace(1, fm, 12, 8, 3, 4,
                                                   device=CPU))
    state = PE.init_state(p, device=CPU)
    ls, lp = PE.shard(state, p, _StubMesh(1, 2))
    rows = slice(6, 12)
    for f in ("base_p_ed", "p_es", "acc", "drift", "outage", "stream"):
        assert torch.equal(getattr(lp, f), getattr(p, f)[rows]), f
    assert torch.equal(lp.counts, p.counts[:, rows])
    for f in ("T", "rate", "class_probs"):
        assert torch.equal(getattr(lp, f), getattr(p, f)), f
    assert torch.equal(lp.fault_trace.es_crash, p.fault_trace.es_crash)
    assert torch.equal(lp.fault_trace.lost, p.fault_trace.lost[:, rows])
    for f in ("p_ed", "pending", "warm_basis", "pos", "cell",
              "p_es_belief"):
        assert torch.equal(getattr(ls, f), getattr(state, f)[rows]), f
    for f in ("period", "cell_load", "seed"):
        assert torch.equal(getattr(ls, f), getattr(state, f)), f
    assert torch.equal(ls.hi.theta, state.hi.theta[rows])


# --------------------------------------------------------------------------
# guards
# --------------------------------------------------------------------------
def test_shard_refuses_a_fleet_the_mesh_does_not_divide():
    p = _fleet(12)
    with pytest.raises(ValueError, match="fleet size 12 does not divide "
                                         "the 5-device mesh"):
        PE.shard(PE.init_state(p, device=CPU), p, _StubMesh(0, 5))


def test_sharded_entry_points_refuse_hi_and_differentiable_params():
    from repro_torch.core.hi import HIModel
    p = _fleet(8)
    hi = p.with_hi(HIModel.make(), rule="threshold")
    s = PE.init_state(hi, device=CPU)
    for call in (lambda: PE.shard(s, hi, None),
                 lambda: PE.step_sharded(s, hi, None, device=CPU),
                 lambda: PE.rollout_sharded(s, hi, 2, None, device=CPU)):
        with pytest.raises(ValueError, match="sharded entry points do not "
                                             r"support armed HI \(hi_rule="
                                             "'threshold'\\)"):
            call()
    diff = p.with_differentiable()
    s = PE.init_state(diff, device=CPU)
    for call in (lambda: PE.step_sharded(s, diff, None, device=CPU),
                 lambda: PE.rollout_sharded(s, diff, 2, None, device=CPU)):
        with pytest.raises(ValueError, match="do not support "
                                             "differentiable params"):
            call()


def test_sharded_entry_points_refuse_unsharded_params():
    """Params not cut by `shard` (the whole fleet's tables on a 2-rank
    mesh) are refused before any collective."""
    p = _fleet(8)
    with pytest.raises(ValueError, match="pass the block"):
        PE.rollout_sharded(PE.init_state(p, device=CPU), p, 2,
                           _StubMesh(0, 2), device=CPU)


def test_fleet_mesh_needs_an_initialised_group(tmp_path):
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="init_process_group"):
        PE.fleet_mesh()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        with pytest.raises(ValueError, match="init_process_group"):
            PE.fleet_mesh(2)
        mesh = PE.fleet_mesh(1)
        assert mesh.mesh_dim_names == ("fleet",) and mesh.size() == 1
        # a world of one is the unsharded rollout, bit for bit
        p = _fleet(8)
        s0 = PE.init_state(p, device=CPU)
        uf, mu = PE.rollout(s0, p, 3, device=CPU)
        sf, ms = PE.rollout_sharded(*PE.shard(s0, p, mesh), 3, mesh,
                                    device=CPU)
        for f in PE.METRIC_FIELDS:
            assert torch.equal(getattr(mu, f), getattr(ms, f)), f
        for f in PE.STATE_FIELDS:
            assert torch.equal(getattr(uf, f), getattr(sf, f)), f
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# across packages: the reference's sharded rollout on 4 host devices
# --------------------------------------------------------------------------
_REFERENCE = textwrap.dedent('''
    import json, sys
    import numpy as np
    sys.path[:0] = [sys.argv[1], sys.argv[2]]
    import jax
    from test_torch_parity_util import reference_x64
    from repro.api import engine as RE
    from repro.serving import FleetConfig
    assert len(jax.devices()) == 4, jax.devices()
    out, periods = sys.argv[3], int(sys.argv[4])
    runs = {}
    with reference_x64():
        for method in ("tableau", "revised"):
            cfg = FleetConfig(n_devices=64, T=1.2, n_servers=4, rate=8.0,
                              batch_max=8, horizon=periods + 2, seed=0,
                              straggler_threshold=1.4)
            p = RE.EngineParams.from_config(cfg, horizon=periods + 2,
                                            lp_method=method)
            mesh = RE.fleet_mesh(4)
            ss, sp = RE.shard(RE.init_state(p), p, mesh)
            sf, ms = RE.rollout_sharded(ss, sp, periods, mesh)
            leaves = {f: np.asarray(getattr(p, f))
                      for f in RE._PARAM_LEAVES
                      if f not in ("faults", "mobility", "hi")}
            np.savez(f"{out}/{method}.npz",
                     **{"p." + k: v for k, v in leaves.items()},
                     **{"m." + f: np.asarray(getattr(ms, f))
                        for f in RE._METRIC_FIELDS},
                     **{"s." + f: np.asarray(getattr(sf, f))
                        for f in ("p_ed", "pending", "head", "warm_basis",
                                  "n_updates")})
            runs[method] = {f: getattr(p, f) for f in RE._PARAM_AUX}
    with open(f"{out}/aux.json", "w") as fh:
        json.dump(runs, fh)
''')


@pytest.fixture(scope="module")
def reference_sharded(tmp_path_factory):
    out = tmp_path_factory.mktemp("reference_sharded")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE, os.path.join(REPO, "tests"),
         os.path.join(REPO, "src"), str(out), "4"],
        env=env, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out / "aux.json") as fh:
        aux = json.load(fh)
    return {m: (dict(np.load(out / f"{m}.npz")), aux[m]) for m in aux}


@pytest.mark.parametrize("lp_method", ["tableau", "revised"])
def test_rollout_sharded_matches_the_reference_sharded(reference_sharded,
                                                       lp_method):
    """Metrics and state (beliefs, backlog, cursors, audit counts) equal;
    the carried bases are not compared across packages: on this fleet a
    few devices' tied LPs carry another optimal basis in each package
    (ROADMAP §3 item 2), while every metric agrees.  Inside the port the
    legs above hold the sharded bases to the unsharded ones exactly."""
    arrays, aux = reference_sharded[lp_method]
    fields = {k[2:]: v for k, v in arrays.items() if k.startswith("p.")}
    fields.update({k: tuple(v) if isinstance(v, list) else v
                   for k, v in aux.items()})
    metrics, state = SR.rollout_on_ranks(fields, 4, shards=4)
    for f in PE.METRIC_FIELDS:
        want = arrays["m." + f]
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(metrics[f], want, rtol=0, atol=1e-9,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(metrics[f], want, err_msg=f)
    for f in ("pending", "head", "n_updates"):
        np.testing.assert_array_equal(state[f], arrays["s." + f], err_msg=f)
    np.testing.assert_allclose(state["p_ed"], arrays["s.p_ed"], rtol=0,
                               atol=1e-9)
    assert metrics["n_backpressured"].sum() > 0
    # the carried params describe the same fleet as the port builds
    carried = convert.params_from_numpy(fields, CPU)
    assert carried.n_devices == 64 and carried.straggler_threshold == 1.4
