"""The port's period-T serving runtime (`repro_torch.serving.executor`,
`runtime`, `profile`) and its launcher's `make_apply` against the
reference's, on the CPU.

Both packages plan the same instances through their own front door
(`solve`): identical jobs (AMDP under ``policy="auto"``) and jobs whose
times all differ (AMR^2; ROADMAP §3 item 2 holds tied LPs only to equal
optima, since their pivot paths may pick other, equally good jobs), and
execute with the same deterministic fake apply functions.
Wall times are replaced by a fake clock (each module's `time` is patched
with one whose `perf_counter` advances only inside the fake applies), so
the measured walls, and with them the straggler audit, are the same
numbers in both packages; real wall times are never compared.  Compared:
routing (`per_model`), per-sample `status`, `replanned` and the ES-outage
replan, dropped samples, every `PeriodStats` field except
``plan_seconds``, and the profile after each audit (exactly).

`make_apply` runs paper_edge's SMOKE model in float32 on parameters
carried over from the reference's `init_params`; its per-job top-1
accuracies equal the reference's `examples/serve_offload.py:make_apply`
(imported by path) exactly.
"""
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models as ref_models
import repro.serving.executor as ref_executor
import repro.serving.profile as ref_profile
import repro.serving.runtime as ref_runtime
from repro.api import Problem as RefProblem
from repro.api import solve as ref_solve
from repro.data.pipeline import DataConfig, TokenPipeline
from repro_torch import configs, convert
from repro_torch.api import Problem, solve
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import serve as port_serve
from repro_torch.serving import executor, profile, runtime
from test_torch_parity_util import reference_x64

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeClock:
    """Stands in for the `time` module: ``perf_counter`` returns a
    counter that only `advance` moves."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        return self.t

    def advance(self, seconds):
        self.t += seconds


@pytest.fixture
def clocks(monkeypatch):
    """One fake clock per package, patched into its executor and profile
    modules."""
    ref_clock, port_clock = FakeClock(), FakeClock()
    for mod in (ref_executor, ref_profile):
        monkeypatch.setattr(mod, "time", ref_clock)
    for mod in (executor, profile):
        monkeypatch.setattr(mod, "time", port_clock)
    return ref_clock, port_clock


def _applies(clock, costs, es_cost, short_es=False):
    """Fake apply functions: model i costs ``costs[i]`` seconds per job on
    the fake clock and returns (i, first token) per job; the ES returns
    one result fewer than its jobs when ``short_es``."""
    def ed(i):
        def apply(jobs):
            clock.advance(costs[i] * len(jobs))
            return [(i, int(j[0])) for j in jobs]
        return apply

    def es(jobs):
        clock.advance(es_cost * len(jobs))
        out = [("es", int(j[0])) for j in jobs]
        return out[:-1] if short_es else out

    return [ed(i) for i in range(len(costs))], es


def _jobs(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 100, 8) for _ in range(n)]


_R = np.random.default_rng(5)
_P0 = _R.uniform(0.005, 0.02, 12)
PROFILES = {
    "identical": ref_profile.TierProfile(
        name="ladder", p_ed=np.array([[0.010, 0.020]]),
        p_es=np.array([0.030]), acc=np.array([0.4, 0.6, 0.9]),
        classes=[64]),
    # one class per job, times drawn apart: no two jobs tie in the LP
    "heterogeneous": ref_profile.TierProfile(
        name="ladder", p_ed=np.stack([_P0, _P0 * _R.uniform(1.5, 2.5, 12)],
                                     axis=1),
        p_es=_R.uniform(0.01, 0.03, 12), acc=np.array([0.4, 0.6, 0.9]),
        classes=list(range(12))),
}


def _port_profile(p):
    return profile.TierProfile(name=p.name, p_ed=p.p_ed.copy(),
                               p_es=p.p_es.copy(), acc=p.acc.copy(),
                               classes=list(p.classes))


def _classes(kind, n):
    return np.full(n, 64) if kind == "identical" else np.arange(n)


@pytest.mark.parametrize("short_es", [False, True])
@pytest.mark.parametrize("es_fail", [False, True])
@pytest.mark.parametrize("policy", ["auto", "amr2", "greedy"])
@pytest.mark.parametrize("kind", sorted(PROFILES))
def test_execute_matches_reference(clocks, kind, policy, es_fail, short_es):
    ref_clock, port_clock = clocks
    n, T = 12, 0.1            # the ED tier alone cannot run every job
    prof = PROFILES[kind]
    inst = prof.instance(_classes(kind, n), T)
    jobs = _jobs(n)
    with reference_x64():
        want_sol = ref_solve(RefProblem.from_instance(inst), policy=policy)
        ref_ed, ref_es = _applies(ref_clock, [0.01, 0.02], 0.03, short_es)
        want = ref_executor.execute(want_sol, ref_ed, ref_es, jobs,
                                    es_fail=es_fail)
    sol = solve(Problem.from_instance(_port_profile(prof).instance(
        _classes(kind, n), T)), policy=policy, device="cpu")
    assert sol.solver_name == want_sol.solver_name
    assert sorted(sol.per_model) == sorted(want_sol.per_model)
    for i, ids in want_sol.per_model.items():
        np.testing.assert_array_equal(sol.per_model[i], ids)
    ed, es = _applies(port_clock, [0.01, 0.02], 0.03, short_es)
    got = executor.execute(sol, ed, es, jobs, es_fail=es_fail, device="cpu")
    np.testing.assert_array_equal(got.status, want.status)
    assert got.results == want.results
    assert got.replanned == want.replanned
    assert got.n_dropped == want.n_dropped
    assert (got.ed_wall, got.es_wall, got.predicted_makespan) == \
        (want.ed_wall, want.es_wall, want.predicted_makespan)
    offloaded = len(want_sol.per_model.get(2, ()))
    assert offloaded > 0                      # every plan uses the ES
    if es_fail:
        assert got.replanned                  # the outage path ran
        assert (got.status == executor.EXEC_FALLBACK_LOCAL).sum() == \
            offloaded - got.n_dropped


def test_exec_codes_match_reference():
    for name in ("EXEC_OK_ED", "EXEC_OK_ES", "EXEC_FALLBACK_LOCAL",
                 "EXEC_DROPPED", "EXEC_STATUS_NAMES"):
        assert getattr(executor, name) == getattr(ref_executor, name)


@pytest.mark.parametrize("ema", [0.5, 0.25])
@pytest.mark.parametrize("threshold", [1.5, 1.2])
def test_audit_profile_matches_reference(threshold, ema):
    """Including the exact tie ``measured == threshold * predicted`` and a
    zero prediction."""
    prof = PROFILES["heterogeneous"]
    for predicted, measured in ((0.0, 1.0), (2.0, 3.0), (2.0, 2.4),
                                (2.0, 3.0000001), (0.1, 0.9), (1.0, 0.2)):
        want, w_up = ref_runtime.audit_profile(
            prof, predicted, measured, threshold=threshold, ema=ema)
        got, g_up = runtime.audit_profile(
            _port_profile(prof), predicted, measured, threshold=threshold,
            ema=ema)
        assert g_up == w_up
        np.testing.assert_array_equal(got.p_ed, want.p_ed)
        np.testing.assert_array_equal(got.p_es, want.p_es)


def test_serving_runtime_matches_reference(clocks):
    """Five periods: normal, ES outage (replan), a 3x ED straggler (the
    audit rescales p_ed), and two after it, with the new profile."""
    ref_clock, port_clock = clocks
    n, T = 10, 0.12
    prof = PROFILES["identical"]
    ref_rt = ref_runtime.ServingRuntime(prof, *_applies(ref_clock,
                                                        [0.01, 0.02], 0.03),
                                        T=T)
    rt = runtime.ServingRuntime(_port_profile(prof),
                                *_applies(port_clock, [0.01, 0.02], 0.03),
                                T=T, device="cpu")
    for period in range(5):
        if period == 2:
            ref_rt.apply_ed = _applies(ref_clock, [0.03, 0.06], 0.03)[0]
            rt.apply_ed = _applies(port_clock, [0.03, 0.06], 0.03)[0]
        jobs = _jobs(n, seed=period)
        with reference_x64():
            want = ref_rt.run_period(jobs, np.full(n, 64),
                                     es_fail=(period == 1))
        got = rt.run_period(jobs, np.full(n, 64), es_fail=(period == 1))
        w, g = dataclasses.asdict(want), dataclasses.asdict(got)
        w.pop("plan_seconds"), g.pop("plan_seconds")
        assert g == w, period
        np.testing.assert_array_equal(rt.profile.p_ed, ref_rt.profile.p_ed)
    flags = [(s.replanned, s.profile_updated) for s in rt.history]
    assert flags[1] == (True, False) and flags[2] == (False, True)


def test_serving_runtime_dual_policy_is_not_ported():
    """(Name kept from before the dual scheduler was ported.)  The dual
    policy plans now: every period is booked under ``"dual"`` with every
    job landed."""
    rt = runtime.ServingRuntime(_port_profile(PROFILES["identical"]),
                                [lambda j: j] * 2, lambda j: j, T=1.0,
                                policy="dual", device="cpu")
    stats = rt.run_period(_jobs(4), np.full(4, 64))
    assert stats.policy == "dual" and stats.n_jobs == 4
    assert stats.n_dropped == 0 and stats.total_accuracy > 0


def test_measure_profiles_matches_reference(clocks):
    """Medians over the fake clock, ES comm added, ED models ordered by
    accuracy."""
    ref_clock, port_clock = clocks

    def fns(clock):
        return {name: (lambda b, c=cost: (clock.advance(c * len(b)), b)[1])
                for name, cost in (("big", 0.02), ("small", 0.01),
                                   ("es", 0.005))}

    batches = [np.zeros((2, 4)), np.zeros((3, 4))]
    accs = {"big": 0.6, "small": 0.4, "es": 0.9}
    args = (accs, "es", [0.001, 0.002], [64, 128])
    want = ref_profile.measure_profiles(fns(ref_clock), batches, *args,
                                        iters=3)
    got = profile.measure_profiles(fns(port_clock), batches, *args, iters=3)
    for f in ("p_ed", "p_es", "acc"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert list(got.classes) == list(want.classes)


def test_block_waits_only_for_cuda_outputs(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: synced.append(1))
    profile._block([torch.zeros(2), {"a": (1.0, torch.ones(1))}])
    assert not synced
    assert profile.measure_latency(lambda: [0.5], (), iters=2) >= 0.0


def _reference_make_apply():
    spec = importlib.util.spec_from_file_location(
        "serve_offload_reference",
        os.path.join(REPO, "examples", "serve_offload.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make_apply


def test_make_apply_matches_reference():
    """paper_edge SMOKE in float32, parameters carried over, 6 jobs
    (bucketed to 8) and 3 jobs (bucketed to 4) of 64 tokens."""
    ref_cfg = dataclasses.replace(
        ref_configs.get_smoke_config("paper_edge"), dtype="float32")
    cfg = dataclasses.replace(configs.get_smoke_config("paper_edge"),
                              dtype="float32", attn_impl="auto")
    ref_params = ref_models.init_params(ref_cfg, jax.random.key(3))
    params = convert.model_params_from_numpy(
        jax.tree.map(np.asarray, ref_params), device="cpu")
    (cfg_p, params_p), = port_serve.build_models([cfg], params=[params],
                                                 device="cpu")
    ref_apply = _reference_make_apply()(ref_cfg, ref_params)
    apply = port_serve.make_apply(cfg_p, params_p)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                    global_batch=8, seed=7))
    jobs = list(pipe.batch_at(0)["tokens"][:6])
    fa_ops.reset_launches()
    for batch in (jobs, jobs[:3]):
        want = ref_apply([jnp.asarray(j) for j in batch])
        got = apply(batch)
        assert got == want
    assert sum(got) > 0                   # not all-zero accuracies
    assert fa_ops.flash_attention_fwd.launches == 0


def test_launcher_runs_on_cpu_with_an_outage(capsys):
    """The port's `main` at a small size, the ladder untrained (its
    default of 20 steps is minutes of CPU; `test_torch_serve_train.py`
    trains it): every period lands all jobs and the ES-outage period
    replans."""
    history = port_serve.main(["--periods", "3", "--n", "6",
                               "--fail-period", "1", "--train-steps", "0",
                               "--device", "cpu"])
    assert len(history) == 3
    assert all(s.n_dropped == 0 and s.n_jobs == 6 for s in history)
    assert all(np.isfinite([s.predicted_makespan, s.wall_makespan,
                            s.total_accuracy]).all() for s in history)
    assert not history[0].replanned and not history[2].replanned
    out = capsys.readouterr().out
    assert out.count("[serve] period") == 3
