"""Parity helper for the port's tests, and the isolation rule it keeps.

The port's tests (`tests/test_torch_*.py`) run the JAX reference beside
`repro_torch` in the same pytest worker as the reference's own test
files.  The reference imports `jax.experimental.enable_x64` inside its
float64 entry points; jax 0.9 dropped that name (it lives on as
`jax.enable_x64`).  `reference_x64()` aliases it only for the duration of
a reference call and then restores the module exactly as it was.  The
body also runs under jax's scoped float64 context, so reference functions
without a scope of their own (kernel oracles, LP constructors) compute in
float64; the global ``jax_enable_x64`` flag is never updated.  Nothing a
port test does leaks into the reference's own tests on the same worker.

Rules for every `tests/test_torch_*.py`: import jax and torch at the top
and keep JAX on the CPU; pass data between the two only as NumPy arrays
made from a seed; decide whether a card is present only inside a fixture
or a test (never at import or collection time).
"""
import contextlib

import jax
import jax.experimental
import numpy as np
import pytest
import torch

_MISSING = object()


@contextlib.contextmanager
def reference_x64():
    """Scope in which the reference's ``from jax.experimental import
    enable_x64`` resolves (to ``jax.enable_x64``) and jax computes in
    float64.  On exit the attribute is restored to its prior state —
    deleted if it was absent."""
    prior = jax.experimental.__dict__.get("enable_x64", _MISSING)
    jax.experimental.enable_x64 = jax.enable_x64
    try:
        with jax.enable_x64(True):
            yield
    finally:
        if prior is _MISSING:
            del jax.experimental.enable_x64
        else:
            jax.experimental.enable_x64 = prior


def to_numpy(x):
    """A reference (jax) or port (torch) array as NumPy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# the helper's own contract
# ---------------------------------------------------------------------------
def test_scope_aliases_and_restores_absent_attribute():
    had = "enable_x64" in jax.experimental.__dict__
    flag = jax.config.jax_enable_x64
    with reference_x64():
        from jax.experimental import enable_x64
        assert enable_x64 is jax.enable_x64
        with enable_x64():
            assert jax.numpy.zeros(1, float).dtype == np.float64
    assert ("enable_x64" in jax.experimental.__dict__) == had
    assert jax.config.jax_enable_x64 == flag


def test_scope_restores_a_prior_attribute_and_the_flag():
    sentinel = object()
    prior = jax.experimental.__dict__.get("enable_x64", _MISSING)
    jax.experimental.enable_x64 = sentinel
    try:
        flag = jax.config.jax_enable_x64
        with pytest.raises(RuntimeError):
            with reference_x64():
                raise RuntimeError("reference call failed")
        assert jax.experimental.enable_x64 is sentinel
        assert jax.config.jax_enable_x64 == flag
    finally:
        if prior is _MISSING:
            del jax.experimental.enable_x64
        else:
            jax.experimental.enable_x64 = prior


def test_reference_call_leaves_global_x64_flag_off():
    from repro.core import InstanceBatch, random_instance, solve_lp_batch
    from repro.core.amr2 import build_lp_arrays_batch
    flag = jax.config.jax_enable_x64
    had = "enable_x64" in jax.experimental.__dict__
    batch = InstanceBatch.stack([random_instance(4, 2, T=1.0, seed=s)
                                 for s in range(3)])
    with reference_x64():
        res = solve_lp_batch(*build_lp_arrays_batch(batch))
    assert res.x.dtype == np.float64
    assert jax.config.jax_enable_x64 == flag
    assert ("enable_x64" in jax.experimental.__dict__) == had


def test_port_calls_keep_torch_defaults():
    from repro_torch.core.lp import simplex_batch_core
    from repro_torch.core.amr2 import build_lp_arrays_torch
    dtype, threads = torch.get_default_dtype(), torch.get_num_threads()
    rng = np.random.default_rng(0)
    p_ed = torch.as_tensor(rng.uniform(0.01, 0.3, (3, 4, 2)))
    p_es = torch.as_tensor(rng.uniform(0.1, 0.5, (3, 4)))
    acc = torch.as_tensor(np.sort(rng.uniform(0.3, 0.9, (3, 3)), axis=1))
    A, b, c = build_lp_arrays_torch(p_ed, p_es, acc, torch.full((3,), 0.6,
                                                          dtype=torch.float64))
    simplex_batch_core(A, b, c, None, nv=12, maxiter=64)
    assert torch.get_default_dtype() == dtype
    assert torch.get_num_threads() == threads


def reference_fault_draws(fm, fault_seed, n_devices, n_jobs, max_retries,
                          periods):
    """The reference's fault realizations of ``periods`` periods, drawn
    with the key its engine step builds for period t
    (``fold_in(PRNGKey(fault_seed), t)``), as NumPy named tuples: what
    `repro_torch.convert.fault_trace_from_numpy` stacks into the port's
    replayed ``fault_trace``."""
    from repro.core.faults import sample_realization
    with reference_x64():
        return [jax.tree.map(np.asarray, sample_realization(
            jax.random.fold_in(jax.random.PRNGKey(fault_seed), t), fm,
            n_devices, n_jobs, max_retries + 1)) for t in range(periods)]


def reference_arm_uniforms(hi_seed, period, n_devices):
    """The (D,) uniforms the reference engine's EXP3 rule draws in period
    t: the second half of ``split(fold_in(PRNGKey(hi_seed), t))``, folded
    by global device id, as its `hi_period` does (under a replayed
    confidence stream too): what the port's ``hi_arm_trace`` replays."""
    import jax.numpy as jnp
    with reference_x64():
        _kc, ka = jax.random.split(jax.random.fold_in(
            jax.random.PRNGKey(hi_seed), period))
        kd = jax.vmap(lambda g: jax.random.fold_in(ka, g))(
            jnp.arange(n_devices, dtype=jnp.int32))
        return np.asarray(jax.vmap(lambda k: jax.random.uniform(
            k, dtype=jnp.float64))(kd))
