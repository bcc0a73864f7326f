"""The serve launcher's training (`launch.serve.build_models(train_steps=)`
and ``--train-steps``): the ladder trained as the reference's
`examples/serve_offload.build_models` trains it, and `main` training
before it serves."""
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest  # noqa: F401
import torch  # noqa: F401

import repro.models as ref_models
from repro.data.pipeline import DataConfig, TokenPipeline
from repro_torch import convert
from repro_torch.launch import serve as port_serve
from test_torch_lm_util import leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _serve_offload(monkeypatch, ladder):
    """The reference's examples/serve_offload.py (imported by path), its
    ladder (ED variants, then the ES config) replaced by ``ladder``."""
    spec = importlib.util.spec_from_file_location(
        "serve_offload_reference",
        os.path.join(REPO, "examples", "serve_offload.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "ED_VARIANTS", ladder[:-1])
    monkeypatch.setattr(mod, "ES_CFG", ladder[-1])
    return mod


def _smoke_ladder(mod):
    """paper_edge's SMOKE at widths 0.25, 0.5 and 1 (2 layers each),
    float32, attention "auto"."""
    base = dataclasses.replace(mod.SMOKE, dtype="float32", attn_impl="auto")
    return [base.scaled(0.25), base.scaled(0.5), base]


def test_build_models_trains_the_ladder_as_the_reference(monkeypatch):
    """`build_models(train_steps=2)` over a ladder of paper_edge's SMOKE
    (float32; the full ladder costs ~2 s of CPU a step) from the
    reference's initial parameters: model i after 2 · (i + 1) AdamW
    steps at lr 3e-3 with dense attention on the reference's batches.
    Every parameter within lr / 20 of the reference's (an element whose
    gradient is within rounding of zero takes another Adam step size),
    the per-job hits of `make_apply` equal to the reference's."""
    from repro.configs import paper_edge as ref_edge
    from repro_torch.configs import paper_edge as edge
    ref_ladder, ladder = _smoke_ladder(ref_edge), _smoke_ladder(edge)
    ref = _serve_offload(monkeypatch, ref_ladder)
    want = ref.build_models(seed=0, train_steps=2)
    init = [convert.model_params_from_numpy(jax.tree.map(
        np.asarray, ref_models.init_params(c, jax.random.key(i))), "cpu")
        for i, c in enumerate(ref_ladder)]
    got = port_serve.build_models(ladder, seed=0, device="cpu",
                                  params=init, train_steps=2)
    pipe = TokenPipeline(DataConfig(vocab_size=ladder[-1].vocab_size,
                                    seq_len=64, global_batch=8, seed=7))
    jobs = list(pipe.batch_at(0)["tokens"])
    for (rcfg, rp), (cfg, pp), p0 in zip(want, got, init):
        assert cfg.attn_impl == "auto"         # serving keeps its config
        moved = 0.0
        for (path, a), (_q, b), (_r, c) in zip(
                leaves(pp), leaves(jax.tree.map(np.asarray, rp)),
                leaves(p0)):
            a, c = a.numpy(), c.numpy()
            np.testing.assert_allclose(a, b, rtol=0, atol=3e-3 / 20,
                                       err_msg=path)
            moved = max(moved, float(np.abs(a - c).max()))
        assert moved > 1e-3                     # it did train
        # the same hits per job (a mean of 63 hits: 1e-6 is an ulp, a
        # hit 1/63)
        np.testing.assert_allclose(
            port_serve.make_apply(cfg, pp)(jobs),
            ref.make_apply(rcfg, rp)([jnp.asarray(j) for j in jobs]),
            rtol=1e-6)


def test_launcher_trains_before_serving(capsys, monkeypatch):
    """`main(["--train-steps", ...])` trains the ladder before it plans,
    here the SMOKE ladder in the launcher's place (the full ladder costs
    ~2 s of CPU a train step): each model's accuracy on the test jobs
    rises above its untrained one.  (No ordering by capacity is
    asserted: the reference's ladder is not ordered at its own defaults
    either — a_1, a_2, a_es = 0.1845, 0.1726, 0.1845 after 20 steps,
    0.2103, 0.1845, 0.1845 after 30, on the launcher's test jobs;
    ROADMAP §1.)"""
    from repro_torch.configs import paper_edge as edge
    ladder = _smoke_ladder(edge)
    monkeypatch.setattr(port_serve, "LADDER", tuple(ladder))
    monkeypatch.setattr(port_serve, "ES_CFG", ladder[-1])

    def accuracies(steps):
        port_serve.main(["--periods", "1", "--n", "4", "--train-steps",
                         str(steps), "--device", "cpu"])
        line = [ln for ln in capsys.readouterr().out.splitlines()
                if "ladder accuracies" in ln][0]
        return [float(x) for x in line.split("accuracies [")[1]
                .split("]")[0].split()]
    untrained, trained = accuracies(0), accuracies(1)
    assert len(trained) == 3
    assert all(t > u for t, u in zip(trained, untrained)), \
        (untrained, trained)
