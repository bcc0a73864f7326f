"""The train step on DTensor parameters (ROADMAP §1 item 13), mirroring
the reference's `tests/test_distributed.py::test_train_step_sharded_8dev`:
internlm2's SMOKE model in float32, a (4, 2) ("data", "model") mesh over
8 gloo CPU ranks, the base rules, 3 AdamW steps at lr 1e-2 on one (8, 32)
batch.  Each rank's losses, gradient norms and the loss on the final
parameters (the last update's check) equal the port's unsharded step on
the same weights to 1e-5 relative, the final parameters within lr / 10
(`smoke_sharded_train.compare`); the losses equal the reference's
sharded step (8 host devices, in a child process) on the weights
`convert` carries over, to the train step's 1e-5
(`tests/test_torch_train_step.py`); the loss falls.  Then a
MoE model (granite-moe's SMOKE) in two microbatches a step on a batch
handed over split over "batch", on a (2, 2) mesh: one capacity group a
microbatch, so the microbatches must hold the reference's rows for its
drops, and so its losses, to match the unsharded step's."""
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import torch

import repro.models as ref_models
from repro_torch import convert
from repro_torch.distributed.ranks import run_ranks
from repro_torch.models import init_params
from repro_torch.scripts import smoke_sharded_train as S

import test_torch_lm_util as U

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
RANK_TIMEOUT_S = 300
LR, STEPS = 1e-2, 3

REFERENCE = textwrap.dedent("""
    import dataclasses, json, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_smoke_config
    from repro.distributed.sharding import (base_rules, sharding_context,
                                            tree_shardings)
    from repro.launch.mesh import make_mesh
    from repro.launch.steps import make_train_step
    from repro.models import init_params, param_axes
    from repro.optim import adamw_init
    tokens = jnp.asarray(np.load(sys.argv[1]))
    cfg = dataclasses.replace(get_smoke_config("internlm2_20b"),
                              dtype="float32")
    mesh = make_mesh((4, 2), ("data", "model"))
    rules = base_rules(False)
    p_shard = tree_shardings(param_axes(cfg), mesh, rules)
    with sharding_context(mesh, rules):
        params = jax.device_put(init_params(cfg, jax.random.key(0)),
                                p_shard)
        opt = adamw_init(params)
        step = jax.jit(make_train_step(cfg, lr=%r), donate_argnums=(0, 1))
        losses = []
        for _ in range(%d):
            params, opt, loss = step(params, opt, {"tokens": tokens})
            losses.append(float(loss))
    print("REF_LOSSES " + json.dumps(losses))
""" % (LR, STEPS))


def test_sharded_step_equals_unsharded_and_the_reference(tmp_path):
    cfg = S.smoke_config("internlm2_20b")
    rcfg, _ = U.cfgs("internlm2_20b", "float32")
    params_np = jax.tree.map(
        np.asarray, ref_models.init_params(rcfg, jax.random.key(0)))
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 32)).astype(np.int32)
    np.save(tmp_path / "tokens.npy", tokens)
    child = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(tmp_path / "tokens.npy")],
        env=dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=8"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ranks = run_ranks(S.sharded_rank, 8,
                          args=((4, 2), "internlm2_20b", params_np, tokens,
                                STEPS, LR), timeout=RANK_TIMEOUT_S)
        out, err = child.communicate(timeout=RANK_TIMEOUT_S)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    want = S.run_steps(cfg, convert.model_params_from_numpy(params_np,
                                                            "cpu"),
                       {"tokens": torch.as_tensor(tokens)}, STEPS, LR)
    want["params"] = S.to_numpy(want["params"])
    for r, res in enumerate(ranks):
        assert S.compare(res, want, LR) is None, (r, S.compare(res, want,
                                                               LR))
    assert ranks[0]["params"] is not None
    assert want["losses"][-1] < want["losses"][0]

    assert child.returncode == 0, err[-4000:]
    line = [ln for ln in out.splitlines() if ln.startswith("REF_LOSSES")]
    ref_losses = json.loads(line[0].split(" ", 1)[1])
    np.testing.assert_allclose(ranks[0]["losses"], ref_losses, rtol=1e-5)


def test_sharded_moe_microbatches_hold_the_global_rows():
    over = dict(microbatches=2, moe_groups=1, capacity_factor=0.5)
    cfg = S.smoke_config("granite_moe_1b_a400m", **over)
    params_np = S.to_numpy(init_params(cfg, 0, device="cpu"))
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (8, 32)).astype(np.int32)
    ranks = run_ranks(S.sharded_rank, 4,
                      args=((2, 2), "granite_moe_1b_a400m", params_np,
                            tokens, 2, LR, over, True),
                      timeout=RANK_TIMEOUT_S)
    want = S.run_steps(cfg, convert.model_params_from_numpy(params_np,
                                                            "cpu"),
                       {"tokens": torch.as_tensor(tokens)}, 2, LR)
    want["params"] = S.to_numpy(want["params"])
    for r, res in enumerate(ranks):
        assert S.compare(res, want, LR) is None, (r, S.compare(res, want,
                                                               LR))
