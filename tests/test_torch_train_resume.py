"""Preemption and resume of the training driver (`launch.train.main`)
and its example (`examples.train_lm`) on mamba2's smoke config, in this
process, on the CPU: ``--preempt-file`` (or SIGTERM) exits with 42 after
a synchronous save, and ``--resume`` then equals an uninterrupted run
bit for bit — its losses and every leaf of its final checkpoint.
"""
import os
import signal

import jax  # noqa: F401  (the port's tests import both frameworks)
import numpy as np
import pytest
import torch

from repro_torch import _tree, configs
from repro_torch.checkpoint import manager as ckpt
from repro_torch.examples import train_lm
from repro_torch.launch import train
from repro_torch.optim import adamw_init

ARGS = ["--arch", "mamba2-130m", "--smoke", "--global-batch", "4",
        "--seq", "32", "--log-every", "100"]


@pytest.fixture(autouse=True)
def _one_thread():
    """Smoke-sized steps: one intra-op thread (as fast alone, and no
    oversubscription when several test workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _run(tmp, name, extra):
    argv = ARGS + ["--steps", "6", "--seed", "1", "--ckpt-every", "2",
                   "--ckpt-dir", str(tmp / name), "--device", "cpu",
                   "--compress-grads"] + extra
    try:
        return 0, train.main(argv)
    except SystemExit as e:
        return e.code, None


def test_preempt_then_resume_with_compressed_grads(tmp_path):
    """With ``--compress-grads``: the sentinel preempts after step 0 (exit
    42, step 0 saved) and ``--resume`` completes from step 1.  The int8
    residual is not checkpointed (as in the reference), so the resumed
    run equals the uninterrupted one up to its first compressed update:
    the loss at step 1."""
    rc, whole = _run(tmp_path, "cont", [])
    assert rc == 0 and len(whole) == 6
    sentinel = tmp_path / "PREEMPT"
    sentinel.touch()
    rc, _ = _run(tmp_path, "cut", ["--preempt-file", str(sentinel)])
    assert rc == train.PREEMPTED == 42
    assert ckpt.latest_step(str(tmp_path / "cut")) == 0
    os.remove(sentinel)
    rc, rest = _run(tmp_path, "cut", ["--resume"])
    assert rc == 0 and len(rest) == 5
    assert rest[0] == whole[1]
    assert ckpt.latest_step(str(tmp_path / "cut")) == 5


def test_resume_is_bit_for_bit(tmp_path):
    argv = ARGS + ["--steps", "6", "--seed", "2", "--ckpt-every", "2",
                   "--device", "cpu"]
    whole = train.main(argv + ["--ckpt-dir", str(tmp_path / "cont")])
    sentinel = tmp_path / "PREEMPT"
    sentinel.touch()
    with pytest.raises(SystemExit) as exc:
        train.main(argv + ["--ckpt-dir", str(tmp_path / "cut"),
                           "--preempt-file", str(sentinel)])
    assert exc.value.code == 42
    os.remove(sentinel)
    rest = train.main(argv + ["--ckpt-dir", str(tmp_path / "cut"),
                              "--resume"])
    assert rest == whole[1:]
    p0 = train.init_params(configs.get_smoke_config("mamba2-130m"), 0,
                           device="cpu")
    like = (p0, adamw_init(p0))
    a, _ = ckpt.restore(str(tmp_path / "cont"), 5, like)
    b, _ = ckpt.restore(str(tmp_path / "cut"), 5, like)
    for x, y in zip(_tree.leaves(a), _tree.leaves(b)):
        assert torch.equal(x, y)


def test_sigterm_preempts(tmp_path, monkeypatch):
    """SIGTERM sets the flag; the driver saves and exits 42."""
    sent = []

    def step_and_signal(*a, **k):
        if not sent:
            sent.append(True)
            os.kill(os.getpid(), signal.SIGTERM)
        return real(*a, **k)
    real = train.TokenPipeline.batch_at
    monkeypatch.setattr(train.TokenPipeline, "batch_at", step_and_signal)
    previous = signal.getsignal(signal.SIGTERM)
    with pytest.raises(SystemExit) as exc:
        train.main(ARGS + ["--steps", "4", "--device", "cpu",
                           "--ckpt-dir", str(tmp_path)])
    assert exc.value.code == 42
    assert ckpt.latest_step(str(tmp_path)) == 0
    assert signal.getsignal(signal.SIGTERM) == previous


def test_train_lm_example_preempts_and_resumes(tmp_path):
    rc1, rc2, losses = train_lm.main(["--steps", "6", "--preempt-after",
                                      "0", "--device", "cpu",
                                      "--ckpt-dir", str(tmp_path / "ck")])
    assert (rc1, rc2) == (42, 0)
    assert len(losses) == 5 and np.isfinite(losses).all()
