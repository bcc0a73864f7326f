"""Checkpoints across the packages (`checkpoint.manager`): the same
format on disk, so a checkpoint the reference writes — (params,
AdamWState) with a bfloat16 and a float8_e4m3fn leaf — is read by the
port bit for bit, and the reverse; published steps only (a `.tmp`
directory is ignored); `rotate`, `latest_step` and `AsyncCheckpointer`.
"""
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint.manager as ref_ckpt
import repro.optim as ref_optim
from repro_torch import _tree
from repro_torch import optim
from repro_torch.checkpoint import manager as ckpt


def _tree_np(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((4, 6)).astype(np.float32),
            "blocks": ({"z": rng.standard_normal((2, 3)).astype(np.float32),
                        "a": rng.standard_normal(5).astype(np.float32)},),
            "emb16": rng.standard_normal((3, 4)).astype(np.float32),
            "fp8": rng.standard_normal(9).astype(np.float32) * 40}


def _ref_state(seed):
    t = jax.tree.map(jnp.asarray, _tree_np(seed))
    t["emb16"] = t["emb16"].astype(jnp.bfloat16)
    t["fp8"] = t["fp8"].astype(jnp.float8_e4m3fn)
    opt = ref_optim.adamw_init(t)
    opt = opt._replace(step=jnp.asarray(7, jnp.int32),
                       m=jax.tree.map(lambda x: x + 0.25, opt.m))
    return t, opt


def _port_state(seed):
    t = jax.tree.map(torch.as_tensor, _tree_np(seed))
    t["emb16"] = t["emb16"].to(torch.bfloat16)
    t["fp8"] = t["fp8"].to(torch.float8_e4m3fn)
    opt = optim.adamw_init(t)
    opt = opt._replace(step=torch.tensor(7, dtype=torch.int32),
                       m=_tree.tree_map(lambda x: x + 0.25, opt.m))
    return t, opt


def _bits(x):
    """A leaf of either package as (dtype name, shape, bytes)."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).split(".")[-1]
        return (name, tuple(x.shape),
                x.reshape(-1).view(torch.uint8).numpy().tobytes())
    a = np.asarray(x)
    return str(a.dtype), a.shape, a.tobytes()


def _assert_same_bits(port_tree, ref_tree):
    got = _tree.leaves(port_tree)
    want = jax.tree_util.tree_leaves(ref_tree)
    assert len(got) == len(want) == 16
    for g, w in zip(got, want):
        assert _bits(g) == _bits(w)


def test_port_reads_reference_checkpoint_bit_for_bit(tmp_path):
    d = str(tmp_path)
    ref_ckpt.save(d, 3, _ref_state(0), {"step": 3, "note": "ref"})
    like = _port_state(1)
    restored, meta = ckpt.restore(d, 3, like)
    assert meta == {"step": 3, "note": "ref"}
    _assert_same_bits(restored, _ref_state(0))
    params, opt = restored
    assert isinstance(opt, optim.AdamWState) and int(opt.step) == 7
    assert params["emb16"].dtype == torch.bfloat16
    assert params["fp8"].dtype == torch.float8_e4m3fn


def test_reference_reads_port_checkpoint_bit_for_bit(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 5, _port_state(2), {"step": 5})
    with open(os.path.join(d, "step_000000005", "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["n_leaves"] == 16
    assert [e["raw"] for e in manifest["leaves"]][:4] == [False, False,
                                                         True, True]
    restored, meta = ref_ckpt.restore(d, 5, _ref_state(3))
    assert meta == {"step": 5}
    _assert_same_bits(_port_state(2), restored)


def test_manifests_are_the_same_but_the_treedef_string(tmp_path):
    ref_ckpt.save(str(tmp_path / "r"), 1, _ref_state(4), {"step": 1})
    ckpt.save(str(tmp_path / "p"), 1, _port_state(4), {"step": 1})
    docs = []
    for side in ("r", "p"):
        with open(tmp_path / side / "step_000000001" / "manifest.json") as f:
            m = json.load(f)
        m.pop("treedef")
        docs.append(m)
    assert docs[0] == docs[1]
    for i in range(16):
        name = f"leaf_{i:05d}.npy"
        a = np.load(tmp_path / "r" / "step_000000001" / name)
        b = np.load(tmp_path / "p" / "step_000000001" / name)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_restore_places_leaves_on_like_and_checks_shapes(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 0, {"a": torch.arange(6, dtype=torch.int32).view(2, 3)})
    out, _ = ckpt.restore(d, 0, {"a": torch.zeros(2, 3)})
    assert out["a"].dtype == torch.float32 and out["a"].tolist() == \
        [[0, 1, 2], [3, 4, 5]]
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(d, 0, {"a": torch.zeros(3, 2)})
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(d, 0, {"a": torch.zeros(2, 3), "b": torch.zeros(1)})


def test_tmp_directory_is_ignored_and_rotate_keeps_the_newest(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 4, 9):
        ckpt.save(d, s, {"x": torch.full((2,), float(s))})
    os.makedirs(os.path.join(d, "step_000000012.tmp"))   # a crashed write
    assert ckpt.latest_step(d) == 9
    assert ref_ckpt.latest_step(d) == 9
    ckpt.rotate(d, keep=2)
    assert sorted(os.listdir(d)) == ["step_000000004", "step_000000009",
                                     "step_000000012.tmp"]
    assert ckpt.latest_step(str(tmp_path / "none")) is None


def test_async_checkpointer_copies_at_submit_and_drains(tmp_path):
    d = str(tmp_path)
    w = ckpt.AsyncCheckpointer(d, keep=2)
    x = {"x": torch.zeros(3)}
    for s in range(4):
        w.submit(s, x, {"step": s})
        x["x"].add_(1.0)                  # the trainer goes on in place
    w.wait()
    assert not w._thread.is_alive()
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(d))
    assert len(steps) <= 2 and steps[-1] == 3
    out, meta = ckpt.restore(d, 3, {"x": torch.empty(3)})
    assert meta == {"step": 3} and out["x"].tolist() == [3.0] * 3
