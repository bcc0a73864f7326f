"""The logical-axis sharding rules on DTensor (ROADMAP §1 item 13)
against `repro.distributed.sharding`, exactly: the rule tables, `spec_for`
on every logical-axes tuple that `param_axes` and `cache_axes` give for
the 11 configs (base, decode and long-context rules, one pod and two),
`validate_divisibility`'s verdicts and messages, and on a (4, 2)
("data", "model") mesh — a `DeviceMesh` over an 8-rank ``fake`` process
group in this process — the local shapes of the placements against
`NamedSharding.shard_shape`.  Then `shard_activation`: a no-op without a
context, a redistribution to the logical axes under one (dropping axes
that do not divide), and `sharding_context`'s implicit replication of
plain tensors."""
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding as RefSharding

import repro.configs as ref_configs
import repro.distributed.sharding as ref_sh
import repro.models as ref_models
from repro_torch import configs
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import cache_axes, param_axes, param_shapes

ARCHS = configs.ARCHS
RULES = {
    "base": lambda mp: sh.base_rules(mp),
    "base_seq": lambda mp: sh.base_rules(mp, seq_shard=True),
    "decode": lambda mp: sh.decode_rules(mp),
    "long": lambda mp: sh.decode_rules(mp, long_context=True),
}
REF_RULES = {
    "base": lambda mp: ref_sh.base_rules(mp),
    "base_seq": lambda mp: ref_sh.base_rules(mp, seq_shard=True),
    "decode": lambda mp: ref_sh.decode_rules(mp),
    "long": lambda mp: ref_sh.decode_rules(mp, long_context=True),
}


def test_meshes_need_an_initialised_group():
    """Runs before the module's group exists (tests run in file order)."""
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="initialised default process"):
        make_mesh((1, 1), ("data", "model"))


@pytest.fixture(scope="module")
def mesh():
    """A (4, 2) mesh over an 8-rank fake group (this process is rank 0);
    the group is destroyed after the module's tests."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=8)
    try:
        yield make_mesh((4, 2), ("data", "model"))
    finally:
        dist.destroy_process_group()


def _axes_of(tree):
    out = []
    sh.map_axes(lambda a: out.append(a), tree)
    return out


def _all_axes():
    seen = set()
    for arch in ARCHS:
        cfg = configs.get_config(arch)
        for a in _axes_of(param_axes(cfg)) + _axes_of(cache_axes(cfg, 2, 64)):
            seen.add(a)
    return sorted(seen, key=repr)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("rules", sorted(RULES))
def test_rule_tables_equal_the_reference(rules, multi_pod):
    assert RULES[rules](multi_pod) == REF_RULES[rules](multi_pod)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("rules", sorted(RULES))
def test_spec_for_equals_the_reference(rules, multi_pod):
    r, rr = RULES[rules](multi_pod), REF_RULES[rules](multi_pod)
    axes = _all_axes()
    assert len(axes) > 40
    for a in axes + [("batch", "seq", "embed"), ("embed", "batch"), None]:
        got, want = sh.spec_for(a, r), ref_sh.spec_for(a, rr)
        assert tuple(got) == tuple(want), (a, got, want)


def _ref_mesh(shape, names):
    return types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(shape, dtype=object))


def _port_mesh(shape, names):
    return types.SimpleNamespace(mesh_dim_names=names, shape=shape)


@pytest.mark.parametrize("mesh_shape, names", [
    ((16, 16), ("data", "model")),
    ((2, 16, 16), ("pod", "data", "model")),
    ((3, 5), ("data", "model")),
    ((4, 6), ("data", "model")),
], ids=["16x16", "2x16x16", "3x5", "4x6"])
def test_validate_divisibility_as_the_reference(mesh_shape, names):
    multi = "pod" in names
    verdicts = []
    for arch in ARCHS:
        for rules in ("base", "decode"):
            cfg = configs.get_config(arch)
            rcfg = ref_configs.get_config(arch)
            args = (param_shapes(cfg), param_axes(cfg))
            rargs = (ref_models.param_shapes(rcfg),
                     ref_models.param_axes(rcfg))
            got = want = None
            try:
                sh.validate_divisibility(*args, _port_mesh(mesh_shape, names),
                                         RULES[rules](multi))
            except ValueError as e:
                got = str(e)
            try:
                ref_sh.validate_divisibility(
                    *rargs, _ref_mesh(mesh_shape, names),
                    REF_RULES[rules](multi))
            except ValueError as e:
                want = str(e)
            assert got == want, (arch, rules)
            verdicts.append(got is None)
    if mesh_shape == (3, 5):
        assert not any(verdicts)          # every model has a dim that fails


@pytest.mark.parametrize("arch", ARCHS)
def test_local_shapes_equal_shard_shape(mesh, arch):
    cfg = configs.get_config(arch)
    ref_mesh = AbstractMesh((4, 2), ("data", "model"))
    for rules in ("base", "decode", "long"):
        r = RULES[rules](False)
        trees = [(param_shapes(cfg), param_axes(cfg)),
                 (None, cache_axes(cfg, 8, 64))]
        for shapes, axes in trees:
            shard = sh.tree_shardings(axes, mesh, r)
            leaves = list(sh.zip_axes(shard, axes))
            if shapes is None:
                from repro_torch.models import cache_specs
                shapes = cache_specs(cfg, 8, 64)
            for (s, a), (t, _a) in zip(leaves, sh.zip_axes(shapes, axes)):
                assert isinstance(s, sh.NamedSharding)
                want = RefSharding(ref_mesh, jax.sharding.PartitionSpec(
                    *s.spec)).shard_shape(tuple(t.shape))
                assert s.shard_shape(t.shape) == tuple(want), (a, s.spec)


def test_placements_nest_over_two_mesh_axes(mesh):
    from torch.distributed.tensor import Replicate, Shard
    spec = sh.PartitionSpec(("data", "model"), None)
    assert tuple(spec) == (("data", "model"),)
    assert sh.placements_for(spec, mesh) == (Shard(0), Shard(0))
    assert sh.placements_for(sh.PartitionSpec(None, "model"), mesh) == (
        Replicate(), Shard(1))
    assert tuple(sh.PartitionSpec(("data",), None)) == ("data",)
    with pytest.raises(ValueError, match="mesh's order"):
        sh.placements_for(sh.PartitionSpec(("model", "data")), mesh)


def test_shard_activation_redistributes_only_under_a_context(mesh):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    x = DTensor.from_local(torch.zeros(2, 6, 8), mesh,
                           [Shard(0), Replicate()], run_check=False)
    assert sh.shard_activation(x, "batch", None, "act_embed") is x
    plain = torch.zeros(8, 6, 8)
    rules = sh.base_rules()
    with sh.sharding_context(mesh, rules):
        assert sh.shard_activation(plain, "batch", None, "act_embed") \
            is plain
        y = sh.shard_activation(x, "batch", None, "act_embed")
        assert y.placements == (Shard(0), Shard(2))
        assert y.to_local().shape == (2, 6, 4)
        assert sh.shard_activation(y, "batch", None, "act_embed") is y
        # 6 does not divide the 4-wide data axis: batch dropped
        z = sh.shard_activation(y, None, "batch", "act_embed")
        assert z.placements == (Replicate(), Shard(2))
        # plain tensors meet DTensors as replicated under the context
        w = y * torch.ones(8)
        assert isinstance(w, DTensor) and w.placements == y.placements
    with pytest.raises(RuntimeError, match="mixed torch.Tensor"):
        y * torch.ones(8)


def test_production_mesh_needs_its_world(mesh):
    with pytest.raises(ValueError, match="needs 256 ranks"):
        make_production_mesh()

