"""The sharding metadata and the dry run's input grid (ROADMAP §1 item
13) against the reference, exactly: `param_axes`, `param_shapes`,
`cache_axes` and `cache_specs` of all 11 configs leaf for leaf in
`jax.tree_util`'s order (axes, shapes and dtypes); `cell_supported`,
`shape_overrides` and the inputs' shapes, dtypes and axes of every
(arch, shape) cell."""
import dataclasses

import jax
import numpy as np
import pytest
import torch  # noqa: F401

import repro.configs as ref_configs
import repro.launch.specs as ref_specs
import repro.models as ref_models
from repro_torch import configs
from repro_torch.launch import specs
from repro_torch.models import (cache_axes, cache_specs, param_axes,
                                param_shapes)

ARCHS = configs.ARCHS
assert len(ARCHS) == 11 and ARCHS == ref_configs.ARCHS


def _is_axes(x):
    return x is None or (isinstance(x, tuple) and x != () and all(
        e is None or isinstance(e, str) for e in x))


def flat(tree, path=""):
    """(path, leaf) pairs, dict keys sorted; an axes tuple, None, a
    tensor or a shape stand-in is a leaf; an empty tuple has none."""
    if _is_axes(tree) or hasattr(tree, "shape") or isinstance(tree, int):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in flat(tree[k],
                                                        f"{path}/{k}")]
    return [pl for i, t in enumerate(tree) for pl in flat(t, f"{path}/{i}")]


def sd(leaf):
    """(shape, dtype name) of a torch meta tensor or a jax stand-in."""
    dt = leaf.dtype
    name = str(dt).replace("torch.", "") if isinstance(dt, torch.dtype) \
        else np.dtype(dt).name
    return tuple(leaf.shape), name


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_and_shapes_equal_the_reference(arch):
    cfg, rcfg = configs.get_config(arch), ref_configs.get_config(arch)
    got, want = flat(param_axes(cfg)), flat(ref_models.param_axes(rcfg))
    assert got == want
    shapes = [(p, sd(t)) for p, t in flat(param_shapes(cfg))]
    ref_shapes = [(p, sd(t)) for p, t in flat(
        ref_models.param_shapes(rcfg))]
    assert shapes == ref_shapes
    assert [p for p, _ in shapes] == [p for p, _ in got]


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_axes_and_specs_equal_the_reference(arch):
    cfg, rcfg = configs.get_config(arch), ref_configs.get_config(arch)
    B, S = 2, 48
    assert flat(cache_axes(cfg, B, S)) == flat(
        ref_models.cache_axes(rcfg, B, S))
    got = [(p, sd(t)) for p, t in flat(cache_specs(cfg, B, S))]
    want = [(p, sd(t)) for p, t in flat(ref_models.cache_specs(rcfg, B, S))]
    assert got == want
    assert all(t.device.type == "meta"
               for _p, t in flat(cache_specs(cfg, B, S)))


@pytest.mark.parametrize("shape", list(specs.SHAPES))
def test_cells_and_overrides_equal_the_reference(shape):
    assert specs.SHAPES == ref_specs.SHAPES
    assert specs.FULL_ATTENTION_ARCHS == ref_specs.FULL_ATTENTION_ARCHS
    assert specs.PERF_OVERRIDES == ref_specs.PERF_OVERRIDES
    for arch in ARCHS:
        assert specs.cell_supported(arch, shape) == \
            ref_specs.cell_supported(arch, shape)
        cfg = specs.shape_overrides(configs.get_config(arch), shape)
        rcfg = ref_specs.shape_overrides(ref_configs.get_config(arch), shape)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)


@pytest.mark.parametrize("shape", list(specs.SHAPES))
def test_input_specs_and_axes_equal_the_reference(shape):
    for arch in ARCHS:
        cfg = specs.shape_overrides(configs.get_config(arch), shape)
        rcfg = ref_specs.shape_overrides(ref_configs.get_config(arch), shape)
        got = [(p, sd(t)) for p, t in flat(specs.input_specs(cfg, shape))]
        want = [(p, sd(t)) for p, t in flat(ref_specs.input_specs(rcfg,
                                                                  shape))]
        assert got == want, arch
        assert flat(specs.batch_axes(cfg, shape)) == flat(
            ref_specs.batch_axes(rcfg, shape)), arch
