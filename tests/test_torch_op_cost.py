"""`launch.op_cost` (the counterpart of `repro.launch.hlo_cost`), case for
case with the reference's `tests/test_hlo_cost.py` and its bands: 8
chained 128³ bfloat16 products, the same nested 3 x 8, a gather of 8 rows
from a 50000 x 256 table, four all-reduces of 64 float32 on a 2-rank
gloo world; then the dot flops of an internlm2 SMOKE forward against
the reference's compiled HLO (its dots summed with `hlo_cost._dot_flops`
and multiplied by their loops' trip counts), the same dense attention on
both sides, within 1%; and the counts per rank under DTensor."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.models as ref_models
from repro.launch import hlo_cost
from repro_torch import convert
from repro_torch.distributed.ranks import run_ranks
from repro_torch.launch import op_cost
from repro_torch.models import forward

import test_torch_lm_util as U

RANK_TIMEOUT_S = 120


def test_chained_products_count_their_dots():
    x = torch.randn(128, 128, dtype=torch.bfloat16)
    w = torch.randn(8, 128, 128, dtype=torch.bfloat16)

    def f(x, w):
        for i in range(8):
            x = x @ w[i]
        return x
    _y, r = op_cost.analyze(f, x, w)
    expect = 8 * 2 * 128 ** 3
    assert expect * 0.95 <= r["flops"] <= expect * 1.15
    assert r["dot_flops"] == expect
    assert r["unparsed_loops"] == 0


def test_nested_products():
    x = torch.randn(128, 128, dtype=torch.bfloat16)
    w = torch.randn(8, 128, 128, dtype=torch.bfloat16)

    def g(x, w):
        for _ in range(3):
            for i in range(8):
                x = x @ w[i]
        return x
    _y, r = op_cost.analyze(g, x, w)
    expect = 3 * 8 * 2 * 128 ** 3
    assert expect * 0.95 <= r["flops"] <= expect * 1.15


@pytest.mark.parametrize("gather", ["index", "index_select", "embedding"])
def test_gather_counts_slice_not_operand(gather):
    table = torch.randn(50000, 256)
    idx = torch.arange(8) * 997
    fn = {"index": lambda t, i: t[i],
          "index_select": lambda t, i: torch.index_select(t, 0, i),
          "embedding": lambda t, i: torch.nn.functional.embedding(i, t)}
    _y, r = op_cost.analyze(fn[gather], table, idx)
    table_bytes = 50000 * 256 * 4
    assert 0 < r["bytes"] < table_bytes / 10      # far below a table read


def test_views_move_nothing_and_live_bytes_peak():
    a = torch.randn(64, 64)
    with op_cost.OpCost(baseline=a.numel() * 4) as c:
        v = a.t()[:32].reshape(-1)
        b = a * 2.0                         # 16 KiB live
        del b
        d = (a + 1.0).sum()
    r = c.result()
    assert v.numel() == 2048 and float(d) == float((a + 1).sum())
    assert r["flops"] == 64 * 64 * 2 + 1
    # the argument, the transposed slice's copy (reshape of a non-
    # contiguous view), b, then a + 1 in b's place and its 4-byte sum
    assert r["peak_live_bytes"] == (64 * 64 + 32 * 64 + 64 * 64) * 4 + 4
    assert c.live == (64 * 64 + 32 * 64) * 4 + 4      # b, a + 1 freed


def _four_all_reduces(rank, world):
    from torch.distributed import _functional_collectives as fc
    x = torch.ones(64, dtype=torch.float32) * (rank + 1)
    with op_cost.OpCost() as c:
        for _ in range(2):
            dist.all_reduce(x)
        for _ in range(2):
            x = fc.all_reduce(x, "sum", dist.group.WORLD)
        x = fc.wait_tensor(x)
    return c.result(), float(x[0])


def test_collectives_counted_per_kind():
    for res, x0 in run_ranks(_four_all_reduces, 2,
                             timeout=RANK_TIMEOUT_S):
        assert res["coll_bytes"] == 4 * 64 * 4       # 4 x 64 float32
        assert res["coll_counts"] == {"all-reduce": 4}
        assert res["coll_by_kind"] == {"all-reduce": 4 * 64 * 4}
        assert x0 == 3.0 * 2 ** 3


def _dtensor_product(rank, world):
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((2,), ("model",))
    a = distribute_tensor(torch.ones(16, 32), mesh, [Shard(0)])
    w = distribute_tensor(torch.ones(32, 8), mesh, [Shard(1)])
    with op_cost.OpCost() as c:
        y = (a @ w).full_tensor()
    return c.result(), float(y.sum())


def test_dtensor_ops_are_counted_on_the_local_shards():
    """Per rank: the product of a (8, 32) row shard with the gathered
    (32, 8) weight, and the all-gathers DTensor issues — not the global
    (16, 32) @ (32, 8) that `FlopCounterMode` would report."""
    for res, total in run_ranks(_dtensor_product, 2,
                                timeout=RANK_TIMEOUT_S):
        assert total == 16 * 8 * 32
        assert res["dot_flops"] == 2 * 8 * 8 * 32
        assert res["coll_counts"].get("all-gather", 0) >= 1


def _dtensor_product_one_rank(rank, world):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1,), ("model",))
    a = distribute_tensor(torch.ones(16, 32), mesh, [Shard(0)])
    w = distribute_tensor(torch.ones(32, 8), mesh, [Replicate()])
    with op_cost.OpCost() as c:
        y = a @ w
    return c.result(), float(y.to_local().sum())


def test_dtensor_product_on_one_rank_counts_the_local_product_alone():
    """On a 1-rank mesh the local product is the whole one, and nothing
    else is counted: DTensor's shape propagation, which runs the same
    product on fake tensors, stays out of the count."""
    (res, total), = run_ranks(_dtensor_product_one_rank, 1,
                              timeout=RANK_TIMEOUT_S)
    assert total == 16 * 8 * 32
    assert res["dot_flops"] == res["flops"] == 2 * 16 * 8 * 32
    assert res["coll_counts"] == {}


def test_refuses_a_torch_without_the_propagation_hooks(monkeypatch):
    """Where DTensor's private propagation methods are missing, the mode
    raises, naming torch's version, rather than count DTensor's global
    shape work as this rank's."""
    import torch.distributed.tensor._sharding_prop as sp

    class Bare:
        pass
    monkeypatch.setattr(sp, "ShardingPropagator", Bare)
    with pytest.raises(RuntimeError, match=re.escape(torch.__version__)):
        with op_cost.OpCost():
            pass


def _ref_dot_flops(text):
    """The dots of the reference's compiled HLO, each loop's body times
    its trip count."""
    h = hlo_cost.HloCost(text)

    def comp(name):
        c = h.comps[name]
        total = 0.0
        for ins in c.instrs:
            if ins.opcode == "dot":
                total += hlo_cost._dot_flops(ins, c.shapes)
            elif ins.opcode == "while":
                body = re.search(r"body=%?([\w.\-]+)", ins.rest).group(1)
                trip, ok = hlo_cost._while_trip(ins, h.comps)
                assert ok
                total += trip * comp(body)
            else:
                m = hlo_cost._CALLED_RE.search(ins.rest)
                if m and m.group(1) in h.comps:
                    total += comp(m.group(1))
        return total
    return comp(h.entry)


# measured: the two counts agree exactly (ratio 1.0)
DOT_RATIO = 1.0


def test_forward_dot_flops_equal_the_reference_hlo():
    rcfg, cfg = U.cfgs("internlm2_20b", "float32", attn_impl="dense")
    rp = U.ref_params("internlm2_20b", "float32", attn_impl="dense")
    b = U.batch_np(rcfg, U.B, U.S_FWD)
    text = jax.jit(lambda p, bb: ref_models.forward(p, bb, rcfg)).lower(
        rp, U.as_jnp(b)).compile().as_text()
    want = _ref_dot_flops(text)
    params = convert.model_params_from_numpy(jax.tree.map(np.asarray, rp),
                                             device="cpu")
    _h, r = op_cost.analyze(forward, params, U.as_torch(b), cfg)
    assert want > 0
    assert abs(r["dot_flops"] / want - DOT_RATIO) <= 0.01, \
        (r["dot_flops"], want)
