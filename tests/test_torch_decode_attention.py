"""The port's flash-decode (`repro_torch.kernels.decode_attention`)
against the reference's, on the CPU, where the wrappers run the kernel's
plain PyTorch version.

References: `repro.kernels.decode_attention.ops.ring_validity` (exactly,
over cache sizes, positions before and after the ring wraps, and
windows), `repro.kernels.decode_attention.ref.decode_attention_ref` and
the Pallas `decode_attention_fwd` in interpret mode (the shapes of the
reference's `test_decode_attention_sweep`: ragged caches, groups 1, 4
and 6), and the model entry against the reference's `ops.decode_attention`
(the check of its `test_decode_attention_matches_model_decode_path`).
Inputs come from numpy seeds.

Tolerances: float32 to 1e-5 absolute (the two sum in other orders).
bfloat16 to rtol = atol = 2^-7: one bfloat16 ulp is 2^-8 relative, the
output is rounded once on each side, and the Pallas kernel rounds p to
bfloat16 against a running max per key block where the port's plain
version uses the row's max (and `decode_attention_ref` does not round p).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import ops as ref_ops
from repro.kernels.decode_attention.decode_attention import \
    decode_attention_fwd as pallas_fwd
from repro.kernels.decode_attention.ref import \
    decode_attention_ref as ref_oracle
from repro_torch.kernels.decode_attention import ops, ref

F32_ATOL = 1e-5
BF16_TOL = 2.0 ** -7
# (W, G, D, bk) of the reference's test_decode_attention_sweep
SWEEP = [(128, 4, 32, 32), (100, 6, 16, 32), (64, 1, 64, 16)]


def _tol(dtype):
    return (dict(rtol=0, atol=F32_ATOL) if dtype == "float32"
            else dict(rtol=BF16_TOL, atol=BF16_TOL))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _case(seed, rows, W, G, D, dtype):
    """(jax q, k, v, valid), (torch q, k, v, valid): ~30% of the slots
    invalid, slot 0 always valid."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((rows, G, D), (rows, W, D), (rows, W, D))]
    valid = (rng.uniform(size=(rows, W)) > 0.3).astype(np.int32)
    valid[:, 0] = 1
    jx = [jnp.asarray(a, dtype) for a in arrs]
    tdt = getattr(torch, dtype)
    tx = [torch.as_tensor(np.array(x.astype(jnp.float32))).to(tdt)
          for x in jx]
    return (*jx, jnp.asarray(valid)), (*tx, torch.as_tensor(valid))


@pytest.mark.parametrize("W", [1, 5, 16, 512])
def test_ring_validity_matches_reference_exactly(W):
    """Every index up to three wraps of the ring, no window and windows
    narrower than, equal to and wider than the ring."""
    for window in (0, 1, 3, W, W + 7):
        for index in range(0, 3 * W + 2, max(1, W // 64)):
            got = ref.ring_validity(W, index, window).numpy()
            want = np.asarray(ref_ops.ring_validity(W, jnp.asarray(index),
                                                    window))
            np.testing.assert_array_equal(got, want)
            assert got.dtype == np.int32
            assert got[index % W] == 1        # the token's own slot


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("W,G,D,bk", SWEEP)
def test_plain_version_matches_pallas_and_oracle(W, G, D, bk, dtype):
    (jq, jk, jv, jvalid), (q, k, v, valid) = _case(W + G, 3, W, G, D,
                                                   dtype)
    ops.reset_launches()
    got = ops.decode_attention_fwd(q, k, v, valid)
    assert ops.decode_attention_fwd.launches == 0    # the plain version ran
    assert got.dtype == q.dtype and got.shape == q.shape
    want = pallas_fwd(jq, jk, jv, jvalid, bk=bk, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    oracle = ref_oracle(jq, jk, jv, jvalid)
    np.testing.assert_allclose(_np(got), _np(oracle), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_entry_matches_reference_ops(dtype):
    """`decode_attention` on (B, 1, H, D) against ring caches (B, W, KH,
    D), GQA 4:2, before the ring wraps, after it, and with a window."""
    B, W, KH, G, D = 2, 16, 2, 2, 8
    rng = np.random.default_rng(3)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, 1, KH * G, D), (B, W, KH, D), (B, W, KH, D))]
    jq, jk, jv = (jnp.asarray(a, dtype) for a in arrs)
    tq, tk, tv = (torch.as_tensor(np.array(_np(x))).to(getattr(torch,
                                                              dtype))
                  for x in (jq, jk, jv))
    for index, window in ((5, 0), (20, 0), (20, 7), (47, 16)):
        want = ref_ops.decode_attention(jq, jk, jv, jnp.asarray(index),
                                        window=window)
        got = ops.decode_attention(tq, tk, tv, index, window=window)
        assert got.shape == (B, 1, KH * G, D) and got.dtype == tq.dtype
        np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


def test_model_entry_reads_kv_head_of_its_group():
    """q head h reads kv head h // G: with one distinct constant V per
    (batch, kv head), every output row equals its kv head's constant."""
    B, W, KH, G, D = 3, 9, 2, 3, 4
    g = torch.Generator().manual_seed(0)
    q = torch.randn(B, 1, KH * G, D, generator=g)
    k = torch.randn(B, W, KH, D, generator=g)
    const = torch.arange(B * KH, dtype=torch.float32).view(B, 1, KH, 1)
    v = const.expand(B, W, KH, D).contiguous()
    o = ops.decode_attention(q, k, v, 11, window=4)
    want = const.repeat_interleave(G, dim=2).expand(B, 1, KH * G, D)
    torch.testing.assert_close(o, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("B,KH,G", [(1, 1, 4), (1, 2, 2), (3, 1, 1)])
def test_grouped_rows_layout_is_contiguous(B, KH, G):
    """What the model entry hands the kernel: contiguous (B·KH, G, D), row
    b·KH + h holding q heads h·G .. h·G + G - 1 of batch b (one sequence,
    B = 1, included)."""
    D = 8
    q = torch.randn(B, 1, KH * G, D)
    got = ops.grouped_rows(q, KH)
    assert got.is_contiguous() and got.shape == (B * KH, G, D)
    for b in range(B):
        for h in range(KH):
            assert torch.equal(got[b * KH + h], q[b, 0, h * G:(h + 1) * G])


def test_refuses_rows_without_a_valid_slot():
    q = torch.zeros(2, 1, 8)
    k = v = torch.zeros(2, 4, 8)
    valid = torch.ones(2, 4, dtype=torch.int32)
    valid[1] = 0
    with pytest.raises(ValueError, match="no valid slot"):
        ops.decode_attention_fwd(q, k, v, valid)


def test_wrapper_checks_shapes_types_and_devices():
    q = torch.zeros(2, 4, 8)
    k = torch.zeros(2, 6, 8)
    valid = torch.ones(2, 6, dtype=torch.int32)
    with pytest.raises(ValueError, match="do not fit"):
        ops.decode_attention_fwd(q, k[:, :, :4].contiguous(), k, valid)
    with pytest.raises(TypeError, match="int32"):
        ops.decode_attention_fwd(q, k, k, valid.long())
    with pytest.raises(ValueError, match="contiguous"):
        ops.decode_attention_fwd(q.transpose(0, 1).contiguous()
                                 .transpose(0, 1), k, k, valid)
    meta = [t.to("meta") for t in (q, k, k)]
    with pytest.raises(ValueError, match="no decode_attention kernel"):
        ops.decode_attention_fwd(*meta, valid)
    with pytest.raises(ValueError, match="does not fit"):
        ops.decode_attention(torch.zeros(2, 1, 3, 8), torch.zeros(2, 6, 2, 8),
                             torch.zeros(2, 6, 2, 8), 3)
    assert ops.decode_attention_fwd.launches == 0


def test_cache_types_the_kernel_takes():
    """The kernel's cache types and their launcher codes: float32,
    bfloat16 and float8_e4m3fn K/V (one type for both) under a float32 or
    bfloat16 q; a float8 q, or K and V of two types, are refused."""
    assert ops.KV_TYPES == {torch.float32: 0, torch.bfloat16: 1,
                            torch.float8_e4m3fn: 2}
    kv = torch.zeros(2, 4, 8)
    for qdt in (torch.float32, torch.bfloat16):
        for kvdt in ops.KV_TYPES:
            ops._check_types(torch.zeros(2, 1, 8, dtype=qdt), kv.to(kvdt),
                             kv.to(kvdt))
    fp8 = kv.to(torch.float8_e4m3fn)
    with pytest.raises(TypeError, match="takes q in"):
        ops._check_types(torch.zeros(2, 1, 8).to(torch.float8_e4m3fn), fp8,
                         fp8)
    with pytest.raises(TypeError, match="takes q in"):
        ops._check_types(torch.zeros(2, 1, 8), fp8, kv.bfloat16())


PLAN_CASES = [(4, 512, 132), (4, 1032, 132), (1, 7, 132), (64, 40000, 132),
              (3, 100, 8), (4, 2048, 132), (1, 1, 132), (2, 130, 132),
              (200, 5000, 132)]


@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,W,sms", PLAN_CASES)
def test_plan_covers_the_cache(rows, W, sms, qdt):
    """For every head width, cache type, group and CTAs an SM holds: whole
    64-key blocks, every slot in exactly one CTA's run, no empty run; at
    most 16 CTAs a cluster and about one CTA per slot in all; ceil(G /
    16) clusters a row; a ring of at least 3
    stages within a block's 232,448 bytes of shared memory; bulk copies
    planned only for rows of a multiple of 16 bytes."""
    for D in (1, 20, 64, 72, 80, 128, 256):
        for kvdt in ops.KV_TYPES:
            itemsize = torch.empty(0, dtype=kvdt).element_size()
            for G, per_sm in ((1, 1), (4, 2), (16, 1), (17, 1)):
                p = ops.plan(rows, G, W, D, 1, qdt, kvdt, sms, per_sm=per_sm)
                assert p.per_sm == per_sm
                assert p.head_blocks == -(-G // 16)
                assert p.blocks == -(-W // ops.BLOCK_KEYS)
                assert 1 <= p.cluster <= 16 and p.cluster <= p.blocks
                assert (rows * p.head_blocks * p.cluster
                        <= max(sms * per_sm, rows * p.head_blocks))
                covered = np.zeros(W, dtype=int)
                for lo, hi in ops.cta_runs(W, p.blocks, p.cluster):
                    assert hi > lo and lo % ops.BLOCK_KEYS == 0
                    assert hi - lo <= p.keys_per_cta
                    covered[lo:hi] += 1
                np.testing.assert_array_equal(covered, 1)
                assert p.stages >= 3 and p.smem <= 232448
                assert p.width >= D and p.width in (64, 128, 256)
                assert p.bulk == (D * itemsize % 16 == 0)
                assert 0 < p.in_flight <= (2 * p.stages * p.tile_keys * D
                                           * itemsize)
                assert p.resident is None


def test_plan_shrinks_the_cluster_to_what_is_resident():
    """Clusters of 16 CTAs need 16 free SMs of one GPC: where the card
    holds fewer clusters of a size than the call has (row, 16 q heads)
    pairs, the plan takes the largest size that it does hold, down to
    single CTAs."""
    bf = torch.bfloat16

    def resident(c):
        return 7 if c > 8 else 132 // c

    p = ops.plan(8, 16, 2048, 256, 1, bf, bf, 132, resident)
    assert p.cluster == 8 and p.resident == 16
    p = ops.plan(4, 4, 1032, 256, 1, bf, bf, 132, resident)
    assert p.cluster == 16 and p.resident == 7
    p = ops.plan(4, 4, 1032, 256, 1, bf, bf, 132, lambda c: 0)
    assert p.cluster == 1 and p.resident == 0
    # two CTAs an SM: the families' 32 rows take clusters of 8, not 4
    p = ops.plan(32, 6, 1032, 128, 8, bf, bf, 132, per_sm=2)
    assert p.cluster == 8 and p.head_blocks == 1
    p = ops.plan(32, 6, 1032, 128, 8, bf, bf, 132)
    assert p.cluster == 4


def test_instances_cover_every_type_and_width():
    """One kernel instance per (q type, cache type, padded width), each
    numbered as the launcher's table, each within a block's shared
    memory; a float8 cache under bfloat16 q adds a widened bfloat16 tile
    and still takes less than a bfloat16 cache."""
    seen = set()
    for qdt in (torch.float32, torch.bfloat16):
        for kvdt in ops.KV_TYPES:
            for D in (64, 128, 256):
                i = ops.instance(qdt, kvdt, D)
                assert ops.instance(qdt, kvdt, D - 1) == i
                seen.add(i)
                assert ops.smem_bytes(qdt, kvdt, D) <= ops.SMEM_LIMIT
    assert seen == set(range(18))
    bf, f8 = torch.bfloat16, torch.float8_e4m3fn
    assert ops.smem_bytes(bf, f8, 256) < ops.smem_bytes(bf, bf, 256)
    assert ops.tile_keys(bf, bf) == 64 and ops.tile_keys(bf, f8) == 64
    assert ops.tile_keys(torch.float32, bf) == 32
    assert ops.tile_keys(bf, torch.float32) == 32
