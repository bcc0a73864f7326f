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


@pytest.mark.parametrize("rows,W,sms", [(4, 512, 132), (4, 1032, 132),
                                        (1, 7, 132), (64, 40000, 132),
                                        (3, 100, 8), (4, 2048, 132),
                                        (1, 1, 132), (2, 130, 132),
                                        (200, 5000, 132)])
def test_splits_cover_the_cache(rows, W, sms):
    """Whole 64-key blocks, every slot in exactly one split, no empty
    split, and at most one split per block and about one CTA per SM in
    all (ceil(sms / rows) splits a row)."""
    nsplit, per = ops.splits(rows, W, sms)
    assert ops.SPLIT_KEYS == 64
    assert per % ops.SPLIT_KEYS == 0 and nsplit >= 1
    assert nsplit * per >= W and (nsplit - 1) * per < W
    covered = np.zeros(W, dtype=int)
    for s in range(nsplit):
        lo, hi = s * per, min(W, (s + 1) * per)
        assert hi > lo                          # no empty split
        covered[lo:hi] += 1
    np.testing.assert_array_equal(covered, 1)
    assert nsplit <= -(-W // ops.SPLIT_KEYS)
    assert nsplit <= max(1, -(-sms // rows))


def test_scratch_is_kept_per_stream_and_grows():
    """The partials' float32 scratch is one buffer per (device, stream):
    reused while it is large enough, replaced by a larger one when not,
    and never shared between two streams."""
    dev = torch.device("cpu")
    a = ops._scratch(100, dev, 11)
    assert a.dtype == torch.float32 and a.numel() >= 100
    assert ops._scratch(50, dev, 11).data_ptr() == a.data_ptr()
    b = ops._scratch(1000, dev, 11)
    assert b.numel() >= 1000
    assert ops._scratch(100, dev, 11).data_ptr() == b.data_ptr()
    c = ops._scratch(100, dev, 12)
    assert c.data_ptr() != b.data_ptr()
    ops._SCRATCH.pop((None, 11)), ops._SCRATCH.pop((None, 12))
