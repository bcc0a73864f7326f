"""The port's flash attention (`repro_torch.kernels.flash_attention`)
against the reference's, on the CPU, where the wrapper runs the kernel's
plain PyTorch version.

References: `repro.kernels.flash_attention.ref.attention_ref` (dense
softmax, KV expanded to the q heads) and the Pallas
`flash_attention_fwd` in interpret mode, as the reference's own tests run
it on the CPU; the layer entry against the reference's `ops` wrapper.
Inputs come from numpy seeds, with ragged Sq and Sk (not multiples of
any block size), every mask kind, GQA groups 1, 2 and 4.

Tolerances: float32 to 1e-5 absolute (the two sum in other orders; the
measured gap is ~1e-6 at these shapes).  bfloat16 to rtol = atol = 2^-7:
one bfloat16 ulp is 2^-8 relative, the output is rounded once on each
side, and the Pallas kernel rounds p to bfloat16 against a running max
per 128-key block where the port's plain version uses the row's max
(and `attention_ref` does not round p at all).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as ref_ops
from repro.kernels.flash_attention.flash_attention import \
    flash_attention_fwd as pallas_fwd
from repro.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_attention import ops, ref

F32_ATOL = 1e-5
BF16_TOL = 2.0 ** -7
WINDOW = 48
CASES = [("causal", 0), ("window", WINDOW), ("none", 0)]


def _tol(dtype):
    return (dict(rtol=0, atol=F32_ATOL) if dtype == "float32"
            else dict(rtol=BF16_TOL, atol=BF16_TOL))


def _inputs(seed, BKH, G, Sq, Sk, D, dtype):
    """(jax q, k, v) in ``dtype`` and the same values as torch tensors."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((BKH * G, Sq, D), (BKH, Sk, D), (BKH, Sk, D))]
    jx = [jnp.asarray(a, dtype) for a in arrs]
    tdt = getattr(torch, dtype)
    tx = [torch.as_tensor(np.array(x.astype(jnp.float32))).to(tdt)
          for x in jx]
    return jx, tx


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("mask_kind,window", CASES)
def test_plain_version_matches_attention_ref(mask_kind, window, group,
                                             dtype):
    Sk = 131 if mask_kind == "none" else 200
    (jq, jk, jv), (q, k, v) = _inputs(group, 2, group, 200, Sk, 64, dtype)
    want = attention_ref(jq, jnp.repeat(jk, group, 0),
                         jnp.repeat(jv, group, 0), mask_kind=mask_kind,
                         window=window)
    ops.reset_launches()
    got = ops.flash_attention_fwd(q, k, v, mask_kind=mask_kind,
                                  window=window, group=group)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert ops.flash_attention_fwd.launches == 0     # the plain version ran
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask_kind,window", CASES)
def test_plain_version_matches_pallas_interpret(mask_kind, window, dtype):
    """Ragged Sq = 200 and Sk = 170: the Pallas kernel pads both to its
    128 blocks and masks ``kp < sk``; group 2 folds q heads onto kv heads
    inside the kernel in both."""
    Sk = 170 if mask_kind == "none" else 200
    (jq, jk, jv), (q, k, v) = _inputs(7, 2, 2, 200, Sk, 64, dtype)
    want = pallas_fwd(jq, jk, jv, mask_kind=mask_kind, window=window,
                      group=2, interpret=True)
    got = ops.flash_attention_fwd(q, k, v, mask_kind=mask_kind,
                                  window=window, group=2)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_entry_matches_reference_ops(dtype):
    """`flash_attention` on (B, S, H, D) with KV un-repeated (GQA 4:2)
    against the reference's `ops.flash_attention`, which takes KV repeated
    to the q heads (interpret mode on the CPU)."""
    B, S, H, KH, D = 2, 40, 4, 2, 16
    rng = np.random.default_rng(3)
    arrs = [rng.standard_normal((B, S, h, D)).astype(np.float32)
            for h in (H, KH, KH)]
    jq, jk, jv = (jnp.asarray(a, dtype) for a in arrs)
    pos = jnp.arange(S)
    want = ref_ops.flash_attention(jq, jnp.repeat(jk, H // KH, 2),
                                   jnp.repeat(jv, H // KH, 2), pos, pos,
                                   mask_kind="window", window=9)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.as_tensor(np.array(_np(x))).to(tdt)
                  for x in (jq, jk, jv))
    tpos = torch.arange(S)
    got = ops.flash_attention(tq, tk, tv, tpos, tpos, mask_kind="window",
                              window=9)
    assert got.shape == (B, S, H, D)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("B,H", [(1, 4), (1, 1), (3, 2)])
def test_layer_layout_is_contiguous_and_heads_major(B, H):
    """What the layer entry hands the kernel: contiguous (B·H, S, D), row
    b·H + h holding head h of batch b (one job, as a serve call of one
    request gives it, included)."""
    x = torch.randn(B, 7, H, 8)
    got = ops.heads_major(x)
    assert got.is_contiguous() and got.shape == (B * H, 7, 8)
    for b in range(B):
        for h in range(H):
            assert torch.equal(got[b * H + h], x[b, :, h])


@pytest.mark.parametrize("Sq", [1, 63, 64, 65, 129, 2048, 4097])
@pytest.mark.parametrize("mask_kind", ["none", "causal", "window"])
@pytest.mark.parametrize("group", [1, 2, 16])
def test_launch_plan_covers_every_query_row_once(Sq, mask_kind, group):
    """The CUDA launch's geometry, computed on every device: the grid rows'
    q tiles cover rows 0 .. Sq-1 exactly once; under a mask the last tile
    (the longest kv band) goes first; D is padded to a multiple of 16; the
    warp groups split the kv tiles under a causal mask or an odd group
    (else they take two q heads of one kv head)."""
    n_qtiles, dp, reverse, split = ops.launch_plan(Sq, 100, mask_kind, group)
    covered = np.zeros(n_qtiles * ops.Q_TILE, dtype=int)
    for y in range(n_qtiles):
        covered[list(ops.q_tile(y, n_qtiles, reverse))] += 1
    np.testing.assert_array_equal(covered[:Sq], 1)
    assert n_qtiles * ops.Q_TILE - Sq < ops.Q_TILE  # padding < one tile
    assert reverse == (mask_kind != "none")
    if reverse:
        assert ops.q_tile(0, n_qtiles, reverse)[-1] >= Sq - 1
    assert dp == 128 and dp % 16 == 0
    assert split == (mask_kind == "causal" or group % 2 == 1)
    for D, want in ((4, 32), (20, 32), (32, 32), (36, 64), (100, 128),
                    (128, 128), (132, 256), (256, 256)):
        assert ops.launch_plan(Sq, D, mask_kind, group)[1] == want
    with pytest.raises(ValueError, match="head_dim"):
        ops.launch_plan(Sq, 260, mask_kind, group)


def test_plain_version_reads_kv_head_b_over_group():
    """Head b of q reads kv head b // group: with one distinct constant V
    per kv head, every output row equals its kv head's constant."""
    G, BKH, S, D = 4, 3, 10, 8
    q = torch.randn(BKH * G, S, D, generator=torch.Generator().manual_seed(0))
    k = torch.randn(BKH, S, D, generator=torch.Generator().manual_seed(1))
    v = torch.arange(BKH, dtype=torch.float32)[:, None, None].expand(
        BKH, S, D).contiguous()
    o = ops.flash_attention_fwd(q, k, v, mask_kind="causal", group=G)
    want = (torch.arange(BKH * G) // G).float()[:, None, None].expand_as(o)
    torch.testing.assert_close(o, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("Sq,Sk,window", [(21, 10, 11), (8, 8, 0)])
def test_refuses_rows_without_a_live_key(Sq, Sk, window):
    q = torch.zeros(1, Sq, 8)
    k = v = torch.zeros(1, Sk, 8)
    with pytest.raises(ValueError, match="no live key"):
        ops.flash_attention_fwd(q, k, v, mask_kind="window", window=window)


def test_wrapper_checks_shapes_masks_and_devices():
    q = torch.zeros(4, 8, 16)
    k = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError, match="do not fit group"):
        ops.flash_attention_fwd(q, k, k, mask_kind="causal", group=1)
    with pytest.raises(ValueError, match="mask_kind"):
        ops.flash_attention_fwd(q, k, k, mask_kind="banded", group=2)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention_fwd(q.transpose(0, 1).contiguous()
                                .transpose(0, 1), k, k, mask_kind="causal",
                                group=2)
    meta = [t.to("meta") for t in (q, k, k)]
    with pytest.raises(ValueError, match="no flash_attention kernel"):
        ops.flash_attention_fwd(*meta, mask_kind="causal", group=2)
    assert ops.flash_attention_fwd.launches == 0


def test_index_mask_matches_reference_mask():
    from repro.models.layers import _mask
    for kind, w in CASES:
        want = np.asarray(_mask(kind, jnp.arange(13), jnp.arange(17), w))
        got = ref.index_mask(kind, 13, 17, w, "cpu").numpy()
        np.testing.assert_array_equal(got, want)
