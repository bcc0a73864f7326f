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


@pytest.mark.parametrize("Sq", [1, 63, 64, 65, 128, 129, 257, 2048, 4097])
@pytest.mark.parametrize("mask_kind", ["none", "causal", "window"])
@pytest.mark.parametrize("D", [16, 20, 64, 80, 100, 128, 256])
def test_launch_plan_covers_every_query_row_once(Sq, mask_kind, D):
    """The CUDA launch's geometry, computed on every device: the grid rows'
    q tiles cover rows 0 .. Sq-1 exactly once; bfloat16 tiles of 128
    queries (two consumer warp groups), of 64 (one) where Sq <= 64; under
    a mask the last tile (the longest kv band) goes first; q, k and v read
    at D rounded up to a multiple of 8 (the TMA's 16-byte rows) by tiles
    holding 64, 80, 128 or 256 columns, kv tiles of 128 keys (80 at D
    256); float32 keeps tiles of 64 queries at the true D."""
    for bf16 in (True, False):
        plan = ops.launch_plan(Sq, D, mask_kind, bf16)
        covered = np.zeros(plan.n_qtiles * plan.q_rows, dtype=int)
        for y in range(plan.n_qtiles):
            covered[list(ops.q_tile(y, plan))] += 1
        np.testing.assert_array_equal(covered[:Sq], 1)
        assert plan.n_qtiles * plan.q_rows - Sq < plan.q_rows
        assert plan.reverse == (mask_kind != "none")
        if plan.reverse:
            assert ops.q_tile(0, plan)[-1] >= Sq - 1
    plan = ops.launch_plan(Sq, D, mask_kind)
    assert plan.q_rows == (64 if Sq <= 64 else 128)
    assert plan.consumers == plan.q_rows // 64
    assert plan.width % 8 == 0 and D <= plan.width < D + 8
    want = {16: 64, 20: 64, 64: 64, 80: 80, 100: 128, 128: 128, 256: 256}
    assert plan.instance == want[D] and plan.width <= plan.instance
    assert plan.kv_tile == (80 if D == 256 else 128)
    assert ops.launch_plan(Sq, 80, mask_kind).width == 80   # unpadded
    f32 = ops.launch_plan(Sq, D, mask_kind, bf16=False)
    assert (f32.q_rows, f32.width) == (64, D)
    with pytest.raises(ValueError, match="head_dim"):
        ops.launch_plan(Sq, 260, mask_kind)


# (mask, window, Sq, Sk): every mask at short, ragged and long shapes,
# windows of one key, of less than a kv tile and past the sequence; none
# leaves a query row without a live key (the wrapper refuses those)
KV_BAND_CASES = [
    (mask, window, Sq, Sk)
    for mask, window in (("none", 0), ("causal", 0), ("window", 1),
                         ("window", 100), ("window", 4096))
    for Sq, Sk in ((1, 1500), (64, 64), (129, 191), (200, 200), (300, 257),
                   (448, 1500), (1000, 1000))
    if mask != "window" or Sq < Sk + window]


@pytest.mark.parametrize("mask_kind,window,Sq,Sk", KV_BAND_CASES)
@pytest.mark.parametrize("D", [64, 256])
def test_kv_tiles_hold_every_live_pair_and_no_dead_tile(mask_kind, window,
                                                        Sq, Sk, D):
    """The kv tiles a q tile visits (`kv_tiles`, the kernel's band) hold
    every live (query, key) pair of `ref.index_mask` for the tile's rows,
    and each visited tile holds at least one: under a mask no tile wholly
    outside the band is loaded."""
    plan = ops.launch_plan(Sq, D, mask_kind)
    live = ref.index_mask(mask_kind, Sq, Sk, window, "cpu").numpy()
    for y in range(plan.n_qtiles):
        rows = ops.q_tile(y, plan)
        tile_rows = live[rows[0]:min(rows[-1] + 1, Sq)]
        seen = np.zeros(Sk, dtype=bool)
        for k0 in ops.kv_tiles(rows, Sq, Sk, mask_kind, window,
                               plan.kv_tile):
            assert k0 % plan.kv_tile == 0 and 0 <= k0 < Sk
            assert tile_rows[:, k0:k0 + plan.kv_tile].any(), (y, k0)
            seen[k0:k0 + plan.kv_tile] = True
        assert not (tile_rows & ~seen).any(), y


@pytest.mark.parametrize("D", [20, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask_kind,window", CASES)
def test_padded_width_with_the_true_scale_equals_attention_ref(
        D, dtype, mask_kind, window):
    """What the wrapper hands the bfloat16 kernel for a D that is no
    multiple of 8: q, k and v zero-padded to the plan's width.  Fed to the
    plain version with the true D's scale (q scaled by sqrt(width / D) in
    float32, since the plain version scales by its input's width), the
    output's first D columns equal `attention_ref` on the unpadded inputs
    and the padded columns are zero (bfloat16 within its tolerance: the
    scaled scores may round p to the other side of a bfloat16 step)."""
    _, (q, k, v) = _inputs(D, 2, 2, 90, 90, D, dtype)
    plan = ops.launch_plan(90, D, mask_kind)
    assert plan.width == D + (8 - D % 8)
    qp, kp, vp = (ops.pad_width(t, plan.width) for t in (q, k, v))
    assert qp.shape[-1] == plan.width and qp.is_contiguous()
    assert torch.equal(qp[..., :D], q) and not qp[..., D:].any()
    kw = dict(mask_kind=mask_kind, window=window, group=2)
    got = ref.attention_ref(qp.float() * (plan.width / D) ** 0.5, kp, vp,
                            **kw)
    want = ref.attention_ref(q.float(), k, v, **kw)
    assert not got[..., D:].any()
    np.testing.assert_allclose(_np(got[..., :D]), _np(want), **_tol(dtype))
    assert ops.pad_width(q, D) is q


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
