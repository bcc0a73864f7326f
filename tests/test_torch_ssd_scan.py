"""The port's SSD scan (`repro_torch.kernels.ssd_scan`) against the
reference's, on the CPU, where the wrapper runs the kernel's chunked
plain version.

References: `repro.kernels.ssd_scan.ref.ssd_sequential_ref` (the exact
recurrence), `repro.models.layers.ssd_scan_chunked` (the chunked jnp
path) and the Pallas `ssd_scan` in interpret mode, as the reference's own
tests run it on the CPU (the shapes of its `test_ssd_kernel_vs_sequential`).
Inputs come from numpy seeds: dt = softplus(normal), A = -exp(normal).

Tolerances (y and the final state alike): the sequential forms to 1e-5
absolute and relative (the same float32 recurrence, summed in other
orders).  The chunked forms (the plain version against the reference's
chunked path or its Pallas kernel) to 1e-5 plus twice the reference's
own error against the exact recurrence in float64, and to 1e-5 plus
three times it against each other: both take exp(cum_t - cum_s) of two
cumulative decays summed in float32, so their error grows with |cum|
(measured at S = 1000, chunk 256, |cum| up to 721: each 2.0e-4 from the
float64 result and 2.7e-4 from the other), and the port is held to the
reference's own accuracy.  The reference's own 1e-3 between the chunked
and the sequential forms.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd_scan as pallas_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_sequential_ref as ref_sequential
from repro.models.layers import _segsum as ref_segsum
from repro.models.layers import ssd_scan_chunked as ref_chunked
from repro_torch.kernels.ssd_scan import ops, ref
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref
from repro_torch.models import layers

SAME = dict(rtol=1e-5, atol=1e-5)
FORMS = dict(rtol=1e-3, atol=1e-3)
# the shapes of the reference's test_ssd_kernel_vs_sequential
KERNEL_SHAPES = [(32, 2, 8, 4, 8), (40, 3, 4, 8, 16), (16, 1, 16, 16, 16)]


def _inputs(seed, B, S, H, P, N, dt_scale=1.0):
    """(x, dt, A, B_, C_) as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = (dt_scale * np.log1p(np.exp(rng.standard_normal((B, S, H))))
          ).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H))).astype(np.float32)
    B_ = rng.standard_normal((B, S, N)).astype(np.float32)
    C_ = rng.standard_normal((B, S, N)).astype(np.float32)
    return x, dt, A, B_, C_


def _exact(arrs):
    """The recurrence in float64: (y (B, S, H, P), final state (B, H, P,
    N)) as numpy."""
    x, dt, A, B_, C_ = (torch.as_tensor(a).double() for a in arrs)
    Bb, S, H, P = x.shape
    h = torch.zeros((Bb, H, P, B_.shape[-1]), dtype=torch.float64)
    ys = []
    for t in range(S):
        h = h * torch.exp(dt[:, t] * A)[..., None, None] + torch.einsum(
            "bh,bn,bhp->bhpn", dt[:, t], B_[:, t], x[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", h, C_[:, t]))
    return torch.stack(ys, dim=1).numpy(), h.numpy()


def _assert_chunked_close(got, want, exact):
    """Each of ``got`` (y, state) within 1e-5 + twice the reference's own
    error of the float64 recurrence's ``exact``, and so within 1e-5 + three
    times it of the reference's ``want``."""
    for g, w, e in zip(got, want, exact):
        _assert_one_close(g, np.asarray(w), e)


def _assert_one_close(got, want, exact):
    own = np.abs(want - exact).max()
    assert np.abs(got - exact).max() <= 1e-5 + 2.0 * own, \
        (np.abs(got - exact).max(), own)
    assert np.abs(got - want).max() <= 1e-5 + 3.0 * own, \
        (np.abs(got - want).max(), own)


def _torch(arrs):
    return [torch.as_tensor(a) for a in arrs]


def _jax(arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("S,H,P,N", [(24, 2, 4, 8), (7, 1, 3, 5)])
def test_sequential_matches_reference(S, H, P, N):
    arrs = _inputs(S, 2, S, H, P, N)
    y, st = ref.ssd_sequential_ref(*_torch(arrs))
    yr, str_ = ref_sequential(*_jax(arrs))
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), **SAME)
    np.testing.assert_allclose(st.numpy(), np.asarray(str_), **SAME)


@pytest.mark.parametrize("S,H,P,N,chunk", [(24, 2, 4, 8, 8),
                                           (40, 3, 4, 8, 16),
                                           (1000, 2, 4, 8, 256),
                                           (5, 2, 4, 8, 16)])
def test_chunked_matches_reference_chunked(S, H, P, N, chunk):
    """S = 40 over 16 and S = 1000 over 256 (mamba2-130m's chunk) are not
    multiples of the chunk: the dt = 0 padding path; S = 5 < chunk."""
    arrs = _inputs(S + chunk, 2, S, H, P, N)
    ops.reset_launches()
    y, st = ops.ssd_scan(*_torch(arrs), chunk)
    assert ops.ssd_scan_fwd.launches == 0           # the plain version ran
    assert y.shape == (2, S, H, P) and st.shape == (2, H, P, N)
    assert y.dtype == st.dtype == torch.float32
    yr, str_ = ref_chunked(*_jax(arrs), chunk)
    _assert_chunked_close((y.numpy(), st.numpy()), (yr, str_),
                          _exact(arrs))
    # the model layer's chunked entry computes the same
    y2, st2 = layers.ssd_scan_chunked(*_torch(arrs), chunk)
    torch.testing.assert_close(y2, y, rtol=0, atol=0)
    torch.testing.assert_close(st2, st, rtol=0, atol=0)


@pytest.mark.parametrize("S,H,P,N,chunk", KERNEL_SHAPES)
def test_plain_version_matches_pallas_interpret(S, H, P, N, chunk):
    arrs = _inputs(4, 2, S, H, P, N)
    y, st = ops.ssd_scan(*_torch(arrs), chunk)
    yr, str_ = pallas_ssd_scan(*_jax(arrs), chunk)
    _assert_chunked_close((y.numpy(), st.numpy()), (yr, str_),
                          _exact(arrs))


@pytest.mark.parametrize("S,H,P,N,chunk", KERNEL_SHAPES + [(37, 2, 4, 8,
                                                            16)])
def test_chunked_matches_sequential(S, H, P, N, chunk):
    x, dt, A, B_, C_ = _torch(_inputs(5, 2, S, H, P, N))
    y, st = ops.ssd_scan(x, dt, A, B_, C_, chunk)
    yr, str_ = ref.ssd_sequential_ref(x, dt, A, B_, C_)
    torch.testing.assert_close(y, yr, **FORMS)
    torch.testing.assert_close(st, str_, **FORMS)


def test_large_decay_stays_finite():
    """dt scaled so a chunk's cumulative decay reaches about -400 (exp
    overflows float32 past 88): exp of the upper triangle would be inf,
    and a 0/1 mask multiplying it NaN.  Both the plain version and the
    reference's chunked path stay finite and agree with the recurrence."""
    S, H, P, N, chunk = 96, 2, 4, 8, 64
    arrs = list(_inputs(9, 2, S, H, P, N, dt_scale=8.0))
    arrs[2] = np.full(H, -1.0, np.float32)
    cum = np.cumsum(arrs[1][:, :chunk] * arrs[2], axis=1)
    assert cum.min() < -88.0 * 2
    x, dt, A, B_, C_ = _torch(arrs)
    y, st = ops.ssd_scan(x, dt, A, B_, C_, chunk)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    yr, str_ = ref_chunked(*_jax(arrs), chunk)
    assert np.isfinite(np.asarray(yr)).all()
    _assert_chunked_close((y.numpy(), st.numpy()), (yr, str_),
                          _exact(arrs))
    ys, sts = ref.ssd_sequential_ref(x, dt, A, B_, C_)
    torch.testing.assert_close(y, ys, **FORMS)
    torch.testing.assert_close(st, sts, **FORMS)
    # the exp of the unselected upper triangle is indeed inf
    seg = ref.segsum(dt[0, :chunk, 0] * A[0])
    full = torch.cumsum(dt[0, :chunk, 0] * A[0], 0)
    assert torch.isinf(torch.exp(full[None, :] - full[:, None])).any()
    assert torch.isfinite(torch.exp(seg)).all()


def test_segsum_matches_reference():
    x = np.random.default_rng(1).standard_normal((2, 3, 9)).astype(
        np.float32)
    got = ref.segsum(torch.as_tensor(x)).numpy()
    want = np.asarray(ref_segsum(jnp.asarray(x)))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **SAME)


@pytest.mark.parametrize("B,H", [(1, 4), (1, 1), (3, 2)])
def test_kernel_layout_is_contiguous_and_heads_major(B, H):
    """What the model entry hands the kernel: contiguous x (B·H, S, P), dt
    (B·H, S) and A (B·H, 1), row b·H + h holding head h of batch b (one
    sequence, B = 1, included)."""
    S, P = 7, 4
    g = torch.Generator().manual_seed(B * 10 + H)
    xs = torch.randn(B, S, H, P, generator=g)
    dt = torch.rand(B, S, H, generator=g)
    A = -torch.rand(H, generator=g)
    x, d, a = ops.kernel_layout(xs, dt, A)
    for t in (x, d, a):
        assert t.is_contiguous()
    assert x.shape == (B * H, S, P) and d.shape == (B * H, S) \
        and a.shape == (B * H, 1)
    for b in range(B):
        for h in range(H):
            assert torch.equal(x[b * H + h], xs[b, :, h])
            assert torch.equal(d[b * H + h], dt[b, :, h])
            assert a[b * H + h, 0] == A[h]
    # and the split views of the model (B_, C_ slices of one tensor) pass
    xbc = torch.randn(B, S, 2 * 5 + 3, generator=g)
    B_, C_ = xbc[..., :5], xbc[..., 5:10]
    y, st = ops.ssd_scan(xs, dt, A, B_, C_, 4)
    assert y.shape == (B, S, H, P) and st.shape == (B, H, P, 5)


def test_wrapper_checks_shapes_and_devices():
    x, dt, A, B_, C_ = _torch(_inputs(0, 2, 8, 2, 4, 3))
    xf, d, a = ops.kernel_layout(x, dt, A)
    with pytest.raises(ValueError, match="do not fit heads"):
        ops.ssd_scan_fwd(xf, d, a, B_, C_, heads=4)
    with pytest.raises(ValueError, match="contiguous"):
        ops.ssd_scan_fwd(xf, d, a, B_.transpose(1, 2).contiguous()
                         .transpose(1, 2), C_, heads=2)
    with pytest.raises(ValueError, match="chunk"):
        ops.ssd_scan_fwd(xf, d, a, B_, C_, heads=2, chunk=0)
    meta = [t.to("meta") for t in (xf, d, a, B_, C_)]
    with pytest.raises(ValueError, match="no ssd_scan kernel"):
        ops.ssd_scan_fwd(*meta, heads=2)
    assert ops.ssd_scan_fwd.launches == 0


@pytest.mark.parametrize("S,Q,nc,Qp", [(2048, 256, 8, 256),
                                       (1000, 256, 4, 256), (40, 8, 5, 64),
                                       (96, 64, 2, 64), (200, 200, 1, 256),
                                       (0, 0, 0, 64)])
def test_scratch_shapes_cover_every_chunk(S, Q, nc, Qp):
    """The card's scratch, Q the wrapper's min(chunk, S).  bfloat16: a
    start state per (row, chunk) in the kernel's 64 x 128 tile and one
    publication count per (row, chunk).  float32: C·Bᵀ tiles per (batch
    row, chunk) padded to the kernels' 64-row tiles (Qp), cumulative decays
    and states per (row, chunk)."""
    bf = ops.scratch_shapes(6, 2, S, 8, 8, Q)
    assert bf == {"states": ((6, nc, 64, 128), torch.float32),
                  "sync": ((1 + 6 * nc,), torch.int32)}
    f32 = ops.scratch_shapes(6, 2, S, 4, 8, Q, torch.float32)
    assert f32 == {"cb": ((2, nc, Qp, Qp), torch.float32),
                   "cum": ((6, nc, Qp), torch.float64),
                   "states": ((6, nc, 4, 8), torch.float32)}
    assert ops.KERNELS_PER_CALL == {torch.bfloat16: 1, torch.float32: 4}
    assert all(len(ops.KERNEL_NAMES[d]) == n
               for d, n in ops.KERNELS_PER_CALL.items())
    assert set(ops.CTAS_PER_SM) == {name for names in
                                    ops.KERNEL_NAMES.values()
                                    for name in names}


@pytest.mark.parametrize("P,N", [(50, 100), (3, 5), (32, 16), (64, 128)])
def test_padding_to_multiples_of_8_changes_nothing(P, N):
    """What the wrapper hands the bfloat16 kernels: P of x and N of B_ and
    C_ zero-padded to multiples of 8 (16-byte rows for the TMA unit).
    Zero columns add nothing to C·Bᵀ or to the state, so the padded scan,
    y and state sliced back, is the unpadded one (the plain version
    computes both)."""
    Bb, S, H, chunk = 2, 40, 3, 16
    x, dt, A, B_, C_ = _torch(_inputs(P * N, Bb, S, H, P, N))
    xf, d, a = ops.kernel_layout(x, dt, A)
    xp, Bp, Cp = ops.pad8(xf, B_, C_)
    assert xp.shape == (Bb * H, S, ops.round8(P))
    assert Bp.shape == Cp.shape == (Bb, S, ops.round8(N))
    assert xp.is_contiguous() and Bp.is_contiguous() and Cp.is_contiguous()
    if (P, N) == (64, 128):
        assert xp is xf and Bp is B_ and Cp is C_
    assert torch.equal(xp[..., :P], xf) and not xp[..., P:].any()
    assert torch.equal(Bp[..., :N], B_) and not Bp[..., N:].any()
    y, st = ssd_chunked_ref(xf, d, a, B_, C_, chunk)
    yp, stp = ssd_chunked_ref(xp, d, a, Bp, Cp, chunk)
    np.testing.assert_allclose(yp[..., :P].numpy(), y.numpy(), **SAME)
    np.testing.assert_allclose(stp[:, :P, :N].numpy(), st.numpy(), **SAME)
    assert not stp[:, P:].any() and not stp[:, :, N:].any()
