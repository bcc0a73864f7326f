"""Plain PyTorch versions of the batched simplex pivot kernels.

Port of `repro.kernels.simplex_pivot.ref` (`pivot_update_ref`,
`price_reduced_ref`, `reduced_pivot_ref`), statement for statement.  They
are what a CPU tensor runs through (`ops`), the oracle the CUDA kernels
are held against on the card, and the pricing step `core.lp` runs after
a revised phase.  Every function here is out of place; the `ops` wrappers
carry the in-place contract of the kernels.

`basis_columns_ref` and `kkt_vjp_ref` are the backward of the implicit-
gradient simplex (`core.lp.simplex_batch_grad`): two (R, R) solves per
lane at the converged basis, plain PyTorch on every device (the
reference computes them in jnp, outside any Pallas kernel).

The rank-1 updates ``x - u * v`` are `torch.addcmul(x, u, v, value=-1)`:
one fused multiply-add, a single rounding — what XLA emits for the
reference's expression on the CPU, and what the CUDA kernels compute with
``__fma_rn``.  Degenerate fleet LPs (identical jobs) break pivot ties on
the last bit, so the rounding has to match for the bases to.
"""
from __future__ import annotations

import torch

INT32_MAX = 2 ** 31 - 1


def pivot_update_ref(tabs: torch.Tensor, r: torch.Tensor, j: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """One simplex pivot on every active lane of a tableau stack.

    tabs: (B, R+1, C+1) float64 tableaus (last row = reduced costs | -obj,
    last column = rhs); r, j: (B,) pivot row/column per lane; mask: (B,)
    bool — lanes with mask False pass through unchanged.  Indices are
    clamped into range, so a masked lane's garbage r/j is harmless."""
    B, R1, C1 = tabs.shape
    r = r.long().clamp(0, R1 - 1)
    j = j.long().clamp(0, C1 - 1)
    colv = torch.gather(tabs, 2, j[:, None, None].expand(B, R1, 1))[..., 0]
    prow = torch.gather(tabs, 1, r[:, None, None].expand(B, 1, C1))[:, 0]
    piv = torch.gather(colv, 1, r[:, None])[:, 0]
    piv = torch.where(mask, piv, 1.0)        # masked lanes: avoid 0-divide
    prow = prow / piv[:, None]
    new = torch.addcmul(tabs, colv[:, :, None], prow[:, None, :], value=-1)
    is_r = torch.arange(R1, device=tabs.device)[None, :] == r[:, None]
    new = torch.where(is_r[:, :, None], prow[:, None, :], new)
    return torch.where(mask[:, None, None], new, tabs)


def price_reduced_ref(A, c_phase, Binv, basis, art_cost: float):
    """Reduced costs out of the basis-inverse factor (one BTRAN + pricing).

    A: (B, R, C0) original columns; c_phase: (B, C0) phase costs; Binv:
    (B, R, R); basis: (B, R) labels — entries >= C0 are virtual
    artificials that price at ``art_cost``.  Returns rc (B, C0)."""
    C0 = A.shape[2]
    cB = torch.where(
        basis >= C0, art_cost,
        torch.gather(c_phase, 1, basis.long().clamp(0, C0 - 1)))
    y = torch.einsum("br,brk->bk", cB, Binv)        # simplex multipliers
    return c_phase - torch.einsum("bk,bkc->bc", y, A)


def reduced_pivot_ref(A, c_phase, Binv, xB, basis, use_bland, may_pivot,
                      lane_ok, *, art_cost: float, tol: float):
    """One fused revised-simplex iteration across the whole lane stack.

    Prices every column out of the factor, picks the entering column
    (Dantzig, or Bland's smallest index where ``use_bland``), runs the
    ratio test on the FTRAN-transformed entering column (artificial
    drive-out, smallest-basis-label tie-break) and applies the eta update
    to ``[Binv | xB]`` on lanes where ``may_pivot & has_enter &
    ~unbounded``.  ``lane_ok`` False lanes never produce an entering
    column.

    Returns ``(Binv', xB', basis' int32, has_enter, unbounded,
    degenerate)`` with the flags (B,) bool."""
    B, R, C0 = A.shape
    dev = A.device
    rc = price_reduced_ref(A, c_phase, Binv, basis, art_cost)
    enter = (rc < -tol) & lane_ok[:, None]
    has_enter = enter.any(dim=1)
    score = torch.where(enter, rc, torch.inf)
    j_dantzig = score.argmin(dim=1)
    j_bland = enter.to(torch.uint8).argmax(dim=1)   # first eligible index
    j = torch.where(use_bland, j_bland, j_dantzig)
    j = torch.where(has_enter, j, 0)                # safe gather index

    # FTRAN: entering column in basis coordinates
    Aj = torch.gather(A, 2, j[:, None, None].expand(B, R, 1))[..., 0]
    d = torch.einsum("brk,bk->br", Binv, Aj)
    pos = d > tol
    ratio = torch.where(pos, xB / torch.where(pos, d, 1.0), torch.inf)
    art_basic = (basis >= C0) & (d.abs() > tol) & (xB <= tol)
    ratio = torch.where(art_basic, 0.0, ratio)
    unbounded = ~(ratio < torch.inf).any(dim=1)
    rmin = ratio.amin(dim=1)
    tie = ratio <= (rmin + torch.clamp_min(rmin.abs() * 1e-9,
                                           1e-12))[:, None]
    r = torch.where(tie, basis, INT32_MAX).argmin(dim=1)

    do = may_pivot & has_enter & ~unbounded
    # product-form update of the augmented factor [Binv | xB]
    F = torch.cat([Binv, xB[..., None]], dim=2)            # (B, R, R+1)
    prow = torch.gather(F, 1, r[:, None, None].expand(B, 1, R + 1))[:, 0]
    piv = torch.gather(d, 1, r[:, None])[:, 0]
    piv = torch.where(do, piv, 1.0)                        # no 0-divide
    prow = prow / piv[:, None]
    Fnew = torch.addcmul(F, d[:, :, None], prow[:, None, :], value=-1)
    is_r = torch.arange(R, device=dev)[None, :] == r[:, None]
    Fnew = torch.where(is_r[:, :, None], prow[:, None, :], Fnew)
    F = torch.where(do[:, None, None], Fnew, F)
    basis = torch.where(do[:, None] & is_r, j[:, None].to(basis.dtype),
                        basis)
    return (F[:, :, :R], F[:, :, R], basis.to(torch.int32),
            has_enter, unbounded, rmin <= tol)


def basis_columns_ref(A, basis):
    """Each lane's basis matrix gathered from the column data.

    A: (B, R, C0); basis: (B, R) labels, labels >= C0 virtual artificials
    whose column is the unit vector ``e_{label - C0}`` (never
    materialized).  Returns ``(Bmat (B, R, R), real (B, R) bool)``,
    ``real`` marking the non-artificial members.  The sign a warm repair
    gave an artificial is dropped: the adjoint zeroes artificial entries
    (`kkt_vjp_ref`), and flipping such a column only rescales the adjoint
    component that multiplies that zero."""
    B, R, C0 = A.shape
    real = basis < C0
    basJ = basis.long().clamp(0, C0 - 1)
    cols = torch.gather(A, 2, basJ[:, None, :].expand(B, R, R))
    art_row = (basis.long() - C0).clamp(0, R - 1)
    unit = (torch.arange(R, device=A.device)[None, :, None]
            == art_row[:, None, :]).to(A.dtype)
    return torch.where(real[:, None, :], cols, unit), real


def kkt_vjp_ref(A, b, c_full, basis, gx, gfun, valid, *, nv: int):
    """The implicit-function VJP of a converged simplex optimum.

    At an optimal basis ``B`` the optimum is locally ``x_B = B^{-1} b``
    with every nonbasic variable at 0 and ``fun = c_B^T x_B``, so given
    output cotangents ``gx`` (B, nv) and ``gfun`` (B,), one adjoint solve
    per lane yields every input cotangent:

        g_B   = gx[basis] + gfun * c_B          (artificials: 0)
        y     = B^{-T} g_B
        b-bar = y
        A-bar = -y (x_B scattered to the basic columns)^T
        c-bar = gfun * x_B scattered to the basic columns

    ``valid`` (B,) bool marks lanes whose basis means something (OPTIMAL,
    unmasked): the others get an identity factor before the solve (gating
    after it would leak ``NaN * 0`` from singular garbage factors) and
    exact zeros.  Each lane's (R, R) solve is `torch.linalg.solve_ex`
    (no error check, no host sync: like the reference's solve, a singular
    valid factor gives inf/nan rather than raising).  Returns ``(A_bar,
    b_bar, c_bar)`` shaped like A, b and c_full."""
    B, R, C0 = A.shape
    dtype, dev = A.dtype, A.device
    Bmat, real = basis_columns_ref(A, basis)
    eye = torch.eye(R, dtype=dtype, device=dev).expand(B, R, R)
    Bsafe = torch.where(valid[:, None, None], Bmat, eye)
    basJ = basis.long().clamp(0, C0 - 1)

    xB = torch.linalg.solve_ex(Bsafe, b[..., None])[0][..., 0]
    gxp = torch.cat([gx, torch.zeros((B, C0 - nv), dtype=dtype, device=dev)],
                    dim=1)                                  # slacks: 0
    gB = (torch.gather(gxp, 1, basJ)
          + gfun[:, None] * torch.gather(c_full, 1, basJ))
    keep = real & valid[:, None]
    gB = torch.where(keep, gB, 0.0)
    y = torch.linalg.solve_ex(Bsafe.transpose(1, 2), gB[..., None])[0][..., 0]

    w = torch.where(keep, xB, 0.0)
    b_bar = torch.where(valid[:, None], y, 0.0)
    wcol = torch.zeros((B, C0), dtype=dtype, device=dev).scatter_add(
        1, basJ, w)
    A_bar = -b_bar[:, :, None] * wcol[:, None, :]
    c_bar = torch.zeros((B, C0), dtype=dtype, device=dev).scatter_add(
        1, basJ, gfun[:, None] * w)
    return A_bar, b_bar, c_bar
