"""Plain PyTorch versions of the batched simplex pivot kernels.

Port of `repro.kernels.simplex_pivot.ref` (`pivot_update_ref`,
`price_reduced_ref`, `reduced_pivot_ref`), statement for statement.  They
are what a CPU tensor runs through (`ops`), the oracle the CUDA kernels
are held against on the card, and the pricing step `core.lp` runs after
a revised phase.  Every function here is out of place; the `ops` wrappers
carry the in-place contract of the kernels.

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
