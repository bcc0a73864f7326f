"""Fleet problem value and the status codes the engine shares (port of
the subset of `repro.core.problem` the fleet engine uses)."""
from __future__ import annotations

import dataclasses

import torch

# Shares codes with `core.amr2` (ok/fallback/infeasible from the rounding,
# "unsolved" for an LP that hit its iteration limit or went unbounded)
# plus the LP bound-only pseudo-status at 3.
SOLUTION_STATUS_NAMES = ("ok", "fallback", "infeasible", "bound", "unsolved")
ST_BOUND = 3
ST_UNSOLVED = 4

# Uniform huge ES time: makes offloading infeasible for real jobs on the
# ES-disabled (backpressure / outage) paths.
ES_DISABLED_SENTINEL = 1e9


@dataclasses.dataclass(frozen=True)
class FleetProblem:
    """B stacked same-shape problems plus the real-job mask.

    Job slots where ``real_mask`` is False are phantom padding: p_ed and
    p_es are 0 (free on every tier), masked out of every metric."""

    p_ed: torch.Tensor       # (B, n, m) float64
    p_es: torch.Tensor       # (B, n)  float64
    acc: torch.Tensor        # (B, m+1) float64
    T: torch.Tensor          # (B,)  float64
    real_mask: torch.Tensor  # (B, n) bool

    def __post_init__(self):
        if self.p_ed.ndim != 3:
            raise ValueError("p_ed must be (B, n, m)")
        B, n, m = self.p_ed.shape
        if tuple(self.p_es.shape) != (B, n):
            raise ValueError("p_es must be (B, n)")
        if tuple(self.acc.shape) != (B, m + 1):
            raise ValueError("acc must be (B, m+1)")
        if tuple(self.T.shape) != (B,):
            raise ValueError("T must be (B,)")
        if tuple(self.real_mask.shape) != (B, n):
            raise ValueError("real_mask must be (B, n)")

    @classmethod
    def from_arrays_unchecked(cls, p_ed, p_es, acc, T,
                              real_mask) -> "FleetProblem":
        """Construct without the shape checks — the engine's per-period
        hot path, whose shapes are fixed by construction."""
        obj = object.__new__(cls)
        for f, v in (("p_ed", p_ed), ("p_es", p_es), ("acc", acc),
                     ("T", T), ("real_mask", real_mask)):
            object.__setattr__(obj, f, v)
        return obj
