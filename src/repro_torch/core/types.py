"""Problem containers for the offloading problem `P` (paper §III).

Port of `repro.core.types` (`OffloadInstance`, `InstanceBatch`,
`Schedule`, `next_pow2`, the `ES` alias).  They stay NumPy containers: they hold host-side
instance data that the solvers and the fleet constructors turn into
tensors, and the schedules that come back.

Notation follows the paper: n jobs, m models on the ED and one on the ES
(index m); ``p_ed[j, i]`` is job j's time on ED model i, ``p_es[j]`` its
total ES time (communication included), ``acc[i]`` the accuracy of model
i, and ``T`` the budget of each capacity constraint.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

ES = -1  # sentinel alias: instance.es_index == m


def next_pow2(x: int) -> int:
    """Smallest power of two >= x (the shape-bucketing primitive)."""
    return 1 << (max(int(x), 1) - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class OffloadInstance:
    """One instance of problem P."""

    p_ed: np.ndarray   # (n, m) float
    p_es: np.ndarray   # (n,)  float  (comm + server compute)
    acc: np.ndarray    # (m+1,) float
    T: float

    def __post_init__(self):
        object.__setattr__(self, "p_ed", np.asarray(self.p_ed, np.float64))
        object.__setattr__(self, "p_es", np.asarray(self.p_es, np.float64))
        object.__setattr__(self, "acc", np.asarray(self.acc, np.float64))
        if self.p_ed.ndim != 2:
            raise ValueError("p_ed must be (n, m)")
        if self.p_es.shape != (self.n,):
            raise ValueError("p_es must be (n,)")
        if self.acc.shape != (self.m + 1,):
            raise ValueError("acc must be (m+1,)")

    @property
    def n(self) -> int:
        return self.p_ed.shape[0]

    @property
    def m(self) -> int:
        return self.p_ed.shape[1]

    @property
    def es_index(self) -> int:
        return self.m

    def p(self, j: int, i: int) -> float:
        """Unified p_{ij} with i == m meaning the ES."""
        return float(self.p_es[j]) if i == self.m else float(self.p_ed[j, i])

    def is_identical(self, rtol: float = 1e-9) -> bool:
        """True when all jobs share processing times (paper §VI setting)."""
        return bool(
            np.allclose(self.p_ed, self.p_ed[:1], rtol=rtol)
            and np.allclose(self.p_es, self.p_es[:1], rtol=rtol))


@dataclasses.dataclass(frozen=True)
class InstanceBatch:
    """B instances sharing (n, m), stacked on a leading axis."""

    p_ed: np.ndarray   # (B, n, m) float
    p_es: np.ndarray   # (B, n)  float
    acc: np.ndarray    # (B, m+1) float
    T: np.ndarray      # (B,)  float

    def __post_init__(self):
        object.__setattr__(self, "p_ed", np.asarray(self.p_ed, np.float64))
        object.__setattr__(self, "p_es", np.asarray(self.p_es, np.float64))
        object.__setattr__(self, "acc", np.asarray(self.acc, np.float64))
        object.__setattr__(self, "T", np.asarray(self.T, np.float64))
        if self.p_ed.ndim != 3:
            raise ValueError("p_ed must be (B, n, m)")
        B, n, m = self.p_ed.shape
        if self.p_es.shape != (B, n):
            raise ValueError("p_es must be (B, n)")
        if self.acc.shape != (B, m + 1):
            raise ValueError("acc must be (B, m+1)")
        if self.T.shape != (B,):
            raise ValueError("T must be (B,)")

    @classmethod
    def stack(cls, instances: "list[OffloadInstance]") -> "InstanceBatch":
        if not instances:
            raise ValueError("cannot stack an empty instance list")
        n, m = instances[0].n, instances[0].m
        for inst in instances[1:]:
            if (inst.n, inst.m) != (n, m):
                raise ValueError(
                    f"instances must share (n, m); got ({inst.n}, {inst.m}) "
                    f"vs ({n}, {m})")
        return cls(p_ed=np.stack([i.p_ed for i in instances]),
                   p_es=np.stack([i.p_es for i in instances]),
                   acc=np.stack([i.acc for i in instances]),
                   T=np.array([i.T for i in instances]))

    def __len__(self) -> int:
        return self.p_ed.shape[0]

    def __getitem__(self, b: int) -> OffloadInstance:
        return OffloadInstance(p_ed=self.p_ed[b], p_es=self.p_es[b],
                               acc=self.acc[b], T=float(self.T[b]))

    def identical_mask(self, rtol: float = 1e-9) -> np.ndarray:
        """(B,) bool: `OffloadInstance.is_identical` vectorized over the
        batch — the criterion every batched dispatch uses."""
        return (np.isclose(self.p_ed, self.p_ed[:, :1], rtol=rtol)
                .all(axis=(1, 2))
                & np.isclose(self.p_es, self.p_es[:, :1], rtol=rtol)
                .all(axis=1))

    @property
    def n(self) -> int:
        return self.p_ed.shape[1]

    @property
    def m(self) -> int:
        return self.p_ed.shape[2]


@dataclasses.dataclass
class Schedule:
    """A (possibly constraint-violating) solution to P: ``assignment[j]``
    in 0..m, m meaning the ES."""

    assignment: np.ndarray          # (n,) int in [0, m]
    instance: OffloadInstance
    lp_accuracy: Optional[float] = None    # A*_LP upper bound when known
    n_fractional: Optional[int] = None     # fractional jobs seen by AMR^2
    status: str = "ok"                     # ok | infeasible | fallback | ...
    solver: str = ""

    @property
    def total_accuracy(self) -> float:
        return float(self.instance.acc[self.assignment].sum())

    @property
    def ed_makespan(self) -> float:
        inst = self.instance
        mask = self.assignment < inst.m
        if not mask.any():
            return 0.0
        j = np.nonzero(mask)[0]
        return float(inst.p_ed[j, self.assignment[j]].sum())

    @property
    def es_makespan(self) -> float:
        inst = self.instance
        return float(inst.p_es[self.assignment == inst.m].sum())

    @property
    def makespan(self) -> float:
        """Both tiers run in parallel: the later finisher."""
        return max(self.ed_makespan, self.es_makespan)

    @property
    def violation(self) -> float:
        """makespan / T - 1 (0 when within budget)."""
        return max(0.0, self.makespan / self.instance.T - 1.0)

    def counts(self) -> np.ndarray:
        """(m+1,) number of jobs per model."""
        return np.bincount(self.assignment, minlength=self.instance.m + 1)

    def summary(self) -> str:
        lp = (self.lp_accuracy if self.lp_accuracy is None
              else round(self.lp_accuracy, 3))
        return (f"[{self.solver}] A={self.total_accuracy:.3f} "
                f"(LP bound {lp}) "
                f"makespan ed={self.ed_makespan:.3f} "
                f"es={self.es_makespan:.3f} "
                f"T={self.instance.T} viol={100 * self.violation:.1f}% "
                f"status={self.status}")
