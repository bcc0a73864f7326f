"""Problem and solution values of the port (port of `repro.core.problem`).

* ``Problem``      — one device's offloading problem (the paper's P).
* ``FleetProblem`` — B stacked, padded, same-shape problems plus the
                     ``real_mask`` marking which job slots are real
                     (phantom padding carries p = 0 on every tier).
* ``Solution``     — the uniform result every registry solver returns:
                     dense assignment(s), status/solver tags, timing, and
                     accuracy/makespan metrics computed on demand.

The front door is a host boundary, as in the reference: these values hold
NumPy arrays, and the solvers move what runs on the card (the LP, the DP)
to tensors themselves.  The fleet engine builds its per-period
`FleetProblem` from tensors with `FleetProblem.from_arrays_unchecked`;
the host methods (`take`, `identical_mask`, `instance`, `to_batch`,
`es_disabled`, ...) need the NumPy form.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .types import InstanceBatch, OffloadInstance, Schedule, next_pow2

# Shares codes with `core.amr2` (ok/fallback/infeasible from the rounding,
# "unsolved" for an LP that hit its iteration limit or went unbounded)
# plus the LP bound-only pseudo-status at 3.
SOLUTION_STATUS_NAMES = ("ok", "fallback", "infeasible", "bound", "unsolved")
ST_BOUND = 3
ST_UNSOLVED = 4

# Uniform huge ES time: makes offloading infeasible for real jobs on the
# ES-disabled (backpressure / outage) paths.
ES_DISABLED_SENTINEL = 1e9

_FLEET_FIELDS = ("p_ed", "p_es", "acc", "T", "real_mask")


def slot_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum (D, n) over its second axis in slot order.  `torch.sum`
    associates differently on the CPU and the card, and devices whose
    sums tie in exact arithmetic (the same jobs in other slots) would then
    be ordered otherwise; the same additions in the same order agree bit
    for bit."""
    out = x[:, 0]
    for k in range(1, x.shape[1]):
        out = out + x[:, k]
    return out


@dataclasses.dataclass(frozen=True)
class Problem:
    """One device's offloading problem."""

    p_ed: np.ndarray   # (n, m) float — per-job ED-model seconds
    p_es: np.ndarray   # (n,)  float — per-job total ES seconds (comm incl.)
    acc: np.ndarray    # (m+1,) float — model accuracies, acc[m] = ES
    T: float           # period budget

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

    def is_identical(self, rtol: float = 1e-9) -> bool:
        return self.to_instance().is_identical(rtol=rtol)

    @classmethod
    def from_instance(cls, inst: OffloadInstance) -> "Problem":
        return cls(p_ed=inst.p_ed, p_es=inst.p_es, acc=inst.acc,
                   T=float(inst.T))

    def to_instance(self) -> OffloadInstance:
        return OffloadInstance(p_ed=self.p_ed, p_es=self.p_es, acc=self.acc,
                               T=float(self.T))

    def es_disabled(self) -> "Problem":
        """The ES-disabled variant: offloading made infeasible for every
        job (the paper's m-model special case)."""
        return Problem(p_ed=self.p_ed.copy(),
                       p_es=np.full(self.n, ES_DISABLED_SENTINEL),
                       acc=self.acc.copy(), T=self.T)


@dataclasses.dataclass(frozen=True)
class FleetProblem:
    """B stacked same-shape problems plus the real-job mask.

    Job slots where ``real_mask`` is False are phantom padding: p_ed and
    p_es are 0 (free on every tier, so they never distort the real jobs'
    trade-offs), masked out of every metric.  Constructed from arrays it
    holds NumPy (float64, bool); the engine's hot path holds tensors
    (`from_arrays_unchecked`)."""

    p_ed: np.ndarray       # (B, n, m) float64
    p_es: np.ndarray       # (B, n)  float64
    acc: np.ndarray        # (B, m+1) float64
    T: np.ndarray          # (B,)  float64
    real_mask: np.ndarray  # (B, n) bool

    def __post_init__(self):
        for f in _FLEET_FIELDS:
            v = getattr(self, f)
            if isinstance(v, torch.Tensor):
                raise TypeError(
                    f"FleetProblem({f}=<tensor>): the constructor takes "
                    f"arrays; tensors go through from_arrays_unchecked")
            object.__setattr__(self, f, np.asarray(
                v, bool if f == "real_mask" else np.float64))
        if self.p_ed.ndim != 3:
            raise ValueError("p_ed must be (B, n, m)")
        B, n, m = self.p_ed.shape
        if self.p_es.shape != (B, n):
            raise ValueError("p_es must be (B, n)")
        if self.acc.shape != (B, m + 1):
            raise ValueError("acc must be (B, m+1)")
        if self.T.shape != (B,):
            raise ValueError("T must be (B,)")
        if self.real_mask.shape != (B, n):
            raise ValueError("real_mask must be (B, n)")

    def __len__(self) -> int:
        return self.p_ed.shape[0]

    @property
    def n(self) -> int:
        return self.p_ed.shape[1]

    @property
    def m(self) -> int:
        return self.p_ed.shape[2]

    def __getitem__(self, b: int) -> Problem:
        """Device b's (still padded) problem."""
        return Problem(p_ed=self.p_ed[b], p_es=self.p_es[b], acc=self.acc[b],
                       T=float(self.T[b]))

    def identical_mask(self, rtol: float = 1e-9) -> np.ndarray:
        """(B,) bool — `Problem.is_identical` vectorized over the batch
        (all job slots, phantoms included: the criterion the fleet
        dispatch uses)."""
        return self.to_batch().identical_mask(rtol=rtol)

    def take(self, rows: np.ndarray) -> "FleetProblem":
        """Row subset (or repeat) used for sub-batch dispatch."""
        return FleetProblem(p_ed=self.p_ed[rows], p_es=self.p_es[rows],
                            acc=self.acc[rows], T=self.T[rows],
                            real_mask=self.real_mask[rows])

    def es_disabled(self) -> "FleetProblem":
        """Offloading made infeasible: real jobs get the uniform huge ES
        time, phantom padding stays free (the backpressure / outage
        replan problem)."""
        return FleetProblem(
            p_ed=self.p_ed.copy(),
            p_es=np.where(self.real_mask, ES_DISABLED_SENTINEL, 0.0),
            acc=self.acc.copy(), T=self.T.copy(), real_mask=self.real_mask)

    @classmethod
    def from_arrays_unchecked(cls, p_ed, p_es, acc, T,
                              real_mask) -> "FleetProblem":
        """Construct without coercion or checks — the engine's per-period
        hot path, whose tensor fields have shapes fixed by construction."""
        obj = object.__new__(cls)
        for f, v in zip(_FLEET_FIELDS, (p_ed, p_es, acc, T, real_mask)):
            object.__setattr__(obj, f, v)
        return obj

    @classmethod
    def from_batch(cls, batch: InstanceBatch,
                   real_mask: Optional[np.ndarray] = None) -> "FleetProblem":
        if real_mask is None:
            real_mask = np.ones(batch.p_es.shape, dtype=bool)
        return cls(p_ed=batch.p_ed, p_es=batch.p_es, acc=batch.acc,
                   T=batch.T, real_mask=real_mask)

    @classmethod
    def from_problems(cls, problems: Sequence[Problem],
                      pad_to: Optional[int] = None) -> "FleetProblem":
        """Stack problems sharing one model count m, padding each job axis
        with phantom (p = 0) slots up to ``pad_to`` (default: the largest
        job count rounded up to a power of two)."""
        problems = list(problems)
        if not problems:
            raise ValueError("cannot stack an empty problem list")
        m = problems[0].m
        for p in problems[1:]:
            if p.m != m:
                raise ValueError(
                    f"problems must share the model count m; got {p.m} "
                    f"vs {m}")
        n_pad = pad_to if pad_to is not None else next_pow2(
            max(p.n for p in problems))
        if any(p.n > n_pad for p in problems):
            raise ValueError(f"job count exceeds pad_to={n_pad}")
        B = len(problems)
        p_ed = np.zeros((B, n_pad, m))
        p_es = np.zeros((B, n_pad))
        mask = np.zeros((B, n_pad), dtype=bool)
        for b, p in enumerate(problems):
            p_ed[b, :p.n] = p.p_ed
            p_es[b, :p.n] = p.p_es
            mask[b, :p.n] = True
        return cls(p_ed=p_ed, p_es=p_es,
                   acc=np.stack([p.acc for p in problems]),
                   T=np.array([p.T for p in problems]), real_mask=mask)

    def to_batch(self) -> InstanceBatch:
        return InstanceBatch(p_ed=self.p_ed, p_es=self.p_es, acc=self.acc,
                             T=self.T)

    def instance(self, b: int, strip: bool = False) -> OffloadInstance:
        """Device b as an OffloadInstance (``strip=True`` drops the
        phantom slots)."""
        keep = self.real_mask[b] if strip else slice(None)
        return OffloadInstance(p_ed=self.p_ed[b][keep],
                               p_es=self.p_es[b][keep],
                               acc=self.acc[b], T=float(self.T[b]))


@dataclasses.dataclass
class Solution:
    """Uniform solver result for single and fleet problems.

    ``assignment`` is (n,) for a `Problem` and (B, n) for a
    `FleetProblem`; ``status`` an int code (or (B,) codes) into
    `SOLUTION_STATUS_NAMES`; ``solver`` the registry name (or a (B,)
    object array when a dispatching policy mixed solvers).  Metrics are
    computed on demand from the current assignment, so in-place
    assignment edits (the engine's backpressure rewrite) stay
    consistent."""

    problem: Union[Problem, FleetProblem]
    assignment: np.ndarray
    status: np.ndarray                 # () or (B,) int codes
    solver: Union[str, np.ndarray]
    plan_seconds: float = 0.0
    lp_accuracy: Optional[np.ndarray] = None    # A*_LP bound when available
    n_fractional: Optional[np.ndarray] = None
    # optimal simplex basis from LP-backed solvers: (R,) or (B, R) int, -1
    # rows for devices another solver handled; feed it back as
    # `solve(..., warm_start=solution.basis)` next period
    basis: Optional[np.ndarray] = None
    _schedules: Optional[List[Schedule]] = dataclasses.field(
        default=None, repr=False)
    _per_model: Optional[Dict[int, np.ndarray]] = dataclasses.field(
        default=None, repr=False)

    @property
    def is_fleet(self) -> bool:
        return self.assignment.ndim == 2

    @property
    def status_name(self) -> Union[str, List[str]]:
        if self.is_fleet:
            return [SOLUTION_STATUS_NAMES[int(s)] for s in
                    np.atleast_1d(self.status)]
        return SOLUTION_STATUS_NAMES[int(self.status)]

    @property
    def solver_name(self) -> str:
        """Scalar solver tag (fleet: the unique name or 'mixed')."""
        if isinstance(self.solver, str):
            return self.solver
        names = {str(s) for s in np.atleast_1d(self.solver)}
        return names.pop() if len(names) == 1 else "mixed"

    def _mask(self) -> np.ndarray:
        if isinstance(self.problem, FleetProblem):
            return self.problem.real_mask
        return np.ones(self.assignment.shape, dtype=bool)

    @property
    def accuracy(self) -> Union[float, np.ndarray]:
        """Summed accuracy over real jobs (per device for fleets)."""
        p = self.problem
        if self.is_fleet:
            rows = np.arange(len(p))[:, None]
            acc_jobs = p.acc[rows, self.assignment]
            return np.where(self._mask(), acc_jobs, 0.0).sum(axis=1)
        return float(p.acc[self.assignment].sum())

    @property
    def ed_makespan(self) -> Union[float, np.ndarray]:
        p = self.problem
        m = p.m
        if self.is_fleet:
            on_ed = self._mask() & (self.assignment < m)
            picked = np.clip(self.assignment, 0, m - 1)[..., None]
            ed = np.take_along_axis(p.p_ed, picked, axis=2)[..., 0]
            return np.where(on_ed, ed, 0.0).sum(axis=1)
        on_ed = self.assignment < m
        if not on_ed.any():
            return 0.0
        j = np.nonzero(on_ed)[0]
        return float(p.p_ed[j, self.assignment[j]].sum())

    @property
    def es_makespan(self) -> Union[float, np.ndarray]:
        p = self.problem
        offl = self._mask() & (self.assignment == p.m)
        if self.is_fleet:
            return np.where(offl, p.p_es, 0.0).sum(axis=1)
        return float(p.p_es[offl].sum())

    @property
    def makespan(self) -> Union[float, np.ndarray]:
        return np.maximum(self.ed_makespan, self.es_makespan) \
            if self.is_fleet else max(self.ed_makespan, self.es_makespan)

    @property
    def violation(self) -> Union[float, np.ndarray]:
        if self.is_fleet:
            return np.maximum(0.0, self.makespan / self.problem.T - 1.0)
        return max(0.0, self.makespan / self.problem.T - 1.0)

    @property
    def per_model(self) -> Dict[int, np.ndarray]:
        """model index -> job ids (single-problem solutions only)."""
        if self.is_fleet:
            raise ValueError("per_model is per-device; index a fleet "
                             "Solution via to_schedule(b)")
        if self._per_model is None:
            a = self.assignment
            self._per_model = {i: np.nonzero(a == i)[0]
                               for i in range(self.problem.m + 1)}
        return self._per_model

    def _lp_acc_at(self, b: Optional[int]) -> Optional[float]:
        """LP bound as a float or None (NaN marks 'no bound')."""
        if self.lp_accuracy is None:
            return None
        v = float(np.atleast_1d(self.lp_accuracy)[b if b is not None else 0])
        return None if np.isnan(v) else v

    def to_schedule(self, b: Optional[int] = None) -> Schedule:
        """The device's `Schedule` (pass ``b`` for fleet solutions)."""
        if self.is_fleet:
            if b is None:
                raise ValueError("fleet Solution: pass the device index b")
            if self._schedules is not None:
                return self._schedules[b]
            return Schedule(
                assignment=np.asarray(self.assignment[b]),
                instance=self.problem.instance(b),
                lp_accuracy=self._lp_acc_at(b),
                n_fractional=(None if self.n_fractional is None else
                              int(np.atleast_1d(self.n_fractional)[b])),
                status=SOLUTION_STATUS_NAMES[int(self.status[b])],
                solver=str(np.atleast_1d(self.solver)[b]
                           if not isinstance(self.solver, str)
                           else self.solver))
        if self._schedules is not None:
            return self._schedules[0]
        return Schedule(
            assignment=self.assignment,
            instance=self.problem.to_instance(),
            lp_accuracy=self._lp_acc_at(None),
            n_fractional=(None if self.n_fractional is None
                          else int(self.n_fractional)),
            status=SOLUTION_STATUS_NAMES[int(self.status)],
            solver=str(self.solver))

    def schedules(self) -> List[Schedule]:
        if not self.is_fleet:
            return [self.to_schedule()]
        return [self.to_schedule(b) for b in range(len(self.problem))]

    @classmethod
    def from_schedule(cls, sched: Schedule, *, solver: str,
                      plan_seconds: float = 0.0,
                      problem: Optional[Problem] = None) -> "Solution":
        status = SOLUTION_STATUS_NAMES.index(sched.status) \
            if sched.status in SOLUTION_STATUS_NAMES else ST_BOUND
        return cls(problem=problem or Problem.from_instance(sched.instance),
                   assignment=sched.assignment,
                   status=np.int64(status), solver=solver,
                   plan_seconds=plan_seconds,
                   lp_accuracy=(None if sched.lp_accuracy is None
                                else np.float64(sched.lp_accuracy)),
                   n_fractional=(None if sched.n_fractional is None
                                 else np.int64(sched.n_fractional)),
                   _schedules=[sched])
