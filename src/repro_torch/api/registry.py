"""Solver registry: one named entry per planning algorithm (port of
`repro.api.registry`).

Each solver registers itself with a declared capability set, and
`repro_torch.api.solve` dispatches on those capabilities.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Protocol, runtime_checkable

from ..core.problem import FleetProblem, Problem, Solution

@dataclasses.dataclass(frozen=True)
class SolverInfo:
    """A registry entry's declared capabilities.  ``batched``,
    ``supports_es_disabled`` and ``bound_only`` are enforced by the front
    door and the fleet engine; ``exact_on_identical`` is descriptive."""
    name: str
    batched: bool                 # has a solve_fleet (batched) path
    exact_on_identical: bool      # optimal when all jobs share proc. times
    supports_es_disabled: bool    # usable for backpressure/outage replans
    bound_only: bool = False      # yields an upper bound, not a schedule
    warm_start: bool = False      # accepts warm_start= (Solution.basis)
    online: bool = False          # learns per sample in-stream
    description: str = ""


@runtime_checkable
class Solver(Protocol):
    """What a registry entry provides: ``solve_one`` for a single
    `Problem` (``backend`` "torch" or "numpy"); batched solvers also
    ``solve_fleet`` over a same-shape `FleetProblem`."""
    info: SolverInfo

    def solve_one(self, problem: Problem, *, backend: str = "torch",
                  **opts) -> Solution: ...

    def solve_fleet(self, fleet: FleetProblem, **opts) -> Solution: ...


_REGISTRY: Dict[str, Solver] = {}


def register_solver(name: str, *, batched: bool, exact_on_identical: bool,
                    supports_es_disabled: bool, bound_only: bool = False,
                    warm_start: bool = False, online: bool = False,
                    description: str = "") -> Callable:
    """Class decorator: instantiate and register a solver under ``name``."""
    def deco(cls):
        solver = cls()
        solver.info = SolverInfo(
            name=name, batched=batched,
            exact_on_identical=exact_on_identical,
            supports_es_disabled=supports_es_disabled,
            bound_only=bound_only, warm_start=warm_start, online=online,
            description=description)
        _REGISTRY[name] = solver
        return cls
    return deco


def get_solver(name: str) -> Solver:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown solver {name!r}; registered: "
            f"{sorted(_REGISTRY)} (or policy='auto')") from None


def solver_names() -> "list[str]":
    return sorted(_REGISTRY)


def solvers() -> Dict[str, SolverInfo]:
    """name -> capabilities."""
    return {name: s.info for name, s in sorted(_REGISTRY.items())}


def solver_table() -> str:
    """The registry rendered as a markdown capability table."""
    rows = ["| solver | batched | exact on identical | es-disabled | "
            "warm-start | online | description |",
            "|--------|---------|--------------------|-------------|"
            "------------|--------|-------------|"]
    for name, info in solvers().items():
        rows.append(
            f"| `{name}` | {'yes' if info.batched else 'no'} "
            f"| {'yes' if info.exact_on_identical else 'no'} "
            f"| {'yes' if info.supports_es_disabled else 'no'} "
            f"| {'yes' if info.warm_start else 'no'} "
            f"| {'yes' if info.online else 'no'} "
            f"| {info.description}"
            f"{' (bound only)' if info.bound_only else ''} |")
    return "\n".join(rows)
