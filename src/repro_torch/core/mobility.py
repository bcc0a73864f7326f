"""Multi-cell mobility: geometry, routing and per-cell admission (port of
`repro.core.mobility`).

The paper has one ED talking to one ES.  The mobility scenario has S
*cells* (base stations), each fronting ``servers_per_cell`` ES servers,
and devices moving in a plane:

``MobilityModel``
    Cell positions and nominal link rates, a coverage ``radius``, the
    distance-to-slowdown coefficient ``link_alpha``, and either a replayed
    position trace (``trace`` (H, D, 2), the parity mode) or a random walk
    (``walk_sigma`` steps, drawn by the engine from a generator seeded by
    (mobility_seed, period)).  `make` holds NumPy arrays; the engine keeps
    a float64 copy on its device (`MobilityModel.to`).
``route_cells``
    Each device picks its serving cell under the coverage radius —
    ``"nearest"`` (min distance) or ``"min_time"`` (min link factor x (1 +
    last period's cell load)) — and gets that cell's link factor, which
    scales its ES latencies.  Uncovered devices get cell -1 and factor 1.
``admit_mask_segmented``
    Per-cell first-fit admission.  Within a cell, ascending demands placed
    least-loaded-first land round-robin on the servers, and rejections
    form a suffix of the ascending order (the reference's docstring has
    the induction).  The reference takes each server chain's running load
    as one global cumsum minus the chain's base; that rounds otherwise on
    the card (a parallel scan) than on the CPU, and its error grows with
    the fleet's total demand.  Here each chain's running load is a fixed
    sequence of adds — a ``cumsum`` down the round axis of a (round,
    chain) matrix, one sequential sum per chain — so the CPU and the card
    agree bit for bit and the admitted sets equal the sequential oracle
    `admit_mask_cells_np`'s.
``admit_mask_pool``
    The one-cell path of the engine (bitwise the sequential scan).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import DeviceLike

__all__ = [
    "MobilityModel", "validate_mobility", "route_cells",
    "admit_mask_segmented", "admit_mask_pool", "admit_mask_cells_np",
    "ROUTING_MODES", "MOBILITY_MODES",
]

MOBILITY_MODES = ("off", "replay", "walk")
ROUTING_MODES = ("nearest", "min_time")

MOBILITY_FIELDS = ("cell_xy", "cell_rate", "radius", "link_alpha",
                   "walk_sigma", "trace")


def _np(x) -> np.ndarray:
    """A field as NumPy (tensors are read back from their device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass(frozen=True)
class MobilityModel:
    """Cell geometry and device motion; every field float64.

    ``trace`` carries the replayed positions ((H, D, 2); periods beyond H
    cycle).  In walk mode only ``trace[0]`` is read (the initial
    positions).  ``radius=inf`` means every device is always covered and
    — because ``d / inf == 0`` — every link factor is exactly 1.0, which
    makes one cell with an infinite radius reduce to the single-pool
    engine bit for bit."""

    cell_xy: np.ndarray      # (S, 2) cell positions
    cell_rate: np.ndarray    # (S,) nominal link-rate multipliers (> 0)
    radius: np.ndarray       # ()   coverage radius (inf: always covered)
    link_alpha: np.ndarray   # ()   slowdown per unit normalized distance
    walk_sigma: np.ndarray   # ()   random-walk step stddev (walk mode)
    trace: np.ndarray        # (H, D, 2) replayed positions / initial pos

    @property
    def n_cells(self) -> int:
        return self.cell_xy.shape[0]

    @classmethod
    def none(cls) -> "MobilityModel":
        """The null geometry: one cell at the origin, infinite radius."""
        return cls(cell_xy=np.zeros((1, 2), np.float64),
                   cell_rate=np.ones(1, np.float64),
                   radius=np.float64(np.inf),
                   link_alpha=np.float64(0.0),
                   walk_sigma=np.float64(0.0),
                   trace=np.zeros((1, 1, 2), np.float64))

    @classmethod
    def make(cls, *, cell_xy, trace, cell_rate=None, radius=np.inf,
             link_alpha: float = 0.0,
             walk_sigma: float = 0.0) -> "MobilityModel":
        """Keyword constructor with float64 coercion.  ``trace`` is
        (H, D, 2) (walk mode passes (1, D, 2) initial positions)."""
        cell_xy = np.asarray(cell_xy, np.float64)
        trace = np.asarray(trace, np.float64)
        if cell_xy.ndim != 2 or cell_xy.shape[1] != 2:
            raise ValueError(f"cell_xy must be (S, 2); got {cell_xy.shape}")
        if trace.ndim != 3 or trace.shape[2] != 2:
            raise ValueError(f"trace must be (H, D, 2); got {trace.shape}")
        S = cell_xy.shape[0]
        rate = (np.ones(S, np.float64) if cell_rate is None
                else np.asarray(cell_rate, np.float64))
        return cls(cell_xy=cell_xy, cell_rate=rate,
                   radius=np.float64(radius),
                   link_alpha=np.float64(link_alpha),
                   walk_sigma=np.float64(walk_sigma), trace=trace)

    def is_null(self) -> bool:
        return (self.n_cells == 1 and self.trace.shape[1] == 1
                and not np.any(_np(self.cell_xy))
                and bool(np.isinf(_np(self.radius))))

    def to(self, device: DeviceLike) -> "MobilityModel":
        """The model with every field a float64 tensor on ``device``."""
        return MobilityModel(**{
            f: torch.as_tensor(_np(getattr(self, f)), dtype=torch.float64,
                               device=device)
            for f in MOBILITY_FIELDS})


def validate_mobility(model: MobilityModel, *, n_devices: int,
                      n_servers: int, mode: str, routing: str) -> None:
    """The geometry guard of `EngineParams.from_fleet` / `with_mobility`:
    non-float64 fields, non-positive link rates and mismatched (D, S)
    shapes raise named `ValueError`s."""
    if mode not in MOBILITY_MODES:
        raise ValueError(f"unknown mobility_mode {mode!r}; expected one "
                         f"of {MOBILITY_MODES}")
    if routing not in ROUTING_MODES:
        raise ValueError(f"unknown routing {routing!r}; expected one of "
                         f"{ROUTING_MODES}")
    if mode == "off":
        return
    for f in MOBILITY_FIELDS:
        leaf = getattr(model, f)
        if isinstance(leaf, torch.Tensor):
            dt, ok = leaf.dtype, leaf.dtype == torch.float64
        else:
            dt = np.asarray(leaf).dtype
            ok = dt == np.float64
        if not ok:
            raise ValueError(
                f"mobility.{f} is {dt} but the engine is float64-only; "
                f"build geometry arrays as float64")
    cell_xy, trace, rate = (_np(model.cell_xy), _np(model.trace),
                            _np(model.cell_rate))
    S = cell_xy.shape[0]
    if cell_xy.ndim != 2 or cell_xy.shape[1] != 2:
        raise ValueError(f"mobility.cell_xy must be (S, 2); got "
                         f"{cell_xy.shape}")
    if rate.shape != (S,):
        raise ValueError(
            f"mobility.cell_rate must be ({S},) to match the "
            f"{S}-cell geometry; got {rate.shape}")
    if not np.all(rate > 0):
        raise ValueError(
            f"mobility.cell_rate must be strictly positive (a zero or "
            f"negative link rate prices an infinite/negative ES latency); "
            f"got min {rate.min()}")
    if trace.ndim != 3 or trace.shape[1] != n_devices \
            or trace.shape[2] != 2:
        raise ValueError(
            f"mobility.trace must be (H, {n_devices}, 2) for this "
            f"{n_devices}-device fleet; got {trace.shape}")
    r = float(_np(model.radius))
    if not r > 0:
        raise ValueError(f"mobility.radius must be positive; got {r}")
    if float(_np(model.link_alpha)) < 0:
        raise ValueError("mobility.link_alpha must be >= 0")
    if mode == "walk" and float(_np(model.walk_sigma)) < 0:
        raise ValueError("mobility.walk_sigma must be >= 0")
    if n_servers % S:
        raise ValueError(
            f"n_servers={n_servers} must be divisible by the "
            f"{S}-cell geometry (servers_per_cell = n_servers // n_cells)")


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------
def route_cells(pos, model: MobilityModel, load_frac, routing: str):
    """``pos`` (D, 2) -> ``(cell (D,) int32, covered (D,) bool,
    link_factor (D,) float64)``, the model's fields tensors on ``pos``'s
    device.

    ``"nearest"`` picks the covered cell at the least distance;
    ``"min_time"`` weights each covered cell's link factor by ``1 +
    load_frac`` (last period's per-cell utilization).  The chosen cell's
    link factor is ``(1 + link_alpha * dist / radius) / cell_rate`` —
    exactly 1.0 under an infinite radius with unit rates.  Ties go to the
    lowest cell index.  Uncovered devices get cell -1 and factor 1.0."""
    diff = pos[:, None, :] - model.cell_xy[None, :, :]
    dist = torch.sqrt(diff[..., 0] * diff[..., 0]
                      + diff[..., 1] * diff[..., 1])          # (D, S)
    covered_per = dist <= model.radius
    lf = (1.0 + model.link_alpha * (dist / model.radius)) \
        / model.cell_rate[None, :]
    if routing == "nearest":
        score = dist
    else:                                                    # "min_time"
        score = lf * (1.0 + load_frac)[None, :]
    score = torch.where(covered_per, score, torch.inf)
    cell = score.argmin(dim=1)
    covered = covered_per.any(dim=1)
    link = torch.gather(lf, 1, cell[:, None])[:, 0]
    return (torch.where(covered, cell, -1).to(torch.int32), covered,
            torch.where(covered, link, 1.0))


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------
def admit_mask_segmented(demands, cell, T, n_cells: int,
                         servers_per_cell: int):
    """Per-cell first-fit admission of ``demands`` (D,) ES seconds (<= 0:
    not offloading) for devices in ``cell`` (D,) int32 (-1: uncovered,
    never admitted): in each cell, ascending demand (device id on ties),
    least-loaded server first.

    Returns ``(admitted (D,) bool, loads (n_cells, servers_per_cell))``:
    each server's load is the last admitted running load of its chain, a
    selection, not a re-summation.  Placement is round-robin by a
    device's position within its cell; each chain's running load is a
    ``cumsum`` down the outer axis of a (round, chain) matrix, which
    PyTorch runs as one sequential sum per chain on the CPU and on the
    card: the same additions in the same order as a sequential first fit,
    with no value read back to the host."""
    D = demands.shape[0]
    k = servers_per_cell
    S = max(n_cells, 1)
    dev, dtype = demands.device, demands.dtype
    active = (demands > 0) & (cell >= 0)
    eff = torch.where(active, demands, torch.inf)
    # segment key: inactive devices go to a phantom cell S
    ckey = torch.where(active, cell.to(torch.int64), S)
    # lexsort by (cell, demand, id): two stable argsorts
    ord1 = torch.argsort(eff, stable=True)
    order = ord1[torch.argsort(ckey[ord1], stable=True)]
    sc = ckey[order]                                   # ascending cells
    act_s = active[order]
    sd = torch.where(act_s, demands[order], 0.0)
    seg_start = torch.searchsorted(sc, torch.arange(S + 1, device=dev))
    pos = torch.arange(D, device=dev) - seg_start[sc]
    rounds = -(-D // k)
    # (round, chain) slots: chain = cell * k + server; every sorted
    # position has its own slot
    width = (S + 1) * k
    slot = (pos // k) * width + sc * k + pos % k
    mat = torch.zeros(rounds * width, dtype=dtype, device=dev)
    mat[slot] = sd
    # a scan down the outer axis: one running sum per chain, row after
    # row, on the CPU and on the card alike
    inc = mat.reshape(rounds, width).cumsum(dim=0).reshape(-1)[slot]
    fits = inc <= T + 1e-12
    # suffix rule: everything at or after the cell's first violation is out
    viol_pos = torch.where(act_s & ~fits, pos, D)
    first_viol = torch.full((S + 1,), D, dtype=pos.dtype, device=dev)
    first_viol = first_viol.scatter_reduce(0, sc, viol_pos, "amin")
    adm_sorted = act_s & fits & (pos < first_viol[sc])
    admitted = torch.zeros(D, dtype=torch.bool, device=dev)
    admitted[order] = adm_sorted
    chain = (sc * k + pos % k).clamp_max(S * k - 1)
    server_loads = torch.zeros(S * k, dtype=dtype, device=dev)
    server_loads = server_loads.scatter_reduce(
        0, chain, torch.where(adm_sorted, inc, 0.0), "amax")
    return admitted, server_loads.reshape(S, k)


def admit_mask_pool(demands, T, n_servers: int):
    """First-fit admission of ``demands`` (D,) ES seconds (<= 0: not
    offloading) onto ``n_servers`` servers of capacity ``T``: ascending
    demand (device id on ties), least-loaded server first.

    The first-index least-loaded rule places the sorted demands round-robin
    on the servers (see the reference's docstring for the induction), so
    the running per-server loads are a ``cumsum`` down the round axis of
    the (ceil(D/k), k) matrix — one sequential sum per server on the CPU
    and the card, the same addition order as a D-step sequential first
    fit.  Rejections form a suffix of the sorted order.  Gradients flow
    from ``demands`` to ``inc`` through the sort's gather.

    Returns ``(admitted (D,) bool, loads (n_servers,), inc (D,))`` with
    ``inc`` each device's inclusive server load at its placement (device
    order; 0 for non-offloaders)."""
    D = demands.shape[0]
    k = n_servers
    dev, dtype = demands.device, demands.dtype
    active = demands > 0
    eff = torch.where(active, demands, torch.inf)
    order = torch.argsort(eff, stable=True)
    sd = torch.where(active[order], demands[order], 0.0)
    rounds = -(-D // k)
    # one column per server, and at least two: the card scans a (rounds,
    # 1) matrix as a flat array, in parallel (another association), and a
    # matrix of several columns one column at a time, in order
    mat = torch.zeros((rounds, max(k, 2)), dtype=dtype, device=dev)
    mat[:, :k] = torch.cat([sd, torch.zeros(rounds * k - D, dtype=dtype,
                                            device=dev)]).reshape(rounds, k)
    inc_mat = mat.cumsum(dim=0)[:, :k]                # (rounds, k)
    inc_sorted = inc_mat.reshape(rounds * k)[:D]
    fits = inc_sorted <= T + 1e-12
    posv = torch.arange(D, device=dev)
    first_viol = torch.where(active[order] & ~fits, posv, D).amin()
    adm_sorted = active[order] & fits & (posv < first_viol)
    admitted = torch.zeros(D, dtype=torch.bool, device=dev)
    admitted[order] = adm_sorted
    # final per-server load: the max of its admitted inclusive loads
    adm_mat = torch.cat([adm_sorted, torch.zeros(rounds * k - D,
                                                 dtype=torch.bool,
                                                 device=dev)])
    loads = torch.where(adm_mat.reshape(rounds, k), inc_mat, 0.0).amax(0)
    inc = torch.zeros(D, dtype=dtype, device=dev)
    inc[order] = inc_sorted
    return admitted, loads, inc


def admit_mask_cells_np(demands, cell, T, n_cells: int,
                        servers_per_cell: int):
    """NumPy oracle for `admit_mask_segmented`: the host pool's
    sequential first fit, run independently inside each cell."""
    demands = np.asarray(demands, np.float64)
    cell = np.asarray(cell)
    D = len(demands)
    mask = np.zeros(D, bool)
    loads = np.zeros((max(n_cells, 1), servers_per_cell))
    eff = np.where((demands > 0) & (cell >= 0), demands, np.inf)
    order = np.argsort(eff, kind="stable")
    for d in order:
        if not np.isfinite(eff[d]):
            break                      # the +inf tail: non-offloaders
        need = float(demands[d])
        c = int(cell[d])
        slot = int(np.argmin(loads[c]))
        if loads[c, slot] + need <= T + 1e-12:
            loads[c, slot] += need
            mask[d] = True
    return mask, loads

