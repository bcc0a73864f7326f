"""Carry the reference's values across to the port, so that both
packages in a parity test start from the same arrays.

* `params_from_numpy` / `state_from_numpy`: the reference engine's
  `EngineParams` / `EngineState` fields, given as NumPy arrays and plain
  scalars keyed by the reference's field names, as the port's values on
  ``device``, the chaos, mobility, HI and differentiable fields
  included.  Arrivals cross as the replayed trace (``counts`` /
  ``stream``), faults as a replayed realization trace and HI's
  confidences as its ``conf_trace`` (``hi_stream="replay"``): `jax.random`
  streams cannot be redrawn in torch.
* `fault_model_from_numpy`, `fault_trace_from_numpy`,
  `mobility_from_numpy`, `hi_model_from_numpy`, `hi_state_from_numpy`:
  the reference's `FaultModel`, a list of its per-period
  `FaultRealization` draws (stacked into the port's ``fault_trace``), its
  `MobilityModel`, `HIModel` and `HILearnerState`.
* `fleet_problem_from_numpy`: a reference `FleetProblem` or
  `InstanceBatch` (anything with its array fields) as the port's
  `FleetProblem`.
* `device_specs_from_numpy`: the reference's `DeviceSpec` list (profile,
  drift, outage) as the port's.
* `solution_fields`: a `Solution` of either package as a dict of NumPy
  arrays, for comparisons.
* `model_params_from_numpy`: the reference LM's `init_params` pytree,
  given as NumPy arrays, as the port's parameters on ``device``.
* `cache_from_numpy`: the reference LM's cache (`init_cache` / `prefill`),
  given as NumPy arrays, as the port's cache on ``device``.

The functions read attributes and arrays only; this module imports
neither jax nor the reference.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .core.problem import FleetProblem
from .serving.fleet import DeviceSpec
from .serving.profile import TierProfile
from .api.engine import (PARAM_ARRAYS, PARAM_CONFIG, EngineParams,
                         EngineState, params_from_arrays,
                         state_from_arrays)
from .core.faults import FAULT_FIELDS, FaultModel, FaultRealization
from .core.hi import HI_STATE_FIELDS, HILearnerState, HIModel
from .core.mobility import MOBILITY_FIELDS, MobilityModel

_HI_TENSORS = ("spread", "theta0", "conf_trace")


def fault_model_from_numpy(fm) -> FaultModel:
    """The port's `FaultModel` from the reference's (float64 scalar
    fields)."""
    return FaultModel(**{f: float(np.asarray(getattr(fm, f)))
                         for f in FAULT_FIELDS})


def fault_trace_from_numpy(realizations: Sequence,
                           device: DeviceLike = None) -> FaultRealization:
    """A replayed fault trace (``EngineParams.fault_trace``) from the
    reference's per-period `FaultRealization` draws (NumPy fields), stacked
    on a leading period axis: period t of a rollout reads entry t mod H."""
    dev = resolve_device(device)
    return FaultRealization(*(
        torch.as_tensor(np.stack([np.asarray(getattr(r, f))
                                  for r in realizations]), device=dev)
        for f in FaultRealization._fields))


def mobility_from_numpy(mm) -> MobilityModel:
    """The port's `MobilityModel` (NumPy float64 fields) from the
    reference's."""
    return MobilityModel(**{f: np.array(getattr(mm, f), np.float64)
                            for f in MOBILITY_FIELDS})


def hi_model_from_numpy(hm) -> HIModel:
    """The port's `HIModel` from the reference's (float64 array fields):
    ``spread``, ``theta0`` and ``conf_trace`` as CPU tensors, the rest as
    Python floats."""
    return HIModel(**{
        f: (torch.as_tensor(np.array(getattr(hm, f), np.float64))
            if f in _HI_TENSORS else float(np.asarray(getattr(hm, f))))
        for f in ("spread", "offload_cost", "lr", "tau", "theta0",
                  "explore", "conf_trace")})


def hi_state_from_numpy(hst, device: DeviceLike = None) -> HILearnerState:
    """The port's `HILearnerState` on ``device`` from the reference's
    (NumPy fields; ``arm`` int32, the rest float64)."""
    dev = resolve_device(device)
    return HILearnerState(**{
        f: torch.as_tensor(np.array(getattr(hst, f)), device=dev,
                           dtype=torch.int32 if f == "arm"
                           else torch.float64)
        for f in HI_STATE_FIELDS})


def params_from_numpy(fields: Dict[str, object],
                      device: DeviceLike = None) -> EngineParams:
    """The port's `EngineParams` from the reference's fields.  Tensor
    fields come from `PARAM_ARRAYS`, configuration (the ``chaos``,
    ``mobility_mode``, ``hi_rule`` and ``differentiable`` flags and the
    HI and relaxation knobs among it) from `PARAM_CONFIG`; ``faults``,
    ``mobility`` and ``hi`` are the reference's models, the port-only
    ``fault_trace`` a list of its per-period draws and ``hi_arm_trace``
    (H, D) EXP3 arm uniforms."""
    dev = resolve_device(device)
    arrays = {k: np.asarray(fields[k]) for k in PARAM_ARRAYS}
    config = {k: fields[k] for k in PARAM_CONFIG if k in fields}
    scenarios = {}
    if fields.get("faults") is not None:
        scenarios["faults"] = fault_model_from_numpy(fields["faults"])
    if fields.get("mobility") is not None:
        scenarios["mobility"] = mobility_from_numpy(fields["mobility"])
    if fields.get("fault_trace") is not None:
        scenarios["fault_trace"] = fault_trace_from_numpy(
            fields["fault_trace"], dev)
    if fields.get("hi") is not None:
        scenarios["hi"] = hi_model_from_numpy(fields["hi"])
    if fields.get("hi_arm_trace") is not None:
        scenarios["hi_arm_trace"] = np.asarray(fields["hi_arm_trace"])
    return params_from_arrays(arrays, dev, **scenarios, **config)


def state_from_numpy(fields: Dict[str, object],
                     device: DeviceLike = None) -> EngineState:
    """The port's `EngineState` from the reference's state fields, the
    mobility leaves (``pos``, ``cell``, ``cell_load``), the ES belief and
    the HI learner (``hi``, a reference `HILearnerState`) included (the
    Poisson key is not carried; the Poisson seed is ``fields["seed"]``, 0
    when absent)."""
    dev = resolve_device(device)
    hi = fields.get("hi")
    return state_from_arrays({"seed": 0, **fields, "hi": None if hi is None
                              else hi_state_from_numpy(hi, dev)}, dev)


def fleet_problem_from_numpy(obj) -> FleetProblem:
    """The port's `FleetProblem` from an object with ``p_ed``, ``p_es``,
    ``acc``, ``T`` and, optionally, ``real_mask`` array fields (a
    reference `FleetProblem` or `InstanceBatch`; every slot real when the
    mask is absent)."""
    p_es = np.asarray(obj.p_es)
    mask = getattr(obj, "real_mask", None)
    return FleetProblem(
        p_ed=np.array(obj.p_ed, np.float64), p_es=np.array(p_es, np.float64),
        acc=np.array(obj.acc, np.float64), T=np.array(obj.T, np.float64),
        real_mask=(np.ones(p_es.shape, bool) if mask is None
                   else np.array(mask, bool)))


def _copy_or_none(a) -> Optional[np.ndarray]:
    return None if a is None else np.array(a)


def device_specs_from_numpy(specs: Sequence) -> List[DeviceSpec]:
    """The port's `DeviceSpec`s from the reference's: each profile's name,
    tables and class labels, the drift and outage schedules, the name."""
    out = []
    for s in specs:
        prof = s.profile
        out.append(DeviceSpec(
            profile=TierProfile(name=prof.name,
                                p_ed=np.array(prof.p_ed, np.float64),
                                p_es=np.array(prof.p_es, np.float64),
                                acc=np.array(prof.acc, np.float64),
                                classes=list(prof.classes)),
            drift=_copy_or_none(s.drift), outage=_copy_or_none(s.outage),
            name=s.name))
    return out


def solution_fields(sol) -> Dict[str, Optional[np.ndarray]]:
    """A `Solution` of either package as NumPy arrays: ``assignment``,
    ``status``, ``solver`` (str array), ``lp_accuracy``, ``n_fractional``
    and ``basis`` (None where the solution has none)."""
    solver = sol.solver
    return {
        "assignment": np.asarray(sol.assignment),
        "status": np.asarray(sol.status),
        "solver": np.asarray([solver] if isinstance(solver, str)
                             else np.atleast_1d(solver)).astype(str),
        "lp_accuracy": _copy_or_none(sol.lp_accuracy),
        "n_fractional": _copy_or_none(sol.n_fractional),
        "basis": _copy_or_none(sol.basis),
    }


# ml_dtypes' types NumPy cannot hand to torch: (their bits, torch's type)
_BY_BITS = {"bfloat16": (np.uint16, torch.bfloat16),
            "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def model_params_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """The port's LM parameters from the reference's `init_params` pytree
    with NumPy leaves: dicts stay dicts (same keys), tuples and lists
    become tuples, each array a tensor of its dtype on ``device``, leaf
    for leaf, so both packages' `forward` compute the same thing."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return tuple(conv(v) for v in x)
        a = np.array(x)
        if a.dtype.name in _BY_BITS:         # ml_dtypes' types: by bits
            bits, dtype = _BY_BITS[a.dtype.name]
            return torch.as_tensor(a.view(bits)).view(dtype).to(dev)
        return torch.as_tensor(a, device=dev)

    return conv(tree)


def cache_from_numpy(cache: Dict[str, Any], cfg,
                     device: DeviceLike = None) -> Dict[str, Any]:
    """The port's generation cache from the reference's (`prefill` or
    `init_cache` output with NumPy leaves): ``blocks`` and ``tail`` leaf
    for leaf as tensors of their dtype on ``device``, ``index`` as a
    Python int, so that the port's `decode_step` continues where the
    reference's `prefill` stopped; a float8 leaf is taken by its bits, an
    encoder-decoder's ``enc_out`` as a tensor.  ``cfg`` (the model's
    `ModelConfig`) checks the layer structure and whether ``enc_out``
    belongs."""
    if cfg.is_encdec != ("enc_out" in cache):
        raise ValueError(f"{cfg.name}: a cache "
                         f"{'without' if cfg.is_encdec else 'with'} "
                         f"enc_out")
    n_cycles, tail = cfg.cycles_and_tail
    blocks = model_params_from_numpy(tuple(cache["blocks"]), device)
    tails = model_params_from_numpy(tuple(cache["tail"]), device)
    if len(blocks) != (len(cfg.pattern) if n_cycles else 0) \
            or len(tails) != tail:
        raise ValueError(f"cache has {len(blocks)} block and {len(tails)} "
                         f"tail entries; {cfg.name} has {n_cycles} cycles "
                         f"of {len(cfg.pattern)} and {tail} tail layers")
    out = {"blocks": blocks, "tail": tails,
           "index": int(np.asarray(cache["index"]))}
    if cfg.is_encdec:
        out["enc_out"] = model_params_from_numpy(cache["enc_out"], device)
    return out
