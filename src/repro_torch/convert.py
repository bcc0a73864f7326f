"""Carry the reference engine's params and state across to the port.

`params_from_numpy` and `state_from_numpy` take the reference's
`EngineParams` / `EngineState` fields, given as NumPy arrays and plain
scalars keyed by the reference's field names, and build the port's
values on ``device``.  The parity tests use them to feed both engines the
same inputs.  Arrivals cross as the replayed trace (``counts`` /
``stream``): `jax.random` streams cannot be redrawn in torch.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ._device import DeviceLike, resolve_device
from .api.engine import (PARAM_ARRAYS, PARAM_CONFIG, EngineParams,
                         EngineState, _not_ported, params_from_arrays,
                         state_from_arrays)

# reference config fields whose non-default value arms a part of the
# engine that is not ported yet
_ARMED = {"chaos": ("chaos", False), "mobility_mode": ("mobility", "off"),
          "hi_rule": ("hi", "off"), "differentiable": ("differentiable",
                                                       False)}


def params_from_numpy(fields: Dict[str, object],
                      device: DeviceLike = None) -> EngineParams:
    """The port's `EngineParams` from the reference's fields.  Tensor
    fields come from `PARAM_ARRAYS`, configuration from `PARAM_CONFIG`;
    the reference's scenario leaves and knobs are ignored as long as
    nothing is armed, and an armed scenario raises."""
    for key, (what, off) in _ARMED.items():
        if key in fields and fields[key] != off:
            raise _not_ported(what)
    arrays = {k: np.asarray(fields[k]) for k in PARAM_ARRAYS}
    config = {k: fields[k] for k in PARAM_CONFIG if k in fields}
    return params_from_arrays(arrays, resolve_device(device), **config)


def state_from_numpy(fields: Dict[str, object],
                     device: DeviceLike = None) -> EngineState:
    """The port's `EngineState` from the reference's state fields (the
    Poisson key, mobility and HI leaves are not carried)."""
    return state_from_arrays(fields, resolve_device(device))
