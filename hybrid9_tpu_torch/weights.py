"""State, parameters and forcing carried across from the JAX package.

The two packages never import each other.  What one holds reaches the
other as numpy arrays and Python scalars keyed by field name (a dataclass
of the JAX package flattened field by field; a nested dataclass gives a
nested mapping), and :func:`from_reference` builds the port's object of
the same class from them.  The tests that hold the port against the JAX
package hand every input over this way.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from . import state as _state
from .assimilate import EnKFConfig
from .calibrate import CalibrationSpec
from .physics.lateral import LateralParams
from .physics.routing import (GridKinematicParams, GridMuskingumParams,
                              GridRouting, KinematicParams, MuskingumParams,
                              RoutingParams)
from .physics.snow import SnowParams, TwoLayerSnowParams

_TENSOR_CLASSES = {cls.__name__: cls for cls in (
    _state.ModelState, _state.SoilParams, _state.SoilState,
    _state.VegState, _state.SnowpackState, _state.CarbonState,
    _state.Forcing, _state.AnnualAccumulators)}

_PARAMS_CLASSES = {cls.__name__: cls for cls in (
    SnowParams, TwoLayerSnowParams, RoutingParams, KinematicParams,
    MuskingumParams, GridKinematicParams, GridMuskingumParams,
    LateralParams)}

#: Index fields of the params classes and their dtypes.
_INDEX_DTYPES = dict(downstream=torch.int64, land_flat_idx=torch.int64,
                     dir_code=torch.int32)


def _params(cls, fields: Mapping, device):
    kw = {}
    for f in dataclasses.fields(cls):
        v = np.asarray(fields[f.name])
        if v.ndim == 0:               # a scalar, as its default's type
            kw[f.name] = type(f.default)(v)
        else:
            kw[f.name] = torch.tensor(v, device=device,
                                      dtype=_INDEX_DTYPES.get(f.name))
    return cls(**kw)


def from_reference(kind: str, fields: Mapping, dtype: torch.dtype, device):
    """The port's object of class ``kind`` from the same-named class of
    the JAX package, given as ``fields``: numpy arrays and Python scalars
    by field name.

    ``kind`` is one of the state classes (``ModelState``, ``SoilParams``,
    ``SoilState``, ``VegState``, ``SnowpackState``, ``CarbonState``,
    ``Forcing``, ``AnnualAccumulators``: every array becomes a ``dtype``
    tensor on ``device``); a params class (``SnowParams``,
    ``TwoLayerSnowParams``, ``RoutingParams``, ``KinematicParams``,
    ``MuskingumParams``, ``GridKinematicParams``, ``GridMuskingumParams``,
    ``LateralParams``: index arrays become int64 tensors, ``dir_code``
    int32, every other array keeps its dtype, so that geometry the JAX
    package holds in float32 in a float64 run stays float32 and promotes
    as it does there; scalars become Python numbers of the field's
    default's type); or ``GridRouting`` (``params`` a nested mapping of
    either dense params class, told apart by its ``slope`` field;
    ``flat_idx`` int64; the JAX package's ``dense_sharding`` has no
    counterpart and is ignored); ``EnKFConfig`` and ``CalibrationSpec``
    (their fields, as Python scalars and a tuple of names); or ``theta``,
    log-multipliers by field name (each array a ``dtype`` tensor on
    ``device``), as ``calibrate``, ``ensemble`` and ``assimilate`` take
    them.
    """
    if kind in _TENSOR_CLASSES:
        return _TENSOR_CLASSES[kind].from_numpy(fields, dtype, device)
    if kind in _PARAMS_CLASSES:
        return _params(_PARAMS_CLASSES[kind], fields, device)
    if kind == "GridRouting":
        inner = ("GridMuskingumParams" if "slope" in fields["params"]
                 else "GridKinematicParams")
        return GridRouting(
            params=from_reference(inner, fields["params"], dtype, device),
            flat_idx=torch.tensor(np.asarray(fields["flat_idx"]),
                                  dtype=torch.int64, device=device),
            n_land=int(fields["n_land"]), ny=int(fields["ny"]),
            nx=int(fields["nx"]))
    if kind == "EnKFConfig":
        return EnKFConfig(**{k: float(fields[k]) for k in EnKFConfig._fields})
    if kind == "CalibrationSpec":
        return CalibrationSpec(fields=tuple(fields["fields"]),
                               per_cell=bool(fields["per_cell"]))
    if kind == "theta":
        return {k: torch.tensor(np.asarray(v), dtype=dtype, device=device)
                for k, v in fields.items()}
    raise ValueError(f"from_reference: no class {kind!r} in the port")
