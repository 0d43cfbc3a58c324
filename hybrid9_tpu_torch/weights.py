"""State, parameters and forcing carried across from the JAX package.

The two packages never import each other.  What one holds reaches the
other as numpy arrays and Python scalars keyed by field name (a dataclass
of the JAX package flattened field by field; a nested dataclass gives a
nested mapping), and :func:`from_reference` builds the port's object of
the same class from them.  The tests that hold the port against the JAX
package hand every input over this way.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from . import state as _state
from .physics.routing import GridKinematicParams, GridRouting
from .physics.snow import SnowParams

_TENSOR_CLASSES = {cls.__name__: cls for cls in (
    _state.ModelState, _state.SoilParams, _state.SoilState,
    _state.VegState, _state.SnowpackState, _state.CarbonState,
    _state.Forcing, _state.AnnualAccumulators)}


def from_reference(kind: str, fields: Mapping, dtype: torch.dtype, device):
    """The port's object of class ``kind`` from the same-named class of
    the JAX package, given as ``fields``: numpy arrays and Python scalars
    by field name.

    ``kind`` is one of the state classes (``ModelState``, ``SoilParams``,
    ``SoilState``, ``VegState``, ``SnowpackState``, ``CarbonState``,
    ``Forcing``, ``AnnualAccumulators``: every array becomes a ``dtype``
    tensor on ``device``), ``SnowParams`` (Python floats),
    ``GridKinematicParams`` (``dir_code`` int32, ``flow_length`` in
    ``dtype``, the scalars as they are) or ``GridRouting`` (``params`` a
    nested ``GridKinematicParams`` mapping, ``flat_idx`` int64; the JAX
    package's ``dense_sharding`` has no counterpart and is ignored).
    """
    if kind in _TENSOR_CLASSES:
        return _TENSOR_CLASSES[kind].from_numpy(fields, dtype, device)
    if kind == "SnowParams":
        return SnowParams(**{k: float(v) for k, v in fields.items()})
    if kind == "GridKinematicParams":
        scalars = {k: float(fields[k])
                   for k in ("c0", "s_ref", "beta", "c_min", "c_max")}
        return GridKinematicParams(
            dir_code=torch.tensor(np.asarray(fields["dir_code"]),
                                  dtype=torch.int32, device=device),
            flow_length=torch.tensor(np.asarray(fields["flow_length"]),
                                     dtype=dtype, device=device),
            n_substeps=int(fields["n_substeps"]), **scalars)
    if kind == "GridRouting":
        return GridRouting(
            params=from_reference("GridKinematicParams", fields["params"],
                                  dtype, device),
            flat_idx=torch.tensor(np.asarray(fields["flat_idx"]),
                                  dtype=torch.int64, device=device),
            n_land=int(fields["n_land"]), ny=int(fields["ny"]),
            nx=int(fields["nx"]))
    raise ValueError(f"from_reference: no class {kind!r} in the port")
