"""Parameter ensembles for uncertainty quantification.

Port of ``hybrid9_tpu/ensemble.py``.  A parameter-perturbed ensemble is
"more cells" with per-member parameters: the member axis is folded into
the packed cell axis, so every member of every cell goes through one
day step, and on the card through one launch of the CUDA day kernel a
day, at the folded width.  The reference ran one SLURM job per member and
diffed the output directories by hand (reference notes.txt Nov-Dec 2016).

The fold is CELL-MAJOR: folded index ``j = cell*m + member``, made by
``torch.repeat_interleave(x, m, dim=0)`` (the JAX package's
``jnp.repeat``), with the per-member multipliers tiled by ``v.repeat(n)``
(torch's ``repeat`` is JAX's ``tile``).  Cells are independent in the day,
so each member's trajectory is that of an unfolded run under its own
parameters.  Member 0 is always the control.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from .calibrate import CALIBRATABLE, apply_multipliers
from .parallel.sharding import DeviceSlabs, slab_devices
from .physics import constants as c
from .physics.hydrology import Geometry
from .state import Forcing, ModelState, SoilParams
from .step import day_step
from .utils import profiling


def perturbed_multipliers(generator: torch.Generator,
                          n_members: int,
                          fields: Sequence[str] = ("hksat", "psi_s",
                                                   "bsw"),
                          sigma: float = 0.3,
                          dtype: torch.dtype = torch.float32
                          ) -> Dict[str, torch.Tensor]:
    """Log-normal multiplier ensemble: ``[n_members]`` per field, drawn
    from ``generator`` on its device, one field after another (the JAX
    package drew each field from its own key of ``jax.random``).

    Member 0 is always the unperturbed control (theta = 0), so the control
    trajectory is recoverable from every ensemble run.
    """
    for f in fields:
        if f not in CALIBRATABLE:
            raise ValueError(f"{f} is not calibratable "
                             f"(allowed: {CALIBRATABLE})")
    theta = {}
    for f in fields:
        t = sigma * torch.randn((n_members,), generator=generator,
                                dtype=dtype, device=generator.device)
        t[0] = 0.0
        theta[f] = t
    return theta


class EnsembleResult(NamedTuple):
    """Stacked outputs, member axis leading."""

    evap: torch.Tensor       # [members, days, n] daily ET        (mm/day)
    runoff: torch.Tensor     # [members, days, n] daily runoff    (mm/day)
    npp: torch.Tensor        # [members, days, n] daily NPP  (g DM/plant)
    final_states: ModelState  # member-stacked end states [members, n, ...]


#: The annual totals of :func:`run_ensemble_annual` by the day diagnostic
#: each sums.
_ANNUAL = dict(evap="evap_day", runoff="rnf_day", npp="npp")


def _members(theta: Dict[str, torch.Tensor]) -> int:
    return len(next(iter(theta.values())))


def fold(x: torch.Tensor, m: int) -> torch.Tensor:
    """The cell-major fold of a per-cell tensor: ``[n, ...]`` ->
    ``[n*m, ...]`` with row ``cell*m + member`` a copy of row ``cell``."""
    return torch.repeat_interleave(x, m, dim=0)


def unfold(x: torch.Tensor, m: int) -> torch.Tensor:
    """The inverse view of :func:`fold`: ``[n*m, ...]`` -> ``[m, n, ...]``."""
    return x.reshape(x.shape[0] // m, m, *x.shape[1:]).transpose(0, 1)


def _fold_problem(theta, params, state0, m):
    """Folded params (multipliers applied, member ``j % m``'s to cell
    ``j``) and folded state."""
    n = state0.veg.lai.shape[0]
    params_m = apply_multipliers(
        params.map(lambda x: fold(x, m)),
        {f: v.repeat(n) for f, v in theta.items()})
    return params_m, state0.map(lambda x: fold(x, m))


def run_ensemble(theta: Dict[str, torch.Tensor],
                 params: SoilParams,
                 state0: ModelState,
                 forcing_days: Forcing,
                 geom: Geometry,
                 nisurf: int = c.NISURF_DEFAULT,
                 vegetation: bool = True,
                 use_kernel=None,
                 zd09_every: int = 1) -> EnsembleResult:
    """Integrate all members of a parameter ensemble and keep the dailies.

    ``theta``: per-field ``[n_members]`` log-multipliers (e.g. from
    :func:`perturbed_multipliers`).  All members share ``state0`` and the
    forcing.  The JAX package vmapped the members; here they are folded
    into the cell axis and the outputs unfolded to ``[members, days, n]``.
    ``use_kernel`` as in ``step.day_step`` (the kernel on CUDA tensors).
    """
    dt = c.SDAY / nisurf
    m = _members(theta)
    params_m, state = _fold_problem(theta, params, state0, m)
    evap, rnf, npp = [], [], []
    for d in range(forcing_days.tas.shape[0]):
        f_m = forcing_days.map(lambda x: fold(x[d], m))
        state, diags = day_step(state, f_m, params_m, geom, dt, nisurf,
                                use_kernel=use_kernel,
                                zd09_every=zd09_every, vegetation=vegetation)
        evap.append(unfold(diags["evap_day"], m))
        rnf.append(unfold(diags["rnf_day"], m))
        npp.append(unfold(diags["npp"], m))
    return EnsembleResult(
        evap=torch.stack(evap, dim=1), runoff=torch.stack(rnf, dim=1),
        npp=torch.stack(npp, dim=1),
        final_states=state.map(lambda x: unfold(x, m)))


def ensemble_spread(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, std) over the member axis of a stacked diagnostic; the std
    divides by the number of members, as ``jnp.std`` does."""
    return torch.mean(x, dim=0), torch.std(x, dim=0, correction=0)


@profiling.spanned("ensemble.run")
def run_ensemble_annual(theta: Dict[str, torch.Tensor],
                        params: SoilParams,
                        state0: ModelState,
                        forcing_days: Forcing,
                        geom: Geometry,
                        nisurf: int = c.NISURF_DEFAULT,
                        vegetation: bool = True,
                        use_kernel=None,
                        zd09_every: int = 1,
                        sharding=None,
                        devices: Optional[Sequence] = None
                        ) -> Dict[str, torch.Tensor]:
    """Ensemble with annual totals only: memory O(members x cells).

    The production-scale form of :func:`run_ensemble`: the day loop
    carries running sums instead of stacking ``[members, days, n]``
    dailies, and the members ride the folded cell axis, so on CUDA tensors
    each day is one launch of the day kernel at ``members x cells``.  The
    forcing is folded one day at a time inside the loop, so the device
    holds one ``[days, n]`` block whatever the ensemble size.  With
    ``sharding`` (one rank of a multi-process run) the inputs are cut to
    the rank's slab (a slab given passes through) and the members fold
    within it: every operation of the day is per cell, so nothing crosses
    the ranks.

    With ``devices`` (a device may repeat), or a ``sharding`` whose rank
    holds several devices, the cells are cut once into device slabs
    (``parallel.sharding.DeviceSlabs``) before the fold and each slab is
    folded on its own device, so a cell's members never straddle two
    slabs: each day is one day step a slab (on the card one kernel launch
    a slab), nothing crosses the slabs, and the totals are joined on the
    first device once, at the end.

    Returns ``{"evap", "runoff", "npp"}`` as ``[members, n]`` totals
    (mm and g DM).  The call is the root span ``ensemble.run``.
    """
    if sharding is not None:
        params, state0 = sharding.put(params), sharding.put(state0)
        forcing_days = sharding.put_block(forcing_days)
    devices = slab_devices(sharding, devices)
    dt = c.SDAY / nisurf
    m = _members(theta)
    n = state0.veg.lai.shape[0]
    if devices is None:
        slabs, parts = None, [(params, state0, forcing_days)]
    else:
        slabs = DeviceSlabs.create(n, devices)
        parts = list(zip(slabs.put(params), slabs.put(state0),
                         slabs.put_block(forcing_days)))
    folded = [_fold_problem({k: v.to(s.veg.lai.device)
                             for k, v in theta.items()}, p, s, m)
              for p, s, _ in parts]
    sums = _run_annual_folded([s for _, s in folded],
                              [f for _, _, f in parts],
                              [p for p, _ in folded], geom, dt, m, nisurf,
                              vegetation, use_kernel, zd09_every)
    # [n*m] -> [n, m] -> the [m, n] contract.
    sums = [{k: v.reshape(-1, m) for k, v in s.items()} for s in sums]
    out = sums[0] if slabs is None else slabs.gather(sums, "result")
    return {k: v.T for k, v in out.items()}


def _run_annual_folded(states, forcings, params, geom, dt, m, nisurf,
                       vegetation, use_kernel, zd09_every):
    """The folded day loop of :func:`run_ensemble_annual` over slabs
    (a list each; the whole problem is one slab): each day, each slab's
    ``[n_slab]`` forcing folded to ``[n_slab*m]``, one day step, the
    slab's sums, one span ``ensemble.day``.  Returns each slab's
    ``{"evap", "runoff", "npp"}`` sums over the folded axis, on its
    device."""
    sums = [dict.fromkeys(_ANNUAL, torch.zeros_like(s.veg.lai))
            for s in states]
    for d in range(forcings[0].tas.shape[0]):
        for i, (f, p) in enumerate(zip(forcings, params)):
            with profiling.span("ensemble.day"):
                f_m = f.map(lambda x: fold(x[d], m))
                states[i], diags = day_step(states[i], f_m, p, geom, dt,
                                            nisurf, use_kernel=use_kernel,
                                            zd09_every=zd09_every,
                                            vegetation=vegetation)
                sums[i] = {k: v + diags[_ANNUAL[k]]
                           for k, v in sums[i].items()}
    return sums
