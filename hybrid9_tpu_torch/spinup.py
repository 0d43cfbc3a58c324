"""Carbon equilibrium spin-up: the semi-analytic repeat-climate loop.

Port of ``hybrid9_tpu/spinup.py``.  The soil-carbon pools start at fixed
mid-latitude values, so a cold-started run reports a false carbon source
or sink for decades (the slow pool turns over in 100 years).  Every
decomposition flux is linear in its pool for a given modifier series
(physics/carbon.py: ``d_pool = pool * min(k * mod, 1)``), so the periodic
steady state under a repeated climate year follows pool by pool from one
rehearsal year's integrated fluxes:

    pool* = pool_end * (annual input to pool) / (annual output of pool)

in cascade order (litter -> fast -> slow, each target input taken at the
upstream pool's own steady state).  A few rehearsal years iterate out
what remains nonlinear; convergence is checked on the slow pool and
reported with the annual NEE.

A rehearsal year is the run's own day step (``Simulation.days``, with
``Simulation.step_kwargs``: the kernel, snow, routing as configured)
over forcing blocks, with the flux sums as ``[n]`` tensors on the run's
device (one set a slab on device slabs); the host reads the slow pool's
drift, the NEE and the pool means once per rehearsal year.

On one rank's slab of a multi-process run (``sim.sharding``) the drift is
the maximum over every rank's land cells and the means are global sums
over the global land count, so every rank stops after the same rehearsal
year and reports what one process reports.  Here the port departs from
the JAX package, whose hosts each decide from their own slab
(``hybrid9_tpu/spinup.py:221-232``) and can stop after different numbers
of rehearsal years (ROADMAP §C).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from . import calendar
from .physics.carbon import RESP_FAST, TO_FAST, TO_SLOW
from .utils.logging import get_logger

log = get_logger(__name__)

#: The log line of a rehearsal year: (year, of max years, max |d slow|
#: g C/m^2/yr, mean NEE g C/m^2/yr, seconds).
SPINUP_LOG = ("carbon spin-up year %d/%d: max|d slow| %.3g g C/m^2/yr, "
              "mean NEE %.3g, %.3f s")

#: Annual flux below which a pool's in/out ratio is degenerate
#: (g C/m^2/yr).  Pools with no throughput are left as they are; pools
#: that decay without input (deserts, permafrost) jump straight to their
#: steady state of zero.
_FLUX_FLOOR = 1.0e-6

#: Accumulator name -> the day_step diagnostic it integrates.
_DIAG_KEY = dict(
    lit_in="c_lit_in", d_lit="c_d_lit", d_fast="c_d_fast",
    d_slow="c_d_slow", nee="nee", npp="npp",
    grow_pm="v_grow_pm", loss_pm="v_loss_pm",
    grow_fm="v_grow_fm", loss_fm="v_loss_fm")


def _add_day(sums, diags):
    """``sums`` with a day's ``diags`` added (:data:`_DIAG_KEY`)."""
    return {k: sums[k] + diags[_DIAG_KEY[k]] for k in sums}


def _jump(pool, inflow, outflow, damping: float = 1.0):
    """Scale ``pool`` by (in/out)**damping.  damping=1 is the exact
    linear-pool fixed point; damping<1 relaxes in log space pools whose
    jump feeds back on their forcing (vegetation -> LAI -> ET -> soil
    moisture -> growth), where the undamped iteration can settle into a
    period-2 cycle."""
    ok = (outflow > _FLUX_FLOOR) & (inflow > _FLUX_FLOOR)
    dead = (outflow > _FLUX_FLOOR) & ~(inflow > _FLUX_FLOOR)
    ratio = inflow / torch.clamp(outflow, min=_FLUX_FLOOR)
    if damping != 1.0:
        ratio = ratio ** damping
    return torch.where(ok, pool * ratio,
                       torch.where(dead, torch.zeros_like(pool), pool))


def _ratio_update(state, sums, spin_vegetation: bool = True):
    """Jump each pool to its implied periodic steady state.  The cascade
    targets use the steady-state upstream throughput: at equilibrium the
    litter pool turns over exactly its input, so the fast pool's target
    input is ``TO_FAST * lit_in``, and likewise for the slow pool.  With
    ``spin_vegetation`` the plant pools jump too (growth is
    mass-independent, GROW.f90:90-91, and the losses proportional,
    GROW.f90:120-146), damped, with LAI scaled with the foliage pool."""
    carbon = state.carbon
    lit_in = sums["lit_in"]
    fast_in = TO_FAST * lit_in
    slow_in = (TO_SLOW + (1.0 - RESP_FAST) * TO_FAST) * lit_in
    carbon = carbon.replace(
        c_litter=_jump(carbon.c_litter, lit_in, sums["d_lit"]),
        c_soil_fast=_jump(carbon.c_soil_fast, fast_in, sums["d_fast"]),
        c_soil_slow=_jump(carbon.c_soil_slow, slow_in, sums["d_slow"]))
    if not spin_vegetation:
        return state.replace(carbon=carbon)
    veg = state.veg
    foliage = _jump(veg.plant_foliage_mass, sums["grow_fm"],
                    sums["loss_fm"], damping=0.5)
    f_ratio = foliage / torch.clamp(veg.plant_foliage_mass, min=1.0e-12)
    veg = veg.replace(
        plant_mass=_jump(veg.plant_mass, sums["grow_pm"],
                         sums["loss_pm"], damping=0.5),
        plant_foliage_mass=foliage,
        lai=torch.clamp(veg.lai * f_ratio, min=0.001))
    return state.replace(carbon=carbon, veg=veg)


def _max_abs(sim, x: np.ndarray) -> float:
    """max |x| over the land cells of every rank (``x``: this rank's)."""
    local = float(np.max(np.abs(x))) if x.size else 0.0
    if sim.sharding is None:
        return local
    return float(sim.sharding.all_reduce_max(
        torch.tensor(local, dtype=torch.float64), "spinup"))


def _means(sim, rows: np.ndarray) -> list:
    """Each row's mean over the land cells of every rank (``rows``:
    ``[k, this rank's land cells]``)."""
    if sim.sharding is None:
        return [float(np.mean(r)) if r.size else 0.0 for r in rows]
    sums = sim.sharding.all_reduce_sum(
        torch.from_numpy(np.sum(rows, axis=1, dtype=np.float64)), "spinup")
    n_land = sim.n_land if sim.n_land is not None else sim.n_global
    return [float(v) / max(int(n_land), 1) for v in sums]


def spinup_carbon(sim, forcing_provider, year: Optional[int] = None,
                  max_loops: int = 8, tol_slow: float = 1.0,
                  block_days: Optional[int] = None,
                  spin_vegetation: bool = True) -> Dict[str, float]:
    """Equilibrate the carbon pools under a repeated climate year.

    ``sim`` is a ``run.Simulation``, whose state is advanced in place
    with its own physics configuration; ``forcing_provider`` as for
    ``Simulation.run_year``; ``year`` the climate year to repeat
    (``cfg.start_year`` by default); ``max_loops`` the budget of
    rehearsal years; ``tol_slow`` the convergence threshold on the slow
    pool's drift over one rehearsal year, max over land cells, g
    C/m^2/yr; ``spin_vegetation`` also jumps the plant pools (needed for
    the annual NEE to converge to about 0).

    The rehearsal years advance the state where ``sim`` holds it
    (``Simulation.days``): on device slabs (``sim.slabs``) with one set of
    flux sums a slab on its device, each slab jumping its own pools, the
    state neither gathered nor cut, and the slow pool's drift and the NEE
    of a year joined on the first device (``Simulation.join``) for the
    year's one host copy.

    Returns a report: loops used, the final max |d slow| per year, the
    final mean annual NEE (g C/m^2/yr) and the mean pools, over land (of
    every rank, under ``sim.sharding``).
    """
    cfg = sim.cfg
    if not (cfg.carbon and cfg.vegetation):
        raise ValueError("carbon spin-up needs Config.carbon and "
                         "Config.vegetation enabled")
    year = int(year if year is not None else cfg.start_year)
    ndays = calendar.days_in_year(year)
    block_days = block_days or cfg.forcing_block_days
    land = slice(0, sim._local_land_count())

    def joined(parts: list) -> np.ndarray:
        """The slabs' ``[r, n_slab]`` rows joined over this run's cells
        and cut to land, in one host copy."""
        return sim.join(parts)[:, land].cpu().numpy()

    report: Dict[str, float] = {}
    drift = float("inf")
    loops = 0
    for loop in range(max_loops):
        t0 = time.perf_counter()
        slow0 = [st.carbon.c_soil_slow for st in sim.slab_states]
        sums = [{k: torch.zeros_like(s) for k in _DIAG_KEY} for s in slow0]
        doy = 1
        while doy <= ndays:
            nblk = min(block_days, ndays - doy + 1)
            for diags in sim.days(sim.forcing_block(forcing_provider, year,
                                                    doy, nblk)):
                sums = [_add_day(s, dg) for s, dg in zip(sums, diags)]
            doy += nblk
        states = sim.slab_states
        # The drift over the rehearsal year before the jump: how far from
        # periodic the unaccelerated dynamics already are.  One host copy.
        d_slow, nee = joined([torch.stack([st.carbon.c_soil_slow - s0,
                                           sm["nee"]])
                              for st, s0, sm in zip(states, slow0, sums)])
        drift = _max_abs(sim, d_slow)
        mean_nee, = _means(sim, nee[None])
        loops = loop + 1
        sim.slab_states = [_ratio_update(st, sm,
                                         spin_vegetation=spin_vegetation)
                           for st, sm in zip(states, sums)]
        log.info(SPINUP_LOG, loops, max_loops, drift, mean_nee,
                 time.perf_counter() - t0)
        report = dict(loops=loops, max_dslow=drift, mean_nee=mean_nee)
        if drift < tol_slow:
            break
    means = joined([torch.stack([st.carbon.c_litter, st.carbon.c_soil_fast,
                                 st.carbon.c_soil_slow])
                    for st in sim.slab_states])
    for k, v in zip(("mean_litter", "mean_fast", "mean_slow"),
                    _means(sim, means)):
        report[k] = v
    if drift >= tol_slow:
        log.warning("carbon spin-up did not converge in %d years "
                    "(max|d slow| %.3g > %.3g)", loops, drift, tol_slow)
    return report
