"""Time-step composition: substep -> day -> forcing block.

Port of ``hybrid9_tpu/step.py``: one model day is the daily snowpack and
the frozen-soil impedance (from the day-start state), the hydrology day
(the CUDA day kernel on CUDA tensors, its plain twin on CPU;
physics/day_kernel.py), daily growth, routing of the day's runoff, the
soil-heat column with the explicit phase change, and the soil-carbon
cascade; ``block_step`` loops the day over a ``[days, n]`` forcing block
and accumulates the annual sums (HYBRID9.f90:93-332).

Lateral groundwater, the hydrology-only mode, two-layer snow, the
routers other than the dense kinematic one and the focus-cell trace are
not ported yet; asking for one raises ``NotImplementedError`` naming its
ROADMAP item.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from .physics import constants as c
from .physics.carbon import carbon_daily
from .physics.day_kernel import (hydrology_day, hydrology_day_plain,
                                 hydrology_day_sharded)
from .physics.grow import grow_daily
from .physics.hydrology import Geometry
from .physics.routing import GridRouting, route_grid_day
from .physics.snow import SnowParams, snow_step
from .physics.soiltemp import (freeze_impedance, freeze_impedance_from_ice,
                               phase_change, soil_temperature_step)
from .state import AnnualAccumulators, Forcing, ModelState, SoilParams

#: The port of the JAX package's ``step._xla_day_substeps``: the plain
#: substep loop lives beside the CUDA kernel it twins.
_plain_day_substeps = hydrology_day_plain


def snow_absorptivity(swe: torch.Tensor, alpha_snow: float = 0.70,
                      swe_half: float = 10.0) -> torch.Tensor:
    """Per-cell shortwave absorptivity under partial snow cover: the
    bare-ground 0.92 (HYBRID9.f90:168-174's constant) blended with the
    snow absorptivity ``1 - alpha_snow`` by the fractional snow cover
    ``f = swe / (swe + swe_half)``."""
    fsno = swe / (swe + swe_half)
    return 0.92 * (1.0 - fsno) + (1.0 - alpha_snow) * fsno


def waits(what: str, item: str):
    """Raise for ``what``, whose code waits for ROADMAP ``item``."""
    raise NotImplementedError(f"{what} is not ported yet: ROADMAP {item}")


def _not_ported(routing=None, lateral=None, snow=None,
                vegetation: bool = True, focus_idx=None) -> None:
    """Raise for a mode whose code is not ported yet."""
    if routing is not None and not isinstance(routing, GridRouting):
        waits(f"routing={type(routing).__name__} (only GridRouting is)",
              "A5.6 (Muskingum-Cunge and the packed routers)")
    if lateral is not None:
        waits(f"lateral={lateral!r}", "A5.6 (lateral groundwater)")
    if snow is not None and not isinstance(snow, SnowParams):
        waits(f"snow={type(snow).__name__} (only SnowParams is)",
              "A5.6 (two-layer snow)")
    if not vegetation:
        waits("vegetation=False", "A5.6 (hydrology-only mode)")
    if focus_idx is not None:
        waits(f"focus_idx={focus_idx!r}",
              "A6 (focus-cell trace, year loop)")


def day_step(state: ModelState, forcing: Forcing, params: SoilParams,
             geom: Geometry, dt: float, nisurf: int,
             use_kernel=None, routing=None, lateral=None, snow=None,
             freeze: bool = False, vegetation: bool = True,
             soil_ice: bool = False, devices: Optional[Sequence] = None,
             zd09_every: int = 1, snow_albedo=None, carbon: bool = False,
             focus_idx=None
             ) -> Tuple[ModelState, Dict[str, torch.Tensor]]:
    """One model day: ``nisurf`` hydrology substeps, then the daily
    modules.  Returns the new state and the daily diagnostics
    (HYBRID9.f90:193-253).

    ``use_kernel`` as in ``Config``.  ``snow`` (a SnowParams) runs the
    daily snowpack, which reshapes the precipitation input; with it,
    ``snow_albedo = (alpha_snow, swe_half)`` lowers the shortwave
    absorptivity over the day-start pack.  ``freeze`` adds the frozen-soil
    impedance, from the ice store with ``soil_ice`` and from yesterday's
    temperature column without.  ``routing`` (a GridRouting) routes the
    day's runoff.  ``carbon`` runs the soil-carbon cascade.  ``devices``
    (a sequence of ``torch.device``) runs the hydrology day through
    ``hydrology_day_sharded``, one slab of cells per entry.
    """
    _not_ported(routing, lateral, snow, vegetation, focus_idx)
    swe = state.swe
    snow_capped = None
    # Snow-albedo feedback: absorptivity from the day-start pack.
    sw_abs = None
    if snow is not None and snow_albedo is not None:
        sw_abs = snow_absorptivity(state.swe, *snow_albedo)
    if snow is not None:
        swe, pr_eff, _melt, snow_capped = snow_step(swe, forcing.tas,
                                                    forcing.pr, snow)
        forcing = forcing.replace(pr=pr_eff)
    # Frozen-soil impedance, lagged like smp and constant across the
    # day's substeps.
    imp = None
    if freeze:
        if soil_ice:
            imp = freeze_impedance_from_ice(state.soil.h2osoi_liq,
                                            state.h2osoi_ice)
        else:
            imp = freeze_impedance(state.t_soil)

    day_args = (state.soil, state.veg, params, forcing, geom, dt, nisurf)
    day_kw = dict(imp=imp, zd09_every=zd09_every, sw_abs=sw_abs,
                  use_kernel=use_kernel)
    if devices is not None:
        soil, diags = hydrology_day_sharded(*day_args, devices=devices,
                                            **day_kw)
    else:
        soil, diags = hydrology_day(*day_args, **day_kw)
    veg, npp, litterfall, vflux = _grow(state.veg, soil, forcing, geom)
    diags = dict(diags, npp=npp, **vflux)
    if snow_capped is not None:        # capped-pack ice runoff (mm)
        diags["rnf_day"] = diags["rnf_day"] + snow_capped
    river, diags = _route(state.river_store, diags, routing)
    t_soil, soil, ice = _soil_thermal(state, soil, params, forcing, geom,
                                      soil_ice, sw_abs)
    cstate, rh, nee, cflux = _carbon(state.carbon, vflux, litterfall,
                                     t_soil, soil, params, geom, carbon)
    diags["rh"] = rh
    diags["nee"] = nee
    diags.update(cflux)
    return ModelState(soil=soil, veg=veg, river_store=river,
                      t_soil=t_soil, swe=swe, h2osoi_ice=ice,
                      snowpack=state.snowpack, carbon=cstate), diags


def _grow(veg, soil, forcing, geom):
    """Daily vegetation update.  Returns ``(veg, npp, litterfall,
    fluxes)``."""
    return grow_daily(veg, soil.smp, forcing.tas, geom.zi,
                      return_fluxes=True)


def _theta(h2osoi: torch.Tensor, dz_soil) -> torch.Tensor:
    """Volumetric water content ``[n, nl]`` of ``h2osoi`` (mm)."""
    dz = torch.as_tensor(dz_soil, dtype=h2osoi.dtype, device=h2osoi.device)
    return h2osoi / (dz[None, :] * c.RHOW / 1.0e3)


def _carbon(carbon_state, vflux, litterfall, t_soil, soil, params, geom,
            enabled: bool):
    """Daily soil-carbon cascade (physics/carbon.py), or a no-op.  Runs on
    the end-of-day soil temperature and moisture; NEE uses the realized
    plant production of the growth flux record.  Returns ``(carbon', rh,
    nee, fluxes)``."""
    if not enabled:
        z = torch.zeros_like(litterfall)
        return carbon_state, z, z, {}
    return carbon_daily(carbon_state, vflux["v_production"], litterfall,
                        t_soil, _theta(soil.h2osoi_liq, geom.dz_soil),
                        params.theta_s, return_fluxes=True)


def _route(river_store, diags, routing):
    """Daily routing of the day's runoff through the dense kinematic
    router (physics/routing.py); without ``routing`` the store is
    unchanged and discharge is 0."""
    if routing is None:
        return river_store, dict(diags,
                                 discharge=torch.zeros_like(river_store))
    new_store, discharge = route_grid_day(river_store, diags["rnf_day"],
                                          routing)
    return new_store, dict(diags, discharge=discharge)


def _soil_thermal(state, soil_new, params, forcing, geom, soil_ice: bool,
                  sw_abs=None):
    """Daily implicit soil-heat step driven by the SW85 ground heat flux
    G = 0.2 * Rnet * exp(-0.7 * LAI) with the day-start LAI
    (HYDROLOGY.f90:335-339), plus an implicit sensible exchange through
    the aerodynamic resistance raa.

    With ``soil_ice`` the solve runs with plain heat capacity (the
    day-start ice conducts and stores heat too) and the explicit phase
    change exchanges sensible heat for ice mass afterwards; otherwise
    freeze/thaw latent heat is approximated in the solve by the
    apparent-capacity band.  Returns ``(t_soil, soil, h2osoi_ice)``."""
    lai = state.veg.lai
    tas = forcing.tas
    a = 0.92 if sw_abs is None else sw_abs
    t2 = tas * tas              # tas ** 4 as JAX's integer_pow forms it
    rnet = a * forcing.rsds + forcing.rlds - c.STBO * (t2 * t2)
    g_flux = 0.2 * rnet * torch.exp(-0.7 * lai)
    raa = torch.where(lai <= 4.0,
                      0.25 * lai * 42.0 + 0.25 * (4.0 - lai) * 34.0, 42.0)
    rho_air = forcing.ps / (c.RGAS * tas)
    h_surf = rho_air * c.CP_AIR / torch.clamp(raa, min=1.0)
    water = soil_new.h2osoi_liq
    if soil_ice:
        water = water + state.h2osoi_ice
    t_soil = soil_temperature_step(
        state.t_soil, _theta(water, geom.dz_soil), params.theta_s, g_flux,
        geom.dz_soil, geom.zc_soil, c.SDAY, t_air=tas, h_surf=h_surf,
        latent_ramp=0.0 if soil_ice else 2.0)
    if not soil_ice:
        return t_soil, soil_new, state.h2osoi_ice
    t_soil, liq, ice = phase_change(t_soil, soil_new.h2osoi_liq,
                                    state.h2osoi_ice, params.theta_s,
                                    geom.dz_soil)
    return t_soil, soil_new.replace(h2osoi_liq=liq), ice


def _accumulate(acc: AnnualAccumulators, state: ModelState,
                forcing: Forcing, diags: Dict[str, torch.Tensor],
                dz_soil) -> AnnualAccumulators:
    """Daily accumulation into annual sums (HYBRID9.f90:235-253)."""
    h = state.soil.h2osoi_liq
    theta = _theta(h, dz_soil)
    return acc.replace(
        npp_sum=acc.npp_sum + diags["npp"],
        discharge_sum=acc.discharge_sum + diags["discharge"],
        t_surf_sum=acc.t_surf_sum + state.t_soil[:, 0],
        plant_mass_sum=acc.plant_mass_sum + state.veg.plant_mass,
        rnf_sum=acc.rnf_sum + diags["rnf_day"],
        evap_sum=acc.evap_sum + diags["evap_day"],
        tas_sum=acc.tas_sum + forcing.tas,
        rlds_sum=acc.rlds_sum + forcing.rlds,
        rsds_sum=acc.rsds_sum + forcing.rsds,
        huss_sum=acc.huss_sum + forcing.huss,
        ps_sum=acc.ps_sum + forcing.ps,
        pr_sum=acc.pr_sum + forcing.pr,
        rhs_sum=acc.rhs_sum + forcing.rhs,
        theta_sum=acc.theta_sum + theta,
        h2osoi_total_sum=acc.h2osoi_total_sum + torch.sum(h, dim=-1),
        swe_sum=acc.swe_sum + state.swe,
        ice_sum=acc.ice_sum + torch.sum(state.h2osoi_ice, dim=-1),
        rh_sum=acc.rh_sum + diags["rh"],
        nee_sum=acc.nee_sum + diags["nee"],
        c_soil_sum=acc.c_soil_sum + state.carbon.c_litter
        + state.carbon.c_soil_fast + state.carbon.c_soil_slow,
        n_days=acc.n_days + 1.0,
        max_abs_residual=torch.maximum(acc.max_abs_residual,
                                       diags["max_abs_residual"]),
    )


def block_step(state: ModelState, acc: AnnualAccumulators,
               forcing_block: Forcing, params: SoilParams, geom: Geometry,
               dt: float, nisurf: int, use_kernel=None,
               zd09_every: int = 1, **extras
               ) -> Tuple[ModelState, AnnualAccumulators]:
    """Run the day step over a ``[days, n]`` forcing block and accumulate
    the annual sums.  Returns ``(state, acc)``.  ``extras`` are the other
    keyword arguments of ``day_step`` (``Simulation.step_kwargs()``)."""
    for d in range(forcing_block.tas.shape[0]):
        f_day = forcing_block.map(lambda x: x[d])
        state, diags = day_step(state, f_day, params, geom, dt, nisurf,
                                use_kernel=use_kernel,
                                zd09_every=zd09_every, **extras)
        acc = _accumulate(acc, state, f_day, diags, geom.dz_soil)
    return state, acc


def annual_means(acc: AnnualAccumulators, nisurf: int
                 ) -> Dict[str, torch.Tensor]:
    """Finalize annual-mean diagnostics (HYBRID9.f90:263-291): npp is an
    annual sum; rnf and evap are mean mm/s over substeps; state variables
    are daily means."""
    nt = acc.n_days
    return dict(
        npp=acc.npp_sum,
        discharge=acc.discharge_sum,
        t_surface=acc.t_surf_sum / nt,
        plant_mass=acc.plant_mass_sum / nt,
        rnf=acc.rnf_sum / (nt * nisurf * (c.SDAY / nisurf)),
        evap=acc.evap_sum / (nt * nisurf * (c.SDAY / nisurf)),
        tas=acc.tas_sum / nt,
        rlds=acc.rlds_sum / nt,
        rsds=acc.rsds_sum / nt,
        huss=acc.huss_sum / nt,
        ps=acc.ps_sum / nt,
        pr=acc.pr_sum / nt,
        rhs=acc.rhs_sum / nt,
        theta=acc.theta_sum / nt,
        theta_total=acc.h2osoi_total_sum / nt,
        swe=acc.swe_sum / nt,
        soil_ice=acc.ice_sum / nt,
        rh=acc.rh_sum,
        nee=acc.nee_sum,
        c_soil=acc.c_soil_sum / nt,
        max_abs_residual=acc.max_abs_residual,
    )
