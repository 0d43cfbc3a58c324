"""Time-step composition: substep -> day -> forcing block.

Port of the reference-scope part of ``hybrid9_tpu/step.py``: one model
day is the hydrology day (the CUDA day kernel on CUDA tensors, its plain
twin on CPU; physics/day_kernel.py), then daily growth, then the
soil-heat column; ``block_step`` loops the day over a ``[days, n]``
forcing block and accumulates the annual sums (HYBRID9.f90:93-332).

The flagship extras (snow, frozen soil, soil ice, carbon, routing,
lateral groundwater) and the focus-cell trace are not ported yet; asking
for one raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .physics import constants as c
from .physics.day_kernel import hydrology_day, hydrology_day_plain
from .physics.grow import grow_daily
from .physics.hydrology import Geometry
from .physics.soiltemp import soil_temperature_step
from .state import AnnualAccumulators, Forcing, ModelState, SoilParams

#: The port of the JAX package's ``step._xla_day_substeps``: the plain
#: substep loop lives beside the CUDA kernel it twins.
_plain_day_substeps = hydrology_day_plain


def _not_ported(**extras) -> None:
    """Raise for any flagship extra or mode that is switched on."""
    roadmap = dict(routing="A5.5 (routing)", lateral="A5.6 (lateral)",
                   hydrology_only="A5.6 (vegetation=False)",
                   snow="A5.1 (snow)", snow_albedo="A5.1 (snow albedo)",
                   freeze="A5.2 (frozen-soil impedance)",
                   soil_ice="A5.3 (soil ice, phase_change)",
                   carbon="A5.4 (carbon)",
                   focus_idx="A6 (focus-cell trace, year loop)")
    for name, value in extras.items():
        if value is not None and value is not False:
            raise NotImplementedError(
                f"{name}={value!r} is not ported yet: ROADMAP "
                f"{roadmap[name]}")


def day_step(state: ModelState, forcing: Forcing, params: SoilParams,
             geom: Geometry, dt: float, nisurf: int,
             use_kernel=None, routing=None, lateral=None, snow=None,
             freeze: bool = False, vegetation: bool = True,
             soil_ice: bool = False, zd09_every: int = 1,
             snow_albedo=None, carbon: bool = False, focus_idx=None
             ) -> Tuple[ModelState, Dict[str, torch.Tensor]]:
    """One model day: ``nisurf`` hydrology substeps, daily growth and the
    soil-heat column.  Returns the new state and the daily diagnostics
    (HYBRID9.f90:193-253).  ``use_kernel`` as in ``Config``."""
    _not_ported(routing=routing, lateral=lateral, snow=snow,
                snow_albedo=snow_albedo, freeze=freeze, soil_ice=soil_ice,
                carbon=carbon, focus_idx=focus_idx,
                hydrology_only=not vegetation)
    soil, diags = hydrology_day(state.soil, state.veg, params, forcing,
                                geom, dt, nisurf, zd09_every=zd09_every,
                                use_kernel=use_kernel)
    veg, npp, litterfall, vflux = _grow(state.veg, soil, forcing, geom)
    diags = dict(diags, npp=npp, **vflux)
    river, diags = _route(state.river_store, diags)
    t_soil, soil, ice = _soil_thermal(state, soil, params, forcing, geom)
    cstate, rh, nee, cflux = _carbon(state.carbon, litterfall)
    diags["rh"] = rh
    diags["nee"] = nee
    diags.update(cflux)
    return ModelState(soil=soil, veg=veg, river_store=river,
                      t_soil=t_soil, swe=state.swe, h2osoi_ice=ice,
                      snowpack=state.snowpack, carbon=cstate), diags


def _grow(veg, soil, forcing, geom):
    """Daily vegetation update.  Returns ``(veg, npp, litterfall,
    fluxes)``."""
    return grow_daily(veg, soil.smp, forcing.tas, geom.zi,
                      return_fluxes=True)


def _carbon(carbon_state, litterfall):
    """The disabled soil-carbon cascade: pools unchanged, zero fluxes."""
    z = torch.zeros_like(litterfall)
    return carbon_state, z, z, {}


def _route(river_store, diags):
    """Routing switched off: the store is unchanged, discharge is 0."""
    return river_store, dict(diags, discharge=torch.zeros_like(river_store))


def _soil_thermal(state, soil_new, params, forcing, geom):
    """Daily implicit soil-heat step (the ``soil_ice=False`` branch of
    the JAX package): driven by the SW85 ground heat flux
    G = 0.2 * Rnet * exp(-0.7 * LAI) with the day-start LAI
    (HYDROLOGY.f90:335-339), plus an implicit sensible exchange through
    the aerodynamic resistance raa, with freeze/thaw latent heat in the
    apparent-capacity band.  Returns ``(t_soil, soil, h2osoi_ice)``."""
    lai = state.veg.lai
    tas = forcing.tas
    t2 = tas * tas              # tas ** 4 as JAX's integer_pow forms it
    rnet = 0.92 * forcing.rsds + forcing.rlds - c.STBO * (t2 * t2)
    g_flux = 0.2 * rnet * torch.exp(-0.7 * lai)
    raa = torch.where(lai <= 4.0,
                      0.25 * lai * 42.0 + 0.25 * (4.0 - lai) * 34.0, 42.0)
    rho_air = forcing.ps / (c.RGAS * tas)
    h_surf = rho_air * c.CP_AIR / torch.clamp(raa, min=1.0)
    dz = torch.as_tensor(geom.dz_soil, dtype=soil_new.h2osoi_liq.dtype,
                         device=soil_new.h2osoi_liq.device)
    theta = soil_new.h2osoi_liq / (dz[None, :] * c.RHOW / 1.0e3)
    t_soil = soil_temperature_step(
        state.t_soil, theta, params.theta_s, g_flux, geom.dz_soil,
        geom.zc_soil, c.SDAY, t_air=tas, h_surf=h_surf, latent_ramp=2.0)
    return t_soil, soil_new, state.h2osoi_ice


def _accumulate(acc: AnnualAccumulators, state: ModelState,
                forcing: Forcing, diags: Dict[str, torch.Tensor],
                dz_soil) -> AnnualAccumulators:
    """Daily accumulation into annual sums (HYBRID9.f90:235-253)."""
    h = state.soil.h2osoi_liq
    dz = torch.as_tensor(dz_soil, dtype=h.dtype, device=h.device)
    theta = h / (dz[None, :] * c.RHOW / 1.0e3)
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
    the annual sums.  Returns ``(state, acc)``.  ``extras`` are the
    flagship switches of ``day_step``, which raise until ported."""
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
