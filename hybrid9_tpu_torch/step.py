"""Time-step composition: substep -> day -> forcing block.

Port of ``hybrid9_tpu/step.py``: one model day is the daily snowpack and
the frozen-soil impedance (from the day-start state), the hydrology day
(the CUDA day kernel on CUDA tensors, its plain twin on CPU;
physics/day_kernel.py), daily growth, routing of the day's runoff, the
soil-heat column with the explicit phase change, and the soil-carbon
cascade; ``block_step`` loops the day over a ``[days, n]`` forcing block
and accumulates the annual sums (HYBRID9.f90:93-332), and with a focus
cell stacks that cell's daily diagnostic row (INTERACTIVE mode).

The switches of ``Config`` choose the snow scheme (degree-day or two
layers), the router (dispatched on its params type), the lateral
groundwater exchange after routing and the hydrology-only mode
(``vegetation=False``: no growth, no carbon).  On one rank's slab of a
multi-process run the router and the lateral exchange come wrapped in
``parallel.sharding.Gathered``: their operands are gathered from every
rank and the global function runs on them.

A day is three parts: the cell-local modules before routing (snow,
impedance, the hydrology day, growth), the cross-cell modules (the router,
lateral groundwater) and the cell-local modules after them (soil heat and
ice, carbon); the accumulation follows.  On device slabs
(``slab_day_step``, ``slab_block_step``) the cell-local parts run slab by
slab on the slabs' devices and the cross-cell part exchanges only what
it must: halo rows and reshards of the row bands, or a gather a day.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from .parallel.sharding import DeviceSlabs, Gathered
from .physics import bounds
from .physics import constants as c
from .physics.carbon import carbon_daily
from .physics.day_kernel import (hydrology_day, hydrology_day_plain,
                                 hydrology_day_sharded)
from .physics.grow import grow_daily
from .physics.hydrology import Geometry
from .physics.lateral import (LateralParams, lateral_groundwater_step,
                              lateral_groundwater_step_split)
from .physics.routing import (GridRouting, KinematicParams,
                              MuskingumParams, RoutingParams, route_daily,
                              route_grid_day, route_grid_day_split,
                              route_kinematic_day, route_muskingum_day)
from .physics.snow import (SnowParams, TwoLayerSnowParams, snow_step,
                           snow_step_two_layer)
from .physics.soil_heat import soil_heat, volumetric_water
from .physics.soiltemp import freeze_impedance, freeze_impedance_from_ice
from .state import AnnualAccumulators, Forcing, ModelState, SoilParams
from .utils import profiling

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


@profiling.spanned("day")
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

    ``use_kernel`` as in ``Config``.  ``snow`` (a SnowParams or a
    TwoLayerSnowParams) runs the daily snowpack, which reshapes the
    precipitation input; with it, ``snow_albedo = (alpha_snow,
    swe_half)`` lowers the shortwave absorptivity over the day-start
    pack.  ``freeze`` adds the frozen-soil impedance, from the ice store
    with ``soil_ice`` and from yesterday's temperature column without.
    ``routing`` (GridRouting, RoutingParams, KinematicParams or
    MuskingumParams) routes the day's runoff, and ``lateral`` (a
    LateralParams) then exchanges aquifer water between cells.
    ``vegetation=False`` keeps the vegetation as it is.  ``carbon`` runs
    the soil-carbon cascade.  ``devices``
    (a sequence of ``torch.device``) runs the hydrology day through
    ``hydrology_day_sharded``, one slab of cells per entry.  With
    ``focus_idx`` the diagnostics carry ``wt_substeps``, that cell's
    ``[nisurf]`` water table after each substep, written by the day
    kernel itself (the JAX package ran a one-cell shadow of the day for
    it).
    """
    mid = _before_routing(state, forcing, params, geom, dt, nisurf,
                          use_kernel=use_kernel, snow=snow, freeze=freeze,
                          vegetation=vegetation, soil_ice=soil_ice,
                          devices=devices, zd09_every=zd09_every,
                          snow_albedo=snow_albedo, focus_idx=focus_idx)
    river, diags = _route(state.river_store, mid.diags, routing)
    soil = _lateral(mid.soil, lateral)
    return _after_routing(state, mid, river, soil, diags, params, geom,
                          soil_ice, carbon, use_kernel)


class _Midday(NamedTuple):
    """What the cell-local part of a day before routing leaves for the
    rest of it: the forcing as the snowpack reshaped it, the snow state,
    the absorptivity, the soil after the hydrology day, the grown
    vegetation, the day's diagnostics so far and the litterfall and
    growth fluxes the carbon cascade reads."""

    forcing: Forcing
    swe: torch.Tensor
    snowpack: object
    sw_abs: Optional[torch.Tensor]
    soil: object
    veg: object
    diags: Dict[str, torch.Tensor]
    litterfall: torch.Tensor
    vflux: Dict[str, torch.Tensor]


def _before_routing(state, forcing, params, geom, dt, nisurf,
                    use_kernel=None, snow=None, freeze: bool = False,
                    vegetation: bool = True, soil_ice: bool = False,
                    devices=None, zd09_every: int = 1, snow_albedo=None,
                    focus_idx=None) -> _Midday:
    """The cell-local part of a day before routing: the snowpack, the
    frozen-soil impedance, the hydrology day and growth (``day_step``'s
    keywords and defaults).  Each part that runs is a span:
    ``day.snow``, ``day.impedance``, ``day.hydrology`` (which the day
    kernel's launch annotates: ``profiling.annotate``) and
    ``day.grow``."""
    swe = state.swe
    snowpack = state.snowpack
    snow_capped = None
    sw_abs = None
    if snow is not None:
        with profiling.span("day.snow", device=swe):
            # Snow-albedo feedback: absorptivity from the day-start pack.
            if snow_albedo is not None:
                sw_abs = snow_absorptivity(state.swe, *snow_albedo)
            if isinstance(snow, TwoLayerSnowParams):
                snowpack, pr_eff, snow_capped = _two_layer_snow(
                    swe, snowpack, forcing, snow)
                swe = snowpack.swe_surf + snowpack.swe_base + snowpack.w_liq
            elif isinstance(snow, SnowParams):
                swe, pr_eff, _melt, snow_capped = snow_step(
                    swe, forcing.tas, forcing.pr, snow)
            else:
                raise TypeError(f"no snow scheme for {type(snow).__name__}")
            forcing = forcing.replace(pr=pr_eff)
    # Frozen-soil impedance, lagged like smp and constant across the
    # day's substeps.
    imp = None
    if freeze:
        with profiling.span("day.impedance", device=state.t_soil):
            if soil_ice:
                imp = freeze_impedance_from_ice(state.soil.h2osoi_liq,
                                                state.h2osoi_ice)
            else:
                imp = freeze_impedance(state.t_soil)

    day_args = (state.soil, state.veg, params, forcing, geom, dt, nisurf)
    day_kw = dict(imp=imp, zd09_every=zd09_every, sw_abs=sw_abs,
                  use_kernel=use_kernel, focus_idx=focus_idx)
    with profiling.span("day.hydrology", device=state.soil.h2osoi_liq):
        if devices is not None:
            soil, diags = hydrology_day_sharded(*day_args, devices=devices,
                                                **day_kw)
        else:
            soil, diags = hydrology_day(*day_args, **day_kw)
    veg, npp, litterfall, vflux = _grow(state.veg, soil, forcing, geom,
                                        vegetation)
    diags = dict(diags, npp=npp, **vflux)
    if snow_capped is not None:        # capped-pack ice runoff (mm)
        diags["rnf_day"] = diags["rnf_day"] + snow_capped
    return _Midday(forcing, swe, snowpack, sw_abs, soil, veg, diags,
                   litterfall, vflux)


def _after_routing(state, mid: _Midday, river, soil, diags, params, geom,
                   soil_ice: bool, carbon: bool, use_kernel=None):
    """The cell-local part of a day after routing and the lateral
    exchange: soil heat and ice (span ``day.soil_heat``, which names the
    soil-heat kernel's build or ``plain``), and the carbon cascade
    (``day.carbon``).  ``use_kernel`` as in ``day_step``.  Returns the
    day's ``(state, diags)``."""
    with profiling.span("day.soil_heat", device=state.t_soil):
        t_soil, soil, ice = _soil_thermal(state, soil, params, mid.forcing,
                                          geom, soil_ice, mid.sw_abs,
                                          use_kernel)
    cstate, rh, nee, cflux = _carbon(state.carbon, mid.vflux,
                                     mid.litterfall, t_soil, soil, params,
                                     geom, carbon)
    diags["rh"] = rh
    diags["nee"] = nee
    diags.update(cflux)
    return ModelState(soil=soil, veg=mid.veg, river_store=river,
                      t_soil=t_soil, swe=mid.swe, h2osoi_ice=ice,
                      snowpack=mid.snowpack, carbon=cstate), diags


def _two_layer_snow(swe, snowpack, forcing, snow):
    """The two-layer snowpack's day.  ``swe`` is the water store across
    scheme switches (the pack total while this scheme runs): the pack is
    first scaled to it, so a degree-day checkpoint resumed under
    "twolayer" banks its SWE in the base layer and a ``swe`` that shrank
    cannot bring back stale pack water; when the scheme ran yesterday
    this changes nothing.  Returns ``(pack, pr_eff, capped_mm)``."""
    total = snowpack.swe_surf + snowpack.swe_base + snowpack.w_liq
    scale = torch.where(total > 0.0,
                        swe / bounds.maximum(total, 1.0e-12), 0.0)
    snowpack = snowpack.replace(
        swe_surf=snowpack.swe_surf * scale,
        swe_base=snowpack.swe_base * scale
        + torch.where(total > 0.0, 0.0, swe),
        w_liq=snowpack.w_liq * scale)
    snowpack, pr_eff, _melt, capped = snow_step_two_layer(
        snowpack, forcing.tas, forcing.pr, snow)
    return snowpack, pr_eff, capped


def _grow(veg, soil, forcing, geom, vegetation: bool):
    """Daily vegetation update, or in hydrology-only mode (BASELINE.json
    config 2) none: LAI and roots keep their initial values, npp and
    litterfall are 0 and the flux dict is empty.  Returns ``(veg, npp,
    litterfall, fluxes)``."""
    if vegetation:
        with profiling.span("day.grow", device=veg.lai):
            return grow_daily(veg, soil.smp, forcing.tas, geom.zi,
                              return_fluxes=True)
    z = torch.zeros_like(veg.lai)
    return veg, z, z, {}


def _carbon(carbon_state, vflux, litterfall, t_soil, soil, params, geom,
            enabled: bool):
    """Daily soil-carbon cascade (physics/carbon.py), or a no-op.  Runs on
    the end-of-day soil temperature and moisture; NEE uses the realized
    plant production of the growth flux record.  Returns ``(carbon', rh,
    nee, fluxes)``."""
    if not enabled:
        z = torch.zeros_like(litterfall)
        return carbon_state, z, z, {}
    with profiling.span("day.carbon", device=litterfall):
        production = (vflux["v_production"] if vflux
                      else torch.zeros_like(litterfall))
        return carbon_daily(carbon_state, production, litterfall, t_soil,
                            volumetric_water(soil.h2osoi_liq,
                                             geom.dz_soil),
                            params.theta_s, return_fluxes=True)


#: The router of each routing params type (physics/routing.py).
_ROUTERS = {GridRouting: route_grid_day, MuskingumParams: route_muskingum_day,
            KinematicParams: route_kinematic_day, RoutingParams: route_daily}


def _route(river_store, diags, routing):
    """Daily routing of the day's runoff by the router of ``routing``'s
    type; without ``routing`` the store is unchanged and discharge is 0.
    On one rank's slab (``routing`` a ``Gathered``) the runoff and the
    store are gathered from every rank, routed over the whole network and
    cut back to the slab.  A span ``day.route`` where a router runs."""
    if routing is None:
        store, discharge = _routed(river_store, diags["rnf_day"], routing)
    else:
        with profiling.span("day.route", device=river_store):
            store, discharge = _routed(river_store, diags["rnf_day"],
                                       routing)
    return store, dict(diags, discharge=discharge)


def _routed(store, rnf, routing):
    """``(new_store, discharge)`` of :func:`_route`."""
    if routing is None:
        return store, torch.zeros_like(store)
    sharding = None
    if isinstance(routing, Gathered):
        routing, sharding = routing.params, routing.sharding
    route = _ROUTERS.get(type(routing))
    if route is None:
        raise TypeError(f"no router for {type(routing).__name__}")
    if sharding is None:
        return route(store, rnf, routing)
    rnf, whole = sharding.all_gather_cells(torch.stack([rnf, store]),
                                           "routing")
    new_store, discharge = route(whole, rnf, routing)
    return sharding.local(new_store), sharding.local(discharge)


def _lateral(soil, lateral):
    """Daily groundwater exchange between cells (physics/lateral.py),
    applied to the aquifer store; on one rank's slab (a ``Gathered``)
    over the gathered ``wa`` and ``zwt`` of every rank.  A span
    ``day.lateral`` where the exchange runs."""
    if lateral is None:
        return soil
    with profiling.span("day.lateral", device=soil.wa):
        return soil.replace(wa=_exchanged(soil.wa, soil.zwt, lateral))


def _exchanged(wa, zwt, lateral):
    """The aquifer store after :func:`_lateral`'s exchange."""
    sharding = None
    if isinstance(lateral, Gathered):
        lateral, sharding = lateral.params, lateral.sharding
    if not isinstance(lateral, LateralParams):
        raise TypeError(f"no lateral exchange for {type(lateral).__name__}")
    if sharding is None:
        return lateral_groundwater_step(wa, zwt, lateral)[0]
    wa, zwt = sharding.all_gather_cells(torch.stack([wa, zwt]), "lateral")
    return sharding.local(lateral_groundwater_step(wa, zwt, lateral)[0])


def _in_one_process(module):
    """A cross-cell module's params for device slabs: a ``Gathered`` of a
    one-rank run (whose exchange moves nothing) is the params it wraps."""
    if isinstance(module, Gathered) and module.sharding.world == 1:
        return module.params
    return module


def _route_slabs(slabs: DeviceSlabs, stores, rnfs, routing):
    """:func:`_routed` on device slabs: the slabs' ``(new_store,
    discharge)`` lists.  A dense router runs split into row bands
    (``route_grid_day_split``); a packed router, or a rank's
    ``Gathered``, gathers its operands onto the first device once a day
    (one "gather"), runs the global function and cuts the result back.
    One slab runs the global function itself.  A span ``day.route``
    (device events on the first slab's device) where a router runs."""
    routing = _in_one_process(routing)
    if routing is None:
        return stores, [torch.zeros_like(s) for s in stores]
    with profiling.span("day.route", device=stores[0]):
        if slabs.k == 1:
            new, discharge = _routed(stores[0], rnfs[0], routing)
            return [new], [discharge]
        if isinstance(routing, GridRouting):
            return route_grid_day_split(stores, rnfs, routing.split(slabs))
        whole = slabs.gather([dict(store=s, rnf=r) for s, r in
                              zip(stores, rnfs)], "gather")
        new, discharge = _routed(whole["store"], whole["rnf"], routing)
        return slabs.put(new), slabs.put(discharge)


def _lateral_slabs(slabs: DeviceSlabs, soils, lateral):
    """:func:`_lateral` on device slabs: lateral groundwater split into
    row bands (``lateral_groundwater_step_split``), or for a rank's
    ``Gathered`` over the operands gathered onto the first device.  A
    span ``day.lateral`` (device events on the first slab's device) where
    the exchange runs."""
    lateral = _in_one_process(lateral)
    if lateral is None:
        return soils
    if slabs.k == 1:
        return [_lateral(soils[0], lateral)]
    with profiling.span("day.lateral", device=soils[0].wa):
        if isinstance(lateral, LateralParams):
            wa, _ = lateral_groundwater_step_split(
                [s.wa for s in soils], [s.zwt for s in soils],
                lateral.split(slabs))
        else:
            whole = slabs.gather([dict(wa=s.wa, zwt=s.zwt) for s in soils],
                                 "gather")
            wa = slabs.put(_exchanged(whole["wa"], whole["zwt"], lateral))
    return [s.replace(wa=w) for s, w in zip(soils, wa)]


def _soil_thermal(state, soil_new, params, forcing, geom, soil_ice: bool,
                  sw_abs=None, use_kernel=None):
    """Daily implicit soil-heat step driven by the SW85 ground heat flux
    G = 0.2 * Rnet * exp(-0.7 * LAI) with the day-start LAI
    (HYDROLOGY.f90:335-339), plus an implicit sensible exchange through
    the aerodynamic resistance raa (``physics/soil_heat.py``: one launch
    of the soil-heat kernel on CUDA tensors, its plain twin on CPU
    tensors or with ``use_kernel=False``).

    With ``soil_ice`` the solve runs with plain heat capacity (the
    day-start ice conducts and stores heat too) and the explicit phase
    change exchanges sensible heat for ice mass afterwards; otherwise
    freeze/thaw latent heat is approximated in the solve by the
    apparent-capacity band.  Returns ``(t_soil, soil, h2osoi_ice)``."""
    t_soil, liq, ice = soil_heat(
        state.t_soil, soil_new.h2osoi_liq, state.h2osoi_ice, params.theta_s,
        state.veg.lai, forcing, geom, c.SDAY, soil_ice,
        0.0 if soil_ice else 2.0, sw_abs=sw_abs, use_kernel=use_kernel)
    if not soil_ice:
        return t_soil, soil_new, ice
    return t_soil, soil_new.replace(h2osoi_liq=liq), ice


def _accumulate(acc: AnnualAccumulators, state: ModelState,
                forcing: Forcing, diags: Dict[str, torch.Tensor],
                dz_soil) -> AnnualAccumulators:
    """Daily accumulation into annual sums (HYBRID9.f90:235-253)."""
    h = state.soil.h2osoi_liq
    theta = volumetric_water(h, dz_soil)
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


def _focus_row(state: ModelState, forcing: Forcing,
               diags: Dict[str, torch.Tensor], dz_soil,
               idx: int) -> Dict[str, torch.Tensor]:
    """Daily diagnostic scalars of one focus cell, the analog of the
    reference's INTERACTIVE per-day CSV line (HYBRID9.f90:221-229, header
    INIT.f90:887-891) and water-table trace (HYDROLOGY.f90:509): 0-d
    tensors on the run's device (``wt_substeps`` is ``[nisurf]``)."""
    dz_sum = float(sum(dz_soil))
    h_tot = torch.sum(state.soil.h2osoi_liq[idx])
    return dict(
        wt_substeps=diags["wt_substeps"],
        tas=forcing.tas[idx], pr=forcing.pr[idx], rsds=forcing.rsds[idx],
        evap=diags["evap_day"][idx], evap_grnd=diags["evap_grnd_day"][idx],
        rnf=diags["rnf_day"][idx], discharge=diags["discharge"][idx],
        npp=diags["npp"][idx], rh=diags["rh"][idx],
        nee=diags["nee"][idx], zwt=state.soil.zwt[idx],
        wa=state.soil.wa[idx], lai=state.veg.lai[idx],
        plant_mass=state.veg.plant_mass[idx],
        theta_mean=h_tot / (dz_sum * c.RHOW / 1.0e3),
        t_surf=state.t_soil[idx, 0],
        swe=state.swe[idx],
        residual=diags["max_abs_residual"][idx],
    )


def block_step(state: ModelState, acc: AnnualAccumulators,
               forcing_block: Forcing, params: SoilParams, geom: Geometry,
               dt: float, nisurf: int, use_kernel=None,
               zd09_every: int = 1, focus_idx: Optional[int] = None,
               devices: Optional[Sequence] = None, **extras):
    """Run the day step over a ``[days, n]`` forcing block and accumulate
    the annual sums.  Returns ``(state, acc)``, and with ``focus_idx`` a
    third element: the focus cell's rows (:func:`_focus_row`) stacked
    over the block's days, on the run's device.  ``extras`` are the other
    keyword arguments of ``day_step`` (``Simulation.step_kwargs()``).

    With ``devices`` the block runs on device slabs
    (:func:`slab_block_step`): the cells are cut once into one slab a
    device, stay there for the block's days, and the state and sums are
    gathered back onto the device of ``state`` at its end (with one
    device and the inputs already there, nothing is copied)."""
    if devices is not None:
        slabs = DeviceSlabs.create(state.soil.h2osoi_liq.shape[0], devices)
        home = state.soil.h2osoi_liq.device
        out = slab_block_step(
            slabs, slabs.put(state), slabs.put(acc),
            slabs.put_block(forcing_block), slabs.put(params), geom, dt,
            nisurf, use_kernel=use_kernel, zd09_every=zd09_every,
            focus_idx=focus_idx, **extras)
        return (slabs.gather(out[0], "state", home),
                slabs.gather(out[1], "state", home)) + tuple(out[2:])
    rows = []
    for d in range(forcing_block.tas.shape[0]):
        f_day = forcing_block.map(lambda x: x[d])
        state, diags = day_step(state, f_day, params, geom, dt, nisurf,
                                use_kernel=use_kernel,
                                zd09_every=zd09_every, focus_idx=focus_idx,
                                **extras)
        acc = _accumulate(acc, state, f_day, diags, geom.dz_soil)
        if focus_idx is not None:
            rows.append(_focus_row(state, f_day, diags, geom.dz_soil,
                                   focus_idx))
    if focus_idx is None:
        return state, acc
    return state, acc, _stack_rows(rows)


def _stack_rows(rows):
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


@profiling.spanned("day")
def slab_day_step(slabs: DeviceSlabs, states: list, forcings: list,
                  params: list, geom: Geometry, dt: float, nisurf: int,
                  routing=None, lateral=None, soil_ice: bool = False,
                  carbon: bool = False, focus_idx: Optional[int] = None,
                  **cell) -> Tuple[list, list]:
    """:func:`day_step` on device slabs, bitwise its result on the card:
    ``states``, ``forcings`` and ``params`` hold one tree a slab of
    ``slabs``, each on its device.  The cell-local parts of the day run
    slab by slab on the slabs' devices (the hydrology day is one kernel
    launch a slab), every slab's launches of a part issued before the
    next part and none waiting on the host; the router and lateral
    groundwater exchange only what they must (``_route_slabs``,
    ``_lateral_slabs``).  ``focus_idx`` (of the slabs' cells) goes, at its
    local index, to the slab that holds it.  ``cell`` are ``day_step``'s
    other keywords (``devices`` is ignored: the slabs are the devices).
    Returns the slabs' ``(states, diags)`` lists.  The day is one span
    ``day``, each slab's parts spans of their own."""
    cell.pop("devices", None)
    mids = [_before_routing(st, f, p, geom, dt, nisurf, devices=None,
                            soil_ice=soil_ice,
                            focus_idx=_local_focus(slabs, focus_idx, i),
                            **cell)
            for i, (st, f, p) in enumerate(zip(states, forcings, params))]
    rivers, discharges = _route_slabs(
        slabs, [st.river_store for st in states],
        [m.diags["rnf_day"] for m in mids], routing)
    soils = _lateral_slabs(slabs, [m.soil for m in mids], lateral)
    out = [_after_routing(st, m, river, soil,
                          dict(m.diags, discharge=dis), p, geom, soil_ice,
                          carbon, cell.get("use_kernel"))
           for st, m, river, soil, dis, p in zip(states, mids, rivers, soils,
                                                 discharges, params)]
    return [o[0] for o in out], [o[1] for o in out]


def _local_focus(slabs: DeviceSlabs, focus_idx, i):
    """``focus_idx`` local to slab ``i``, or None where another slab
    holds it."""
    lo, hi = slabs.bounds[i]
    if focus_idx is not None and lo <= focus_idx < hi:
        return focus_idx - lo
    return None


def slab_block_step(slabs: DeviceSlabs, states: list, accs: list,
                    blocks: list, params: list, geom: Geometry, dt: float,
                    nisurf: int, use_kernel=None, zd09_every: int = 1,
                    focus_idx: Optional[int] = None, **extras):
    """:func:`block_step` on device slabs (:func:`slab_day_step` a day):
    ``states``, ``accs``, ``blocks`` (``[days, n_slab]``) and ``params``
    hold one tree a slab, each on its device, and so do the results.
    Nothing is gathered: the state and the annual sums stay on the slabs'
    devices from day to day.  Returns ``(states, accs)`` and with
    ``focus_idx`` the focus cell's stacked rows, from its slab."""
    rows = []
    for d in range(blocks[0].tas.shape[0]):
        f_days = [b.map(lambda x: x[d]) for b in blocks]
        states, diags = slab_day_step(
            slabs, states, f_days, params, geom, dt, nisurf,
            use_kernel=use_kernel, zd09_every=zd09_every,
            focus_idx=focus_idx, **extras)
        accs = [_accumulate(a, st, f, dg, geom.dz_soil)
                for a, st, f, dg in zip(accs, states, f_days, diags)]
        if focus_idx is not None:
            i = next(i for i in range(slabs.k)
                     if _local_focus(slabs, focus_idx, i) is not None)
            rows.append(_focus_row(states[i], f_days[i], diags[i],
                                   geom.dz_soil,
                                   _local_focus(slabs, focus_idx, i)))
    if focus_idx is None:
        return states, accs
    return states, accs, _stack_rows(rows)


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
