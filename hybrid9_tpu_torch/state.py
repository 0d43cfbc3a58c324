"""Model state as dataclasses of tensors.

Port of ``hybrid9_tpu/state.py``: the same classes, field names, shapes,
units and ``[n, nl]`` cell-major layout, with torch tensors in place of
flax pytrees.  Every class can be built from the JAX package's arrays
flattened to numpy by field name (``from_numpy``) and moved between
devices (``to``).

Shapes: ``[n]`` per-cell scalars, ``[n, nl]`` per-cell-per-soil-layer.
Units follow the reference exactly (mm, mm/s, K, W/m^2, g, m^2/m^2).
"""

from __future__ import annotations

import dataclasses
import math
import typing
from typing import Callable, Mapping

import numpy as np
import torch

from .physics import constants as c


class _Tensors:
    """Field-wise helpers shared by the state dataclasses."""

    @classmethod
    def from_numpy(cls, arrays: Mapping, dtype: torch.dtype, device):
        """Build on ``device`` from numpy arrays keyed by field name; a
        nested state (e.g. ``ModelState.soil``) takes a nested mapping.
        This is the one route by which the JAX package's ``ModelState``,
        ``SoilParams``, ``Forcing`` and ``AnnualAccumulators`` become the
        port's (flattened to numpy by field name)."""
        hints = typing.get_type_hints(cls)
        kw = {}
        for f in dataclasses.fields(cls):
            v = arrays[f.name]
            sub = hints[f.name]
            if isinstance(sub, type) and issubclass(sub, _Tensors):
                kw[f.name] = sub.from_numpy(v, dtype, device)
            else:
                kw[f.name] = torch.tensor(np.asarray(v), dtype=dtype,
                                          device=device)
        return cls(**kw)

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]):
        """Apply ``fn`` to every tensor, recursing into nested states."""
        changes = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            changes[f.name] = v.map(fn) if isinstance(v, _Tensors) else fn(v)
        return dataclasses.replace(self, **changes)

    def to(self, device):
        return self.map(lambda x: x.to(device))

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class SoilParams(_Tensors):
    """Static per-cell soil properties (SHARED.f90:398-449)."""

    theta_s: torch.Tensor   # [n, nl] Saturated vol. water content (-)
    hksat: torch.Tensor     # [n, nl] Saturated hydraulic conductivity (mm/s)
    lambda_: torch.Tensor   # [n, nl] Pore-size distribution index      (-)
    bsw: torch.Tensor       # [n, nl] Clapp-Hornberger b = 1/lambda     (-)
    psi_s: torch.Tensor     # [n, nl] Saturated matric potential       (mm)
    theta_m: torch.Tensor   # [n, nl] Residual water content at -31 bar (-)
    fmax: torch.Tensor      # [n]     Max. saturated fraction           (-)

    @property
    def n_cells(self) -> int:
        return self.theta_s.shape[0]


@dataclasses.dataclass
class SoilState(_Tensors):
    """Prognostic per-cell hydrology state (SHARED.f90:459-472, plus the
    lagged matric potential ``smp``)."""

    h2osoi_liq: torch.Tensor     # [n, nl] Liquid water per layer     (mm)
    zwt: torch.Tensor            # [n]     Water table depth           (m)
    wa: torch.Tensor             # [n]     Aquifer water store        (mm)
    smp: torch.Tensor            # [n, nl] Matric potential (lagged)  (mm)
    h2osoi_liq_ma: torch.Tensor  # [n, nl] Macropore liquid water     (mm)


@dataclasses.dataclass
class VegState(_Tensors):
    """Prognostic per-cell vegetation state (SHARED.f90:30-52)."""

    plant_mass: torch.Tensor          # [n] Plant structural mass  (g DM)
    plant_foliage_mass: torch.Tensor  # [n] Foliage mass           (g DM)
    plant_length: torch.Tensor        # [n] Cylinder length          (mm)
    rdepth: torch.Tensor              # [n] Rooting depth            (mm)
    lai: torch.Tensor                 # [n] Leaf area index     (m^2/m^2)
    lai_litter: torch.Tensor          # [n] Litter-layer LAI    (m^2/m^2)
    rootr: torch.Tensor               # [n, nl] Root fraction per layer (-)
    c_labile: torch.Tensor            # [n] Labile C pool           (g C)
    n_labile: torch.Tensor            # [n] Labile N pool           (g N)
    p_labile: torch.Tensor            # [n] Labile P pool           (g P)


@dataclasses.dataclass
class SnowpackState(_Tensors):
    """Two-layer snowpack prognostics (physics/snow.py
    ``snow_step_two_layer``); untouched by the degree-day scheme."""

    swe_surf: torch.Tensor   # [n] Surface-layer SWE (ice)          (mm)
    swe_base: torch.Tensor   # [n] Base-layer SWE (ice)             (mm)
    w_liq: torch.Tensor      # [n] Retained liquid water            (mm)
    t_surf: torch.Tensor     # [n] Surface-layer temperature  (K, <= TF)
    t_base: torch.Tensor     # [n] Base-layer temperature     (K, <= TF)

    @classmethod
    def zeros(cls, n: int, dtype: torch.dtype, device) -> "SnowpackState":
        def z():
            return torch.zeros((n,), dtype=dtype, device=device)

        def tf():
            return torch.full((n,), c.TF, dtype=dtype, device=device)

        return cls(swe_surf=z(), swe_base=z(), w_liq=z(),
                   t_surf=tf(), t_base=tf())


@dataclasses.dataclass
class CarbonState(_Tensors):
    """Soil-carbon pools (g C/m^2, ``[n]``)."""

    c_litter: torch.Tensor     # [n] Litter carbon
    c_soil_fast: torch.Tensor  # [n] Fast SOM (~10 yr turnover)
    c_soil_slow: torch.Tensor  # [n] Slow SOM (~100 yr turnover)

    @classmethod
    def initial(cls, n: int, dtype: torch.dtype, device) -> "CarbonState":
        def full(v):
            return torch.full((n,), v, dtype=dtype, device=device)

        return cls(c_litter=full(100.0), c_soil_fast=full(1000.0),
                   c_soil_slow=full(5000.0))


@dataclasses.dataclass
class ModelState(_Tensors):
    """Full prognostic state: soil + vegetation + the extras' stores."""

    soil: SoilState
    veg: VegState
    river_store: torch.Tensor  # [n] River store for routed flow     (mm)
    t_soil: torch.Tensor       # [n, nl] Soil temperature column      (K)
    swe: torch.Tensor          # [n] Snow water equivalent           (mm)
    h2osoi_ice: torch.Tensor   # [n, nl] Soil ice per layer          (mm)
    snowpack: SnowpackState
    carbon: CarbonState


@dataclasses.dataclass
class Forcing(_Tensors):
    """Daily climate forcing (READ_PGF.f90:22-109): ``[n]`` for one day,
    ``[days, n]`` for a forcing block."""

    tas: torch.Tensor    # Surface air temperature                  (K)
    rlds: torch.Tensor   # Downwelling longwave radiation       (W/m^2)
    rsds: torch.Tensor   # Downwelling shortwave radiation      (W/m^2)
    huss: torch.Tensor   # Specific humidity                    (kg/kg)
    ps: torch.Tensor     # Surface air pressure                    (Pa)
    pr: torch.Tensor     # Precipitation flux                (kg/m^2/s)
    rhs: torch.Tensor    # Relative humidity                        (%)


@dataclasses.dataclass
class SubstepFluxes(_Tensors):
    """Per-substep diagnostic fluxes (mm/s unless noted;
    HYDROLOGY.f90:1221-1283)."""

    qflx_surf: torch.Tensor       # [n] Surface runoff
    qflx_evap_grnd: torch.Tensor  # [n] Ground (substrate) evaporation
    qflx_tran_veg: torch.Tensor   # [n] Canopy transpiration
    rsub_top: torch.Tensor        # [n] Topographic subsurface runoff
    qflx_rsub_sat: torch.Tensor   # [n] Saturation-excess drainage
    qcharge: torch.Tensor         # [n] Aquifer recharge
    rnff: torch.Tensor            # [n, nl+1] Per-layer drainage
    residual: torch.Tensor        # [n] Water-balance residual      (mm)


@dataclasses.dataclass
class AnnualAccumulators(_Tensors):
    """Running annual sums carried through the day loop
    (HYBRID9.f90:134-146, 235-253)."""

    npp_sum: torch.Tensor
    discharge_sum: torch.Tensor
    t_surf_sum: torch.Tensor
    plant_mass_sum: torch.Tensor
    rnf_sum: torch.Tensor
    evap_sum: torch.Tensor
    tas_sum: torch.Tensor
    rlds_sum: torch.Tensor
    rsds_sum: torch.Tensor
    huss_sum: torch.Tensor
    ps_sum: torch.Tensor
    pr_sum: torch.Tensor
    rhs_sum: torch.Tensor
    theta_sum: torch.Tensor          # [n, nl]
    h2osoi_total_sum: torch.Tensor
    swe_sum: torch.Tensor
    ice_sum: torch.Tensor
    rh_sum: torch.Tensor
    nee_sum: torch.Tensor
    c_soil_sum: torch.Tensor
    n_days: torch.Tensor             # [] days accumulated
    max_abs_residual: torch.Tensor

    @classmethod
    def zeros(cls, n: int, dtype: torch.dtype, device,
              nsoil: int = c.NSOIL_LAYERS) -> "AnnualAccumulators":
        kw = {f.name: torch.zeros((n,), dtype=dtype, device=device)
              for f in dataclasses.fields(cls)}
        kw["theta_sum"] = torch.zeros((n, nsoil), dtype=dtype,
                                      device=device)
        kw["n_days"] = torch.zeros((), dtype=dtype, device=device)
        return cls(**kw)


def initial_state(params: SoilParams, dz_mm: np.ndarray, zi_mm: np.ndarray,
                  dtype: torch.dtype, device) -> ModelState:
    """Build the t=0 prognostic state from soil parameters (INIT.f90:
    707-811): layers at 40 % of saturation, the water table 5 m below the
    bottom soil interface, 4000 mm in the aquifer, one 1 g plant with an
    exponential root profile, and ``smp`` consistent with the moisture.
    """
    n = params.n_cells
    nsoil = len(dz_mm) - 1          # dz includes the aquifer layer
    dz = torch.as_tensor(np.asarray(dz_mm[:nsoil]), dtype=dtype,
                         device=device)
    zi = torch.as_tensor(np.asarray(zi_mm), dtype=dtype, device=device)

    def full(v):
        return torch.full((n,), v, dtype=dtype, device=device)

    theta_s = params.theta_s.to(dtype)
    # INIT.f90:730-733 — initial water = 0.4 * theta_s * dz (mm).
    h2osoi_liq = 0.4 * theta_s * dz[None, :]
    h2osoi_liq_ma = 0.4 * 0.1 * dz[None, :] * torch.ones(
        (n, 1), dtype=dtype, device=device)
    s = torch.clamp(0.4 * torch.ones_like(theta_s), 0.01, 1.0)
    smp = torch.clamp(params.psi_s.to(dtype) * s ** (-params.bsw.to(dtype)),
                      min=c.SMPMIN)

    soil = SoilState(
        h2osoi_liq=h2osoi_liq,
        zwt=full(float(zi_mm[nsoil] + 5000.0) / 1000.0),
        wa=full(4000.0),
        smp=smp,
        h2osoi_liq_ma=h2osoi_liq_ma,
    )

    plant_mass = full(1.0)
    plant_foliage_mass = full(0.0435)
    plant_length = (400.0 * plant_mass / 3.142e-3) ** (1.0 / 3.0)
    rdepth = 0.3 * plant_length
    lai = plant_foliage_mass * c.SLA / c.PLOT_AREA
    # Exponential root profile (INIT.f90:793-807; GROW.f90:176-182).
    decay = torch.exp(math.log(0.1) / (rdepth / 10.0))
    rootr = (decay[:, None] ** (zi[None, :nsoil] / 10.0)
             - decay[:, None] ** (zi[None, 1:nsoil + 1] / 10.0))
    c_labile = plant_mass * 0.5 * 0.1
    n_labile = c_labile * 0.035
    p_labile = n_labile * 0.025

    veg = VegState(
        plant_mass=plant_mass,
        plant_foliage_mass=plant_foliage_mass,
        plant_length=plant_length,
        rdepth=rdepth,
        lai=lai,
        lai_litter=full(0.001),
        rootr=rootr,
        c_labile=c_labile,
        n_labile=n_labile,
        p_labile=p_labile,
    )
    return ModelState(
        soil=soil, veg=veg,
        river_store=full(0.0),
        t_soil=torch.full((n, nsoil), 283.15, dtype=dtype, device=device),
        swe=full(0.0),
        h2osoi_ice=torch.zeros((n, nsoil), dtype=dtype, device=device),
        snowpack=SnowpackState.zeros(n, dtype, device),
        carbon=CarbonState.initial(n, dtype, device))
