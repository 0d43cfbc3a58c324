"""Hydrology substep: the model's hot loop body.

Port of ``hybrid9_tpu/physics/hydrology.py`` (reference: SOURCE/
HYDROLOGY.f90).  Stage order follows the reference:

  surface runoff -> dual-source ET -> infiltration -> implicit vertical
  soil water (ZD09 + Thomas) -> aquifer recharge -> drainage /
  water-table -> fix-ups -> conservation residual.

``substep_values`` is the value-level core on lists of ``[n]`` tensors,
shared by the plain day loop (day_kernel.hydrology_day_plain) and, as a
line-by-line template, by the CUDA day kernel (csrc/day_kernel.cu).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from . import bounds
from . import constants as c
from .drainage import drainage
from .et import dual_source_et
from .layers import stack, unstack
from .soilwater import soil_water_update
from ..state import Forcing, SoilState, SubstepFluxes, VegState


class Geometry(NamedTuple):
    """Static vertical geometry in mm, as tuples of Python floats.

    Expressions such as ``zi[i] / 1000.0`` and ``dz[i] / dt`` therefore
    fold in double precision and round once to the working dtype, as in
    the JAX package.
    """

    zi: tuple       # [nl + 2] interface depths
    dz_soil: tuple  # [nl] soil-layer thicknesses
    zc_soil: tuple  # [nl] soil-layer node depths

    @classmethod
    def from_layer_grid(cls, grid) -> "Geometry":
        nl = grid.nsoil
        return cls(
            zi=tuple(float(z) for z in grid.zi),
            dz_soil=tuple(float(z) for z in grid.dz[:nl]),
            zc_soil=tuple(float(z) for z in grid.zc[:nl]),
        )


def derive_forcing(f: Forcing, sw_abs=None) -> Dict[str, torch.Tensor]:
    """Daily forcing scalars derived by the driver (HYBRID9.f90:168-189):
    net radiation with 8 % shortwave albedo, PAR, rain flux and the latent
    heat of vaporisation.  ``sw_abs`` optionally overrides the constant
    0.92 shortwave absorptivity per cell."""
    a = 0.92 if sw_abs is None else sw_abs
    tak = f.tas
    t2 = f.tas * f.tas           # tas ** 4 as JAX's integer_pow forms it
    rnet = a * f.rsds + f.rlds - c.STBO * (t2 * t2)
    par = a * f.rsds * 2.3
    forc_rain = 1.0e3 * f.pr / c.RHOW
    lamb = (2503.0 - 2.386 * (tak - c.TF)) * 1.0e3
    return dict(tak=tak, rh=f.rhs, rnet=rnet, par=par,
                forc_rain=forc_rain, lamb=lamb, huss=f.huss, ps=f.ps)


def substep_values(h, smp_prev, zwt, wa, rootr, lai, lai_litter,
                   p_theta_s, p_hksat, p_psi_s, p_bsw, fmax,
                   fd: Dict[str, torch.Tensor], geom: Geometry,
                   dt: float, imp=None, zq=None,
                   et_ctx=None, sy=None) -> Dict[str, object]:
    """One hydrology substep on plain values.

    Per-layer args (``h``, ``smp_prev``, ``rootr``, ``p_*``, ``imp``,
    ``zq``, ``sy``) are lists of ``[n]`` tensors; the rest are ``[n]``
    tensors.  ``imp`` is the optional frozen-soil impedance, ``zq`` and
    ``sy`` optionally cached ZD09 and specific-yield profiles, ``et_ctx``
    the optional daily ET context.

    Returns a dict with the updated prognostics (``h``, ``smp`` as lists;
    ``zwt``, ``wa``) and the substep fluxes.
    """
    nl = len(h)
    dz = geom.dz_soil
    theta = [h[i] / (dz[i] * c.RHOW / 1.0e3) for i in range(nl)]

    # Opening balance (HYDROLOGY.f90:141-151).
    w0 = fd["forc_rain"] * dt + wa + sum(h)

    # TOPMODEL saturated fraction (HYDROLOGY.f90:178-213).
    fsat = fmax * torch.exp(-0.5 * c.FFF * zwt)
    qflx_top_soil = fd["forc_rain"]
    qflx_surf = fsat * qflx_top_soil

    # Dual-source ET (HYDROLOGY.f90:228-418).
    et = dual_source_et(theta, p_theta_s, smp_prev, rootr,
                        lai, lai_litter, geom.zc_soil, dz[0], dt, fd,
                        ctx=et_ctx)

    # Infiltration (HYDROLOGY.f90:426-478).
    eff_porosity = [bounds.maximum(ts, 0.01) for ts in p_theta_s]
    qflx_in_soil = (qflx_top_soil - qflx_surf) - et.qflx_evap_grnd
    qinmax = (1.0 - fsat) * torch.minimum(
        torch.minimum(p_hksat[0], p_hksat[1]), p_hksat[2])
    if imp is not None:
        qinmax = qinmax * imp[0]
    qflx_infl_excess = bounds.maximum(qflx_in_soil - qinmax, 0.0)
    qflx_infl = qflx_in_soil - qflx_infl_excess
    qflx_surf = qflx_surf + qflx_infl_excess

    # Implicit vertical step + recharge (HYDROLOGY.f90:485-909).
    sw = soil_water_update(
        h, theta, zwt, p_theta_s, p_hksat, p_psi_s, p_bsw,
        qflx_infl, et.qflx_tran_veg, rootr, geom.zi, dz, geom.zc_soil,
        dt, imp, zq=zq)

    # Water table, baseflow, fix-ups (HYDROLOGY.f90:911-1216).
    dr = drainage(sw.h2osoi, zwt, wa, sw.qcharge,
                  p_theta_s, p_psi_s, p_bsw, eff_porosity,
                  geom.zi, dz, dt, s_y_prof=sy)

    # Conservation residual (HYDROLOGY.f90:1221-1274) as a diagnostic.
    w1 = (qflx_surf + et.qflx_evap_grnd + et.qflx_tran_veg
          + dr.rsub_top + dr.qflx_rsub_sat) * dt + dr.wa + sum(dr.h2osoi)
    residual = w1 - w0

    return dict(
        h=dr.h2osoi, smp=sw.smp, zwt=dr.zwt, wa=dr.wa,
        qflx_surf=qflx_surf, qflx_evap_grnd=et.qflx_evap_grnd,
        qflx_tran_veg=et.qflx_tran_veg, rsub_top=dr.rsub_top,
        qflx_rsub_sat=dr.qflx_rsub_sat, qcharge=sw.qcharge,
        rnff=dr.rnff, residual=residual,
    )


def hydrology_substep(soil: SoilState, veg: VegState, params,
                      fd: Dict[str, torch.Tensor], geom: Geometry,
                      dt: float, imp=None, zq=None, et_ctx=None,
                      sy=None) -> Tuple[SoilState, SubstepFluxes]:
    """One hydrology substep for all cells, on state dataclasses.

    ``imp`` is the optional ``[n, nl]`` frozen-soil impedance, ``zq`` an
    optional ``[n, nl+1]`` ZD09 profile and ``sy`` an optional
    ``[n, nl]`` specific-yield profile.
    """
    out = substep_values(
        unstack(soil.h2osoi_liq), unstack(soil.smp), soil.zwt, soil.wa,
        unstack(veg.rootr), veg.lai, veg.lai_litter,
        unstack(params.theta_s), unstack(params.hksat),
        unstack(params.psi_s), unstack(params.bsw), params.fmax,
        fd, geom, dt,
        imp=None if imp is None else unstack(imp),
        zq=None if zq is None else unstack(zq),
        et_ctx=et_ctx,
        sy=None if sy is None else unstack(sy))

    new_soil = SoilState(
        h2osoi_liq=stack(out["h"]),
        zwt=out["zwt"],
        wa=out["wa"],
        smp=stack(out["smp"]),
        h2osoi_liq_ma=soil.h2osoi_liq_ma,
    )
    fluxes = SubstepFluxes(
        qflx_surf=out["qflx_surf"],
        qflx_evap_grnd=out["qflx_evap_grnd"],
        qflx_tran_veg=out["qflx_tran_veg"],
        rsub_top=out["rsub_top"],
        qflx_rsub_sat=out["qflx_rsub_sat"],
        qcharge=out["qcharge"],
        rnff=stack(out["rnff"]),
        residual=out["residual"],
    )
    return new_soil, fluxes
