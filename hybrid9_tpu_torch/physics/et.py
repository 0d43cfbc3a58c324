"""Shuttleworth-Wallace (1985) dual-source Penman-Monteith ET.

Port of ``hybrid9_tpu/physics/et.py`` (reference: SOURCE/HYDROLOGY.f90:
228-418): all cells advance together as ``[n]`` tensors; the reference's
scalar branches become ``torch.where`` selects.  Expressions keep the JAX
package's order and grouping, so Python-float subexpressions fold in
double precision exactly as they do there.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import torch

from . import constants as c


class ETResult(NamedTuple):
    qflx_tran_veg: torch.Tensor   # [n] canopy transpiration          (mm/s)
    qflx_evap_grnd: torch.Tensor  # [n] substrate evaporation, limited(mm/s)
    beta: torch.Tensor            # [n] stomatal water-stress factor     (-)


def air_state(fd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Air density, vapour-pressure slope, deficit, psychrometric const.

    Reference: HYDROLOGY.f90:228-263 (FAO-56 esat curve).
    """
    tak = fd["tak"]
    tsv = tak * (1.0 + fd["huss"] * c.DELTX)
    rho = fd["ps"] / (c.RGAS * tsv)
    tc = tak - c.TF
    tc_off = tc + 237.3
    # (tc + 237.3) ** 2 is a product in JAX (integer_pow); so here.
    desatdT = (4098.0 * (0.6108 * torch.exp(17.27 * tc / tc_off))) \
        / (tc_off * tc_off)
    desatdT = desatdT * 18.0 / (c.GASC * tak)
    esat = 0.6108 * torch.exp(17.27 * tc / tc_off)
    esat = esat * 18.0 / (c.GASC * tak)
    vdd = esat * (1.0 - fd["rh"] / 100.0)
    gamma = (c.CP_AIR * fd["ps"] / (fd["lamb"] * 0.622)) \
        * (18.0e-3 / (c.GASC * tak))
    return dict(rho=rho, desatdT=desatdT, vdd=vdd, gamma=gamma)


def daily_et_context(fd: Dict[str, torch.Tensor], lai: torch.Tensor
                     ) -> Dict[str, torch.Tensor]:
    """Forcing/LAI-only ET terms, constant across a day's substeps."""
    a = air_state(fd)
    rho = a["rho"]
    lai_safe = torch.where(lai > 0.0, lai, 1.0)
    # Stomatal VPD attenuation (HYDROLOGY.f90:283-295).
    vpd_att = 2.8 ** (-80.0 * torch.clamp(a["vdd"], min=0.0) / rho)
    # Baldocchi et al. (2004) minimum resistance.
    rsc_min = 1.0 / ((lai_safe / 2.7) * 0.9 / (rho * 1.0e3 / 18.0))
    # Boundary/aerodynamic resistances (SW85 Eqns 20, 30, 31).
    rac = torch.where(lai > 0.0, 25.0 / (2.0 * lai_safe), 1.0e6)
    raa = torch.where(lai <= 4.0,
                      0.25 * lai * 42.0 + 0.25 * (4.0 - lai) * 34.0, 42.0)
    ras = torch.where(lai <= 4.0,
                      0.25 * lai * 128.0 + 0.25 * (4.0 - lai) * 49.0, 128.0)
    # Substrate net radiation and ground heat flux (HYDROLOGY.f90:
    # 335-339).
    rnets = fd["rnet"] * torch.exp(-0.7 * lai)
    g_soil = 0.2 * rnets
    return dict(rho=rho, desatdT=a["desatdT"], vdd=a["vdd"],
                gamma=a["gamma"], vpd_att=vpd_att, lai_safe=lai_safe,
                rsc_min=rsc_min, rac=rac, raa=raa, ras=ras, rnets=rnets,
                g_soil=g_soil)


def dual_source_et(theta: List[torch.Tensor], theta_s: List[torch.Tensor],
                   smp_prev: List[torch.Tensor],
                   rootr: List[torch.Tensor],
                   lai: torch.Tensor, lai_litter: torch.Tensor,
                   zc_soil, dz0, dt: float,
                   fd: Dict[str, torch.Tensor],
                   ctx: Dict[str, torch.Tensor] = None) -> ETResult:
    """Dual-source ET with stomatal stress and top-layer supply limit.

    Per-layer args are lists of ``[n]`` tensors; ``zc_soil`` the static
    node depths (mm), ``dz0`` the top-layer thickness (mm), ``fd`` the
    derived forcing and ``ctx`` an optional precomputed
    :func:`daily_et_context`.
    """
    if ctx is None:
        ctx = daily_et_context(fd, lai)
    rho, desatdT = ctx["rho"], ctx["desatdT"]
    vdd, gamma = ctx["vdd"], ctx["gamma"]
    lai_safe = ctx["lai_safe"]

    # Root-weighted stomatal water stress (HYDROLOGY.f90:269-276).
    beta = None
    for i in range(len(rootr)):
        beta_l = 1.0 - (smp_prev[i] - zc_soil[i]) / (-150000.0)
        term = rootr[i] * torch.clamp(beta_l, 0.0, 1.0)
        beta = term if beta is None else beta + term

    # Canopy stomatal resistance, guarded against LAI/beta/PAR = 0.
    par = fd["par"]
    active = (lai > 0.0) & (beta > 0.0) & (par > 0.0)
    beta_safe = torch.where(beta > 0.0, beta, 1.0)
    par_safe = torch.where(par > 0.0, par, 1.0)
    rsc_a = (1.0 / (par_safe / (par_safe + 300.0))) * 400.0 / (
        2.0 * lai_safe * ctx["vpd_att"])
    # Divide by beta floored at the cap point (et.py:126-131 of the JAX
    # package): the capped result is unchanged, the derivative finite.
    rsc_raw = rsc_a / torch.maximum(beta_safe, rsc_a / c.RSC_MAX)
    rsc = torch.where(active, rsc_raw, 1.0e6)
    # Baldocchi et al. (2004) minimum (HYDROLOGY.f90:295).
    rsc = torch.where(lai > 0.0, torch.maximum(rsc, ctx["rsc_min"]), rsc)
    # Cap: 1e8 s/m is already a hermetically closed canopy.
    rsc = torch.clamp(rsc, max=c.RSC_MAX)

    rac, raa, ras = ctx["rac"], ctx["raa"], ctx["ras"]

    # Substrate resistance (van de Griend & Owe 1994 Eqn 20;
    # HYDROLOGY.f90:325-331).
    th0 = theta[0]
    rss = torch.where(
        th0 <= 0.15,
        (10.0 + 1000.0 * lai_litter)
        * torch.exp(0.3563 * 100.0 * (0.15 - th0)),
        10.0 + 1000.0 * lai_litter * (1.0 - th0 / theta_s[0]))

    # Dual-source Penman-Monteith (SW85 Eqns 12-13, 21;
    # HYDROLOGY.f90:335-389).
    rnet = fd["rnet"]
    rnets = ctx["rnets"]
    g_soil = ctx["g_soil"]
    pmc = (desatdT * (rnet - g_soil)
           + (rho * c.CP_AIR * vdd - desatdT * rac * (rnets - g_soil))
           / (raa + rac)) \
        / (desatdT + gamma * (1.0 + rsc / (raa + rac)))
    pms = (desatdT * (rnet - g_soil)
           + (rho * c.CP_AIR * vdd - desatdT * ras * (rnet - rnets))
           / (raa + ras)) \
        / (desatdT + gamma * (1.0 + rss / (raa + ras)))
    r_a = (desatdT + gamma) * raa
    r_s = (desatdT + gamma) * ras + gamma * rss
    r_c = (desatdT + gamma) * rac + gamma * rsc
    cc = 1.0 / (1.0 + r_c * r_a / (r_s * (r_c + r_a)))
    cs = 1.0 / (1.0 + r_s * r_a / (r_c * (r_s + r_a)))
    le = cc * pmc + cs * pms
    vdd0 = vdd + (desatdT * (rnet - g_soil) - (desatdT + gamma) * le) \
        * raa / (rho * c.CP_AIR)
    lec = (desatdT * (rnet - rnets) + rho * c.CP_AIR * vdd0 / rac) \
        / (desatdT + gamma * (1.0 + rsc / rac))
    les = (desatdT * (rnets - g_soil) + rho * c.CP_AIR * vdd0 / ras) \
        / (desatdT + gamma * (1.0 + rss / ras))
    qflx_tran_veg = lec * 1.0e3 / (c.RHOW * fd["lamb"])
    qflx_evap_grnd = les * 1.0e3 / (c.RHOW * fd["lamb"])

    # Limit substrate evaporation to available top-layer water
    # (HYDROLOGY.f90:396-400).
    evap_max1 = dz0 * (th0 - c.WATMIN) / dt - qflx_tran_veg * rootr[0]
    evap_max1 = torch.clamp(evap_max1, min=0.0)
    qflx_evap_grnd = torch.minimum(evap_max1, qflx_evap_grnd)

    return ETResult(qflx_tran_veg=qflx_tran_veg,
                    qflx_evap_grnd=qflx_evap_grnd, beta=beta)
