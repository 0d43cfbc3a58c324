"""Scalar single-column oracle implementation (NumPy, float64).

A copy of ``hybrid9_tpu/physics/reference_column.py``, kept in numpy: a
deliberately loop-style, branch-style, per-column implementation of the
HYBRID9 physics, written directly from the governing equations with the
same operation ordering as the reference Fortran:

* CESM SurfaceRunoff / Infiltration / SoilWater / Drainage following
  Oleson et al. (2013) §7.4 (reference: SOURCE/HYDROLOGY.f90:154-1216),
* Shuttleworth & Wallace (1985) dual-source Penman-Monteith ET
  (HYDROLOGY.f90:228-418),
* Zeng & Decker (2009) equilibrium-profile correction
  (HYDROLOGY.f90:512-591),
* daily vegetation growth (SOURCE/GROW.f90).

It is the port's own oracle (the tensor code of ``hydrology.py`` and
``grow.py`` must reproduce it in the working dtype) and the default
engine of site mode (site.py), the analog of the reference's
INTERACTIVE/LCLIM harness (HYBRID9.f90:339-484).  It runs in float64
for tight water-balance closure and never on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from . import constants as c


@dataclasses.dataclass
class ColumnParams:
    """Soil parameters for one column (8 layers, float64)."""

    theta_s: np.ndarray   # [8] saturated vol. water content (-)
    hksat: np.ndarray     # [8] saturated conductivity (mm/s)
    bsw: np.ndarray       # [8] Clapp-Hornberger b (-)
    psi_s: np.ndarray     # [8] saturated matric potential (mm, negative)
    fmax: float           # max saturated fraction (-)


@dataclasses.dataclass
class ColumnState:
    """Prognostic state for one column."""

    h2osoi: np.ndarray    # [8] liquid water per layer (mm)
    zwt: float            # water table depth (m)
    wa: float             # aquifer store (mm)
    smp: np.ndarray       # [8] matric potential from previous substep (mm)
    lai: float
    lai_litter: float
    rootr: np.ndarray     # [8] root fraction per layer (-)
    plant_mass: float
    plant_foliage_mass: float


@dataclasses.dataclass
class DailyForcing:
    """One day of PGF-style forcing for one column."""

    tas: float    # K
    rlds: float   # W/m^2
    rsds: float   # W/m^2
    huss: float   # kg/kg
    ps: float     # Pa
    pr: float     # kg/m^2/s
    rhs: float    # %


def derived_forcing(f: DailyForcing) -> Dict[str, float]:
    """Daily forcing scalars derived by the driver.

    Reference: HYBRID9.f90:168-189 — net radiation with 8 % shortwave
    albedo, PAR conversion, rain flux, latent heat of vaporisation
    (Pereira da Silva 2012 Eqn 4).
    """
    tak = f.tas
    rnet = 0.92 * f.rsds + f.rlds - c.STBO * f.tas ** 4
    par = 0.92 * f.rsds * 2.3
    forc_rain = 1.0e3 * f.pr / c.RHOW
    lamb = (2503.0 - 2.386 * (tak - c.TF)) * 1.0e3
    return dict(tak=tak, rh=f.rhs, rnet=rnet, par=par,
                forc_rain=forc_rain, lamb=lamb, huss=f.huss, ps=f.ps)


def hydrology_substep(state: ColumnState, p: ColumnParams,
                      fd: Dict[str, float], zi: np.ndarray, dz: np.ndarray,
                      zc: np.ndarray, dt: float) -> Dict[str, float]:
    """One hydrology substep for a single column; mutates ``state``.

    Stage ordering mirrors HYDROLOGY.f90: ET -> surface runoff ->
    infiltration -> ZD09 equilibrium -> tridiagonal Richards solve ->
    aquifer recharge -> drainage/water-table update -> fix-ups ->
    conservation residual.  ``zi``/``dz``/``zc`` are the static layer
    geometry in mm (zi has 10 entries; dz/zc have 9, the 9th being the
    aquifer layer whose geometry is overwritten per step).

    Returns a dict of diagnostic fluxes including the water-balance
    residual ``w1 - w0`` (mm).
    """
    nl = len(p.theta_s)          # active soil layers (8 in the reference)
    h = state.h2osoi
    dz = dz.copy()
    zc = zc.copy()

    # --- Opening water balance and volumetric water (HYDROLOGY.f90:141-151)
    w0 = fd["forc_rain"] * dt + state.wa + float(np.sum(h[:nl]))
    theta = h[:nl] / (dz[:nl] * c.RHOW / 1.0e3)

    # --- CESM SurfaceRunoff (HYDROLOGY.f90:178-213): TOPMODEL saturated
    # fraction from water-table depth.
    fsat = p.fmax * np.exp(-0.5 * c.FFF * state.zwt)
    qflx_top_soil = fd["forc_rain"]
    qflx_surf = fsat * qflx_top_soil

    # --- Air state (HYDROLOGY.f90:228-263).
    tak = fd["tak"]
    tsv = tak * (1.0 + fd["huss"] * c.DELTX)
    rho = fd["ps"] / (c.RGAS * tsv)
    desatdT = (4098.0 * (0.6108 * np.exp((17.27 * (tak - c.TF))
                                         / (tak - c.TF + 237.3)))) \
        / ((tak - c.TF + 237.3) ** 2)
    desatdT = desatdT * 18.0 / (c.GASC * tak)
    esat = 0.6108 * np.exp(17.27 * (tak - c.TF) / (tak - c.TF + 237.3))
    esat = esat * 18.0 / (c.GASC * tak)
    vdd = esat * (1.0 - fd["rh"] / 100.0)
    gamma = (c.CP_AIR * fd["ps"] / (fd["lamb"] * 0.622)) \
        * (18.0e-3 / (c.GASC * tak))

    # --- Root-weighted stomatal water stress (HYDROLOGY.f90:269-276),
    # using the matric potential carried from the previous substep.
    beta = 0.0
    for i in range(nl):
        b_i = 1.0 - (state.smp[i] - zc[i]) / (-150000.0)
        beta += state.rootr[i] * min(1.0, max(0.0, b_i))

    # --- Canopy stomatal resistance w/ PAR & VPD response
    # (Shuttleworth Eqn 20 family; HYDROLOGY.f90:283-295).
    lai = state.lai
    par = fd["par"]
    if lai > 0.0 and beta > 0.0 and par > 0.0:
        rsc = (1.0 / (par / (par + 300.0))) * 400.0 / (
            2.0 * lai * beta * 2.8 ** (-80.0 * max(0.0, vdd) / rho))
    else:
        rsc = 1.0e6
    rsc = max(rsc, 1.0 / ((lai / 2.7) * 0.9 / (rho * 1.0e3 / 18.0)))
    rsc = min(rsc, c.RSC_MAX)   # overflow guard, see DEVIATIONS.md

    # --- Boundary/aerodynamic resistances (SW85 Eqns 20, 30, 31;
    # HYDROLOGY.f90:302-318).
    rac = 25.0 / (2.0 * lai) if lai > 0.0 else 1.0e6
    if lai <= 4.0:
        raa = 0.25 * lai * 42.0 + 0.25 * (4.0 - lai) * 34.0
        ras = 0.25 * lai * 128.0 + 0.25 * (4.0 - lai) * 49.0
    else:
        raa, ras = 42.0, 128.0

    # --- Substrate resistance incl. litter (van de Griend & Owe 1994
    # Eqn 20; HYDROLOGY.f90:325-331).
    if theta[0] <= 0.15:
        rss = (10.0 + 1000.0 * state.lai_litter) \
            * np.exp(0.3563 * 100.0 * (0.15 - theta[0]))
    else:
        rss = 10.0 + 1000.0 * state.lai_litter \
            * (1.0 - theta[0] / p.theta_s[0])

    # --- SW85 dual-source Penman-Monteith (HYDROLOGY.f90:335-389).
    rnet = fd["rnet"]
    rnets = rnet * np.exp(-0.7 * lai)     # SW85 Eqn 21
    g_soil = 0.2 * rnets
    pmc = (desatdT * (rnet - g_soil)
           + (rho * c.CP_AIR * vdd - desatdT * rac * (rnets - g_soil))
           / (raa + rac)) \
        / (desatdT + gamma * (1.0 + rsc / (raa + rac)))   # SW85 Eqn 12
    pms = (desatdT * (rnet - g_soil)
           + (rho * c.CP_AIR * vdd - desatdT * ras * (rnet - rnets))
           / (raa + ras)) \
        / (desatdT + gamma * (1.0 + rss / (raa + ras)))   # SW85 Eqn 13
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

    # --- Limit substrate evaporation to available top-layer water
    # (HYDROLOGY.f90:396-400).  Note: the reference compares volumetric
    # theta against the watmin *mm* constant; reproduced as-is.
    evap_max1 = dz[0] * (theta[0] - c.WATMIN) / dt \
        - qflx_tran_veg * state.rootr[0]
    evap_max1 = max(0.0, evap_max1)
    qflx_evap_grnd = min(evap_max1, qflx_evap_grnd)

    # --- CESM Infiltration (HYDROLOGY.f90:426-478).
    eff_porosity = np.maximum(0.01, p.theta_s)
    qflx_in_soil = (qflx_top_soil - qflx_surf) - qflx_evap_grnd
    qinmax = (1.0 - fsat) * float(np.min(p.hksat[0:3]))
    qflx_infl_excess = max(0.0, qflx_in_soil - qinmax)
    qflx_infl = qflx_in_soil - qflx_infl_excess
    qflx_surf = qflx_surf + qflx_infl_excess

    # --- CESM SoilWater (HYDROLOGY.f90:489-905) ---------------------------
    zwtmm = 1000.0 * state.zwt

    # jwt: number of interfaces strictly above the water table; 0 when the
    # table is in the top layer, nl when below the column
    # (HYDROLOGY.f90:499-508).
    jwt = nl
    for i in range(nl):
        if state.zwt <= zi[i + 1] / 1000.0:
            jwt = i
            break

    # Zeng & Decker (2009) equilibrium water content and potential
    # (HYDROLOGY.f90:512-590).  vol_eq/zq have 9 entries (index 8 =
    # virtual aquifer layer).
    vol_eq = np.zeros(nl + 1)
    zq = np.zeros(nl + 1)
    for i in range(nl):
        if zwtmm <= zi[i]:
            vol_eq[i] = p.theta_s[i]
        elif zi[i] < zwtmm < zi[i + 1]:
            tempi = 1.0
            temp0 = (((-p.psi_s[i]) + zwtmm - zi[i]) / (-p.psi_s[i])) \
                ** (1.0 - 1.0 / p.bsw[i])
            voleq1 = p.psi_s[i] * p.theta_s[i] / (1.0 - 1.0 / p.bsw[i]) \
                / (zwtmm - zi[i]) * (tempi - temp0)
            vol_eq[i] = (voleq1 * (zwtmm - zi[i])
                         + p.theta_s[i] * (zi[i + 1] - zwtmm)) \
                / (zi[i + 1] - zi[i])
            vol_eq[i] = min(p.theta_s[i], max(vol_eq[i], 0.0))
        else:
            tempi = ((-p.psi_s[i] + zwtmm - zi[i + 1]) / (-p.psi_s[i])) \
                ** (1.0 - 1.0 / p.bsw[i])
            temp0 = ((-p.psi_s[i] + zwtmm - zi[i]) / (-p.psi_s[i])) \
                ** (1.0 - 1.0 / p.bsw[i])
            vol_eq[i] = p.psi_s[i] * p.theta_s[i] / (1.0 - 1.0 / p.bsw[i]) \
                / (zi[i + 1] - zi[i]) * (tempi - temp0)
            vol_eq[i] = min(p.theta_s[i], max(vol_eq[i], 0.0))
        zq[i] = p.psi_s[i] * max(vol_eq[i] / p.theta_s[i], 0.01) \
            ** (-p.bsw[i])
        zq[i] = max(c.SMPMIN, zq[i])

    # Virtual 9th layer when the table is below the column
    # (HYDROLOGY.f90:574-590).
    i = nl - 1
    if jwt == nl:
        tempi = 1.0
        temp0 = ((-p.psi_s[i] + zwtmm - zi[nl]) / (-p.psi_s[i])) \
            ** (1.0 - 1.0 / p.bsw[i])
        vol_eq[nl] = p.psi_s[i] * p.theta_s[i] / (1.0 - 1.0 / p.bsw[i]) \
            / (zwtmm - zi[nl]) * (tempi - temp0)
        vol_eq[nl] = min(p.theta_s[i], max(vol_eq[nl], 0.0))
        zq[nl] = p.psi_s[i] * max(vol_eq[nl] / p.theta_s[i], 0.01) \
            ** (-p.bsw[i])
        zq[nl] = max(c.SMPMIN, zq[nl])

    # Interface conductivities, matric potentials, derivatives
    # (O13 Eqn 7.94; HYDROLOGY.f90:598-639).
    hk = np.zeros(nl)
    dhkdw = np.zeros(nl)
    smp = np.zeros(nl)
    dsmpdw = np.zeros(nl)
    for i in range(nl):
        inext = min(nl - 1, i + 1)
        s1 = 0.5 * (theta[i] + theta[inext]) \
            / (0.5 * (p.theta_s[i] + p.theta_s[inext]))
        s1 = min(1.0, s1)
        s2 = p.hksat[i] * s1 ** (2.0 * p.bsw[i] + 2.0)
        hk[i] = s1 * s2
        dhkdw[i] = (2.0 * p.bsw[i] + 3.0) * s2 \
            * (1.0 / (p.theta_s[i] + p.theta_s[inext]))
        s_node = min(1.0, max(theta[i] / p.theta_s[i], 0.01))
        smp[i] = max(c.SMPMIN, p.psi_s[i] * s_node ** (-p.bsw[i]))
        dsmpdw[i] = -p.bsw[i] * smp[i] / (s_node * p.theta_s[i])

    # Aquifer-layer geometry (HYDROLOGY.f90:643-650).
    zc[nl] = 0.5 * (zwtmm + zc[nl - 1])
    dz[nl] = dz[nl - 1] if jwt < nl else zwtmm - zc[nl - 1]

    # Tridiagonal assembly, O13 Eqns 7.116-7.141
    # (HYDROLOGY.f90:658-800).  9 unknowns: 8 soil + aquifer.
    amx = np.zeros(nl + 1)
    bmx = np.zeros(nl + 1)
    cmx = np.zeros(nl + 1)
    rmx = np.zeros(nl + 1)
    qin = np.zeros(nl + 1)
    qout = np.zeros(nl + 1)

    # Top layer.
    qin[0] = qflx_infl
    den = zc[1] - zc[0]
    dzq = zq[1] - zq[0]
    num = (smp[1] - smp[0]) - dzq
    qout[0] = -hk[0] * num / den
    dqodw1 = -(-hk[0] * dsmpdw[0] + num * dhkdw[0]) / den
    dqodw2 = -(hk[0] * dsmpdw[1] + num * dhkdw[0]) / den
    rmx[0] = qin[0] - qout[0] - qflx_tran_veg * state.rootr[0]
    amx[0] = 0.0
    bmx[0] = dz[0] / dt + dqodw1
    cmx[0] = dqodw2

    # Interior layers.
    for i in range(1, nl - 1):
        den = zc[i] - zc[i - 1]
        dzq = zq[i] - zq[i - 1]
        num = smp[i] - smp[i - 1] - dzq
        qin[i] = -hk[i - 1] * num / den
        dqidw0 = -(-hk[i - 1] * dsmpdw[i - 1] + num * dhkdw[i - 1]) / den
        dqidw1 = -(hk[i - 1] * dsmpdw[i] + num * dhkdw[i - 1]) / den
        den = zc[i + 1] - zc[i]
        dzq = zq[i + 1] - zq[i]
        num = (smp[i + 1] - smp[i]) - dzq
        qout[i] = -hk[i] * num / den
        dqodw1 = -(-hk[i] * dsmpdw[i] + num * dhkdw[i]) / den
        dqodw2 = -(hk[i] * dsmpdw[i + 1] + num * dhkdw[i]) / den
        rmx[i] = qin[i] - qout[i] - qflx_tran_veg * state.rootr[i]
        amx[i] = -dqidw0
        bmx[i] = dz[i] / dt - dqidw1 + dqodw1
        cmx[i] = dqodw2

    # Bottom soil layer + aquifer layer; two cases
    # (HYDROLOGY.f90:712-799).
    i = nl - 1
    den = zc[i] - zc[i - 1]
    dzq = zq[i] - zq[i - 1]
    num = smp[i] - smp[i - 1] - dzq
    qin[i] = -hk[i - 1] * num / den
    dqidw0 = -(-hk[i - 1] * dsmpdw[i - 1] + num * dhkdw[i - 1]) / den
    dqidw1 = -(hk[i - 1] * dsmpdw[i] + num * dhkdw[i - 1]) / den
    if jwt < nl:
        # Water table inside the soil column: zero flux at column base;
        # hydrologically inactive aquifer layer.
        qout[i] = 0.0
        rmx[i] = qin[i] - qout[i] - qflx_tran_veg * state.rootr[i]
        amx[i] = -dqidw0
        bmx[i] = dz[i] / dt - dqidw1
        cmx[i] = 0.0
        rmx[nl] = 0.0
        amx[nl] = 0.0
        bmx[nl] = dz[nl] / dt
        cmx[nl] = 0.0
    else:
        # Water table below the column: active aquifer layer.
        s_node = min(1.0, max(0.5 * (1.0 + theta[i] / p.theta_s[i]), 0.01))
        smp1 = max(c.SMPMIN, p.psi_s[i] * s_node ** (-p.bsw[i]))
        dsmpdw1 = -p.bsw[i] * smp1 / (s_node * p.theta_s[i])
        den = zc[nl] - zc[i]
        dzq = zq[nl] - zq[i]
        num = smp1 - smp[i] - dzq
        qout[i] = -hk[i] * num / den
        dqodw1 = -(-hk[i] * dsmpdw[i] + num * dhkdw[i]) / den
        dqodw2 = -(hk[i] * dsmpdw1 + num * dhkdw[i]) / den
        rmx[i] = qin[i] - qout[i] - qflx_tran_veg * state.rootr[i]
        amx[i] = -dqidw0
        bmx[i] = dz[i] / dt - dqidw1 + dqodw1
        cmx[i] = dqodw2
        qin[nl] = qout[i]
        dqidw0_a = -(-hk[i] * dsmpdw[i] + num * dhkdw[i]) / den
        dqidw1_a = -(hk[i] * dsmpdw1 + num * dhkdw[i]) / den
        qout[nl] = 0.0
        rmx[nl] = qin[nl] - qout[nl]
        amx[nl] = -dqidw0_a
        bmx[nl] = dz[nl] / dt - dqidw1_a
        cmx[nl] = 0.0

    # Thomas solve (Press et al. 1989 §2.6; HYDROLOGY.f90:806-837).
    gam = np.zeros(nl + 1)
    dwat2 = np.zeros(nl + 1)
    bet = bmx[0]
    dwat2[0] = rmx[0] / bet
    for i in range(1, nl + 1):
        gam[i] = cmx[i - 1] / bet
        bet = bmx[i] - amx[i] * gam[i]
        dwat2[i] = (rmx[i] - amx[i] * dwat2[i - 1]) / bet
    for i in range(nl - 1, -1, -1):
        dwat2[i] = dwat2[i] - gam[i + 1] * dwat2[i + 1]

    # State update (HYDROLOGY.f90:845-850).
    for i in range(nl):
        h[i] = h[i] + dwat2[i] * dz[i]

    # Aquifer recharge (HYDROLOGY.f90:856-904).
    if jwt < nl:
        s1 = min(1.0, max(theta[jwt] / p.theta_s[jwt], 0.01))
        ka = p.hksat[jwt] * s1 ** (2.0 * p.bsw[jwt] + 3.0)
        j = max(0, jwt - 1)
        smp1q = max(c.SMPMIN, smp[j])
        wh = smp1q - zq[j]
        if jwt == 0:
            qcharge = -ka * (0.0 - wh) / (zwtmm + 1.0)
        else:
            qcharge = -ka * (0.0 - wh) / ((zwtmm - zc[jwt - 1]) * 2.0)
        qcharge = min(10.0 / dt, max(-10.0 / dt, qcharge))
    else:
        qcharge = dwat2[nl] * dz[nl] / dt

    # --- CESM Drainage (HYDROLOGY.f90:915-1212) ---------------------------
    def compute_jwt() -> int:
        for ii in range(nl):
            if state.zwt <= zi[ii + 1] / 1000.0:
                return ii
        return nl

    def spec_yield(layer: int, zwtmm_local: float) -> float:
        s_y = p.theta_s[layer] * (
            1.0 - (1.0 + zwtmm_local / (-p.psi_s[layer]))
            ** (-1.0 / p.bsw[layer]))
        return max(s_y, 0.02)

    jwt = compute_jwt()
    rous = spec_yield(nl - 1, zwtmm)

    if jwt == nl:
        # Water table below the column: recharge moves the aquifer store.
        state.wa += qcharge * dt
        state.zwt -= (qcharge * dt) / 1000.0 / rous
    else:
        # Water table in the column: walk layers to re-locate the table.
        # Note the reference keeps ``zwtmm`` stale during the walk.
        qcharge_tot = qcharge * dt
        if qcharge_tot > 0.0:    # rising table: walk upward
            for i in range(jwt, -1, -1):
                s_y = spec_yield(i, zwtmm)
                qcharge_layer = min(qcharge_tot, s_y * (zwtmm - zi[i]))
                qcharge_layer = max(qcharge_layer, 0.0)
                if s_y > 0.0:
                    state.zwt -= qcharge_layer / s_y / 1000.0
                qcharge_tot -= qcharge_layer
                if qcharge_tot <= 0.0:
                    break
        else:                    # deepening table: walk downward
            for i in range(jwt, nl):
                s_y = spec_yield(i, zwtmm)
                qcharge_layer = max(qcharge_tot, -s_y * (zi[i + 1] - zwtmm))
                qcharge_layer = min(qcharge_layer, 0.0)
                qcharge_tot -= qcharge_layer
                if qcharge_tot >= 0.0:
                    state.zwt -= qcharge_layer / s_y / 1000.0
                    break
                state.zwt = zi[i + 1] / 1000.0
            if qcharge_tot > 0.0:
                state.zwt -= qcharge_tot / 1000.0 / rous
        jwt = compute_jwt()

    # Baseflow (HYDROLOGY.f90:1015-1123).
    zwtmm = 1000.0 * state.zwt
    rsub_top = c.RSUB_TOP_MAX * np.exp(-c.FFF * state.zwt)
    rous = spec_yield(nl - 1, zwtmm)
    rnff = np.zeros(nl + 1)

    if jwt == nl:
        state.wa -= rsub_top * dt
        state.zwt += (rsub_top * dt) / 1000.0 / rous
        h[nl - 1] += max(0.0, state.wa - 5000.0)
        state.wa = min(state.wa, 5000.0)
        rnff[nl] = rsub_top
    else:
        rsub_top_tot = -rsub_top * dt
        for i in range(jwt, nl):
            s_y = spec_yield(i, zwtmm)
            rsub_top_layer = max(rsub_top_tot, -(s_y * (zi[i + 1] - zwtmm)))
            rsub_top_layer = min(rsub_top_layer, 0.0)
            h[i] += rsub_top_layer
            rnff[i] = -rsub_top_layer
            rsub_top_tot -= rsub_top_layer
            if rsub_top_tot >= 0.0:
                state.zwt -= rsub_top_layer / s_y / 1000.0
                break
            state.zwt = zi[i + 1] / 1000.0
        state.zwt -= rsub_top_tot / 1000.0 / rous
        state.wa += rsub_top_tot
        rnff[nl] -= rsub_top_tot
        jwt = compute_jwt()

    # Water-table clamps (HYDROLOGY.f90:1122-1123).
    state.zwt = min(80.0, max(0.0, state.zwt))

    # Saturation-excess bucket cascade, bottom-up
    # (HYDROLOGY.f90:1131-1137).
    for i in range(nl - 1, 0, -1):
        xsi = max(h[i] - eff_porosity[i] * dz[i], 0.0)
        h[i] = min(eff_porosity[i] * dz[i], h[i])
        h[i - 1] += xsi

    # Top-layer excess to drainage (HYDROLOGY.f90:1144-1152).
    xs1 = max(max(h[0], 0.0) - max(0.0, p.theta_s[0] * dz[0]), 0.0)
    h[0] = min(max(0.0, p.theta_s[0] * dz[0]), h[0])
    qflx_rsub_sat = xs1 / dt

    # watmin floor: borrow from the layer below (HYDROLOGY.f90:1161-1174).
    for i in range(nl - 1):
        if h[i] < c.WATMIN:
            xs = c.WATMIN - h[i]
            # Fortran layer number is i+1; deepen the table if borrowing
            # across it.
            if (i + 1) == jwt:
                state.zwt += xs / eff_porosity[i] / 1000.0
        else:
            xs = 0.0
        h[i] += xs
        h[i + 1] -= xs

    # Bottom layer: search upward for water (HYDROLOGY.f90:1180-1211).
    i = nl - 1
    if h[i] < c.WATMIN:
        xs = c.WATMIN - h[i]
        for j in range(nl - 2, -1, -1):
            available = max(h[j] - c.WATMIN - xs, 0.0)
            if available >= xs:
                h[i] += xs
                h[j] -= xs
                xs = 0.0
                break
            h[i] += available
            h[j] -= available
            xs -= available
    else:
        xs = 0.0
    h[i] += xs
    rsub_top -= xs / dt

    # --- Conservation residual (HYDROLOGY.f90:1221-1244).
    w1 = (qflx_surf + qflx_evap_grnd + qflx_tran_veg
          + rsub_top + qflx_rsub_sat) * dt + state.wa + float(np.sum(h[:nl]))
    residual = w1 - w0

    # Carry smp for the next substep's beta and for GROW.
    state.smp = smp

    return dict(
        qflx_surf=qflx_surf,
        qflx_evap_grnd=qflx_evap_grnd,
        qflx_tran_veg=qflx_tran_veg,
        rsub_top=rsub_top,
        qflx_rsub_sat=qflx_rsub_sat,
        qcharge=qcharge,
        rnff=rnff,
        residual=residual,
        beta=beta,
    )


def grow_daily(state: ColumnState, tas: float, zi: np.ndarray
               ) -> Dict[str, float]:
    """Daily vegetation growth; mutates ``state``.  Reference: GROW.f90.

    Returns diagnostics including daily NPP (g DM/day).
    """
    nl = len(state.smp)

    # Soil-moisture growth constraint, root-weighted ramp on smp between
    # -150,000 and -50,000 mm (CESM Eqn 8.27 analog; GROW.f90:55-62).
    w_i = 0.0
    for i in range(nl):
        wi_l = (-150000.0 - state.smp[i]) / (-150000.0 - (-50000.0))
        w_i += state.rootr[i] * min(1.0, max(0.0, wi_l))

    # Temperature constraint (Hayat et al. 2017 Eqn 19; GROW.f90:66-72).
    # The reference leaves the warm side unclamped (negative growth above
    # 39 C daily mean -> negative mass -> root-profile divergence); we
    # clamp it at 0, matching grow.py (DEVIATIONS.md #9).
    d = tas - c.TF
    if d > 18.0:
        f_t = max(0.0, 1.0 - (abs(d - 18.0) / 21.0) ** 2)
    else:
        f_t = 1.0 - (abs(d - 18.0) / 25.0) ** 2
        f_t = min(1.0, max(0.0, f_t))

    # Single plant (nplants_max = 1; GROW.f90:82-188).
    grow_pm = (1000.0 / 365.0) * w_i * f_t
    grow_fm = grow_pm / 3.3
    loss_pm = (0.1 / 365.0) * state.plant_mass
    loss_fm = (1.0 / 365.0) * state.plant_foliage_mass \
        / min(1.0, max(0.01, w_i))
    if w_i < 0.6:
        loss_fm = 0.1 * state.plant_foliage_mass
    dpm = grow_pm - loss_pm
    dfm = grow_fm - loss_fm
    # Seed-bank floors, matching grow.py (DEVIATIONS.md #9).
    state.plant_mass = max(1.0e-3, state.plant_mass + dpm)
    state.plant_foliage_mass = max(1.0e-5,
                                   state.plant_foliage_mass + dfm)

    # Cylinder allometry (GROW.f90:155-156); cbrt for robustness at
    # non-positive mass (see DEVIATIONS.md).
    plant_length = np.cbrt(400.0 * state.plant_mass / 3.142e-3)
    dlai = dfm * c.SLA
    state.lai = max(0.001, state.lai + dlai)
    state.lai_litter += max(0.0, dlai)
    rdepth = 0.3 * plant_length

    # Root profile: 90 % of roots within rdepth (Baldocchi;
    # GROW.f90:176-182).
    decay = np.exp(np.log(0.1) / (max(rdepth, 1.0) / 10.0))
    for i in range(nl):
        state.rootr[i] = decay ** (zi[i] / 10.0) \
            - decay ** (zi[i + 1] / 10.0)

    npp = dpm

    # Litter decay, 2 %/day (GROW.f90:201).
    state.lai_litter -= 0.02 * state.lai_litter

    return dict(npp=npp, w_i=w_i, f_t=f_t, plant_length=plant_length,
                rdepth=rdepth)


def run_day(state: ColumnState, p: ColumnParams, f: DailyForcing,
            zi: np.ndarray, dz: np.ndarray, zc: np.ndarray, dt: float,
            nisurf: int, subdaily=None, grow: bool = True
            ) -> Dict[str, float]:
    """One model day: ``nisurf`` hydrology substeps then daily growth.

    Reference: the innermost loops of the driver (HYBRID9.f90:150-253).

    ``subdaily`` optionally provides per-substep forcing overrides — a
    list of ``nisurf`` dicts with any of the derived-forcing keys
    (``tak``, ``rh``, ``rnet``, ``par``, ``forc_rain``, ``lamb``) — the
    analog of the reference's LCLIM sub-daily rows where observed
    Rnet/PAR/rain replace the daily derivation (HYBRID9.f90:426-460).
    ``grow=False`` skips the daily GROW call, as the LCLIM branch does
    when LAI is prescribed (HYBRID9.f90:473-475).
    """
    fd = derived_forcing(f)
    evap_day = 0.0
    evap_grnd_day = 0.0
    rnf_day = 0.0
    max_resid = 0.0
    for ns in range(nisurf):
        fd_step = fd
        if subdaily is not None:
            fd_step = dict(fd)
            fd_step.update(subdaily[ns])
            if "tak" in subdaily[ns] and "lamb" not in subdaily[ns]:
                fd_step["lamb"] = (2503.0 - 2.386
                                   * (fd_step["tak"] - c.TF)) * 1.0e3
        fx = hydrology_substep(state, p, fd_step, zi, dz, zc, dt)
        evap_day += (fx["qflx_evap_grnd"] + fx["qflx_tran_veg"]) * dt
        evap_grnd_day += fx["qflx_evap_grnd"] * dt
        rnf_day += (fx["qflx_surf"] + fx["rsub_top"]) * dt
        max_resid = max(max_resid, abs(fx["residual"]))
    if grow:
        gx = grow_daily(state, f.tas, zi)
    else:
        gx = dict(npp=0.0, w_i=0.0, f_t=0.0)
    return dict(evap_day=evap_day, evap_grnd_day=evap_grnd_day,
                rnf_day=rnf_day, npp=gx["npp"], max_residual=max_resid,
                w_i=gx["w_i"], f_t=gx["f_t"])
