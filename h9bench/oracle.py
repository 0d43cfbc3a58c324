"""The plain reference of the benchmark: one soil column, scalar by scalar.

Frozen from ``hybrid9_tpu_torch/physics/reference_column.py`` at commit
4b4e2efbab26aa9d426bea47f8b90395f66dc63b (the port's copy of the JAX
package's per-column oracle, written from the reference Fortran), with
what the timed paths add to it:

* the ``zd09_every`` refresh: the Zeng & Decker equilibrium potentials of
  the soil layers and the specific yields of every layer are worked out at
  substeps ``0, k, 2k, ...`` of a day and held in between, the aquifer
  entry of the profile fresh every substep (the configuration states
  ``zd09_every``; at 1 every value is fresh, as in the frozen oracle);
* the daily soil-heat column (``hybrid9_tpu_torch/physics/soiltemp.py``
  at the same commit: implicit diffusion with the apparent-capacity band
  of 2 K, driven by the ground heat flux of the day-start LAI);
* the cell-local scalar-observation square-root filter with relaxation
  to the prior spread (``assimilate.py`` at the same commit, after
  Whitaker & Hamill 2002 and 2012), on one cell's members.

Every value is a Python number, so a column runs at the speed of the
interpreter and not of a library's dispatch.  The arithmetic type is a
parameter: ``F64`` computes in float64; ``BF16`` rounds every result to
bfloat16, which is the control of the benchmark's comparison.  Nothing
here imports the program or a library beyond ``math`` and ``struct``.
"""

from __future__ import annotations

import math
import struct

# Physical constants (hybrid9_tpu_torch/physics/constants.py).
RHOW = 1000.0
MAIR = 28.9655
MWAT = 18.015
GASC = 8.314510
RGAS = 1000.0 * GASC / MAIR
STBO = 5.67e-8
DELTX = 1.0 / (MWAT / MAIR) - 1.0
TF = 273.16
LFUS = 3.337e5
SMPMIN = -1.0e8
WATMIN = 0.01
CP_AIR = 1010.0
RSC_MAX = 1.0e8
FFF = 2.5
RSUB_TOP_MAX = 5.5e-3
SLA = 23.0e-3
SDAY = 86400.0
# Soil heat (soiltemp.py).
K_DRY = 0.30
K_SAT = 1.80
C_SOLID = 2.0e6
C_WATER = 4.18e6
LATENT_RAMP = 2.0

_F32 = struct.Struct("<f")
_U32 = struct.Struct("<I")


def _to_bf16(x: float) -> float:
    """``x`` rounded to the nearest bfloat16, ties to even (through
    float32, as a bfloat16 unit rounds a float32 result)."""
    if x != x or x in (math.inf, -math.inf):
        return x
    try:
        bits = _U32.unpack(_F32.pack(x))[0]
    except OverflowError:
        return math.copysign(math.inf, x)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return _F32.unpack(_U32.pack(bits))[0]


class BF16(float):
    """A float whose every arithmetic result is rounded to bfloat16."""

    __slots__ = ()

    def __new__(cls, x=0.0):
        return float.__new__(cls, _to_bf16(float(x)))


def _binary(op):
    def f(a, b):
        return BF16(op(float(a), float(b)))
    return f


for _name, _op in (("add", float.__add__), ("sub", float.__sub__),
                   ("mul", float.__mul__), ("truediv", float.__truediv__),
                   ("pow", float.__pow__)):
    setattr(BF16, f"__{_name}__", _binary(_op))
    setattr(BF16, f"__r{_name}__", _binary(lambda a, b, _op=_op: _op(b, a)))
BF16.__neg__ = lambda a: BF16(-float(a))
BF16.__abs__ = lambda a: BF16(abs(float(a)))


class F64:
    """float64 arithmetic."""

    num = float
    exp = staticmethod(math.exp)
    log = staticmethod(math.log)
    sqrt = staticmethod(math.sqrt)

    @staticmethod
    def pow(a, b):
        return math.pow(a, b)


class BF16Math:
    """bfloat16 arithmetic: every input, result and function value
    rounded to bfloat16."""

    num = BF16

    @staticmethod
    def exp(x):
        return BF16(math.exp(x))

    @staticmethod
    def log(x):
        return BF16(math.log(x))

    @staticmethod
    def sqrt(x):
        return BF16(math.sqrt(x))

    @staticmethod
    def pow(a, b):
        return BF16(math.pow(a, b))


ARITHMETIC = {"float64": F64, "bfloat16": BF16Math}


class Geometry:
    """Interfaces ``zi`` ([nl + 2], mm), thicknesses ``dz`` and node
    depths ``zc`` ([nl + 1], mm; the last entry the aquifer layer's)."""

    def __init__(self, zi):
        self.zi = [float(z) for z in zi]
        self.nl = len(self.zi) - 2
        self.dz = [self.zi[i + 1] - self.zi[i] for i in range(self.nl + 1)]
        self.zc = [self.zi[i + 1] - self.dz[i] / 2.0
                   for i in range(self.nl + 1)]


class Column:
    """One column's parameters and state, as lists of numbers: the soil
    parameters ``theta_s``, ``hksat``, ``bsw``, ``psi_s`` ([nl]) and
    ``fmax``; the state ``h`` (liquid water, mm), ``smp``, ``rootr``,
    ``t_soil`` ([nl]), ``zwt`` (m), ``wa`` (mm), ``lai``, ``lai_litter``,
    ``plant_mass``, ``plant_foliage_mass``."""

    LAYERED = ("theta_s", "hksat", "bsw", "psi_s", "h", "smp", "rootr",
               "t_soil")
    SCALAR = ("fmax", "zwt", "wa", "lai", "lai_litter", "plant_mass",
              "plant_foliage_mass")

    def __init__(self, values: dict, M=F64):
        for k in self.LAYERED:
            setattr(self, k, [M.num(v) for v in values[k]])
        for k in self.SCALAR:
            setattr(self, k, M.num(values[k]))

    def state(self) -> dict:
        return {k: (list(map(float, getattr(self, k)))
                    if k in self.LAYERED else float(getattr(self, k)))
                for k in ("h", "smp", "rootr", "t_soil", "zwt", "wa", "lai",
                          "lai_litter", "plant_mass", "plant_foliage_mass")}


def derived_forcing(f: dict, M=F64) -> dict:
    """Daily forcing scalars (HYBRID9.f90:168-189); ``f`` holds ``tas``,
    ``rlds``, ``rsds``, ``huss``, ``ps``, ``pr``, ``rhs``."""
    tas = M.num(f["tas"])
    t2 = tas * tas
    rsds = M.num(f["rsds"])
    return dict(tak=tas, rh=M.num(f["rhs"]),
                rnet=0.92 * rsds + M.num(f["rlds"]) - STBO * (t2 * t2),
                par=0.92 * rsds * 2.3,
                forc_rain=1.0e3 * M.num(f["pr"]) / RHOW,
                lamb=(2503.0 - 2.386 * (tas - TF)) * 1.0e3,
                huss=M.num(f["huss"]), ps=M.num(f["ps"]))


def _spec_yield(col: Column, layer: int, zwtmm, M):
    s_y = col.theta_s[layer] * (1.0 - M.pow(
        1.0 + zwtmm / (-col.psi_s[layer]), -1.0 / col.bsw[layer]))
    return max(s_y, 0.02)


def _jwt(zwt, zi, nl) -> int:
    """Interfaces strictly above the table: 0 with the table in the top
    layer, ``nl`` below the column."""
    for i in range(nl):
        if zwt <= zi[i + 1] / 1000.0:
            return i
    return nl


def _equilibrium(col: Column, zwtmm, geo: Geometry, M):
    """ZD09 equilibrium potential of each soil layer (HYDROLOGY.f90:
    512-573)."""
    zi, nl = geo.zi, geo.nl
    zq = [0.0] * nl
    for i in range(nl):
        ps, ts, bs = col.psi_s[i], col.theta_s[i], col.bsw[i]
        if zwtmm <= zi[i]:
            vol_eq = ts
        elif zi[i] < zwtmm < zi[i + 1]:
            temp0 = M.pow(((-ps) + zwtmm - zi[i]) / (-ps), 1.0 - 1.0 / bs)
            voleq1 = ps * ts / (1.0 - 1.0 / bs) / (zwtmm - zi[i]) \
                * (1.0 - temp0)
            vol_eq = (voleq1 * (zwtmm - zi[i]) + ts * (zi[i + 1] - zwtmm)) \
                / (zi[i + 1] - zi[i])
            vol_eq = min(ts, max(vol_eq, 0.0))
        else:
            tempi = M.pow((-ps + zwtmm - zi[i + 1]) / (-ps), 1.0 - 1.0 / bs)
            temp0 = M.pow((-ps + zwtmm - zi[i]) / (-ps), 1.0 - 1.0 / bs)
            vol_eq = ps * ts / (1.0 - 1.0 / bs) / (zi[i + 1] - zi[i]) \
                * (tempi - temp0)
            vol_eq = min(ts, max(vol_eq, 0.0))
        zq[i] = max(SMPMIN, ps * M.pow(max(vol_eq / ts, 0.01), -bs))
    return zq


def _aquifer_zq(col: Column, zwtmm, jwt: int, geo: Geometry, M):
    """The virtual aquifer layer's equilibrium potential (HYDROLOGY.f90:
    574-590): 0 unless the table is below the column."""
    nl, zi = geo.nl, geo.zi
    if jwt != nl:
        return 0.0
    i = nl - 1
    ps, ts, bs = col.psi_s[i], col.theta_s[i], col.bsw[i]
    temp0 = M.pow((-ps + zwtmm - zi[nl]) / (-ps), 1.0 - 1.0 / bs)
    vol_eq = ps * ts / (1.0 - 1.0 / bs) / (zwtmm - zi[nl]) * (1.0 - temp0)
    vol_eq = min(ts, max(vol_eq, 0.0))
    return max(SMPMIN, ps * M.pow(max(vol_eq / ts, 0.01), -bs))


def refresh(col: Column, geo: Geometry, M=F64):
    """The held profiles of the ``zd09_every`` refresh at the current
    table: ``(zq of the soil layers, specific yield of every layer)``."""
    zwtmm = 1000.0 * col.zwt
    return (_equilibrium(col, zwtmm, geo, M),
            [_spec_yield(col, i, zwtmm, M) for i in range(geo.nl)])


def substep(col: Column, fd: dict, geo: Geometry, dt: float, held=None,
            M=F64) -> dict:
    """One hydrology substep of one column; updates ``col``.  ``held``:
    the profiles of :func:`refresh`, or None for fresh ones.  Returns the
    substep's fluxes (mm/s) and its water-balance residual (mm)."""
    nl, zi = geo.nl, geo.zi
    dz = list(geo.dz)
    zc = list(geo.zc)
    h = col.h
    ts_, hk_, ps_, bs_ = col.theta_s, col.hksat, col.psi_s, col.bsw

    w0 = fd["forc_rain"] * dt + col.wa + sum(h)
    theta = [h[i] / (dz[i] * RHOW / 1.0e3) for i in range(nl)]

    # Surface runoff (HYDROLOGY.f90:178-213).
    fsat = col.fmax * M.exp(-0.5 * FFF * col.zwt)
    qflx_top_soil = fd["forc_rain"]
    qflx_surf = fsat * qflx_top_soil

    # Air state (HYDROLOGY.f90:228-263).
    tak = fd["tak"]
    tsv = tak * (1.0 + fd["huss"] * DELTX)
    rho = fd["ps"] / (RGAS * tsv)
    tc = tak - TF
    esat0 = 0.6108 * M.exp((17.27 * tc) / (tc + 237.3))
    desat = (4098.0 * esat0) / ((tc + 237.3) * (tc + 237.3))
    desat = desat * 18.0 / (GASC * tak)
    esat = esat0 * 18.0 / (GASC * tak)
    vdd = esat * (1.0 - fd["rh"] / 100.0)
    gamma = (CP_AIR * fd["ps"] / (fd["lamb"] * 0.622)) \
        * (18.0e-3 / (GASC * tak))

    # Root-weighted stomatal stress (HYDROLOGY.f90:269-276).
    beta = 0.0
    for i in range(nl):
        b_i = 1.0 - (col.smp[i] - zc[i]) / (-150000.0)
        beta = beta + col.rootr[i] * min(1.0, max(0.0, b_i))

    # Resistances (HYDROLOGY.f90:283-331).
    lai = col.lai
    par = fd["par"]
    if lai > 0.0 and beta > 0.0 and par > 0.0:
        rsc = (1.0 / (par / (par + 300.0))) * 400.0 / (
            2.0 * lai * beta * M.pow(2.8, -80.0 * max(0.0, vdd) / rho))
    else:
        rsc = 1.0e6
    rsc = max(rsc, 1.0 / ((lai / 2.7) * 0.9 / (rho * 1.0e3 / 18.0)))
    rsc = min(rsc, RSC_MAX)
    rac = 25.0 / (2.0 * lai) if lai > 0.0 else 1.0e6
    if lai <= 4.0:
        raa = 0.25 * lai * 42.0 + 0.25 * (4.0 - lai) * 34.0
        ras = 0.25 * lai * 128.0 + 0.25 * (4.0 - lai) * 49.0
    else:
        raa, ras = 42.0, 128.0
    if theta[0] <= 0.15:
        rss = (10.0 + 1000.0 * col.lai_litter) \
            * M.exp(0.3563 * 100.0 * (0.15 - theta[0]))
    else:
        rss = 10.0 + 1000.0 * col.lai_litter * (1.0 - theta[0] / ts_[0])

    # Dual-source Penman-Monteith (HYDROLOGY.f90:335-389).
    rnet = fd["rnet"]
    rnets = rnet * M.exp(-0.7 * lai)
    g_soil = 0.2 * rnets
    pmc = (desat * (rnet - g_soil)
           + (rho * CP_AIR * vdd - desat * rac * (rnets - g_soil))
           / (raa + rac)) / (desat + gamma * (1.0 + rsc / (raa + rac)))
    pms = (desat * (rnet - g_soil)
           + (rho * CP_AIR * vdd - desat * ras * (rnet - rnets))
           / (raa + ras)) / (desat + gamma * (1.0 + rss / (raa + ras)))
    r_a = (desat + gamma) * raa
    r_s = (desat + gamma) * ras + gamma * rss
    r_c = (desat + gamma) * rac + gamma * rsc
    cc = 1.0 / (1.0 + r_c * r_a / (r_s * (r_c + r_a)))
    cs = 1.0 / (1.0 + r_s * r_a / (r_c * (r_s + r_a)))
    le = cc * pmc + cs * pms
    vdd0 = vdd + (desat * (rnet - g_soil) - (desat + gamma) * le) \
        * raa / (rho * CP_AIR)
    lec = (desat * (rnet - rnets) + rho * CP_AIR * vdd0 / rac) \
        / (desat + gamma * (1.0 + rsc / rac))
    les = (desat * (rnets - g_soil) + rho * CP_AIR * vdd0 / ras) \
        / (desat + gamma * (1.0 + rss / ras))
    qflx_tran_veg = lec * 1.0e3 / (RHOW * fd["lamb"])
    qflx_evap_grnd = les * 1.0e3 / (RHOW * fd["lamb"])
    evap_max1 = max(0.0, dz[0] * (theta[0] - WATMIN) / dt
                    - qflx_tran_veg * col.rootr[0])
    qflx_evap_grnd = min(evap_max1, qflx_evap_grnd)

    # Infiltration (HYDROLOGY.f90:426-478).
    eff_porosity = [max(0.01, ts_[i]) for i in range(nl)]
    qflx_in_soil = (qflx_top_soil - qflx_surf) - qflx_evap_grnd
    qinmax = (1.0 - fsat) * min(min(hk_[0], hk_[1]), hk_[2])
    qflx_infl_excess = max(0.0, qflx_in_soil - qinmax)
    qflx_infl = qflx_in_soil - qflx_infl_excess
    qflx_surf = qflx_surf + qflx_infl_excess

    # Soil water (HYDROLOGY.f90:489-905).
    zwtmm = 1000.0 * col.zwt
    jwt = _jwt(col.zwt, zi, nl)
    zq = (_equilibrium(col, zwtmm, geo, M) if held is None
          else list(held[0]))
    zq.append(_aquifer_zq(col, zwtmm, jwt, geo, M))

    hk = [0.0] * nl
    dhkdw = [0.0] * nl
    smp = [0.0] * nl
    dsmpdw = [0.0] * nl
    for i in range(nl):
        inext = min(nl - 1, i + 1)
        s1 = 0.5 * (theta[i] + theta[inext]) \
            / (0.5 * (ts_[i] + ts_[inext]))
        s1 = min(1.0, s1)
        s2 = hk_[i] * M.pow(s1, 2.0 * bs_[i] + 2.0)
        hk[i] = s1 * s2
        dhkdw[i] = (2.0 * bs_[i] + 3.0) * s2 * (1.0 / (ts_[i] + ts_[inext]))
        s_node = min(1.0, max(theta[i] / ts_[i], 0.01))
        smp[i] = max(SMPMIN, ps_[i] * M.pow(s_node, -bs_[i]))
        dsmpdw[i] = -bs_[i] * smp[i] / (s_node * ts_[i])

    zc[nl] = 0.5 * (zwtmm + zc[nl - 1])
    dz[nl] = dz[nl - 1] if jwt < nl else zwtmm - zc[nl - 1]

    amx = [0.0] * (nl + 1)
    bmx = [0.0] * (nl + 1)
    cmx = [0.0] * (nl + 1)
    rmx = [0.0] * (nl + 1)
    den = zc[1] - zc[0]
    num = (smp[1] - smp[0]) - (zq[1] - zq[0])
    qout = -hk[0] * num / den
    dqodw1 = -(-hk[0] * dsmpdw[0] + num * dhkdw[0]) / den
    dqodw2 = -(hk[0] * dsmpdw[1] + num * dhkdw[0]) / den
    rmx[0] = qflx_infl - qout - qflx_tran_veg * col.rootr[0]
    bmx[0] = dz[0] / dt + dqodw1
    cmx[0] = dqodw2
    for i in range(1, nl - 1):
        den = zc[i] - zc[i - 1]
        num = smp[i] - smp[i - 1] - (zq[i] - zq[i - 1])
        qin = -hk[i - 1] * num / den
        dqidw0 = -(-hk[i - 1] * dsmpdw[i - 1] + num * dhkdw[i - 1]) / den
        dqidw1 = -(hk[i - 1] * dsmpdw[i] + num * dhkdw[i - 1]) / den
        den = zc[i + 1] - zc[i]
        num = (smp[i + 1] - smp[i]) - (zq[i + 1] - zq[i])
        qout = -hk[i] * num / den
        dqodw1 = -(-hk[i] * dsmpdw[i] + num * dhkdw[i]) / den
        dqodw2 = -(hk[i] * dsmpdw[i + 1] + num * dhkdw[i]) / den
        rmx[i] = qin - qout - qflx_tran_veg * col.rootr[i]
        amx[i] = -dqidw0
        bmx[i] = dz[i] / dt - dqidw1 + dqodw1
        cmx[i] = dqodw2
    i = nl - 1
    den = zc[i] - zc[i - 1]
    num = smp[i] - smp[i - 1] - (zq[i] - zq[i - 1])
    qin = -hk[i - 1] * num / den
    dqidw0 = -(-hk[i - 1] * dsmpdw[i - 1] + num * dhkdw[i - 1]) / den
    dqidw1 = -(hk[i - 1] * dsmpdw[i] + num * dhkdw[i - 1]) / den
    if jwt < nl:
        rmx[i] = qin - 0.0 - qflx_tran_veg * col.rootr[i]
        amx[i] = -dqidw0
        bmx[i] = dz[i] / dt - dqidw1
        bmx[nl] = dz[nl] / dt
    else:
        s_node = min(1.0, max(0.5 * (1.0 + theta[i] / ts_[i]), 0.01))
        smp1 = max(SMPMIN, ps_[i] * M.pow(s_node, -bs_[i]))
        dsmpdw1 = -bs_[i] * smp1 / (s_node * ts_[i])
        den = zc[nl] - zc[i]
        num = smp1 - smp[i] - (zq[nl] - zq[i])
        qout = -hk[i] * num / den
        dqodw1 = -(-hk[i] * dsmpdw[i] + num * dhkdw[i]) / den
        dqodw2 = -(hk[i] * dsmpdw1 + num * dhkdw[i]) / den
        rmx[i] = qin - qout - qflx_tran_veg * col.rootr[i]
        amx[i] = -dqidw0
        bmx[i] = dz[i] / dt - dqidw1 + dqodw1
        cmx[i] = dqodw2
        rmx[nl] = qout
        amx[nl] = -dqodw1
        bmx[nl] = dz[nl] / dt - dqodw2

    # Thomas solve (HYDROLOGY.f90:806-837).
    gam = [0.0] * (nl + 1)
    dwat = [0.0] * (nl + 1)
    bet = bmx[0]
    dwat[0] = rmx[0] / bet
    for i in range(1, nl + 1):
        gam[i] = cmx[i - 1] / bet
        bet = bmx[i] - amx[i] * gam[i]
        dwat[i] = (rmx[i] - amx[i] * dwat[i - 1]) / bet
    for i in range(nl - 1, -1, -1):
        dwat[i] = dwat[i] - gam[i + 1] * dwat[i + 1]
    for i in range(nl):
        h[i] = h[i] + dwat[i] * dz[i]

    # Aquifer recharge (HYDROLOGY.f90:856-904).
    if jwt < nl:
        s1 = min(1.0, max(theta[jwt] / ts_[jwt], 0.01))
        ka = hk_[jwt] * M.pow(s1, 2.0 * bs_[jwt] + 3.0)
        j = max(0, jwt - 1)
        wh = max(SMPMIN, smp[j]) - zq[j]
        if jwt == 0:
            qcharge = -ka * (0.0 - wh) / (zwtmm + 1.0)
        else:
            qcharge = -ka * (0.0 - wh) / ((zwtmm - zc[jwt - 1]) * 2.0)
        qcharge = min(10.0 / dt, max(-10.0 / dt, qcharge))
    else:
        qcharge = dwat[nl] * dz[nl] / dt

    # Drainage (HYDROLOGY.f90:915-1212); the walks read the stale zwtmm.
    def s_y(layer, zmm):
        if held is not None:
            return held[1][layer]
        return _spec_yield(col, layer, zmm, M)

    rous = s_y(nl - 1, zwtmm)
    if jwt == nl:
        col.wa = col.wa + qcharge * dt
        col.zwt = col.zwt - (qcharge * dt) / 1000.0 / rous
    else:
        tot = qcharge * dt
        if tot > 0.0:
            for i in range(jwt, -1, -1):
                sy = s_y(i, zwtmm)
                ql = max(min(tot, sy * (zwtmm - zi[i])), 0.0)
                col.zwt = col.zwt - ql / sy / 1000.0
                tot = tot - ql
                if tot <= 0.0:
                    break
        else:
            for i in range(jwt, nl):
                sy = s_y(i, zwtmm)
                ql = min(max(tot, -sy * (zi[i + 1] - zwtmm)), 0.0)
                tot = tot - ql
                if tot >= 0.0:
                    col.zwt = col.zwt - ql / sy / 1000.0
                    break
                col.zwt = M.num(zi[i + 1] / 1000.0)
            if tot > 0.0:
                col.zwt = col.zwt - tot / 1000.0 / rous
        jwt = _jwt(col.zwt, zi, nl)

    # Baseflow (HYDROLOGY.f90:1015-1123).
    zwtmm = 1000.0 * col.zwt
    rsub_top = RSUB_TOP_MAX * M.exp(-FFF * max(col.zwt, -1.0))
    rous = s_y(nl - 1, zwtmm)
    if jwt == nl:
        col.wa = col.wa - rsub_top * dt
        col.zwt = col.zwt + (rsub_top * dt) / 1000.0 / rous
        h[nl - 1] = h[nl - 1] + max(0.0, col.wa - 5000.0)
        col.wa = min(col.wa, 5000.0)
    else:
        tot = -rsub_top * dt
        for i in range(jwt, nl):
            sy = s_y(i, zwtmm)
            ql = min(max(tot, -(sy * (zi[i + 1] - zwtmm))), 0.0)
            h[i] = h[i] + ql
            tot = tot - ql
            if tot >= 0.0:
                col.zwt = col.zwt - ql / sy / 1000.0
                break
            col.zwt = M.num(zi[i + 1] / 1000.0)
        col.zwt = col.zwt - tot / 1000.0 / rous
        col.wa = col.wa + tot
        jwt = _jwt(col.zwt, zi, nl)
    col.zwt = min(80.0, max(0.0, col.zwt))

    # Saturation excess, bottom-up, and the top layer's to drainage
    # (HYDROLOGY.f90:1131-1152).
    for i in range(nl - 1, 0, -1):
        cap = eff_porosity[i] * dz[i]
        xsi = max(h[i] - cap, 0.0)
        h[i] = min(cap, h[i])
        h[i - 1] = h[i - 1] + xsi
    cap0 = max(0.0, ts_[0] * dz[0])
    xs1 = max(max(h[0], 0.0) - cap0, 0.0)
    h[0] = min(cap0, h[0])
    qflx_rsub_sat = xs1 / dt

    # watmin floor: borrow from the layer below (HYDROLOGY.f90:1161-1174).
    for i in range(nl - 1):
        if h[i] < WATMIN:
            xs = WATMIN - h[i]
            if (i + 1) == jwt:
                col.zwt = col.zwt + xs / eff_porosity[i] / 1000.0
            h[i] = h[i] + xs
            h[i + 1] = h[i + 1] - xs

    # Bottom layer: search upward for water (HYDROLOGY.f90:1180-1211).
    i = nl - 1
    xs = 0.0
    if h[i] < WATMIN:
        xs = WATMIN - h[i]
        for j in range(nl - 2, -1, -1):
            available = max(h[j] - WATMIN - xs, 0.0)
            if available >= xs:
                h[i] = h[i] + xs
                h[j] = h[j] - xs
                xs = 0.0
                break
            h[i] = h[i] + available
            h[j] = h[j] - available
            xs = xs - available
    h[i] = h[i] + xs
    rsub_top = rsub_top - xs / dt

    w1 = (qflx_surf + qflx_evap_grnd + qflx_tran_veg + rsub_top
          + qflx_rsub_sat) * dt + col.wa + sum(h)
    col.smp = smp
    return dict(qflx_surf=qflx_surf, qflx_evap_grnd=qflx_evap_grnd,
                qflx_tran_veg=qflx_tran_veg, rsub_top=rsub_top,
                residual=w1 - w0)


def grow(col: Column, tas, geo: Geometry, M=F64):
    """A day of vegetation growth (GROW.f90, the seed-bank floors and the
    clamped warm side of DEVIATIONS.md #9); updates ``col``, returns the
    day's NPP (g DM)."""
    nl, zi = geo.nl, geo.zi
    w_i = 0.0
    for i in range(nl):
        wi_l = (-150000.0 - col.smp[i]) / (-150000.0 - (-50000.0))
        w_i = w_i + col.rootr[i] * min(1.0, max(0.0, wi_l))
    d = tas - TF
    if d > 18.0:
        warm = abs(d - 18.0) / 21.0
        f_t = max(0.0, 1.0 - warm * warm)
    else:
        cool = abs(d - 18.0) / 25.0
        f_t = min(1.0, max(0.0, 1.0 - cool * cool))
    grow_pm = (1000.0 / 365.0) * w_i * f_t
    grow_fm = grow_pm / 3.3
    loss_pm = (0.1 / 365.0) * col.plant_mass
    loss_fm = (1.0 / 365.0) * col.plant_foliage_mass \
        / min(1.0, max(0.01, w_i))
    if w_i < 0.6:
        loss_fm = 0.1 * col.plant_foliage_mass
    dpm = grow_pm - loss_pm
    dfm = grow_fm - loss_fm
    col.plant_mass = max(1.0e-3, col.plant_mass + dpm)
    col.plant_foliage_mass = max(1.0e-5, col.plant_foliage_mass + dfm)
    plant_length = M.pow(400.0 * col.plant_mass / 3.142e-3, 1.0 / 3.0)
    dlai = dfm * SLA
    col.lai = max(0.001, col.lai + dlai)
    col.lai_litter = col.lai_litter + max(0.0, dlai)
    decay = M.exp(math.log(0.1) / (max(0.3 * plant_length, 1.0) / 10.0))
    col.rootr = [M.pow(decay, zi[i] / 10.0) - M.pow(decay, zi[i + 1] / 10.0)
                 for i in range(nl)]
    col.lai_litter = col.lai_litter - 0.02 * col.lai_litter
    return dpm


def _thomas(a, b, c, r):
    n = len(b)
    gam = [0.0] * n
    x = [0.0] * n
    bet = b[0]
    x[0] = r[0] / bet
    for i in range(1, n):
        gam[i] = c[i - 1] / bet
        bet = b[i] - a[i] * gam[i]
        x[i] = (r[i] - a[i] * x[i - 1]) / bet
    for i in range(n - 2, -1, -1):
        x[i] = x[i] - gam[i + 1] * x[i + 1]
    return x


def soil_heat(col: Column, lai0, f: dict, geo: Geometry, M=F64):
    """The day's soil-heat step (soiltemp.soil_temperature_step with the
    apparent-capacity band of 2 K, driven as step._soil_thermal drives it
    without soil ice): ``lai0`` is the day-start LAI."""
    nl = geo.nl
    tas = M.num(f["tas"])
    t2 = tas * tas
    rnet = 0.92 * M.num(f["rsds"]) + M.num(f["rlds"]) - STBO * (t2 * t2)
    g_flux = 0.2 * rnet * M.exp(-0.7 * lai0)
    raa = (0.25 * lai0 * 42.0 + 0.25 * (4.0 - lai0) * 34.0
           if lai0 <= 4.0 else 42.0)
    h_surf = (M.num(f["ps"]) / (RGAS * tas)) * CP_AIR / max(raa, 1.0)
    dz = [geo.dz[i] / 1000.0 for i in range(nl)]
    zc = [geo.zc[i] / 1000.0 for i in range(nl)]
    th = [col.h[i] / (geo.dz[i] * RHOW / 1.0e3) for i in range(nl)]
    ts = col.theta_s
    t = col.t_soil
    k_l = [K_DRY + (K_SAT - K_DRY) * min(1.0, max(0.0, th[i] / ts[i]))
           for i in range(nl)]
    cv = [C_SOLID * (1.0 - ts[i]) + C_WATER * th[i] for i in range(nl)]
    g_if = [0.5 * (k_l[i] + k_l[i + 1]) / (zc[i + 1] - zc[i])
            for i in range(nl - 1)]

    def solve(cv_eff):
        a, b, c, r = [], [], [], []
        for i in range(nl):
            diag = cv_eff[i] * dz[i] / SDAY
            rhs = diag * t[i]
            bi = diag
            if i > 0:
                bi = bi + g_if[i - 1]
            if i < nl - 1:
                bi = bi + g_if[i]
            if i == 0:
                rhs = rhs + g_flux
                bi = bi + h_surf
                rhs = rhs + h_surf * tas
            a.append(-g_if[i - 1] if i > 0 else 0.0)
            b.append(bi)
            c.append(-g_if[i] if i < nl - 1 else 0.0)
            r.append(rhs)
        return _thomas(a, b, c, r)

    t_new = solve(cv)
    cv_aug = []
    for i in range(nl):
        crosses = (min(t[i], t_new[i]) < TF
                   and max(t[i], t_new[i]) > TF - LATENT_RAMP)
        cv_aug.append(cv[i] + (RHOW * LFUS * th[i] / LATENT_RAMP
                               if crosses else 0.0))
    col.t_soil = solve(cv_aug)


def run_day(col: Column, f: dict, geo: Geometry, nisurf: int,
            zd09_every: int, M=F64) -> dict:
    """One model day of the ensemble and assimilation paths: ``nisurf``
    hydrology substeps, growth, soil heat.  Returns the day's ``evap``,
    ``runoff`` (mm), ``npp`` (g DM) and ``max_residual`` (mm)."""
    dt = SDAY / nisurf
    fd = derived_forcing(f, M)
    lai0 = col.lai
    evap = runoff = 0.0
    max_res = 0.0
    held = None
    for it in range(nisurf):
        if zd09_every > 1 and it % zd09_every == 0:
            held = refresh(col, geo, M)
        fx = substep(col, fd, geo, dt, held, M)
        evap = evap + (fx["qflx_evap_grnd"] + fx["qflx_tran_veg"]) * dt
        runoff = runoff + (fx["qflx_surf"] + fx["rsub_top"]) * dt
        max_res = max(max_res, abs(float(fx["residual"])))
    npp = grow(col, fd["tak"], geo, M)
    soil_heat(col, lai0, f, geo, M)
    return dict(evap=evap, runoff=runoff, npp=npp, max_residual=max_res)


def enkf_cell(members: list, y_pred: list, obs, observed: bool,
              obs_err_std: float, rtps: float, theta: list,
              theta_bounds: tuple, geo: Geometry, M=F64) -> list:
    """The analysis of one cell's members (assimilate.
    enkf_update_scalar_obs and _enkf_cycle's guards): the augmented state
    is each layer's water, the aquifer store and the hksat
    log-multiplier; an unobserved cell keeps them as they are.  The
    guards and the matric potential from the analysed water apply to
    every cell.  Updates ``members`` (Columns) in place and returns the
    analysed log-multipliers."""
    m = len(members)
    nl = geo.nl
    layers = [[col.h[i] for col in members] for i in range(nl)]
    wa = [col.wa for col in members]
    theta_a = list(theta)
    if observed:
        y_mean = sum(y_pred) / m
        dy = [y - y_mean for y in y_pred]
        r = obs_err_std ** 2
        denom = sum(d * d for d in dy) / (m - 1) + r
        sqrt_fac = 1.0 / (1.0 + M.sqrt(r / denom))
        innov = obs - y_mean

        def update(x):
            mean = sum(x) / m
            dx = [v - mean for v in x]
            gain = (sum(a * b for a, b in zip(dy, dx)) / (m - 1)) / denom
            dx_a = [d - (sqrt_fac * gain) * e for d, e in zip(dx, dy)]
            sig_f = M.sqrt(sum(d * d for d in dx) / (m - 1))
            sig_a = M.sqrt(sum(d * d for d in dx_a) / (m - 1))
            relax = 1.0 + rtps * (sig_f - sig_a) / max(sig_a, 1.0e-12)
            return [(mean + gain * innov) + d * relax for d in dx_a]

        layers = [update(x) for x in layers]
        wa = update(wa)
        theta_a = update(theta_a)
    for k, col in enumerate(members):
        col.h = [max(layers[i][k], 1.0e-3) for i in range(nl)]
        col.wa = min(5000.0, max(0.0, wa[k]))
        for i in range(nl):
            s_node = min(1.0, max((col.h[i] / geo.dz[i]) / col.theta_s[i],
                                  0.01))
            col.smp[i] = max(col.psi_s[i] * M.pow(s_node, -col.bsw[i]),
                             SMPMIN)
    lo, hi = theta_bounds
    return [min(hi, max(lo, t)) for t in theta_a]
