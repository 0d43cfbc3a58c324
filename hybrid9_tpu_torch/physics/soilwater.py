"""Vertical soil-water movement: ZD09 equilibrium + batched Richards solve.

Port of ``hybrid9_tpu/physics/soilwater.py`` (reference: SOURCE/
HYDROLOGY.f90:485-909): Zeng & Decker (2009) equilibrium profile,
Clapp-Hornberger matric potentials, tridiagonal assembly (O13 Eqns
7.116-7.141) and a Thomas solve with one refinement step.  Every branch
of the reference is a ``torch.where`` select over guarded operands, and
per-layer fields are Python lists of ``[n]`` tensors (layers.py).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from . import constants as c
from .layers import select_layer


class SoilWaterResult(NamedTuple):
    h2osoi: List[torch.Tensor]   # nl x [n] updated layer water        (mm)
    smp: List[torch.Tensor]      # nl x [n] matric potential (carry)   (mm)
    qcharge: torch.Tensor        # [n] aquifer recharge              (mm/s)
    jwt: torch.Tensor            # [n] int32 first-unsaturated index    (-)
    dwat_aq: torch.Tensor        # [n] aquifer-layer solution increment (-)


def water_table_index(zwt: torch.Tensor, zi) -> torch.Tensor:
    """jwt: number of soil interfaces strictly above the water table
    (0 when the table is in the top layer, nl when below the column;
    HYDROLOGY.f90:499-508)."""
    jwt = None
    for i in range(1, len(zi) - 1):
        above = (zwt > zi[i] / 1000.0).to(torch.int32)
        jwt = above if jwt is None else jwt + above
    return jwt


def _equilibrium_profile(zwtmm: torch.Tensor, jwt: torch.Tensor,
                         theta_s: List[torch.Tensor],
                         psi_s: List[torch.Tensor], bsw: List[torch.Tensor],
                         zi) -> List[torch.Tensor]:
    """Zeng & Decker (2009) equilibrium potential ``zq`` per layer.

    Returns nl+1 ``[n]`` tensors (last = virtual aquifer layer, valid
    only where jwt == nl).  Reference: HYDROLOGY.f90:512-590.
    """
    nl = len(theta_s)
    zq: List[torch.Tensor] = []
    for i in range(nl):
        ts, ps, bs = theta_s[i], psi_s[i], bsw[i]
        zlo, zhi = zi[i], zi[i + 1]
        mask_sat = zwtmm <= zlo
        mask_in = (zwtmm < zhi) & (zwtmm > zlo)
        mask_below = ~(mask_sat | mask_in)
        expo = 1.0 - 1.0 / bs
        neg_psi = -ps

        # One shared pow serves the "inside" and "below" branches.
        base_lo = torch.where(mask_in | mask_below,
                              (neg_psi + zwtmm - zlo) / neg_psi, 1.0)
        temp0_lo = base_lo ** expo

        # Table inside the layer.
        den_in = torch.where(mask_in, zwtmm - zlo, 1.0)
        voleq1 = ps * ts / (1.0 - 1.0 / bs) / den_in * (1.0 - temp0_lo)
        vol_in = (voleq1 * (zwtmm - zlo) + ts * (zhi - zwtmm)) \
            / (zhi - zlo)
        vol_in = torch.clamp(torch.minimum(ts, vol_in), min=0.0)

        # Table below the layer: closed-form layer average.
        base_hi = torch.where(mask_below,
                              (neg_psi + zwtmm - zhi) / neg_psi, 1.0)
        vol_below = ps * ts / (1.0 - 1.0 / bs) / (zhi - zlo) \
            * (base_hi ** expo - temp0_lo)
        vol_below = torch.minimum(ts, torch.clamp(vol_below, min=0.0))

        vol_eq = torch.where(mask_sat, ts,
                             torch.where(mask_in, vol_in, vol_below))
        zq_i = ps * torch.clamp(vol_eq / ts, min=0.01) ** (-bs)
        zq.append(torch.clamp(zq_i, min=c.SMPMIN))

    zq.append(_aquifer_zq(zwtmm, jwt, theta_s[-1], psi_s[-1], bsw[-1],
                          zi, nl))
    return zq


def _aquifer_zq(zwtmm: torch.Tensor, jwt: torch.Tensor,
                tsl: torch.Tensor, psl: torch.Tensor, bl: torch.Tensor,
                zi, nl: int) -> torch.Tensor:
    """Virtual aquifer-layer equilibrium potential ``zq[nl]``.

    ZERO where ``jwt < nl``, so it is discontinuous in zwt at the column
    bottom and must never be served stale (see soil_water_update).
    """
    maskq = jwt == nl
    base_aq = torch.where(maskq, (-psl + zwtmm - zi[nl]) / (-psl), 1.0)
    temp0_aq = base_aq ** (1.0 - 1.0 / bl)
    den_aq = torch.where(maskq, zwtmm - zi[nl], 1.0)
    vol_aq = psl * tsl / (1.0 - 1.0 / bl) / den_aq * (1.0 - temp0_aq)
    vol_aq = torch.minimum(tsl, torch.clamp(vol_aq, min=0.0))
    zq_aq = torch.clamp(psl * torch.clamp(vol_aq / tsl, min=0.01) ** (-bl),
                        min=c.SMPMIN)
    return torch.where(maskq, zq_aq, 0.0)


def compute_equilibrium_zq(zwt: torch.Tensor, theta_s: List[torch.Tensor],
                           psi_s: List[torch.Tensor],
                           bsw: List[torch.Tensor],
                           zi) -> List[torch.Tensor]:
    """Standalone ZD09 equilibrium profile for a given water table, for
    the ``zd09_every`` refresh of the substep loops."""
    zwtmm = 1000.0 * zwt
    jwt = water_table_index(zwt, zi)
    return _equilibrium_profile(zwtmm, jwt, theta_s, psi_s, bsw, zi)


def _conductivity_and_potential(theta: List[torch.Tensor],
                                theta_s: List[torch.Tensor],
                                hksat: List[torch.Tensor],
                                psi_s: List[torch.Tensor],
                                bsw: List[torch.Tensor],
                                imp: Optional[List[torch.Tensor]] = None):
    """Interface conductivity, matric potential and their derivatives
    (HYDROLOGY.f90:598-639).  Returns (hk, dhkdw, smp, dsmpdw)."""
    nl = len(theta)
    hk, dhkdw, smp, dsmpdw = [], [], [], []
    for i in range(nl):
        inext = min(nl - 1, i + 1)
        s1 = 0.5 * (theta[i] + theta[inext]) \
            / (0.5 * (theta_s[i] + theta_s[inext]))
        s1 = torch.clamp(s1, max=1.0)
        s2 = hksat[i] * s1 ** (2.0 * bsw[i] + 2.0)
        if imp is not None:
            s2 = s2 * torch.minimum(imp[i], imp[inext])
        hk.append(s1 * s2)
        dhkdw.append((2.0 * bsw[i] + 3.0) * s2
                     * (1.0 / (theta_s[i] + theta_s[inext])))
        s_node = torch.clamp(theta[i] / theta_s[i], 0.01, 1.0)
        smp_i = torch.clamp(psi_s[i] * s_node ** (-bsw[i]), min=c.SMPMIN)
        smp.append(smp_i)
        dsmpdw.append(-bsw[i] * smp_i / (s_node * theta_s[i]))
    return hk, dhkdw, smp, dsmpdw


def _thomas_solve(a: List[torch.Tensor], b: List[torch.Tensor],
                  cc: List[torch.Tensor], r: List[torch.Tensor]
                  ) -> List[torch.Tensor]:
    """Batched Thomas algorithm, unrolled over the layers
    (HYDROLOGY.f90:806-837, Press et al. 1989 §2.6)."""
    n_eq = len(b)
    bet = b[0]
    dw = [r[0] / bet]
    gam: List[torch.Tensor] = [torch.zeros_like(bet)]
    for i in range(1, n_eq):
        g = cc[i - 1] / bet
        bet = b[i] - a[i] * g
        dw.append((r[i] - a[i] * dw[i - 1]) / bet)
        gam.append(g)
    for i in range(n_eq - 2, -1, -1):
        dw[i] = dw[i] - gam[i + 1] * dw[i + 1]
    return dw


def _tridiag_matvec(a: List[torch.Tensor], b: List[torch.Tensor],
                    cc: List[torch.Tensor], x: List[torch.Tensor]
                    ) -> List[torch.Tensor]:
    """y = T x for the tridiagonal (a: sub, b: diag, cc: super)."""
    n_eq = len(b)
    y = []
    for i in range(n_eq):
        yi = b[i] * x[i]
        if i > 0:
            yi = yi + a[i] * x[i - 1]
        if i < n_eq - 1:
            yi = yi + cc[i] * x[i + 1]
        y.append(yi)
    return y


def _thomas_solve_refined(a, b, cc, r) -> List[torch.Tensor]:
    """Thomas solve plus one step of iterative refinement: without it
    f32 loses 3-4 digits near the SMPMIN clamp (DEVIATIONS.md #8)."""
    dw = _thomas_solve(a, b, cc, r)
    t_dw = _tridiag_matvec(a, b, cc, dw)
    resid = [r[i] - t_dw[i] for i in range(len(r))]
    err = _thomas_solve(a, b, cc, resid)
    return [dw[i] + err[i] for i in range(len(dw))]


def soil_water_update(h2osoi: List[torch.Tensor],
                      theta: List[torch.Tensor],
                      zwt: torch.Tensor, theta_s: List[torch.Tensor],
                      hksat: List[torch.Tensor], psi_s: List[torch.Tensor],
                      bsw: List[torch.Tensor], qflx_infl: torch.Tensor,
                      qflx_tran_veg: torch.Tensor,
                      rootr: List[torch.Tensor], zi, dz_soil, zc_soil,
                      dt: float,
                      imp: Optional[List[torch.Tensor]] = None,
                      zq: Optional[List[torch.Tensor]] = None
                      ) -> SoilWaterResult:
    """One implicit vertical soil-water step for all cells.

    ``zi``, ``dz_soil``, ``zc_soil`` are static geometry (mm, Python
    floats); ``imp`` the optional frozen-soil impedance per layer; ``zq``
    an optionally precomputed ZD09 profile (:func:`compute_equilibrium_zq`)
    whose aquifer entry is recomputed fresh here.
    """
    nl = len(h2osoi)
    zwtmm = 1000.0 * zwt
    jwt = water_table_index(zwt, zi)
    in_col = jwt < nl          # water table inside the soil column
    below = ~in_col

    if zq is None:
        zq = _equilibrium_profile(zwtmm, jwt, theta_s, psi_s, bsw, zi)
    else:
        # The cached per-layer entries are continuous in zwt; the
        # branch-gated aquifer entry is not, so it is always fresh.
        zq = list(zq[:nl]) + [_aquifer_zq(zwtmm, jwt, theta_s[-1],
                                          psi_s[-1], bsw[-1], zi, nl)]
    hk, dhkdw, smp, dsmpdw = _conductivity_and_potential(
        theta, theta_s, hksat, psi_s, bsw, imp)

    # Aquifer-layer geometry (HYDROLOGY.f90:643-650).
    zc_aq = 0.5 * (zwtmm + zc_soil[nl - 1])
    dz_aq = torch.where(in_col, dz_soil[nl - 1], zwtmm - zc_soil[nl - 1])

    # --- Tridiagonal assembly (O13 7.116-7.141) ---------------------------
    a: List[torch.Tensor] = [None] * (nl + 1)  # type: ignore
    b: List[torch.Tensor] = [None] * (nl + 1)  # type: ignore
    cc: List[torch.Tensor] = [None] * (nl + 1)  # type: ignore
    r: List[torch.Tensor] = [None] * (nl + 1)  # type: ignore

    # Top layer.
    den = zc_soil[1] - zc_soil[0]
    num = (smp[1] - smp[0]) - (zq[1] - zq[0])
    qout0 = -hk[0] * num / den
    dqodw1 = -(-hk[0] * dsmpdw[0] + num * dhkdw[0]) / den
    dqodw2 = -(hk[0] * dsmpdw[1] + num * dhkdw[0]) / den
    r[0] = qflx_infl - qout0 - qflx_tran_veg * rootr[0]
    a[0] = torch.zeros_like(qflx_infl)
    b[0] = dz_soil[0] / dt + dqodw1
    cc[0] = dqodw2

    # Interior layers.
    for i in range(1, nl - 1):
        den_in = zc_soil[i] - zc_soil[i - 1]
        num_in = smp[i] - smp[i - 1] - (zq[i] - zq[i - 1])
        qin_i = -hk[i - 1] * num_in / den_in
        dqidw0 = -(-hk[i - 1] * dsmpdw[i - 1]
                   + num_in * dhkdw[i - 1]) / den_in
        dqidw1 = -(hk[i - 1] * dsmpdw[i]
                   + num_in * dhkdw[i - 1]) / den_in
        den_out = zc_soil[i + 1] - zc_soil[i]
        num_out = (smp[i + 1] - smp[i]) - (zq[i + 1] - zq[i])
        qout_i = -hk[i] * num_out / den_out
        dqodw1 = -(-hk[i] * dsmpdw[i] + num_out * dhkdw[i]) / den_out
        dqodw2 = -(hk[i] * dsmpdw[i + 1] + num_out * dhkdw[i]) / den_out
        r[i] = qin_i - qout_i - qflx_tran_veg * rootr[i]
        a[i] = -dqidw0
        b[i] = dz_soil[i] / dt - dqidw1 + dqodw1
        cc[i] = dqodw2

    # Bottom soil layer and aquifer layer: two variants selected per
    # cell on water-table position (HYDROLOGY.f90:712-799).
    i = nl - 1
    den_in = zc_soil[i] - zc_soil[i - 1]
    num_in = smp[i] - smp[i - 1] - (zq[i] - zq[i - 1])
    qin_bot = -hk[i - 1] * num_in / den_in
    dqidw0 = -(-hk[i - 1] * dsmpdw[i - 1]
               + num_in * dhkdw[i - 1]) / den_in
    dqidw1 = -(hk[i - 1] * dsmpdw[i]
               + num_in * dhkdw[i - 1]) / den_in

    # Variant B (table below the column): aquifer coupling.
    s_node_aq = torch.clamp(0.5 * (1.0 + theta[i] / theta_s[i]), 0.01, 1.0)
    smp_aq = torch.clamp(psi_s[i] * s_node_aq ** (-bsw[i]), min=c.SMPMIN)
    dsmpdw_aq = -bsw[i] * smp_aq / (s_node_aq * theta_s[i])
    den_b = torch.where(below, zc_aq - zc_soil[i], 1.0)
    num_b = smp_aq - smp[i] - (zq[nl] - zq[i])
    qout_b = -hk[i] * num_b / den_b
    dqodw1_b = -(-hk[i] * dsmpdw[i] + num_b * dhkdw[i]) / den_b
    dqodw2_b = -(hk[i] * dsmpdw_aq + num_b * dhkdw[i]) / den_b

    qout_bot = torch.where(below, qout_b, 0.0)
    r[i] = qin_bot - qout_bot - qflx_tran_veg * rootr[i]
    a[i] = -dqidw0
    b[i] = torch.where(below,
                       dz_soil[i] / dt - dqidw1 + dqodw1_b,
                       dz_soil[i] / dt - dqidw1)
    cc[i] = torch.where(below, dqodw2_b, 0.0)

    r[nl] = torch.where(below, qout_b, 0.0)
    a[nl] = torch.where(below, -dqodw1_b, 0.0)
    b[nl] = torch.where(below, dz_aq / dt - dqodw2_b, dz_aq / dt)
    cc[nl] = torch.zeros_like(dz_aq)

    # --- Thomas solve and state update ------------------------------------
    dw = _thomas_solve_refined(a, b, cc, r)
    h2osoi_new = [h2osoi[i] + dw[i] * dz_soil[i] for i in range(nl)]

    # --- Aquifer recharge (HYDROLOGY.f90:856-904) -------------------------
    th_j = select_layer(theta, jwt, fill=1.0)
    ts_j = select_layer(theta_s, jwt, fill=1.0)
    hk_j = select_layer(hksat, jwt, fill=0.0)
    b_j = select_layer(bsw, jwt, fill=1.0)
    s1q = torch.clamp(th_j / ts_j, 0.01, 1.0)
    ka = hk_j * s1q ** (2.0 * b_j + 3.0)
    jm = torch.clamp(jwt - 1, min=0)
    smp_jm = select_layer(smp, jm, fill=0.0)
    zq_jm = select_layer(zq[:nl], jm, fill=0.0)
    wh = torch.clamp(smp_jm, min=c.SMPMIN) - zq_jm
    zc_jm = select_layer([torch.full_like(zwtmm, zc_soil[i])
                          for i in range(nl)], jm, fill=0.0)
    den_q = torch.where(jwt == 0, zwtmm + 1.0, (zwtmm - zc_jm) * 2.0)
    qcharge_in = torch.clamp(-ka * (0.0 - wh) / den_q,
                             -10.0 / dt, 10.0 / dt)
    qcharge_below = dw[nl] * dz_aq / dt
    qcharge = torch.where(in_col, qcharge_in, qcharge_below)

    return SoilWaterResult(h2osoi=h2osoi_new, smp=smp, qcharge=qcharge,
                           jwt=jwt, dwat_aq=dw[nl])
