"""Water-table update, baseflow and soil-moisture fix-ups.

Port of ``hybrid9_tpu/physics/drainage.py`` (reference: SOURCE/
HYDROLOGY.f90:911-1216).  The reference's layer walks with early EXITs
become fixed sweeps with per-cell "active" masks.  The reference's quirks
are kept: the walks use the stale ``zwtmm``, and jwt is not recomputed
after the below-column recharge branch.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from . import bounds
from . import constants as c
from .soilwater import water_table_index


class DrainageResult(NamedTuple):
    h2osoi: List[torch.Tensor]   # nl x [n] layer water after fix-ups  (mm)
    zwt: torch.Tensor            # [n] water table depth                (m)
    wa: torch.Tensor             # [n] aquifer store                   (mm)
    rsub_top: torch.Tensor       # [n] topographic baseflow          (mm/s)
    qflx_rsub_sat: torch.Tensor  # [n] saturation-excess drainage    (mm/s)
    rnff: List[torch.Tensor]     # nl+1 x [n] per-layer drainage diagnostic


def _specific_yield(theta_s_l: torch.Tensor, psi_s_l: torch.Tensor,
                    bsw_l: torch.Tensor, zwtmm: torch.Tensor
                    ) -> torch.Tensor:
    """Analytical specific yield, floored at 0.02 (HYDROLOGY.f90:
    937-941)."""
    s_y = theta_s_l * (1.0 - (1.0 + zwtmm / (-psi_s_l)) ** (-1.0 / bsw_l))
    return bounds.maximum(s_y, 0.02)


def compute_specific_yields(zwt: torch.Tensor, theta_s: List[torch.Tensor],
                            psi_s: List[torch.Tensor],
                            bsw: List[torch.Tensor]) -> List[torch.Tensor]:
    """Per-layer specific-yield profile at the current water table, for
    the ``zd09_every`` refresh of the substep loops.  Every water move in
    the walks is remainder-accounted, so a stale profile leaves mass
    conservation exact."""
    zwtmm = 1000.0 * zwt
    return [_specific_yield(theta_s[i], psi_s[i], bsw[i], zwtmm)
            for i in range(len(theta_s))]


def drainage(h2osoi: List[torch.Tensor], zwt: torch.Tensor,
             wa: torch.Tensor, qcharge: torch.Tensor,
             theta_s: List[torch.Tensor], psi_s: List[torch.Tensor],
             bsw: List[torch.Tensor], eff_porosity: List[torch.Tensor],
             zi, dz_soil, dt: float,
             s_y_prof: List[torch.Tensor] = None) -> DrainageResult:
    """Drainage phase for all cells; returns updated state and fluxes.

    ``s_y_prof`` optionally supplies a precomputed specific-yield profile
    (:func:`compute_specific_yields`) that replaces BOTH per-substep
    evaluations (the stale-table set and the post-recharge set).
    """
    nl = len(h2osoi)
    h = list(h2osoi)

    # --- Water-table response to recharge (HYDROLOGY.f90:920-1009) -------
    zwtmm = 1000.0 * zwt                       # stale during the walks
    jwt = water_table_index(zwt, zi)
    below = jwt == nl
    in_col = ~below
    s_y_stale = s_y_prof if s_y_prof is not None else [
        _specific_yield(theta_s[i], psi_s[i], bsw[i], zwtmm)
        for i in range(nl)]
    rous = s_y_stale[nl - 1]

    # Below the column: recharge moves the aquifer store directly.
    wa_b = wa + qcharge * dt
    zwt_b = zwt - (qcharge * dt) / 1000.0 / rous

    # Inside the column: walk layers to re-locate the table.
    qtot = qcharge * dt
    rising = in_col & (qtot > 0.0)
    falling = in_col & (qtot <= 0.0)

    zwt_w = zwt
    # Rising walk (HYDROLOGY.f90:961-973).
    rem = torch.where(rising, qtot, 0.0)
    for i in range(nl - 1, -1, -1):
        act = rising & (jwt >= i) & (rem > 0.0)
        s_y = s_y_stale[i]
        ql = bounds.maximum(torch.minimum(rem, s_y * (zwtmm - zi[i])), 0.0)
        zwt_w = torch.where(act, zwt_w - ql / s_y / 1000.0, zwt_w)
        rem = torch.where(act, rem - ql, rem)

    # Falling walk (HYDROLOGY.f90:977-994).
    rem_f = torch.where(falling, qtot, 0.0)
    for i in range(nl):
        act = falling & (jwt <= i) & (rem_f < 0.0)
        s_y = s_y_stale[i]
        ql = bounds.minimum(torch.maximum(rem_f, -s_y * (zi[i + 1] - zwtmm)),
                            0.0)
        rem_new = rem_f - ql
        zwt_w = torch.where(
            act,
            torch.where(rem_new >= 0.0, zwt_w - ql / s_y / 1000.0,
                        zi[i + 1] / 1000.0),
            zwt_w)
        rem_f = torch.where(act, rem_new, rem_f)
    # Residual guard kept for faithfulness (HYDROLOGY.f90:993-994).
    zwt_w = torch.where(falling & (rem_f > 0.0),
                        zwt_w - rem_f / 1000.0 / rous, zwt_w)

    zwt1 = torch.where(below, zwt_b, zwt_w)
    wa1 = torch.where(below, wa_b, wa)
    # The reference recomputes jwt only in the in-column branch
    # (HYDROLOGY.f90:997-1007).
    jwt1 = torch.where(below, jwt, water_table_index(zwt1, zi))

    # --- Baseflow (HYDROLOGY.f90:1013-1123) -------------------------------
    zwtmm1 = 1000.0 * zwt1
    # The exp argument is guarded against pathological negative tables.
    rsub_top = c.RSUB_TOP_MAX * torch.exp(
        -c.FFF * bounds.maximum(zwt1, -1.0))
    s_y_1 = s_y_prof if s_y_prof is not None else [
        _specific_yield(theta_s[i], psi_s[i], bsw[i], zwtmm1)
        for i in range(nl)]
    rous1 = s_y_1[nl - 1]
    below1 = jwt1 == nl
    in_col1 = ~below1
    zero = torch.zeros_like(zwt)
    rnff: List[torch.Tensor] = [zero] * (nl + 1)

    # Below the column: drain the aquifer; spill any excess over 5000 mm
    # into the bottom soil layer.
    wa_tmp = wa1 - rsub_top * dt
    zwt_b1 = zwt1 + (rsub_top * dt) / 1000.0 / rous1
    spill = bounds.maximum(wa_tmp - 5000.0, 0.0)
    h[nl - 1] = h[nl - 1] + torch.where(below1, spill, 0.0)
    wa_b1 = bounds.minimum(wa_tmp, 5000.0)
    rnff[nl] = torch.where(below1, rsub_top, 0.0)

    # Inside the column: remove baseflow from saturated layers, walking
    # down with an activity mask (HYDROLOGY.f90:1064-1103).
    rem_b = torch.where(in_col1, -rsub_top * dt, 0.0)
    zwt_w1 = zwt1
    for i in range(nl):
        act = in_col1 & (jwt1 <= i) & (rem_b < 0.0)
        s_y = s_y_1[i]
        ql = bounds.minimum(
            torch.maximum(rem_b, -(s_y * (zi[i + 1] - zwtmm1))), 0.0)
        h[i] = h[i] + torch.where(act, ql, 0.0)
        rnff[i] = torch.where(act, -ql, rnff[i])
        rem_new = rem_b - ql
        zwt_w1 = torch.where(
            act,
            torch.where(rem_new >= 0.0, zwt_w1 - ql / s_y / 1000.0,
                        zi[i + 1] / 1000.0),
            zwt_w1)
        rem_b = torch.where(act, rem_new, rem_b)
    # Residual baseflow comes out of the aquifer (HYDROLOGY.f90:1100-1102).
    zwt_w1 = torch.where(in_col1, zwt_w1 - rem_b / 1000.0 / rous1, zwt_w1)
    wa2 = torch.where(below1, wa_b1, wa1 + rem_b)
    rnff[nl] = rnff[nl] + torch.where(in_col1, -rem_b, 0.0)

    zwt2 = torch.where(below1, zwt_b1, zwt_w1)
    jwt2 = torch.where(below1, jwt1, water_table_index(zwt2, zi))

    # Clamps (HYDROLOGY.f90:1122-1123).
    zwt2 = bounds.clip(zwt2, 0.0, 80.0)

    # --- Saturation-excess bucket cascade, bottom-up
    # (HYDROLOGY.f90:1131-1137).
    for i in range(nl - 1, 0, -1):
        cap = eff_porosity[i] * dz_soil[i]
        xsi = bounds.maximum(h[i] - cap, 0.0)
        h[i] = torch.minimum(cap, h[i])
        h[i - 1] = h[i - 1] + xsi

    # Top-layer excess to drainage (HYDROLOGY.f90:1144-1152).
    cap0 = bounds.maximum(theta_s[0] * dz_soil[0], 0.0)
    xs1 = bounds.maximum(bounds.maximum(h[0], 0.0) - cap0, 0.0)
    h[0] = torch.minimum(cap0, h[0])
    qflx_rsub_sat = xs1 / dt

    # --- watmin floor: borrow from the layer below
    # (HYDROLOGY.f90:1161-1174).  Fortran layer number i+1 vs jwt.
    for i in range(nl - 1):
        short = h[i] < c.WATMIN
        xs = torch.where(short, c.WATMIN - h[i], 0.0)
        zwt2 = zwt2 + torch.where(short & (jwt2 == i + 1),
                                  xs / eff_porosity[i] / 1000.0, 0.0)
        h[i] = h[i] + xs
        h[i + 1] = h[i + 1] - xs

    # --- Bottom layer: search upward for water (HYDROLOGY.f90:1180-1211).
    xs = torch.where(h[nl - 1] < c.WATMIN, c.WATMIN - h[nl - 1], 0.0)
    for j in range(nl - 2, -1, -1):
        avail = bounds.maximum(h[j] - c.WATMIN - xs, 0.0)
        take = torch.minimum(xs, avail)
        h[nl - 1] = h[nl - 1] + take
        h[j] = h[j] - take
        xs = xs - take
    # Any un-met deficit is created and taken back out of drainage
    # (HYDROLOGY.f90:1204-1211).
    h[nl - 1] = h[nl - 1] + xs
    rsub_top = rsub_top - xs / dt

    return DrainageResult(h2osoi=h, zwt=zwt2, wa=wa2,
                          rsub_top=rsub_top, qflx_rsub_sat=qflx_rsub_sat,
                          rnff=rnff)
