"""Snowpack: daily rain/snow partition and melt, in two schemes.

Port of ``hybrid9_tpu/physics/snow.py``.  Precipitation partitions
linearly between snow and rain across the air temperature ramp
``[TF - 1, TF + 3]`` K, and melt plus rain feed the hydrology substeps as
effective rainfall.  Both schemes run once per day on ``[n]`` fields
outside the day kernel (``Config.snow_scheme``):

- ``"degree-day"`` (:func:`snow_step`): one SWE store melting at
  ``ddf * (tas - TF)`` mm per day; ``swe' - swe + rain_eff + capped =
  pr``.
- ``"twolayer"`` (:func:`snow_step_two_layer`): surface and base layers
  with prognostic temperatures (cold content), liquid retention and
  refreeze; ``d(ice + liquid) + outflow + capped = pr``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from . import constants as c


@dataclasses.dataclass(frozen=True)
class SnowParams:
    """Static snow-scheme parameters (Python floats, no tensors)."""

    ddf: float = 3.0            # Degree-day melt factor   (mm w.e./K/day)
    t_rain: float = c.TF + 3.0  # All rain at or above                (K)
    t_snow: float = c.TF - 1.0  # All snow at or below                (K)
    swe_cap: float = 1000.0     # Largest pack                       (mm)


def snow_step(swe: torch.Tensor, tas: torch.Tensor, pr: torch.Tensor,
              p: SnowParams) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor, torch.Tensor]:
    """One daily snowpack update on ``[n]`` fields: ``swe`` (mm), ``tas``
    (K), ``pr`` (kg/m^2/s).

    Returns ``(swe_new, pr_eff, melt_mm, capped_mm)``: ``pr_eff`` is the
    effective rainfall flux for the hydrology (units of ``pr``),
    ``melt_mm`` the day's melt, and ``capped_mm`` what a pack above
    ``swe_cap`` sheds as ice runoff straight to the river network.
    """
    pr_mm_day = pr * c.SDAY            # kg/m^2/s == mm/s -> mm/day
    frac_snow = torch.clamp((p.t_rain - tas) / (p.t_rain - p.t_snow),
                            0.0, 1.0)
    snowfall = pr_mm_day * frac_snow
    melt_pot = p.ddf * torch.clamp(tas - c.TF, min=0.0)
    melt = torch.minimum(swe + snowfall, melt_pot)
    swe_new = swe + snowfall - melt
    capped = torch.clamp(swe_new - p.swe_cap, min=0.0)
    swe_new = swe_new - capped
    pr_eff = (pr_mm_day - snowfall + melt) / c.SDAY
    return swe_new, pr_eff, melt, capped


@dataclasses.dataclass(frozen=True)
class TwoLayerSnowParams:
    """Static parameters of the two-layer cold-content snowpack."""

    ddf: float = 3.0            # Degree-day energy     (mm w.e./K/day)
    t_rain: float = c.TF + 3.0  # All rain at or above                (K)
    t_snow: float = c.TF - 1.0  # All snow at or below                (K)
    swe_cap: float = 1000.0     # Largest pack, ice + liquid         (mm)
    surf_max: float = 100.0     # Surface-layer SWE                  (mm)
    hold_frac: float = 0.05     # Liquid capacity per mm of ice        (-)
    k_surf: float = 0.5         # T_surf -> tas relaxation         (/day)
    k_base: float = 0.05        # T_base -> T_surf relaxation      (/day)
    # Cold content per mm SWE per K below freezing, in mm of refreeze
    # equivalent: c_ice / L_f = 2100 / 334000 (J/kg/K over J/kg).
    cc_per_k: float = 2100.0 / 334000.0
    t_floor: float = c.TF - 60.0  # Layer temperature clamp           (K)


def snow_step_two_layer(pack, tas: torch.Tensor, pr: torch.Tensor,
                        p: TwoLayerSnowParams):
    """One daily update of the two-layer cold-content snowpack.

    In order: snowfall into the surface layer at ``min(tas, TF)``;
    surface overflow into the base layer (mass-weighted temperatures);
    daily thermal relaxation (surface toward the air, base toward the
    surface); degree-day energy first cancels the cold content
    (ripening), the rest melts ice top-down; rain and melt enter the
    liquid store, refreeze against the remaining cold content and drain
    beyond the holding capacity; the total pack (ice and liquid) is
    capped at ``swe_cap``.

    ``pack`` is a ``state.SnowpackState``, ``tas`` the ``[n]`` daily air
    temperature (K), ``pr`` the precipitation flux (kg/m^2/s).  Returns
    ``(pack', pr_eff, melt_mm, capped_mm)`` with ``pr_eff`` the effective
    rainfall flux for the hydrology.
    """
    tf = c.TF
    eps = 1.0e-8
    pr_mm = pr * c.SDAY
    frac_snow = torch.clamp((p.t_rain - tas) / (p.t_rain - p.t_snow),
                            0.0, 1.0)
    snowfall = pr_mm * frac_snow
    rain = pr_mm - snowfall

    m_s, m_b = pack.swe_surf, pack.swe_base
    t_s = torch.clamp(pack.t_surf, p.t_floor, tf)
    t_b = torch.clamp(pack.t_base, p.t_floor, tf)

    # 1. New snow lands in the surface layer at min(tas, TF).
    t_new = torch.clamp(tas, max=tf)
    t_s = torch.where(m_s + snowfall > eps,
                      (t_s * m_s + t_new * snowfall)
                      / torch.clamp(m_s + snowfall, min=eps), tf)
    m_s = m_s + snowfall

    # 2. Surface overflow pushes (with its temperature) into the base.
    over = torch.clamp(m_s - p.surf_max, min=0.0)
    t_b = torch.where(m_b + over > eps,
                      (t_b * m_b + t_s * over)
                      / torch.clamp(m_b + over, min=eps), tf)
    m_b = m_b + over
    m_s = m_s - over

    # 3. Daily thermal relaxation, bounded by freezing.
    t_s = torch.clamp(t_s + p.k_surf * (tas - t_s), max=tf)
    t_b = torch.clamp(t_b + p.k_base * (t_s - t_b), max=tf)
    t_s = torch.clamp(t_s, p.t_floor, tf)
    t_b = torch.clamp(t_b, p.t_floor, tf)

    # 4. Cold content in mm-of-refreeze equivalent.
    cc_s = p.cc_per_k * (tf - t_s) * m_s
    cc_b = p.cc_per_k * (tf - t_b) * m_b

    # 5. Degree-day energy: ripen the pack first, then melt top-down.
    energy = p.ddf * torch.clamp(tas - tf, min=0.0)
    warm_s = torch.minimum(energy, cc_s)
    energy = energy - warm_s
    cc_s = cc_s - warm_s
    warm_b = torch.minimum(energy, cc_b)
    energy = energy - warm_b
    cc_b = cc_b - warm_b
    melt_s = torch.minimum(m_s, energy)
    energy = energy - melt_s
    melt_b = torch.minimum(m_b, energy)
    m_s = m_s - melt_s
    m_b = m_b - melt_b
    melt = melt_s + melt_b

    # 6. Liquid store: refreeze against the remaining cold content,
    #    retain up to hold_frac of the ice mass, drain the rest.
    w = pack.w_liq + rain + melt
    rf_s = torch.minimum(w, cc_s)
    w = w - rf_s
    rf_b = torch.minimum(w, cc_b)
    w = w - rf_b
    m_s = m_s + rf_s
    m_b = m_b + rf_b
    cc_s = cc_s - rf_s
    cc_b = cc_b - rf_b
    ice = m_s + m_b
    cap_liq = p.hold_frac * ice
    outflow = torch.clamp(w - cap_liq, min=0.0)
    w = w - outflow
    # A vanished pack cannot hold liquid.
    outflow = torch.where(ice > eps, outflow, outflow + w)
    w = torch.where(ice > eps, w, 0.0)

    # 7. Capping: excess ice leaves as ice runoff, base first; the cap
    #    bounds the total pack, so a pack at the cap sheds its liquid.
    capped = torch.clamp(ice - p.swe_cap, min=0.0)
    rm_b = torch.minimum(m_b, capped)
    m_b = m_b - rm_b
    m_s = m_s - (capped - rm_b)
    liq_over = torch.clamp(m_s + m_b + w - p.swe_cap, min=0.0)
    liq_over = torch.minimum(liq_over, w)
    outflow = outflow + liq_over
    w = w - liq_over

    # 8. Layer temperatures from the surviving cold content.
    t_s = torch.where(m_s > eps,
                      tf - cc_s / (p.cc_per_k * torch.clamp(m_s, min=eps)),
                      tf)
    t_b = torch.where(m_b > eps,
                      tf - cc_b / (p.cc_per_k * torch.clamp(m_b, min=eps)),
                      tf)
    t_s = torch.clamp(t_s, p.t_floor, tf)
    t_b = torch.clamp(t_b, p.t_floor, tf)

    new_pack = pack.replace(swe_surf=m_s, swe_base=m_b, w_liq=w,
                            t_surf=t_s, t_base=t_b)
    pr_eff = outflow / c.SDAY          # capped ice goes to the rivers
    return new_pack, pr_eff, melt, capped
