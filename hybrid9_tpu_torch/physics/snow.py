"""Snowpack: daily rain/snow partition and degree-day melt.

Port of the degree-day scheme of ``hybrid9_tpu/physics/snow.py``:
precipitation partitions linearly between snow and rain across the air
temperature ramp ``[TF - 1, TF + 3]`` K, the pack melts at
``ddf * (tas - TF)`` mm per day, and melt plus rain feed the hydrology
substeps as effective rainfall.  The daily water balance is exact by
construction: ``swe' - swe + rain_eff + capped = pr``.  Runs once per
day on ``[n]`` fields outside the day kernel.

The two-layer cold-content scheme (``TwoLayerSnowParams``,
``snow_step_two_layer``) is not ported yet (ROADMAP A5.6).
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
