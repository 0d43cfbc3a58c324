"""Soil carbon: litter + two SOM pools, decomposition, respiration, NEE.

Port of ``hybrid9_tpu/physics/carbon.py``: the CENTURY-family cascade at
daily cadence on ``[n]`` cell tensors.

    litterfall (g C) -> litter pool -> { respired CO2
                                       , fast SOM } -> { respired CO2
                                                       , slow SOM } -> CO2

Base turnover at 25 C and moist soil: litter 1 yr, fast SOM 10 yr, slow
SOM 100 yr; a Q10 = 2 temperature modifier on the root-zone soil
temperature and a moisture modifier rising over wetness 0.05 -> 0.6 of
saturation, then easing to 0.6 at saturation.  Of each pool's decomposed
flux a fraction is respired and the rest cascades on.  Conservative by
construction: d(litter + fast + slow) = litterfall_C - rh; NEE = rh -
production_C (negative = land sink).
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import constants as c

C_PER_DM = 0.47              # g C per g DM (GROW.f90:104)
K_LITTER = 1.0 / 365.0       # /day at reference conditions
K_FAST = 1.0 / (10.0 * 365.0)
K_SLOW = 1.0 / (100.0 * 365.0)
RESP_LITTER = 0.55           # respired fraction of decomposed litter
TO_FAST = 0.35               # litter -> fast SOM fraction
TO_SLOW = 0.10               # litter -> slow SOM fraction
RESP_FAST = 0.55             # respired fraction of decomposed fast SOM
Q10 = 2.0
T_REF = 25.0                 # C


def decomposition_modifiers(t_soil: torch.Tensor, theta: torch.Tensor,
                            theta_s: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(f_T, f_W) decomposition rate modifiers, each ``[n]``, from the
    mean of the top four layers (the root and litter zone) of the
    ``[n, nl]`` temperature, water content and porosity columns."""
    t_c = torch.mean(t_soil[:, :4], dim=1) - c.TF
    f_t = torch.pow(Q10, (t_c - T_REF) / 10.0)
    wet = torch.clamp(torch.mean(theta[:, :4], dim=1)
                      / torch.clamp(torch.mean(theta_s[:, :4], dim=1),
                                    min=0.05), 0.0, 1.0)
    rise = torch.clamp((wet - 0.05) / (0.60 - 0.05), 0.0, 1.0)
    fall = 1.0 - 0.4 * torch.clamp((wet - 0.60) / 0.40, 0.0, 1.0)
    return f_t, rise * fall


def carbon_daily(carbon, production_dm: torch.Tensor,
                 litterfall_dm: torch.Tensor, t_soil: torch.Tensor,
                 theta: torch.Tensor, theta_s: torch.Tensor,
                 return_fluxes: bool = False):
    """One day of the soil-carbon cascade.

    ``carbon`` is a ``state.CarbonState`` (g C/m^2); ``production_dm``
    and ``litterfall_dm`` the day's realized plant production and
    litterfall (g DM/day, ``grow_daily``'s flux record); ``t_soil``,
    ``theta`` and ``theta_s`` are ``[n, nl]``.  Returns ``(carbon', rh,
    nee)`` in g C/m^2/day and, with ``return_fluxes``, a dict of the
    litter C input and the decomposed flux out of each pool.
    """
    f_t, f_w = decomposition_modifiers(t_soil, theta, theta_s)
    mod = f_t * f_w

    lit_in = C_PER_DM * torch.clamp(litterfall_dm, min=0.0)
    d_lit = carbon.c_litter * torch.clamp(K_LITTER * mod, max=1.0)
    d_fast = carbon.c_soil_fast * torch.clamp(K_FAST * mod, max=1.0)
    d_slow = carbon.c_soil_slow * torch.clamp(K_SLOW * mod, max=1.0)

    c_litter = carbon.c_litter + lit_in - d_lit
    c_fast = carbon.c_soil_fast + TO_FAST * d_lit - d_fast
    c_slow = (carbon.c_soil_slow + TO_SLOW * d_lit
              + (1.0 - RESP_FAST) * d_fast - d_slow)

    rh = RESP_LITTER * d_lit + RESP_FAST * d_fast + d_slow
    nee = rh - C_PER_DM * production_dm
    new = carbon.replace(c_litter=c_litter, c_soil_fast=c_fast,
                         c_soil_slow=c_slow)
    if return_fluxes:
        fluxes = dict(c_lit_in=lit_in, c_d_lit=d_lit, c_d_fast=d_fast,
                      c_d_slow=d_slow)
        return new, rh, nee, fluxes
    return new, rh, nee
