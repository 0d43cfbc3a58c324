"""Daily vegetation dynamics.

Port of ``hybrid9_tpu/physics/grow.py`` (reference: SOURCE/GROW.f90): a
function ``(VegState, smp, tas) -> (VegState, npp, litterfall)`` over all
cells.
"""

from __future__ import annotations

import math

import torch

from . import constants as c
from ..state import VegState


def grow_daily(veg: VegState, smp: torch.Tensor, tas: torch.Tensor,
               zi, return_fluxes: bool = False):
    """One day of growth for all cells.

    ``smp`` is the ``[n, nl]`` matric potential at the end of the day's
    hydrology (GROW.f90:57), ``tas`` the ``[n]`` daily air temperature
    (K) and ``zi`` the interface depths (mm).  Returns ``(veg, npp,
    litterfall)``, plus a dict of the day's per-pool fluxes with
    ``return_fluxes``.
    """
    nl = smp.shape[1]
    zi = torch.as_tensor(zi, dtype=smp.dtype, device=smp.device)

    # Root-weighted soil-moisture constraint (GROW.f90:55-62).
    wi_l = (-150000.0 - smp) / (-150000.0 - (-50000.0))
    w_i = torch.sum(veg.rootr * torch.clamp(wi_l, 0.0, 1.0), dim=-1)

    # Temperature constraint (Hayat et al. 2017 Eqn 19; GROW.f90:66-72),
    # warm branch clamped at 0 (DEVIATIONS.md #9).
    d = tas - c.TF
    warm = torch.abs(d - 18.0) / 21.0
    cool = torch.abs(d - 18.0) / 25.0
    ft_warm = torch.clamp(1.0 - warm * warm, min=0.0)
    ft_cool = torch.clamp(1.0 - cool * cool, 0.0, 1.0)
    f_t = torch.where(d > 18.0, ft_warm, ft_cool)

    # Growth and losses (GROW.f90:90-146).
    grow_pm = (1000.0 / 365.0) * w_i * f_t
    grow_fm = grow_pm / 3.3
    loss_pm = (0.1 / 365.0) * veg.plant_mass
    loss_fm = (1.0 / 365.0) * veg.plant_foliage_mass \
        / torch.clamp(w_i, 0.01, 1.0)
    loss_fm = torch.where(w_i < 0.6, 0.1 * veg.plant_foliage_mass, loss_fm)
    dpm = grow_pm - loss_pm
    dfm = grow_fm - loss_fm
    # Seed-bank floors (DEVIATIONS.md #9).
    plant_mass = torch.clamp(veg.plant_mass + dpm, min=1.0e-3)
    plant_foliage_mass = torch.clamp(veg.plant_foliage_mass + dfm,
                                     min=1.0e-5)

    # Cylinder allometry (GROW.f90:155-156).  torch has no cbrt; pow(1/3)
    # is valid because plant_mass >= 1e-3 > 0, and differs from cbrt by
    # rounding only.
    plant_length = (400.0 * plant_mass / 3.142e-3) ** (1.0 / 3.0)
    dlai = dfm * c.SLA
    lai = torch.clamp(veg.lai + dlai, min=0.001)
    lai_litter = veg.lai_litter + torch.clamp(dlai, min=0.0)
    rdepth = 0.3 * plant_length

    # Root profile: 90 % of roots within rdepth (GROW.f90:176-182).
    decay = torch.exp(math.log(0.1) / (torch.clamp(rdepth, min=1.0) / 10.0))
    rootr = (decay[:, None] ** (zi[None, :nl] / 10.0)
             - decay[:, None] ** (zi[None, 1:nl + 1] / 10.0))

    npp = dpm

    # Litter decay, 2 %/day (GROW.f90:201).
    lai_litter = lai_litter - 0.02 * lai_litter

    new_veg = veg.replace(
        plant_mass=plant_mass,
        plant_foliage_mass=plant_foliage_mass,
        plant_length=plant_length,
        rdepth=rdepth,
        lai=lai,
        lai_litter=lai_litter,
        rootr=rootr,
    )
    # Litterfall: the mass the plant pools actually lost today (g DM).
    litterfall = (torch.clamp(veg.plant_mass + grow_pm - plant_mass,
                              min=0.0)
                  + torch.clamp(veg.plant_foliage_mass + grow_fm
                                - plant_foliage_mass, min=0.0))
    if return_fluxes:
        production = ((plant_mass - veg.plant_mass)
                      + (plant_foliage_mass - veg.plant_foliage_mass)
                      + litterfall)
        fluxes = dict(v_grow_pm=grow_pm, v_loss_pm=loss_pm,
                      v_grow_fm=grow_fm, v_loss_fm=loss_fm,
                      v_production=production)
        return new_veg, npp, litterfall, fluxes
    return new_veg, npp, litterfall
