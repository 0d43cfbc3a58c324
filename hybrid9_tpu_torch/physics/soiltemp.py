"""Prognostic soil-temperature column (surface energy balance closure).

Port of ``hybrid9_tpu/physics/soiltemp.py``: a CLM-style implicit
heat-diffusion column on the soil layers, driven by the daily-mean ground
heat flux and an implicit sensible exchange with the air, with
freeze/thaw latent heat either by the apparent-heat-capacity method
(``latent_ramp``) or by the explicit daily ``phase_change`` into a
prognostic ice store; and the frozen-soil hydraulic impedance from that
store (``freeze_impedance_from_ice``) or from a temperature ramp
(``freeze_impedance``).
"""

from __future__ import annotations

from typing import List

import torch

from . import constants as c
from .layers import stack, unstack
from .soilwater import _thomas_solve

K_DRY = 0.30       # Dry soil thermal conductivity            (W/m/K)
K_SAT = 1.80       # Saturated soil thermal conductivity      (W/m/K)
C_SOLID = 2.0e6    # Volumetric heat capacity of soil solids  (J/m^3/K)
C_WATER = 4.18e6   # Volumetric heat capacity of water        (J/m^3/K)
C_ICE = 1.9e6      # Volumetric heat capacity of ice          (J/m^3/K)
WATMIN = 0.01      # Liquid floor never frozen (mm; reference watmin,
                   # HYDROLOGY.f90:1156)


def soil_temperature_step(t_soil: torch.Tensor, theta: torch.Tensor,
                          theta_s: torch.Tensor, g_flux: torch.Tensor,
                          dz_mm, zc_mm, dt: float,
                          t_air: torch.Tensor = None,
                          h_surf=0.0,
                          latent_ramp: float = 0.0) -> torch.Tensor:
    """One implicit heat-diffusion step.

    ``t_soil``, ``theta``, ``theta_s`` are ``[n, nl]``; ``g_flux`` the
    ``[n]`` ground heat flux (W/m^2, down); ``dz_mm``/``zc_mm`` static
    geometry (mm); ``t_air`` and ``h_surf`` the implicit surface sensible
    exchange.  With ``latent_ramp`` > 0 (K) a predictor pass with plain
    capacity locates the layers whose step crosses the freezing band
    ``(TF - latent_ramp, TF)``, and a corrector re-solves with their
    fusion enthalpy spread over the band.  Returns ``[n, nl]``
    temperatures.
    """
    nl = t_soil.shape[1]
    t = unstack(t_soil)
    th = unstack(theta)
    ts = unstack(theta_s)
    dz = [dz_mm[i] / 1000.0 for i in range(nl)]      # m
    zc = [zc_mm[i] / 1000.0 for i in range(nl)]      # m

    # Moisture-dependent thermal properties per layer.
    k_l: List[torch.Tensor] = []
    cv: List[torch.Tensor] = []
    for i in range(nl):
        se = torch.clamp(th[i] / ts[i], 0.0, 1.0)
        k_l.append(K_DRY + (K_SAT - K_DRY) * se)
        cv.append(C_SOLID * (1.0 - ts[i]) + C_WATER * th[i])

    # Interface conductance g_i between nodes i and i+1 (W/m^2/K).
    g_if: List[torch.Tensor] = []
    for i in range(nl - 1):
        k_int = 0.5 * (k_l[i] + k_l[i + 1])
        g_if.append(k_int / (zc[i + 1] - zc[i]))

    def solve(cv_eff):
        # cv_i dz_i / dt (T'_i - T_i) = g_{i-1}(T'_{i-1}-T'_i)
        #                               - g_i(T'_i - T'_{i+1}) + [G]_top
        a, b, cc, r = [], [], [], []
        for i in range(nl):
            diag = cv_eff[i] * dz[i] / dt
            rhs = diag * t[i]
            lower = g_if[i - 1] if i > 0 else None
            upper = g_if[i] if i < nl - 1 else None
            bi = diag
            if lower is not None:
                bi = bi + lower
            if upper is not None:
                bi = bi + upper
            if i == 0:
                rhs = rhs + g_flux
                if t_air is not None:
                    bi = bi + h_surf
                    rhs = rhs + h_surf * t_air
            a.append(-lower if lower is not None
                     else torch.zeros_like(diag))
            b.append(bi)
            cc.append(-upper if upper is not None
                      else torch.zeros_like(diag))
            r.append(rhs)
        return _thomas_solve(a, b, cc, r)

    t_new = solve(cv)
    if latent_ramp > 0.0:
        cv_aug: List[torch.Tensor] = []
        for i in range(nl):
            lo = torch.minimum(t[i], t_new[i])
            hi = torch.maximum(t[i], t_new[i])
            crosses = ((lo < c.TF)
                       & (hi > c.TF - latent_ramp)).to(cv[i].dtype)
            cv_aug.append(cv[i] + crosses * (c.RHOW * c.LFUS * th[i]
                                             / latent_ramp))
        t_new = solve(cv_aug)
    return stack(t_new)


def column_energy(t_soil: torch.Tensor, theta: torch.Tensor,
                  theta_s: torch.Tensor, dz_mm) -> torch.Tensor:
    """Column heat content (J/m^2) for conservation diagnostics."""
    total = None
    for i in range(t_soil.shape[1]):
        cv = C_SOLID * (1.0 - theta_s[:, i]) + C_WATER * theta[:, i]
        term = cv * (dz_mm[i] / 1000.0) * t_soil[:, i]
        total = term if total is None else total + term
    return total


def phase_change(t_soil: torch.Tensor, liq_mm: torch.Tensor,
                 ice_mm: torch.Tensor, theta_s: torch.Tensor, dz_mm
                 ) -> tuple:
    """Explicit CLM-style soil freeze/thaw: sensible heat <-> ice mass.

    Runs once per day after the plain-capacity temperature solve
    (``latent_ramp=0`` there).  Per layer:

      freeze = min(liq - watmin, hc (TF - T) / L_f)   where T < TF
      melt   = min(ice,          hc (T - TF) / L_f)   where T > TF
      T' = T + (freeze - melt) L_f / hc

    with hc the layer heat content per kelvin (J/m^2/K) and L_f = LFUS
    J/m^2 per mm of water.  T' cannot overshoot TF from either side,
    ``liq + ice`` is invariant and the energy exchanged is exactly
    ``(freeze - melt) * L_f``.  The ``WATMIN`` floor keeps a trace of
    liquid so the Richards solve never sees a fully dry layer.

    ``t_soil``, ``liq_mm``, ``ice_mm`` and ``theta_s`` are ``[n, nl]``;
    ``dz_mm`` the static layer thicknesses (mm).  Returns ``(t_new,
    liq_new, ice_new)``.
    """
    dz_m = torch.as_tensor(dz_mm, dtype=t_soil.dtype,
                           device=t_soil.device)[None, :] / 1000.0
    th_liq = liq_mm / (dz_m * 1000.0)
    th_ice = ice_mm / (dz_m * 1000.0)
    hc = (C_SOLID * (1.0 - theta_s) + C_WATER * th_liq
          + C_ICE * th_ice) * dz_m                      # J/m^2/K
    cold = torch.clamp(c.TF - t_soil, min=0.0)
    warm = torch.clamp(t_soil - c.TF, min=0.0)
    freeze = torch.minimum(torch.clamp(liq_mm - WATMIN, min=0.0),
                           hc * cold / c.LFUS)
    melt = torch.minimum(ice_mm, hc * warm / c.LFUS)
    t_new = t_soil + (freeze - melt) * c.LFUS / hc
    return t_new, liq_mm - freeze + melt, ice_mm + freeze - melt


def freeze_impedance_from_ice(liq_mm: torch.Tensor, ice_mm: torch.Tensor,
                              omega: float = 6.0) -> torch.Tensor:
    """Hydraulic impedance from the prognostic ice store, ``[n, nl]``:
    the CLM ``f = 10^(-omega * F_ice)`` (Swenson et al. 2012) with the
    ice mass fraction ``F_ice = ice / (liq + ice)``.  Ice-free soil
    returns exactly 1."""
    f_ice = ice_mm / torch.clamp(liq_mm + ice_mm, min=1e-12)
    return torch.pow(10.0, -omega * f_ice)


def freeze_impedance(t_soil: torch.Tensor, omega: float = 6.0,
                     ramp_k: float = 2.0) -> torch.Tensor:
    """Hydraulic impedance of (partially) frozen layers, ``[n, nl]``:
    ``f = 10^(-omega * F_ice)`` with the frozen fraction approximated by
    the linear ramp ``F_ice = clip((TF - T) / ramp_k, 0, 1)`` in lieu of
    an ice store.  It scales interface conductivity and the infiltration
    capacity in the substep, so water conservation is untouched.
    Unfrozen soil returns exactly 1."""
    f_ice = torch.clamp((c.TF - t_soil) / ramp_k, 0.0, 1.0)
    return torch.pow(10.0, -omega * f_ice)
