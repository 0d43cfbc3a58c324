"""Prognostic soil-temperature column (surface energy balance closure).

Port of ``soil_temperature_step`` and its constants from
``hybrid9_tpu/physics/soiltemp.py``: a CLM-style implicit heat-diffusion
column on the soil layers, driven by the daily-mean ground heat flux and
an implicit sensible exchange with the air, with freeze/thaw latent heat
by the apparent-heat-capacity method.  The phase-change and impedance
functions of that file belong to the flagship extras and are not ported
yet (ROADMAP A5).
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
