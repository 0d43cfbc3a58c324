"""Deterministic synthetic soil parameters and climate forcing.

Copied from ``hybrid9_tpu/data/synthetic.py`` (numpy only, same
``RandomState`` seeds), so both packages are fed identical inputs.
Stand-in for the HWSD/BNU soil-property ingest (reference:
SOURCE/INIT.f90:473-726) and the PGF v2.1 forcing reader (SOURCE/
READ_PGF.f90).
"""

from __future__ import annotations

import numpy as np

from ..physics import constants as c


def synthetic_soil_params(n: int, seed: int = 0,
                          lat: np.ndarray | None = None,
                          n_layers: int = c.NSOIL_LAYERS) -> dict:
    """Per-cell soil properties with CLM-like vertical structure.

    Returns a dict of float64 NumPy arrays matching SoilParams fields.
    ``theta_m`` follows the reference's -31 bar inversion
    (INIT.f90:707-726).
    """
    rng = np.random.RandomState(seed)
    nl = n_layers
    depth_frac = np.linspace(0.0, 1.0, nl)[None, :]    # 0 at surface

    # Texture-like latent variable per cell in [0, 1] (0 = sand, 1 = clay).
    tex = rng.uniform(0.05, 0.95, size=(n, 1))

    theta_s = 0.35 + 0.15 * tex - 0.03 * depth_frac \
        + rng.uniform(-0.02, 0.02, size=(n, nl))
    theta_s = np.clip(theta_s, 0.25, 0.55)

    # Saturated conductivity: sandier and shallower = faster (mm/s).
    log_k = np.log(5.0e-3) - 2.0 * tex - 1.0 * depth_frac \
        + rng.uniform(-0.3, 0.3, size=(n, nl))
    hksat = np.exp(log_k)

    # Pore-size distribution index; bsw = 1/lambda (INIT.f90:628-631).
    lambda_ = 0.45 - 0.33 * tex + rng.uniform(-0.02, 0.02, size=(n, nl))
    lambda_ = np.maximum(lambda_, c.TRUNC)
    bsw = 1.0 / lambda_

    # Saturated matric potential (mm, negative).
    psi_s = -(80.0 + 500.0 * tex + rng.uniform(0.0, 100.0, size=(n, nl)))

    # Residual water at -31 bar (INIT.f90:718-722).
    theta_m = theta_s * ((-3.1e9 / (1000.0 * 9.8)) / psi_s) ** (-lambda_)

    # TOPMODEL max saturated fraction; reference default 0.3809
    # (INIT.f90:652-680).
    fmax = np.clip(0.3809 + rng.uniform(-0.15, 0.15, size=(n,)), 0.05, 0.6)

    return dict(theta_s=theta_s, hksat=hksat, lambda_=lambda_, bsw=bsw,
                psi_s=psi_s, theta_m=theta_m, fmax=fmax)


def synthetic_forcing_day(n: int, day_of_year: int, seed: int = 0,
                          lat: np.ndarray | None = None) -> dict:
    """One day of PGF-style forcing (float64 NumPy arrays, shape [n]).

    Seasonal cycle keyed to latitude; precipitation is an intermittent
    exponential process.  Fields and units match READ_PGF.f90:22-109.
    """
    if lat is None:
        lat = np.linspace(-55.0, 65.0, n)
    rng = np.random.RandomState(seed * 100003 + day_of_year)
    phase = 2.0 * np.pi * (day_of_year - 15) / 365.0
    season = np.cos(phase) * np.where(lat >= 0.0, -1.0, 1.0)

    tas = 288.0 - 0.4 * np.abs(lat) + 10.0 * season \
        + rng.normal(0.0, 2.0, n)
    rsds = np.clip(220.0 - 2.0 * np.abs(lat) + 120.0 * season
                   + rng.normal(0.0, 15.0, n), 5.0, 420.0)
    rlds = np.clip(1.2 * (tas - 210.0) + rng.normal(0.0, 10.0, n),
                   120.0, 460.0)
    wet = rng.uniform(size=n) < 0.35
    pr = np.where(wet, rng.exponential(6.0e-5, n), 0.0)   # kg/m^2/s
    rhs = np.clip(65.0 + 20.0 * np.sin(phase + lat / 30.0)
                  + rng.normal(0.0, 8.0, n), 20.0, 100.0)
    ps = 101325.0 - 40.0 * np.abs(lat) + rng.normal(0.0, 300.0, n)
    # Saturation specific humidity at tas scaled by relative humidity.
    esat_pa = 610.8 * np.exp(17.27 * (tas - c.TF) / (tas - c.TF + 237.3))
    huss = 0.622 * (rhs / 100.0) * esat_pa / ps

    return dict(tas=tas, rlds=rlds, rsds=rsds, huss=huss, ps=ps, pr=pr,
                rhs=rhs)


def synthetic_forcing_block(n_days: int, n: int, seed: int = 0,
                            start_doy: int = 1,
                            lat: np.ndarray | None = None) -> dict:
    """A [n_days, n] forcing block (the input of the day loop)."""
    days = [synthetic_forcing_day(n, start_doy + d, seed, lat)
            for d in range(n_days)]
    return {k: np.stack([d[k] for d in days]) for k in days[0]}
