"""The inputs of a cell, made by the benchmark from the seed.

Everything the program and the reference read is made here, on the card
where it can be: the land grid's latitudes, the layer geometry, the soil
parameters, the initial state and the forcing blocks.  The program gets
these tensors; the reference reads the same values as Python numbers.
Frozen copies, from commit 4b4e2efbab26aa9d426bea47f8b90395f66dc63b of
``hybrid9_tpu_torch``:

- ``land_latitudes``: ``grids/grid.py::synthetic_land_mask``,
  ``make_land_grid`` and ``LandGrid.cell_lat`` (numpy, seed 0: the grid is
  the configuration's geography, the same in every run);
- ``soil``: ``data/synthetic.py::synthetic_soil_params``, drawn on the
  card from the seed instead of numpy's ``RandomState(0)``;
- ``initial_state``: ``state.initial_state`` (INIT.f90:707-811);
- ``forcing_block``: ``data/device_forcing.py::generate_block``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_MASK64 = (1 << 64) - 1
TF = 273.16
SMPMIN = -1.0e8
SLA = 23.0e-3
PLOT_AREA = 1.0
#: The traffic's random streams, each keyed apart from the others.
STREAMS = dict(soil=101, members=102, prior=103, obs=104, sample=105)


def stream_seed(*keys: int) -> int:
    """A 63-bit generator seed from integer keys (splitmix64 finalisers of
    each in turn, as ``device_forcing._stream_seed``)."""
    x = 0
    for v in keys:
        x = (x + 0x9E3779B97F4A7C15 + (v & _MASK64)) & _MASK64
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
        x ^= x >> 31
    return x >> 1


def generator(device, *keys: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(*keys))
    return g


def land_latitudes(resolution_deg: float, land_fraction: float,
                   pad_multiple: int) -> tuple:
    """``(latitude of each packed cell, land cells)``: the synthetic
    pseudo-continents at ``resolution_deg``, packed in row-major order and
    padded to a multiple of ``pad_multiple`` (padding at latitude 0)."""
    nx = int(round(360.0 / resolution_deg))
    ny = int(round(180.0 / resolution_deg))
    rng = np.random.RandomState(0)
    field = np.zeros((ny, nx))
    yy = np.linspace(0.0, 2.0 * np.pi, ny, endpoint=False)
    xx = np.linspace(0.0, 2.0 * np.pi, nx, endpoint=False)
    for ky in range(1, 5):
        for kx in range(1, 5):
            amp = rng.normal() / (kx * kx + ky * ky)
            ph_x, ph_y = rng.uniform(0, 2 * np.pi, 2)
            field += amp * np.outer(np.cos(ky * yy + ph_y),
                                    np.cos(kx * xx + ph_x))
    lat = 90.0 - resolution_deg / 2.0 - resolution_deg * np.arange(ny)
    polar = (np.abs(lat) > 83.0)[:, None] & np.ones((1, nx), dtype=bool)
    field[polar] = -np.inf
    mask = field >= np.quantile(field[~polar], 1.0 - land_fraction)
    land_idx = np.flatnonzero(mask.reshape(-1))
    n_land = land_idx.shape[0]
    n = max(pad_multiple, -(-n_land // pad_multiple) * pad_multiple)
    out = np.zeros(n)
    out[:n_land] = lat[land_idx // nx]
    return out, n_land


def geometry(zi_mm) -> dict:
    """Interfaces ``zi`` (mm, [nl + 2]), thicknesses ``dz`` and node
    depths ``zc`` ([nl + 1]) as Python floats (config.LayerGrid)."""
    zi = [float(z) for z in zi_mm]
    dz = [zi[i + 1] - zi[i] for i in range(len(zi) - 1)]
    zc = [zi[i + 1] - dz[i] / 2.0 for i in range(len(dz))]
    return dict(zi=zi, dz=dz, zc=zc, nl=len(zi) - 2)


def soil(seed: int, n: int, nl: int, dtype, device) -> dict:
    """Per-cell soil parameters with CLM-like vertical structure, drawn on
    ``device`` from ``seed`` with the statistics of
    ``synthetic_soil_params``; ``theta_m`` at -31 bar (INIT.f90:718)."""
    g = generator(device, seed, STREAMS["soil"])

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=g, dtype=dtype,
                          device=device) * (hi - lo) + lo

    depth = torch.linspace(0.0, 1.0, nl, dtype=dtype, device=device)[None]
    tex = uniform((n, 1), 0.05, 0.95)
    theta_s = torch.clamp(0.35 + 0.15 * tex - 0.03 * depth
                          + uniform((n, nl), -0.02, 0.02), 0.25, 0.55)
    hksat = torch.exp(math.log(5.0e-3) - 2.0 * tex - 1.0 * depth
                      + uniform((n, nl), -0.3, 0.3))
    lambda_ = torch.clamp(0.45 - 0.33 * tex + uniform((n, nl), -0.02, 0.02),
                          min=1.0e-8)
    psi_s = -(80.0 + 500.0 * tex + uniform((n, nl), 0.0, 100.0))
    theta_m = theta_s * ((-3.1e9 / (1000.0 * 9.8)) / psi_s) ** (-lambda_)
    fmax = torch.clamp(0.3809 + uniform((n,), -0.15, 0.15), 0.05, 0.6)
    return dict(theta_s=theta_s, hksat=hksat, lambda_=lambda_,
                bsw=1.0 / lambda_, psi_s=psi_s, theta_m=theta_m, fmax=fmax)


def initial_state(params: dict, geo: dict) -> dict:
    """The t=0 state from the soil parameters (INIT.f90:707-811): layers
    at 40 % of saturation, the table 5 m below the column, 4000 mm in the
    aquifer, one 1 g plant with an exponential root profile, the soil at
    283.15 K, ``smp`` from the moisture."""
    theta_s = params["theta_s"]
    n, nl = theta_s.shape
    dtype, device = theta_s.dtype, theta_s.device
    dz = torch.tensor(geo["dz"][:nl], dtype=dtype, device=device)
    zi = torch.tensor(geo["zi"], dtype=dtype, device=device)

    def full(v):
        return torch.full((n,), v, dtype=dtype, device=device)

    s = torch.full_like(theta_s, 0.4)
    plant_mass = full(1.0)
    plant_foliage_mass = full(0.0435)
    plant_length = (400.0 * plant_mass / 3.142e-3) ** (1.0 / 3.0)
    rdepth = 0.3 * plant_length
    decay = torch.exp(math.log(0.1) / (rdepth / 10.0))
    c_labile = plant_mass * 0.5 * 0.1
    return dict(
        h2osoi_liq=0.4 * theta_s * dz[None, :],
        h2osoi_liq_ma=(0.4 * 0.1 * dz[None, :]).expand(n, nl).contiguous(),
        zwt=full((geo["zi"][nl] + 5000.0) / 1000.0),
        wa=full(4000.0),
        smp=torch.clamp(params["psi_s"] * s ** (-params["bsw"]), min=SMPMIN),
        plant_mass=plant_mass, plant_foliage_mass=plant_foliage_mass,
        plant_length=plant_length, rdepth=rdepth,
        lai=plant_foliage_mass * SLA / PLOT_AREA, lai_litter=full(0.001),
        rootr=(decay[:, None] ** (zi[None, :nl] / 10.0)
               - decay[:, None] ** (zi[None, 1:nl + 1] / 10.0)),
        c_labile=c_labile, n_labile=c_labile * 0.035,
        p_labile=c_labile * 0.035 * 0.025,
        t_soil=torch.full((n, nl), 283.15, dtype=dtype, device=device))


def forcing_block(seed: int, year: int, start_doy: int, n_days: int,
                  lat: torch.Tensor) -> dict:
    """A ``[n_days, n]`` forcing block made on ``lat``'s device, in its
    dtype: a seasonal cycle keyed to latitude, intermittent exponential
    rain (READ_PGF.f90's fields and units)."""
    device, dtype = lat.device, lat.dtype
    n = lat.shape[0]
    days = start_doy + torch.arange(n_days, device=device, dtype=dtype)
    phase = 2.0 * math.pi * (days[:, None] - 15) / 365.0
    season = torch.cos(phase) * torch.where(lat >= 0.0, -1.0, 1.0)[None, :]
    shape = (n_days, n)

    def gen(stream):
        return generator(device, seed, year, stream)

    def noise(stream, scale):
        return scale * torch.randn(shape, generator=gen(stream),
                                   dtype=dtype, device=device)

    def uniform(stream, lo=0.0, hi=1.0):
        u = torch.rand(shape, generator=gen(stream), dtype=dtype,
                       device=device)
        return u * (hi - lo) + lo

    abs_lat = torch.abs(lat)[None, :]
    tas = 288.0 - 0.4 * abs_lat + 10.0 * season + noise(0, 2.0)
    rsds = torch.clamp(220.0 - 2.0 * abs_lat + 120.0 * season
                       + noise(1, 15.0), 5.0, 420.0)
    rlds = torch.clamp(1.2 * (tas - 210.0) + noise(2, 10.0), 120.0, 460.0)
    wet = uniform(3) < 0.35
    pr = torch.where(wet, 6.0e-5 * -torch.log(uniform(4, 1e-7, 1.0)),
                     torch.zeros((), dtype=dtype, device=device))
    rhs = torch.clamp(65.0 + 20.0 * torch.sin(phase + lat[None, :] / 30.0)
                      + noise(5, 8.0), 20.0, 100.0)
    ps = (101325.0 - 40.0 * abs_lat).expand(shape).contiguous()
    esat_pa = 610.8 * torch.exp(17.27 * (tas - TF) / (tas - TF + 237.3))
    huss = 0.622 * (rhs / 100.0) * esat_pa / ps
    return dict(tas=tas, rlds=rlds, rsds=rsds, huss=huss, ps=ps, pr=pr,
                rhs=rhs)
