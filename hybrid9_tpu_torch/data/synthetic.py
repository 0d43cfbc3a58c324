"""Deterministic synthetic soil parameters and climate forcing.

Copied from ``hybrid9_tpu/data/synthetic.py`` (numpy only, same
``RandomState`` seeds), so both packages are fed identical inputs; the
raw soil archive of ``synthesize_raw_soil_archive`` is written with
``h5py`` as the JAX package writes it.
Stand-in for the HWSD/BNU soil-property ingest (reference:
SOURCE/INIT.f90:473-726) and the PGF v2.1 forcing reader (SOURCE/
READ_PGF.f90).
"""

from __future__ import annotations

import os

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


def synthesize_raw_soil_archive(out_dir: str, resolution_deg: float = 4.0,
                                factor: int = 12, n_layers: int = 8,
                                seed: int = 0, with_fmax: bool = True,
                                compress: bool = False,
                                band_coarse_rows: int = 32) -> dict:
    """Write a synthetic HWSD + BNU-layout raw soil archive to disk.

    Produces, under ``out_dir``, the file set the reference's INIT-time
    soil ingest expects (INIT.f90:473-680) in our naming convention:

    * ``hwsd.nc`` — soil texture classes at model resolution (0 = ocean,
      1..12 = soil, 13 = water bodies),
    * ``<var>_l<k>.nc4`` — per-layer BNU 30-arc-sec-style fields at
      ``factor``x the model resolution, **in archive units** (0.001
      cm^3/cm^3, cm/day, 0.001, cm), NaN over ocean,
    * ``fmax.nc`` (optional) — max saturated fraction with some cells
      missing (exercising the 3809/10000 default, INIT.f90:652-680).

    Fine fields are the coarse-scale pattern upsampled with +-5 %
    multiplicative sub-grid noise, generated band-by-band so full
    30-arc-sec global archives (43200 x 21600) synthesize in bounded
    memory; ``compress`` gzips the HDF5 datasets.  Without ``h5py`` the
    fine fields are NetCDF-3 files of the same names and values, their
    latitude rows the record dimension (``io.netcdf.RecordWriter``;
    the reader tells the containers apart by their first bytes).  Returns
    a dict of paths (``hwsd``, ``bnu_dir``, ``fmax``) plus the
    coarse-unit truth fields for validation.
    """
    try:
        import h5py
    except ImportError:
        h5py = None

    from ..grids.grid import cell_centres, synthetic_land_mask

    os.makedirs(out_dir, exist_ok=True)
    ny = int(round(180.0 / resolution_deg))
    nx = int(round(360.0 / resolution_deg))
    rng = np.random.RandomState(seed)
    mask = synthetic_land_mask(resolution_deg, seed=seed)
    lon, lat = cell_centres(resolution_deg)

    # HWSD texture: classes 1..12 on land, ~2 % water bodies (13).
    tex_class = np.zeros((ny, nx), np.float64)
    tex_class[mask] = rng.randint(1, 13, size=int(mask.sum()))
    water = mask & (rng.uniform(size=(ny, nx)) < 0.02)
    tex_class[water] = 13.0
    from ..io import netcdf
    hwsd_path = os.path.join(out_dir, "hwsd.nc")
    netcdf.write_grid_file(hwsd_path, {"soil_tex": tex_class}, lon, lat,
                           units={"soil_tex": "HWSD class"})

    # Coarse latent texture drives the per-layer property pattern
    # (same construction as synthetic_soil_params, in ARCHIVE units).
    tex = rng.uniform(0.05, 0.95, size=(ny, nx))
    truth = {v: np.full((ny, nx, n_layers), np.nan) for v in
             ("theta_s", "k_s", "lambda", "psi_s")}
    fy, fx = ny * factor, nx * factor
    kw = dict(compression="gzip", compression_opts=2) if compress else {}
    for layer in range(n_layers):
        df = layer / max(1, n_layers - 1)
        coarse = {
            # 0.001 cm^3/cm^3
            "theta_s": np.clip(0.35 + 0.15 * tex - 0.03 * df, 0.25,
                               0.55) * 1.0e3,
            # cm/day  (mm/s * 8640)
            "k_s": np.exp(np.log(5.0e-3) - 2.0 * tex - 1.0 * df) * 8640.0,
            # 0.001
            "lambda": np.maximum(0.45 - 0.33 * tex, 0.02) * 1.0e3,
            # cm (negative; mm / 10)
            "psi_s": -(80.0 + 500.0 * tex) / 10.0,
        }
        for vi, (var, cf) in enumerate(coarse.items()):
            cf = np.where(mask, cf, np.nan)
            truth[var][:, :, layer] = cf
            path = os.path.join(out_dir, f"{var}_l{layer + 1}.nc4")
            nrng = np.random.RandomState(seed + 101 * layer + 17 * vi)

            def bands(cf=cf, nrng=nrng):
                for r0 in range(0, ny, band_coarse_rows):
                    r1 = min(ny, r0 + band_coarse_rows)
                    band = np.repeat(np.repeat(cf[r0:r1], factor, axis=0),
                                     factor, axis=1)
                    noise = nrng.uniform(0.95, 1.05, size=band.shape)
                    yield r0, (band * noise).astype(np.float32)

            if h5py is None:
                with netcdf.RecordWriter(path, var, ("lat", "lon"),
                                         (fx,)) as w:
                    for _, band in bands():
                        w.append(band)
                continue
            with h5py.File(path, "w") as f:
                dset = f.create_dataset(
                    var, shape=(fy, fx), dtype=np.float32,
                    chunks=(min(fy, band_coarse_rows * factor), fx), **kw)
                for r0, band in bands():
                    dset[r0 * factor:r0 * factor + band.shape[0]] = band

    fmax_path = None
    if with_fmax:
        fmax = np.where(mask,
                        np.clip(0.3809 + rng.uniform(
                            -0.15, 0.15, size=(ny, nx)), 0.05, 0.6),
                        np.nan)
        # ~10 % of land cells missing -> exercises the reference default.
        missing = mask & (rng.uniform(size=(ny, nx)) < 0.1)
        fmax[missing] = np.nan
        fmax_path = os.path.join(out_dir, "fmax.nc")
        netcdf.write_grid_file(fmax_path, {"fmax": fmax}, lon, lat,
                               units={"fmax": "-"})

    return dict(hwsd=hwsd_path, bnu_dir=out_dir, fmax=fmax_path,
                truth=truth, mask=mask, soil_tex=tex_class)


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
