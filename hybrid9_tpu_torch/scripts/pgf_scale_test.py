"""Full-archive-scale test of the PGF forcing ingest path.

Port of ``scripts/pgf_scale_test.py``.  Synthesizes a PGF v2.1-layout
decade archive (7 variables x 3653 days x 360x720 float32, about 26 GB,
file naming per READ_PGF.f90:22-109) and times a multi-year global
0.5-degree run driven by it through NetCDFForcingProvider +
PrefetchingProvider + the native packer, on the card unless ``--device``
names another.

The files keep the reference's names (``forcing.pgf_decade_path``,
``<var>_pgfv2.1_1901_1910.nc4``) and the JAX program's values, but hold
NetCDF-3 with 64-bit offsets, time the record dimension
(``io.netcdf.RecordWriter``): the port reads NetCDF-4 only through
``h5py``, which a machine need not have, and the reader tells the two
containers apart by their first bytes.  A day's block is then a mapped
slice of each file.

Usage:
    python -m hybrid9_tpu_torch.scripts.pgf_scale_test [--years 2]
        [--dir .pgf_scratch]
    python -m hybrid9_tpu_torch.scripts.pgf_scale_test --keep

The archive is written under the working directory (``.pgf_scratch``,
gitignored) and deleted at the end unless --keep is given.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time

import numpy as np
import torch

from ..config import Config
from ..data.forcing import (PGF_VARIABLES, NetCDFForcingProvider,
                            PrefetchingProvider, pgf_decade_path)
from ..data.soil import load_soil
from ..io import netcdf
from ..run import Simulation, resolve_device

NY, NX = 360, 720
DECADE = (1901, 1910)
NDAYS = 3653                      # 1901-1910 incl. leap days
SLAB = 64                         # days generated and written at once


def synth_day_fields(doy: int, lat2d: np.ndarray, noise_bank: np.ndarray
                     ) -> dict:
    """Cheap physical-range daily fields (values matter less than bytes)."""
    season = np.cos(2.0 * np.pi * (doy - 200.0) / 365.0)
    nz = noise_bank[doy % noise_bank.shape[0]]
    latr = np.deg2rad(lat2d)
    tas = (288.0 + 25.0 * np.cos(latr) - 15.0
           + 12.0 * season * np.sign(lat2d) + 3.0 * nz)
    rsds = np.maximum(
        0.0, 180.0 * np.cos(latr) + 80.0 * season * np.sign(lat2d)
        + 30.0 * nz)
    rlds = 180.0 + 1.2 * (tas - 230.0) + 10.0 * nz
    huss = np.clip(0.012 * np.exp((tas - 288.0) / 18.0) * (1 + 0.2 * nz),
                   1e-4, 0.03)
    ps = 101325.0 - 800.0 * np.abs(lat2d) / 90.0 + 100.0 * nz
    wet = nz > 0.3
    pr = np.where(wet, 8.0e-5 * (1.0 + nz), 0.0)
    rhs = np.clip(70.0 + 20.0 * nz, 5.0, 100.0)
    return dict(tas=tas, rlds=rlds, rsds=rsds, huss=huss, ps=ps, pr=pr,
                rhs=rhs)


def make_archive(base: str, ndays: int = NDAYS, ny: int = NY,
                 nx: int = NX) -> None:
    """Write the archive's seven files, ``SLAB`` days at a time."""
    os.makedirs(base, exist_ok=True)
    lat = 90.0 - 0.25 - 0.5 * np.arange(ny)
    lat2d = np.repeat(lat[:, None], nx, 1).astype(np.float32)
    rng = np.random.RandomState(0)
    noise_bank = rng.standard_normal((16, ny, nx)).astype(np.float32)

    t0 = time.perf_counter()
    writers = {v: netcdf.RecordWriter(pgf_decade_path(base, v, DECADE[0]),
                                      v,
                                      ("time", "lat", "lon"), (ny, nx))
               for v in PGF_VARIABLES}
    try:
        for start in range(0, ndays, SLAB):
            n = min(SLAB, ndays - start)
            bufs = {v: np.empty((n, ny, nx), np.float32)
                    for v in PGF_VARIABLES}
            for d in range(n):
                day = start + d
                fields = synth_day_fields(day % 365 + 1, lat2d, noise_bank)
                for v in PGF_VARIABLES:
                    bufs[v][d] = fields[v]
            for v in PGF_VARIABLES:
                writers[v].append(bufs[v])
            if start % 512 == 0:
                print(f"  archive: day {start}/{ndays} "
                      f"({time.perf_counter() - t0:.0f}s)", flush=True)
    finally:
        for w in writers.values():
            w.close()
    size = sum(os.path.getsize(os.path.join(base, p))
               for p in os.listdir(base))
    print(f"archive complete: {size / 1e9:.1f} GB in "
          f"{time.perf_counter() - t0:.0f}s")


def pgf_config(base: str, n_years: int) -> Config:
    """``n_years`` from 1901 at 0.5 degrees on the archive under
    ``base``, in 122-day blocks."""
    return Config(resolution_deg=0.5, start_year=1901,
                  end_year=1900 + n_years, forcing="pgf",
                  forcing_path=base, forcing_block_days=122,
                  write_annual=False)


def run_timed(base: str, cfg: Config, device) -> float:
    """``cfg``'s years on the archive through the prefetching reader;
    prints the seconds a year and returns the worst land residual."""
    dtype = getattr(torch, cfg.dtype)
    grid, params = load_soil(cfg, dtype, device)
    provider = PrefetchingProvider(NetCDFForcingProvider(
        base, grid, dtype=dtype, device=device))
    sim = Simulation(cfg, params, land_grid=grid)
    t0 = time.perf_counter()
    try:
        sim.run(provider)
    finally:
        provider.close()
    wall = time.perf_counter() - t0
    n_years = cfg.end_year - cfg.start_year + 1
    ndays = sum(365 + (y % 4 == 0) for y in range(1901, 1901 + n_years))
    wait = sum(t["forcing_wait_s"] for t in sim.timings)
    print(f"PGF-driven run: {n_years} years, {grid.n_land} land cells, "
          f"{wall:.1f}s wall ({wall / n_years:.1f} s/yr, "
          f"{grid.n_land * ndays / wall / 1e6:.2f} M cell-days/s; "
          f"forcing wait {wait:.1f}s; kernel={sim.use_kernel}, device "
          f"{sim.device})")
    worst = max(float(np.max(m["max_abs_residual"][:grid.n_land]))
                for m in sim.annual_results)
    print(f"max|residual| over run: {worst:.3g} mm")
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--years", type=int, default=2)
    ap.add_argument("--dir", default=None)
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    base = args.dir or ".pgf_scratch"
    try:
        if not os.path.exists(pgf_decade_path(base, "tas", DECADE[0])):
            make_archive(base)
        run_timed(base, pgf_config(base, args.years), device)
    finally:
        if not args.keep and os.path.isdir(base):
            shutil.rmtree(base)
            print(f"removed {base}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
