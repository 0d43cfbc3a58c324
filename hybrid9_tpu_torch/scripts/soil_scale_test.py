"""Archive-scale raw-soil ingest test.

Port of ``scripts/soil_scale_test.py``, the soil-side analog of
``pgf_scale_test``: it synthesizes a full-size BNU-layout raw archive on
disk (default: the global 0.5-degree model grid at 30x fine resolution,
21600 x 10800 per field, 8 layers x 4 variables, about 30 GB, the scale of
the 26 GB PGF decade test; ``--factor 60`` gives the true 30-arc-sec
43200 x 21600 layout, about 119 GB, disk permitting), then runs the
production pipeline end to end:

    raw archives -> prepare_soil (band-chunked hyperslab reads +
    native box-average regrid) -> load_soil -> SoilParams ->
    one simulated year on the device (the card unless --device names
    another).

Reference: INIT.f90:473-726 (the reference re-runs this regrid at every
model start; it runs once offline here).  Without ``h5py`` the fine
fields are NetCDF-3 files (``data/synthetic.py``).  Usage:

    python -m hybrid9_tpu_torch.scripts.soil_scale_test [--factor 30]
        [--layers 8] [--res 0.5] [--workdir .soil_scratch] [--keep]
        [--skip-year]
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
from ..data.device_forcing import DeviceSyntheticForcingProvider
from ..data.soil import load_soil
from ..data.synthetic import synthesize_raw_soil_archive
from ..io.native import available as native_available
from ..run import Simulation, resolve_device


def scale_test(workdir: str, factor: int, layers: int, res: float,
               device, skip_year: bool = False,
               band_coarse_rows: int = 16) -> dict:
    """Synthesize, regrid, load and (unless ``skip_year``) run a year;
    raises if the regrid leaves the coarse truth or the year's residual
    reaches 0.1 mm.  Returns the seconds and errors of each stage."""
    os.makedirs(workdir, exist_ok=True)
    ny = int(round(180.0 / res))
    nx = int(round(360.0 / res))
    fy, fx = ny * factor, nx * factor
    n_fields = layers * 4
    gb = fy * fx * 4 * n_fields / 2**30
    print(f"[1/3] synthesizing archive: {n_fields} fields of "
          f"{fy}x{fx} f32 (~{gb:.1f} GB) under {workdir}", flush=True)
    t0 = time.perf_counter()
    arch = synthesize_raw_soil_archive(
        workdir, resolution_deg=res, factor=factor,
        n_layers=layers, seed=11, band_coarse_rows=band_coarse_rows)
    t_synth = time.perf_counter() - t0
    du = sum(os.path.getsize(os.path.join(workdir, f))
             for f in os.listdir(workdir))
    print(f"      synthesized in {t_synth:.0f}s, {du / 2**30:.1f} GB "
          f"on disk", flush=True)

    print(f"[2/3] prepare_soil (native regrid: {native_available()})",
          flush=True)
    t0 = time.perf_counter()
    cfg = Config(resolution_deg=res,
                 start_year=1901, end_year=1901,
                 soil_source="raw",
                 soil_hwsd_path=arch["hwsd"],
                 soil_bnu_dir=arch["bnu_dir"],
                 soil_fmax_path=arch["fmax"],
                 soil_path=os.path.join(workdir, "soil_prep.nc"),
                 forcing="device-synthetic",
                 output_path=os.path.join(workdir, "out"),
                 write_annual=False)
    dtype = getattr(torch, cfg.dtype)
    grid, params = load_soil(cfg, dtype, device)
    t_prep = time.perf_counter() - t0
    rate = gb / t_prep
    print(f"      raw -> SoilParams in {t_prep:.0f}s "
          f"({rate:.2f} GB/s archive read+regrid), "
          f"{grid.n_land} land cells", flush=True)
    # Truth check: packed theta_s matches the synthesizer's coarse truth.
    truth = arch["truth"]["theta_s"][:, :, 0] / 1.0e3
    packed_truth = grid.pack(truth, fill=np.nan)[:grid.n_land]
    got = params.theta_s[:grid.n_land, 0].cpu().numpy()
    ok = np.isfinite(packed_truth)
    err = np.nanmax(np.abs(got[ok] - packed_truth[ok])
                    / np.abs(packed_truth[ok]))
    # +-5 % uniform sub-grid noise averages down as 0.029/factor per
    # box; allow 6 standard errors (plus a float32-storage floor).
    tol = max(0.005, 6.0 * 0.0289 / factor)
    print(f"      max rel err vs coarse truth: {err:.3g} "
          f"(tol {tol:.3g})", flush=True)
    assert err < tol, "regrid diverged from coarse truth"
    out = dict(gb=du / 2**30, synth_s=t_synth, prep_s=t_prep,
               max_rel_err=float(err), n_land=grid.n_land)

    if not skip_year:
        print("[3/3] one simulated year on device", flush=True)
        sim = Simulation(cfg, params, land_grid=grid)
        provider = DeviceSyntheticForcingProvider(
            grid.n_padded, seed=0, lat=grid.cell_lat, dtype=dtype,
            device=device)
        t0 = time.perf_counter()
        means = sim.run_year(1901, provider)
        t_year = time.perf_counter() - t0
        worst = float(np.max(means["max_abs_residual"][:grid.n_land]))
        print(f"      year in {t_year:.1f}s wall, max|residual| "
              f"{worst:.3g} mm (kernel={sim.use_kernel}, device "
              f"{sim.device})", flush=True)
        assert worst < 0.1
        out.update(year_s=t_year, worst_residual_mm=worst)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--factor", type=int, default=30,
                    help="fine-to-model resolution ratio (60 = BNU "
                         "30-arc-sec at 0.5 deg)")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--res", type=float, default=0.5)
    ap.add_argument("--workdir", default=".soil_scratch")
    ap.add_argument("--keep", action="store_true",
                    help="keep the synthesized archive on exit")
    ap.add_argument("--skip-year", action="store_true",
                    help="stop after load_soil (no device run)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    scale_test(args.workdir, args.factor, args.layers, args.res,
               resolve_device(args.device), skip_year=args.skip_year)
    if not args.keep:
        shutil.rmtree(args.workdir, ignore_errors=True)
    print("SOIL SCALE TEST OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
