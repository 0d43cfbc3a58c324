"""The reference's flagship experiment, all new physics on.

Port of ``scripts/flagship_run.py``: the 1901-2012 configuration (112
years, global 0.5 degrees; the reference took 114 min on 64 Sandy Bridge
cores, notes.txt:31) with every capability enabled: the CUDA day kernel,
the snowpack, frozen-soil impedance, sub-daily kinematic-wave routing,
annual NetCDF output and decadal checkpoints.  Synthetic forcing made on
the device stands in for the PGF archive (the real ingest path at
archive scale is ``pgf_scale_test``).

    python -m hybrid9_tpu_torch.scripts.flagship_run [--years 112]
        [--out DIR]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..config import Config
from ..data.device_forcing import DeviceSyntheticForcingProvider
from ..data.soil import load_soil
from ..io.checkpoint import Checkpointer
from ..io.writer import AnnualWriter
from ..run import Simulation, resolve_device


def flagship_config(years: int, out: str) -> Config:
    """The experiment's Config: 1901 on for ``years``, output under
    ``out``, a checkpoint every 10 years under ``out/ckpt``."""
    return Config(resolution_deg=0.5, start_year=1901,
                  end_year=1900 + years, forcing="device-synthetic",
                  forcing_block_days=366, output_path=out,
                  routing_scheme="kinematic",
                  checkpoint_every_years=10,
                  checkpoint_path=os.path.join(out, "ckpt"))


def run_flagship(cfg: Config, device) -> dict:
    """Run ``cfg`` on ``device`` with its annual files and checkpoints;
    returns the summary the program prints."""
    dtype = getattr(torch, cfg.dtype)
    grid, params = load_soil(cfg, dtype, device)
    provider = DeviceSyntheticForcingProvider(
        grid.n_padded, seed=0, lat=grid.cell_lat, dtype=dtype,
        device=device)
    sim = Simulation(cfg, params, land_grid=grid)
    writer = AnnualWriter(cfg.output_path, grid)
    ck = Checkpointer(cfg.checkpoint_path)

    t0 = time.perf_counter()
    sim.run(provider, writer=writer, checkpointer=ck)
    wall = time.perf_counter() - t0

    years = cfg.end_year - cfg.start_year + 1
    worst = max(float(np.max(m["max_abs_residual"][:grid.n_land]))
                for m in sim.annual_results)
    files = [f for f in os.listdir(cfg.output_path) if f.startswith("axy")]
    swe_mean = float(np.mean(sim.annual_results[-1]["swe"][:grid.n_land]))
    return dict(years=years, n_land=grid.n_land, wall_s=wall,
                s_per_year=wall / years, files=len(files),
                worst_residual_mm=worst, final_swe_mean_mm=swe_mean,
                kernel=sim.use_kernel)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--years", type=int, default=112)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    out = args.out or tempfile.mkdtemp(prefix="flagship_")
    s = run_flagship(flagship_config(args.years, out), device)
    print(f"flagship: {s['years']} years, {s['n_land']} land cells, "
          f"{s['wall_s'] / 60.0:.1f} min wall ({s['s_per_year']:.2f} s/yr), "
          f"{s['files']} annual files, worst residual "
          f"{s['worst_residual_mm']:.3g} mm, final-year mean SWE "
          f"{s['final_swe_mean_mm']:.1f} mm")
    print(f"output: {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
