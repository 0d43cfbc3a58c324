"""Climatological bound on the zd09_every approximation.

Port of ``scripts/zd09_drift.py``.  ``Config.zd09_every=8`` refreshes
the Zeng & Decker (2009) equilibrium profile and the drainage
specific-yield profile every 8 substeps (every 4 h at NISURF=48) instead
of every substep (the reference's behaviour, HYDROLOGY.f90:512-590).
This program produces the climatological numbers behind that default:

  paired global runs, SAME forcing, k=1 vs k=8, over N years
  (default 10).  For each annual diagnostic (evap, rnf, theta_total)
  and the end-of-year water table, report
    - the raw max/mean absolute k8-k1 drift per year,
    - that drift normalised by the field's own per-cell interannual
      std (from the k=1 run), the acceptance metric,
    - the drift's time trend (does it accumulate, or is it stationary
      weather-scale decorrelation noise?).

Two scopes (``--scope``):

- ``reference`` (hydrology + growth; snow/ice/carbon/routing off)
  isolates the approximation itself.
- ``flagship``: the shipped defaults (snow + albedo + soil ice/thermal +
  carbon + routing), which interact with the water table; adds swe /
  soil_ice / c_soil / nee / discharge to the audited fields.

Runs the production path: the CUDA day kernel on the card (both arms),
the plain twin with ``--no-kernel`` or on the CPU.

Usage: python -m hybrid9_tpu_torch.scripts.zd09_drift [--years 10]
           [--scope flagship]
Prints one summary line per field; updates ``--out`` (default
zd09_drift_torch.json, beside the JAX package's zd09_drift.json) under
the scope's key.  ``--save-raw`` / ``--from-raw`` write and read the raw
``[years, n_land]`` records as ``k{k}_{field}`` arrays of an npz, the
JAX program's layout: an npz of either package reads in the other.
Exit 0 iff every field passes the bound.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..config import Config
from ..data.forcing import SyntheticForcingProvider
from ..data.soil import load_soil
from ..run import Simulation, resolve_device

REFERENCE_FIELDS = ("evap", "rnf", "theta_total", "zwt")
FLAGSHIP_FIELDS = REFERENCE_FIELDS + ("swe", "soil_ice", "c_soil",
                                      "nee", "discharge")
# Acceptance (metric v2): drift must vanish under natural variability.
BOUND_MEAN, BOUND_P99, BOUND_STATIC = 0.05, 0.10, 0.01


def arm_config(k: int, years: int, resolution: float, nisurf: int,
               use_kernel=None, scope: str = "reference"):
    """The Config of the ``zd09_every=k`` arm: the shipped defaults
    (``flagship``) or hydrology and growth alone (``reference``); only
    the knob under study varies between arms."""
    common = dict(resolution_deg=resolution, start_year=1901,
                  end_year=1900 + years, nisurf=nisurf, zd09_every=k,
                  write_annual=False, use_kernel=use_kernel)
    if scope == "flagship":
        return Config(**common)
    return Config(**common, snow=False, snow_albedo=False,
                  frozen_soil=False, soil_ice=False, carbon=False,
                  lateral_routing=False)


def run_arm(cfg, fields, device) -> dict:
    """``cfg``'s years on ``device`` with host synthetic forcing (seed
    0): each field's ``[years, n_land]`` record (annual means; ``zwt``
    the end-of-year state)."""
    dtype = getattr(torch, cfg.dtype)
    grid, params = load_soil(cfg, dtype, device)
    provider = SyntheticForcingProvider(grid.n_padded, seed=0,
                                        lat=grid.cell_lat, dtype=dtype,
                                        device=device)
    sim = Simulation(cfg, params, land_grid=grid)
    nl = grid.n_land
    rec = {f: [] for f in fields}
    t0 = time.perf_counter()
    for year in range(cfg.start_year, cfg.end_year + 1):
        means = sim.run_year(year, provider)
        for f in fields:
            if f == "zwt":
                rec[f].append(sim.state.soil.zwt[:nl].cpu().numpy())
            else:
                rec[f].append(np.asarray(means[f])[:nl])
    years = cfg.end_year - cfg.start_year + 1
    scope = "reference" if not cfg.snow else "flagship"
    print(f"k={cfg.zd09_every}: {years} {scope} years in "
          f"{time.perf_counter()-t0:.0f}s ({grid.n_land} land "
          f"cells, kernel={sim.use_kernel}, device {sim.device})",
          flush=True)
    return {f: np.stack(v) for f, v in rec.items()}


def run_paired(years: int, resolution: float, nisurf: int, ks=(1, 8),
               use_kernel=None, scope: str = "reference", device=None):
    """Both arms on ``device`` (the card by default); returns
    ``({k: {field: [years, n_land]}}, fields)``."""
    device = resolve_device(device)
    fields = (FLAGSHIP_FIELDS if scope == "flagship"
              else REFERENCE_FIELDS)
    out = {k: run_arm(arm_config(k, years, resolution, nisurf, use_kernel,
                                 scope), fields, device)
           for k in ks}
    return out, fields


def analyse(out: dict, ks, fields) -> tuple:
    """Metric v2 of the k=ks[1] arm against the exact k=ks[0] arm, per
    field; prints one line a field.  Returns (report, all_pass).

    Per field, sigma = pooled interannual std (RMS of the per-cell stds
    from the exact run).  Cells whose own std is >= 5 % of sigma are
    "varying": their per-cell drift/std ratios must satisfy mean < 5 %,
    p99 < 10 %.  The rest are "quasi-static" (a static water table under
    ice, tropical swe=0, ...): a per-cell ratio there is 0/0 noise, so
    their drift is bounded absolutely, p99 < 1 % of sigma.  A field inert
    in both arms (sigma == 0) passes iff its drift is exactly zero."""
    report = {}
    all_pass = True
    for f in fields:
        a1, a8 = out[ks[0]][f], out[ks[1]][f]      # [years, n_land]
        diff = np.abs(a8 - a1)
        md = np.mean(diff, axis=0)                 # per-cell mean drift
        std = np.std(a1, axis=0, ddof=1)
        sigma = float(np.sqrt(np.mean(std ** 2)))  # pooled variability
        per_year = np.mean(diff, axis=1)           # domain-mean |drift|
        half = max(1, len(per_year) // 2)
        trend = float(np.mean(per_year[half:])
                      / max(np.mean(per_year[:half]), 1.0e-30))
        if sigma == 0.0:
            ok = float(np.max(diff)) == 0.0
            mean_ratio = p99_ratio = 0.0
            n_var = 0
            static_p99 = float(np.percentile(md, 99)) if md.size else 0.0
        else:
            varying = std >= 0.05 * sigma
            n_var = int(varying.sum())
            if n_var:
                r = md[varying] / std[varying]
                mean_ratio = float(np.mean(r))
                p99_ratio = float(np.percentile(r, 99))
            else:
                mean_ratio = p99_ratio = 0.0
            static_p99 = (float(np.percentile(md[~varying], 99))
                          if (~varying).any() else 0.0)
            ok = (mean_ratio < BOUND_MEAN and p99_ratio < BOUND_P99
                  and static_p99 < BOUND_STATIC * sigma)
        all_pass &= ok
        report[f] = dict(
            mean_abs_drift=float(np.mean(diff)),
            max_abs_drift=float(np.max(diff)),
            pooled_interannual_std=sigma,
            n_varying_cells=n_var,
            mean_ratio_to_interannual_std=mean_ratio,
            p99_ratio_to_interannual_std=p99_ratio,
            static_cells_p99_drift=static_p99,
            late_vs_early_drift_ratio=trend,
            passes_bound=ok,
        )
        print(f"{f:12s}: mean|d|={report[f]['mean_abs_drift']:.3e} "
              f"max|d|={report[f]['max_abs_drift']:.3e} "
              f"sigma={sigma:.3e} "
              f"ratio mean={mean_ratio:.4f} p99={p99_ratio:.4f} "
              f"static p99|d|={static_p99:.3e} "
              f"late/early={trend:.2f} "
              f"{'PASS' if ok else 'FAIL'}")
    return report, all_pass


def write_report(path: str, scope: str, years: int, resolution: float,
                 nisurf: int, report: dict, all_pass: bool) -> None:
    """Put the scope's entry into the JSON at ``path``, keeping the other
    scope's."""
    try:
        with open(path) as fjson:
            doc = json.load(fjson)
        if "fields" in doc:       # legacy single-scope layout
            doc = {"reference": doc}
    except (OSError, ValueError):
        doc = {}
    doc[scope] = dict(years=years, resolution=resolution,
                      nisurf=nisurf, metric="v2",
                      bound=dict(mean=BOUND_MEAN, p99=BOUND_P99,
                                 static_p99_of_sigma=BOUND_STATIC),
                      all_pass=all_pass, fields=report)
    with open(path, "w") as fjson:
        json.dump(doc, fjson, indent=2)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--years", type=int, default=10)
    ap.add_argument("--resolution", type=float, default=0.5)
    ap.add_argument("--nisurf", type=int, default=48)
    ap.add_argument("--out", default="zd09_drift_torch.json")
    ap.add_argument("--ks", default="1,8",
                    help="comma-separated zd09_every values to run")
    ap.add_argument("--scope", default="reference",
                    choices=("reference", "flagship"))
    ap.add_argument("--save-raw", default=None,
                    help="npz path for the raw [years, n_land] per-field"
                         " records of both arms (metric forensics)")
    ap.add_argument("--from-raw", default=None,
                    help="re-analyse a --save-raw npz instead of "
                         "re-running the paired integration")
    ap.add_argument("--no-kernel", action="store_true",
                    help="force the plain twin (isolate kernel effects)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    ks = tuple(int(v) for v in args.ks.split(","))

    if args.from_raw:
        with np.load(args.from_raw) as d:
            fields = sorted({k.split("_", 1)[1] for k in d.files})
            out = {k: {f: d[f"k{k}_{f}"] for f in fields} for k in ks}
    else:
        out, fields = run_paired(
            args.years, args.resolution, args.nisurf, ks=ks,
            use_kernel=False if args.no_kernel else None,
            scope=args.scope, device=args.device)
    if args.save_raw and not args.from_raw:
        np.savez_compressed(args.save_raw,
                            **{f"k{k}_{f}": out[k][f]
                               for k in ks for f in fields})
        print(f"raw records -> {args.save_raw}")
    for k in ks:
        for f in ("evap", "zwt"):
            bad = int(np.sum(~np.isfinite(out[k][f])))
            if bad:
                print(f"k={k} {f}: {bad} NON-FINITE entries")
    if len(ks) < 2:
        return 0
    report, all_pass = analyse(out, ks, fields)
    write_report(args.out, args.scope, args.years, args.resolution,
                 args.nisurf, report, all_pass)
    print(f"wrote {args.out} ({args.scope}: "
          f"{'ALL PASS' if all_pass else 'BOUND EXCEEDED'})")
    return 0 if all_pass else 1


if __name__ == "__main__":
    sys.exit(main())
