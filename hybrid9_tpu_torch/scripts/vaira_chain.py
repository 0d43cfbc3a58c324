"""Chained multi-year LCLIM validation rehearsal.

Port of ``scripts/vaira_chain.py``.  The reference's LCLIM harness ran
Vaira Ranch 2002 AND 2003 through one spin-up + scoring loop
(HYBRID9.f90:339-484, syr..eyr), with each year's prescribed LAI
phenology embedded (the waypoints live in site.VAIRA_LAI_WAYPOINTS).
The real Vaira flux-tower record is not in the repository, so this
program is the closest rehearsal: it synthesizes a two-year
Mediterranean-climate record in the reference's own positional LCLIM
formats (unit-10 daily + unit-11 sub-daily), with an observed-ET column
built from an INDEPENDENT bucket-model climatology (not from the model's
physics), then runs the chained 730-day record through the site's tensor
engine (``engine="kernel"``) with spin-up repeats and reports:

  - obs-vs-model daily-ET RMSE (mm/day), per year and overall;
  - dry-down timing: the day each year when 7-day-smoothed ET first
    falls below 25 % of its spring peak, model vs obs, and the offset.

Exercises end-to-end: positional-file ingest, multi-year record
handling with per-year phenology waypoints (2003's waypoints ride at
record positions 366+doy), spin-up repeats, engine scoring, and the
obs-comparison column: what a real Vaira record drops into (swap the
two synthesized files for the real ones; RUNBOOK.md).  The synthesized
files are byte for byte those of the JAX program at the same seed.

Usage: python -m hybrid9_tpu_torch.scripts.vaira_chain
           [--out vaira_chain_torch.csv] [--device cpu]
Exit 0 iff RMSE < 1.5 mm/day and |dry-down offset| <= 21 days/year.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

from ..config import Config
from ..run import resolve_device
from ..site import (VAIRA_LAI_WAYPOINTS, read_lclim_daily_csv,
                    read_lclim_subdaily_csv, run_site)

NISURF = 24
YEARS = (2002, 2003)
NDAYS = 365


def climatology(rng):
    """Two years of daily Vaira-like weather + independent obs ET.

    Mediterranean annual cycle: winter rains (Nov-Mar), hot dry summer.
    Observed ET comes from a simple independent bucket model (PET x
    moisture x phenology), NOT from the hybrid9 physics.
    """
    days = []
    for yi, year in enumerate(YEARS):
        for d in range(1, NDAYS + 1):
            # Season phase: 0 at mid-winter (doy ~15), 1 mid-summer.
            phase = np.sin(np.pi * (d - 15.0) / 365.0) ** 2
            wet = d < 110 or d > 305
            rain = 0.0
            if wet and rng.random() < 0.38:
                rain = float(rng.exponential(6.0))          # mm/day
            elif not wet and rng.random() < 0.02:
                rain = float(rng.exponential(1.5))
            tas_c = 9.0 + 16.0 * phase + rng.normal(0.0, 1.5)
            rh = 78.0 - 40.0 * phase + rng.normal(0.0, 4.0)
            rh = float(np.clip(rh, 15.0, 98.0))
            rnet_peak = 120.0 + 380.0 * phase               # W/m^2 midday
            days.append(dict(year=year, doy=d, pr=rain, tas=tas_c,
                             rh=rh, rnet_peak=rnet_peak))

    # Interpolated LAI trajectory from the embedded waypoints (record
    # positions; flat between waypoints, as prescribed LAI behaves).
    lai = np.zeros(len(days))
    cur = 0.6
    for i, day in enumerate(days):
        wps = VAIRA_LAI_WAYPOINTS[day["year"]]
        if day["doy"] in wps:
            cur = wps[day["doy"]]
        lai[i] = cur

    # Independent bucket: 150 mm plant-available store.
    cap, store = 150.0, 75.0
    obs = np.zeros(len(days))
    for i, day in enumerate(days):
        pet = 0.0135 * day["rnet_peak"] * (2.0 / np.pi) \
            * (1.0 - day["rh"] / 150.0) * 1.6      # mm/day, crude PM-ish
        veg = min(1.0, 0.25 + lai[i] / 2.5)
        moist = min(1.0, (store / cap) * 1.6)
        et = max(0.05, pet * veg * moist)
        store = min(cap, store + day["pr"]) - min(store, et)
        obs[i] = et
    return days, obs, lai


def write_lclim_files(days, obs, daily_path, sub_path):
    """Emit the reference's positional unit-10/unit-11 layouts."""
    huss, ps = 0.0075, 101300.0
    with open(daily_path, "w") as f:
        f.write("doy evap pr tas rh huss ps\n")
        for day, et in zip(days, obs):
            f.write(f"{day['doy']} {et:.4f} {day['pr']:.4f} "
                    f"{day['tas']:.3f} {day['rh']:.2f} {huss} {ps}\n")
    with open(sub_path, "w") as f:
        f.write(" ".join(f"c{i}" for i in range(37)) + "\n")
        for day, et in zip(days, obs):
            for s in range(NISURF):
                daylight = max(0.0, np.sin(np.pi * (s + 0.5) / NISURF)
                               - 0.25) / 0.75
                cols = [0.0] * 37
                tak = day["tas"] - 4.0 + 9.0 * daylight
                lamb = (2503.0 - 2.386 * tak) * 1.0e3       # J/kg at C
                # Spread the day's obs ET over daylight substeps as LE.
                frac = daylight / (sum(
                    max(0.0, np.sin(np.pi * (k + 0.5) / NISURF) - 0.25)
                    / 0.75 for k in range(NISURF)) or 1.0)
                le = (et * frac) * lamb / 86400.0 * NISURF  # W/m^2
                cols[11] = le
                cols[13] = day["rnet_peak"] * daylight
                cols[15] = 0.45 * day["rnet_peak"] * daylight
                cols[21] = tak
                cols[24] = min(98.0, day["rh"] + 10.0 * (1 - daylight))
                cols[34] = day["pr"] / NISURF
                f.write(" ".join(f"{v:.5f}" for v in cols) + "\n")


def drydown_day(et, year_index):
    """First day (doy, 7-day smoothed) after the spring peak where ET
    falls below 25 % of that peak, searched in doy 80-260."""
    y = et[year_index * NDAYS:(year_index + 1) * NDAYS]
    k = np.convolve(y, np.ones(7) / 7.0, mode="same")
    window = k[79:260]
    peak_i = int(np.argmax(window[:100]))
    peak = window[peak_i]
    below = np.flatnonzero(window[peak_i:] < 0.25 * peak)
    return 80 + peak_i + (int(below[0]) if below.size else len(window))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="vaira_chain_torch.csv")
    ap.add_argument("--spinup", type=int, default=2)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--device", default=None,
                    help="torch device of the site engine (default: the "
                         "card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    rng = np.random.default_rng(args.seed)
    days, obs, lai = climatology(rng)
    td = tempfile.mkdtemp(prefix="vaira_")
    daily_path = os.path.join(td, "vaira_0203_daily.txt")
    sub_path = os.path.join(td, "vaira_0203_sub.txt")
    write_lclim_files(days, obs, daily_path, sub_path)
    print(f"synthesized 2-year LCLIM record in {td} "
          f"({len(days)} days, NISURF={NISURF})")

    climate, obs_daily = read_lclim_daily_csv(daily_path)
    subdaily = read_lclim_subdaily_csv(sub_path, NISURF)
    # Chained phenology: 2002 waypoints at record positions 1-365,
    # 2003's at 366-730 (the engine keys waypoints by record position,
    # so a multi-year record chains naturally).
    waypoints = dict(VAIRA_LAI_WAYPOINTS[2002])
    waypoints.update({NDAYS + d: v
                      for d, v in VAIRA_LAI_WAYPOINTS[2003].items()})

    cfg = Config(spinup_years=args.spinup, nisurf=NISURF,
                 start_year=2002)
    t0 = time.perf_counter()
    res = run_site(cfg, climate=climate, subdaily=subdaily,
                   lai_waypoints=waypoints, grow=False,
                   csv_out=args.out, engine="kernel",
                   evap_obs_daily=obs_daily,
                   record_year_days=NDAYS, device=device)
    wall = time.perf_counter() - t0
    model = np.array([r["evap_day"] for r in res.daily])
    worst = max(r["max_residual"] for r in res.daily)
    site_days = (args.spinup + 1) * len(days)
    print(f"kernel engine on {device}: {len(res.daily)} scored days "
          f"(spin-up {args.spinup} repeats), max|residual| "
          f"{worst:.3g} mm; {wall:.1f}s for {site_days} site days "
          f"({wall / site_days * 1e3:.1f} ms a site day)")

    ok = True
    for yi, year in enumerate(YEARS):
        sl = slice(yi * NDAYS, (yi + 1) * NDAYS)
        rmse = float(np.sqrt(np.mean((model[sl] - obs[sl]) ** 2)))
        bias = float(np.mean(model[sl] - obs[sl]))
        dd_m = drydown_day(model, yi)
        dd_o = drydown_day(obs, yi)
        off = dd_m - dd_o
        print(f"{year}: daily-ET RMSE {rmse:.3f} mm/day "
              f"(bias {bias:+.3f}); dry-down model doy {dd_m} vs obs "
              f"doy {dd_o} (offset {off:+d} d)")
        ok &= rmse < 1.5 and abs(off) <= 21
    overall = float(np.sqrt(np.mean((model - obs) ** 2)))
    print(f"overall RMSE {overall:.3f} mm/day; CSV -> {args.out}")
    print("vaira_chain:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
