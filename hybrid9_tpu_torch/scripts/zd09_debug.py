"""Bisect a zd09_every=8 multi-year non-finite blowup.

Port of ``scripts/zd09_debug.py``.  Runs the zd09_drift configuration
(0.5 degrees, reference-scope physics, k=8, the CUDA day kernel on the
card) day by day from 1901 to 1915, keeping the previous day's state and
counting each day's non-finite land cells; at the first bad day it:

  1. reports the day and the offending cells,
  2. re-steps the SAME pre-blowup state under the isolation matrix
     {kernel, twin} x {k=8, k=1} (``isolation_matrix``): a cell that
     blows up under the kernel and not under the plain twin is a kernel
     fault, one that blows up at k=8 under both and not at k=1 is the
     approximation,
  3. dumps the pre-blowup column state of the offending cells.

Writes the full pre-blowup state to zd09_blowup_full.npz (the input of
``zd09_cell_probe``) and the offending columns to zd09_blowup_state.npz.

Usage: python -m hybrid9_tpu_torch.scripts.zd09_debug [--device cpu]
Exit 0 when no day blows up, 1 when one does.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import calendar
from ..config import Config
from ..data.forcing import SyntheticForcingProvider
from ..data.soil import load_soil
from ..physics.hydrology import Geometry
from ..run import resolve_device
from ..state import initial_state
from ..step import day_step

#: The isolation matrix: (label, zd09_every, day kernel).
MATRIX = (("k=8 kernel", 8, True), ("k=1 kernel", 1, True),
          ("k=8 twin", 8, False), ("k=1 twin", 1, False))


def debug_config() -> Config:
    """The zd09_drift reference-scope configuration at k=8, 1901-1915."""
    return Config(resolution_deg=0.5, start_year=1901, end_year=1915,
                  nisurf=48, zd09_every=8, snow=False, snow_albedo=False,
                  frozen_soil=False, soil_ice=False, carbon=False,
                  lateral_routing=False, write_annual=False)


def finite_cells(state) -> torch.Tensor:
    """``[n]`` True where the water table, the aquifer and every layer's
    water are finite."""
    return (torch.isfinite(state.soil.zwt)
            & torch.isfinite(state.soil.h2osoi_liq).all(dim=1)
            & torch.isfinite(state.soil.wa))


def step_day(state, forcing, params, geom, cfg: Config, k: int,
             use_kernel):
    """One reference-scope ``day_step`` at ``zd09_every=k``."""
    return day_step(state, forcing, params, geom, cfg.dt, cfg.nisurf,
                    use_kernel=use_kernel, zd09_every=k)


def isolation_matrix(state, forcing, params, geom, cfg: Config,
                     matrix=MATRIX) -> dict:
    """The same state and day under each ``(label, k, kernel)`` of
    ``matrix``: ``{label: (state, diags)}``."""
    return {label: step_day(state, forcing, params, geom, cfg, k, kernel)
            for label, k, kernel in matrix}


def scan(cfg: Config, params, geom, state, provider, n_land: int,
         use_kernel=None, max_days=None):
    """Day by day from ``cfg.start_year`` at ``cfg.zd09_every`` until a
    day leaves a non-finite land cell (or ``max_days`` days have run).
    Returns ``(found, prev, prev_forcing, new_state, days)``: ``found``
    is (year, doy, bad cells) or None, ``prev`` the state before the last
    day run and ``prev_forcing`` that day's forcing."""
    prev = state
    new_state = prev_f = None
    days = 0
    for year in range(cfg.start_year, cfg.end_year + 1):
        ndays = calendar.days_in_year(year)
        if max_days is not None:
            ndays = min(ndays, max_days - days)
        block = provider(year, 1, ndays)
        for d in range(ndays):
            f_day = block.map(lambda x: x[d])
            new_state, _ = step_day(prev, f_day, params, geom, cfg,
                                    cfg.zd09_every, use_kernel)
            days += 1
            nb = int((~finite_cells(new_state)[:n_land]).sum())
            if nb:
                return (year, d + 1, nb), prev, f_day, new_state, days
            if max_days is not None and days == max_days:
                return None, prev, f_day, new_state, days
            prev = new_state
        print(f"year {year}: clean (mean zwt "
              f"{float(torch.mean(new_state.soil.zwt)):.2f} m)", flush=True)
    return None, prev, prev_f, new_state, days


def _host(x) -> np.ndarray:
    return x.cpu().numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = debug_config()
    dtype = getattr(torch, cfg.dtype)
    grid, params = load_soil(cfg, dtype, device)
    lg = cfg.layer_grid()
    state = initial_state(params, lg.dz, lg.zi, dtype, device)
    geom = Geometry.from_layer_grid(lg)
    provider = SyntheticForcingProvider(grid.n_padded, seed=0,
                                        lat=grid.cell_lat, dtype=dtype,
                                        device=device)
    use_kernel = device.type == "cuda"
    print(f"device {device}, kernel={use_kernel}, {grid.n_land} land cells")

    found, prev, prev_f, new_state, _ = scan(cfg, params, geom, state,
                                             provider, grid.n_land)
    if not found:
        print("no blowup found — nothing to bisect")
        return 0
    year, doy, nb = found
    print(f"\nFIRST NON-FINITE: year {year} doy {doy}: {nb} cells")

    ok = _host(finite_cells(new_state))
    bad_idx = np.flatnonzero(~ok[:grid.n_land])
    print(f"offending cells: {bad_idx[:12]}")
    for j in bad_idx[:4]:
        print(f"  cell {j}: post-step zwt="
              f"{float(new_state.soil.zwt[j]):.4f} "
              f"wa={float(new_state.soil.wa[j]):.4f} "
              f"h2osoi={_host(new_state.soil.h2osoi_liq[j])}")

    # Full pre-blowup snapshot: lets the single bad day be re-stepped
    # offline (the plain twin reproduces, so CPU debugging works).
    full = {}
    for name, leaf in [("h2osoi", prev.soil.h2osoi_liq),
                       ("zwt", prev.soil.zwt), ("wa", prev.soil.wa),
                       ("smp", prev.soil.smp),
                       ("lai", prev.veg.lai),
                       ("lai_litter", prev.veg.lai_litter),
                       ("plant_mass", prev.veg.plant_mass),
                       ("plant_foliage_mass",
                        prev.veg.plant_foliage_mass),
                       ("rootr", prev.veg.rootr)]:
        full[name] = _host(leaf)
    for f in ("tas", "rlds", "rsds", "huss", "ps", "pr", "rhs"):
        full[f"forc_{f}"] = _host(getattr(prev_f, f))
    full["bad_idx"] = bad_idx
    np.savez_compressed("zd09_blowup_full.npz", **full)
    print("wrote zd09_blowup_full.npz (full pre-blowup state)")

    # Isolation matrix: same pre-blowup state, one day, four configs.
    matrix = MATRIX if use_kernel else tuple(
        row for row in MATRIX if not row[2])
    for label, (st, diags) in isolation_matrix(prev, prev_f, params, geom,
                                               cfg, matrix).items():
        nb2 = int((~finite_cells(st)[:grid.n_land]).sum())
        res = float(torch.max(diags["max_abs_residual"]))
        print(f"  {label:12s}: bad={nb2:5d} max|res|={res:.3g} mm")

    idx = torch.as_tensor(bad_idx, device=device)
    snap = dict(
        h2osoi=_host(prev.soil.h2osoi_liq[idx]),
        zwt=_host(prev.soil.zwt[idx]),
        wa=_host(prev.soil.wa[idx]),
        smp=_host(prev.soil.smp[idx]),
        lai=_host(prev.veg.lai[idx]),
        theta_s=_host(params.theta_s[idx]),
        hksat=_host(params.hksat[idx]),
        bsw=_host(params.bsw[idx]),
        psi_s=_host(params.psi_s[idx]),
        fmax=_host(params.fmax[idx]),
        tas=_host(prev_f.tas[idx]),
        pr=_host(prev_f.pr[idx]),
        bad_idx=bad_idx, year=year, doy=doy,
    )
    np.savez("zd09_blowup_state.npz", **snap)
    i = int(bad_idx[0])
    print(f"\nfirst bad cell {i}: zwt={snap['zwt'][0]:.3f} m "
          f"wa={snap['wa'][0]:.1f} mm")
    print(f"  h2osoi: {snap['h2osoi'][0]}")
    print(f"  theta_s: {snap['theta_s'][0]}")
    print(f"  bsw: {snap['bsw'][0]}")
    print(f"  psi_s: {snap['psi_s'][0]}")
    print(f"  hksat: {snap['hksat'][0]}")
    print(f"  tas={snap['tas'][0]:.1f} K pr={snap['pr'][0]:.2e} mm/s "
          f"lai={snap['lai'][0]:.3f}")
    print("wrote zd09_blowup_state.npz")
    return 1


if __name__ == "__main__":
    sys.exit(main())
