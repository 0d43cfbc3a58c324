"""Per-substep probe of a zd09_every blowup cell (offline).

Port of ``scripts/zd09_cell_probe.py``.  Loads the pre-blowup snapshot
``zd09_blowup_full.npz`` written by ``zd09_debug``, rebuilds the single
offending column and replays the fatal day substep by substep under the
k refresh cadence, printing the water table, aquifer store, recharge and
baseflow each substep: the mechanism trace.

Usage: python -m hybrid9_tpu_torch.scripts.zd09_cell_probe [K]
           [--device cpu]
           (K: the refresh cadence, default 8; the replay runs on the
           card unless ``--device`` names another)
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..config import Config
from ..data.soil import load_soil
from ..physics.drainage import compute_specific_yields
from ..physics.et import daily_et_context
from ..physics.hydrology import Geometry, derive_forcing, hydrology_substep
from ..physics.layers import stack, unstack
from ..physics.soilwater import compute_equilibrium_zq, water_table_index
from ..run import resolve_device
from ..state import Forcing, initial_state

CELL = 1291
FORCING_KEYS = ("tas", "rlds", "rsds", "huss", "ps", "pr", "rhs")


def probe(snapshot: dict, params, cfg: Config, cell: int, k: int) -> list:
    """Replay one day of column ``cell`` from ``snapshot`` (the arrays of
    zd09_blowup_full.npz) with the ZD09 and specific-yield profiles
    refreshed every ``k`` substeps (k=1: every substep, inside the
    substep), on the device of ``params``; prints one line a substep and
    returns the rows."""
    lg = cfg.layer_grid()
    dtype = torch.float32
    device = params.theta_s.device
    geom = Geometry.from_layer_grid(lg)
    dt = cfg.dt
    sel = slice(cell, cell + 1)

    def col(name):
        return torch.as_tensor(np.asarray(snapshot[name][sel]), dtype=dtype,
                               device=device)

    p1 = params.map(lambda x: x[sel].to(dtype))
    state = initial_state(p1, lg.dz, lg.zi, dtype, device)
    soil = state.soil.replace(h2osoi_liq=col("h2osoi"), zwt=col("zwt"),
                              wa=col("wa"), smp=col("smp"))
    veg = state.veg.replace(lai=col("lai"), lai_litter=col("lai_litter"),
                            rootr=col("rootr"))
    f1 = Forcing(**{f: col(f"forc_{f}") for f in FORCING_KEYS})
    fd = derive_forcing(f1)
    et_ctx = daily_et_context(fd, veg.lai)

    def fresh(zwt):
        zq = stack(compute_equilibrium_zq(
            zwt, unstack(p1.theta_s), unstack(p1.psi_s),
            unstack(p1.bsw), geom.zi))
        sy = stack(compute_specific_yields(
            zwt, unstack(p1.theta_s), unstack(p1.psi_s),
            unstack(p1.bsw)))
        return zq, sy

    zq = sy = None
    print(f"k={k}; start zwt={float(soil.zwt[0]):.4f} m "
          f"wa={float(soil.wa[0]):.2f} mm  "
          f"rain={float(fd['forc_rain'][0])*86400:.2f} mm/day")
    rows = []
    for it in range(cfg.nisurf):
        if k > 1:
            if it % k == 0:
                zq, sy = fresh(soil.zwt)
                tag = "R"            # refreshed this substep
            else:
                tag = " "
            soil, fx = hydrology_substep(soil, veg, p1, fd, geom, dt,
                                         zq=zq, sy=sy, et_ctx=et_ctx)
        else:
            tag = "R"
            soil, fx = hydrology_substep(soil, veg, p1, fd, geom, dt,
                                         et_ctx=et_ctx)
        jwt = int(water_table_index(soil.zwt, geom.zi)[0])
        row = dict(substep=it, refreshed=tag == "R",
                   zwt=float(soil.zwt[0]), jwt=jwt, wa=float(soil.wa[0]),
                   qcharge=float(fx.qcharge[0]),
                   rsub_top=float(fx.rsub_top[0]),
                   residual=float(fx.residual[0]))
        rows.append(row)
        print(f"  {it:2d}{tag} zwt={row['zwt']:12.5f} jwt={jwt} "
              f"wa={row['wa']:14.3f} "
              f"qcharge={row['qcharge']:12.4e} mm/s "
              f"rsub={row['rsub_top']:12.4e} "
              f"res={row['residual']:10.3e}")
        if not np.isfinite(row["wa"]):
            print("  -> NON-FINITE, stopping")
            break
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("k", nargs="?", type=int, default=8,
                    help="ZD09 refresh cadence in substeps")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = Config(resolution_deg=0.5, nisurf=48)
    _, params = load_soil(cfg, torch.float32, device)
    with np.load("zd09_blowup_full.npz") as z:
        probe(dict(z), params, cfg, CELL, args.k)
    return 0


if __name__ == "__main__":
    sys.exit(main())
