"""Production-resolution rehearsal of the split dense router.

Port of ``scripts/halo_rehearsal.py``.  Runs the dense kinematic router
(``Config.routing_form="grid"``) at the real production resolution, 0.5
degrees (a 360 x 720 grid), split into 8 row bands over device slabs
(``parallel.sharding.DeviceSlabs``, ``step.slab_day_step``), and audits
the exchanges of one routed day by the census of
``parallel.sharding.collectives``: exactly ``2 (k - 1)`` halo row copies
a routing substep, one reshard each way, no gather of the whole grid and
no exchange from a cell-local module (a day without the router makes
none).  Then it times one routed day in both routing forms over the same
slabs: the packed form, which gathers its operands onto the first device
once a day, and the split dense form.

Usage: python -m hybrid9_tpu_torch.scripts.halo_rehearsal [--device cuda]
           [--resolution 0.5] [--bands 8] [--iters 5]
Prints the census, the audit verdict and the wall time of a routed day
in each form; exit 0 iff the audit holds.  The bands may share one card
(``[cuda:0] * 8`` on a one-card machine).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..entry import build_reference_case
from ..grids.grid import make_land_grid, synthetic_land_mask
from ..grids.routing import (build_downstream_index, direction_codes,
                             flow_length_m)
from ..parallel import sharding as parallel
from ..physics.routing import (GridKinematicParams, GridRouting,
                               KinematicParams)
from ..run import resolve_device
from ..step import slab_day_step

NISURF = 4          # the audit does not depend on nisurf
N_SUBSTEPS = 8      # Config.routing_substeps' default


def _census(fn) -> dict:
    parallel.collectives.clear()
    fn()
    return dict(parallel.collectives)


def rehearse(device: torch.device, resolution_deg: float = 0.5,
             bands: int = 8, iters: int = 5) -> dict:
    """The audit and the timings at ``resolution_deg`` over ``bands``
    slabs of ``device``.  Returns a dict: the grid, the census of a
    routed day in each form and of a day without the router, the
    expected counts, ``ok`` and the seconds of a routed day in each
    form."""
    mask = synthetic_land_mask(resolution_deg=resolution_deg, seed=1)
    grid = make_land_grid(mask, resolution_deg, pad_multiple=1024)
    down = build_downstream_index(grid)
    length = flow_length_m(grid, down)
    flat_idx = np.full(grid.n_padded, grid.ny * grid.nx, np.int64)
    flat_idx[:grid.n_land] = grid.land_idx
    routers = dict(
        grid=GridRouting(
            params=GridKinematicParams(
                dir_code=torch.tensor(direction_codes(grid, down),
                                      device=device),
                flow_length=torch.tensor(grid.scatter(length, fill=1.0),
                                         dtype=torch.float32, device=device),
                n_substeps=N_SUBSTEPS),
            flat_idx=torch.tensor(flat_idx, device=device),
            n_land=grid.n_land, ny=grid.ny, nx=grid.nx),
        packed=KinematicParams(
            downstream=torch.tensor(down, dtype=torch.int64, device=device),
            flow_length=torch.tensor(length, dtype=torch.float32,
                                     device=device),
            n_substeps=N_SUBSTEPS))

    case = build_reference_case(grid.n_padded, "float32", device)
    slabs = parallel.DeviceSlabs.create(grid.n_padded, [device] * bands)
    states, forcings, params = (slabs.put(x) for x in (
        case.state, case.forcing, case.params))

    def day(routing):
        return slab_day_step(slabs, states, forcings, params, case.geom,
                             case.cfg.dt, NISURF, routing=routing)

    census = {name: _census(lambda: day(r)) for name, r in routers.items()}
    census["no_router"] = _census(lambda: day(None))
    want = dict(grid={"halo": 2 * (bands - 1) * N_SUBSTEPS, "reshard": 2},
                packed={"gather": 1}, no_router={})
    out = dict(grid=f"{grid.ny}x{grid.nx}", land_cells=grid.n_land,
               cells=grid.n_padded, bands=bands,
               rows=[list(r) for r in slabs.row_bands(grid.ny)],
               census=census, expected=want, ok=census == want)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    seconds = {}
    for name, routing in routers.items():
        _, diags = day(routing)                          # warm
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            _, diags = day(routing)
        checksum = float(sum(d["discharge"].double().sum() for d in diags))
        sync()
        seconds[name] = (time.perf_counter() - t0) / iters
        if not np.isfinite(checksum):
            raise RuntimeError(f"{name} routed day: non-finite discharge")
    out["seconds_a_day"] = seconds
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m hybrid9_tpu_torch.scripts.halo_rehearsal",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="device of the bands (default: the card)")
    ap.add_argument("--resolution", type=float, default=0.5)
    ap.add_argument("--bands", type=int, default=8)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    res = rehearse(device, args.resolution, args.bands, args.iters)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"grid: {res['grid']} dense, {res['land_cells']} land cells, "
          f"{res['cells']} padded, {res['bands']} row bands {res['rows']} "
          f"on {device} ({name})")
    print("collective census of one day: " + json.dumps(res["census"]))
    if res["ok"]:
        print(f"audit OK at {res['grid'].split('x')[0]} rows: the split "
              f"router exchanges {res['expected']['grid']['halo']} halo "
              f"rows and one reshard each way a day, the packed router "
              f"one gather, the cell-local modules nothing")
    else:
        print("FAIL: census differs from " + json.dumps(res["expected"]))
    for form, s in res["seconds_a_day"].items():
        print(f"{form:6s} routed day: {s * 1e3:.3f} ms ({res['bands']} "
              f"slabs of {device}, nisurf={NISURF}, routing substeps="
              f"{N_SUBSTEPS})")
    s = res["seconds_a_day"]
    print(f"grid/packed wall ratio: {s['grid'] / s['packed']:.2f}x")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
