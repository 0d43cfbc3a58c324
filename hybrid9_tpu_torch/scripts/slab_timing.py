"""The flagship day on device slabs of one card: time, launches, syncs.

    python -m hybrid9_tpu_torch.scripts.slab_timing [--slabs 1,2,4]
        [--days 5] [--reps 2]

Builds ``build_flagship_case()`` (``Config()`` at 0.5 degrees, 69,632
cells) on the card, runs 30 days from 1 January to the winter state, and
then times ``--days`` days from there through
``block_step(devices=[cuda:0] * k)`` for each k of ``--slabs`` and
without ``devices`` (the unsharded day): ms a day by CUDA events and by
the host clock (each run closed by a synchronize), CUDA kernel launches
a day (``torch.profiler``), day-kernel launches a day, and host
synchronisations a day (``torch.cuda.set_sync_debug_mode("warn")``),
the forms in turns (in order, then in reverse).  Prints one JSON line
per form and the card's name and power limit.

The module imports only ``hybrid9_tpu_torch``'s public names, so it can
time another tree's package, e.g. the parent commit's, from its root:
``PYTHONPATH=<tree> python <this file>``.  What ``devices=`` runs is that
tree's: a hydrology day sharded per day, or resident slabs.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import warnings

import torch

from hybrid9_tpu_torch.data.synthetic import synthetic_forcing_block
from hybrid9_tpu_torch.entry import build_flagship_case
from hybrid9_tpu_torch.physics import day_kernel
from hybrid9_tpu_torch.state import AnnualAccumulators, Forcing
from hybrid9_tpu_torch.step import block_step

WINTER_DAYS = 30


def winter(case):
    """The flagship case's state after 30 days from 1 January, and the
    forcing of the days after it (seed 1, as ``chip_smoke.py``)."""
    sim = case.sim
    lat = case.land_grid.cell_lat

    def block(days, start):
        return Forcing.from_numpy(synthetic_forcing_block(
            days, sim.n, seed=1, start_doy=start, lat=lat), sim.dtype,
            sim.device)

    acc = AnnualAccumulators.zeros(sim.n, sim.dtype, sim.device)
    state, _ = block_step(sim.state, acc, block(WINTER_DAYS, 1), sim.params,
                          sim.geom, sim.cfg.dt, sim.cfg.nisurf,
                          **case.step_kwargs)
    return state, (lambda days: block(days, 1 + WINTER_DAYS))


def day_costs(case, state, block, devices, reps: int = 2) -> dict:
    """``block_step`` of ``block`` from ``state`` with ``devices``: ms a
    day (CUDA events, and the host clock around each synchronised run:
    their range over ``reps`` runs), CUDA kernel launches, day-kernel
    launches and host synchronisations a day."""
    sim = case.sim
    days = block.tas.shape[0]

    def run():
        acc = AnnualAccumulators.zeros(sim.n, sim.dtype, sim.device)
        return block_step(state, acc, block, sim.params, sim.geom,
                          sim.cfg.dt, sim.cfg.nisurf,
                          **dict(case.step_kwargs, devices=devices))[0]

    run()
    torch.cuda.synchronize()
    event_ms, wall_ms = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = run()
        stop.record()
        torch.cuda.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3 / days)
        event_ms.append(start.elapsed_time(stop) / days)
        if not bool(torch.isfinite(out.soil.h2osoi_liq).all()):
            raise RuntimeError(f"devices={devices}: non-finite state")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    launches0 = day_kernel.launches
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    day_launches = (day_kernel.launches - launches0) / days
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    return dict(slabs=0 if devices is None else len(devices),
                ms_a_day=event_ms, wall_ms_a_day=wall_ms,
                launches_a_day=len(kernels) / days,
                device_ms_a_day=sum(e.device_time for e in kernels)
                / 1e3 / days,
                day_kernel_launches_a_day=day_launches,
                host_syncs_a_day=syncs / days)


def in_turns(case, state, block, forms, reps: int = 2) -> list:
    """:func:`day_costs` of each of ``forms`` (lists of devices, None for
    the unsharded day), in turns: every form once in order, then in the
    reverse order; a form's ms lists join, its counts are the last
    run's."""
    out = {}
    for devices in list(forms) + list(forms)[::-1]:
        key = None if devices is None else len(devices)
        got = day_costs(case, state, block, devices, reps)
        if key in out:
            for name in ("ms_a_day", "wall_ms_a_day"):
                got[name] = out[key][name] + got[name]
        out[key] = got
    return [out[None if f is None else len(f)] for f in forms]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m hybrid9_tpu_torch.scripts.slab_timing",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--slabs", default="1,2,4")
    ap.add_argument("--days", type=int, default=5)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("slab_timing: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    case = build_flagship_case()
    dev = case.sim.device
    state, forcing = winter(case)
    block = forcing(args.days)
    print(f"slab_timing: {case.sim.n} cells, {args.days} days from day "
          f"{1 + WINTER_DAYS}, {smi}")
    forms = [None] + [[dev] * int(k) for k in args.slabs.split(",")]
    for costs in in_turns(case, state, block, forms, args.reps):
        print(json.dumps(costs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
