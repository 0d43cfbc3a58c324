"""Where the port's day goes on one CUDA GPU.

    python3 scripts/gpu_day_breakdown.py              # reference scope
    python3 scripts/gpu_day_breakdown.py --flagship   # Config() defaults
    python3 scripts/gpu_day_breakdown.py --year       # the flagship year
    python3 scripts/gpu_day_breakdown.py --switches   # Config's switches
    python3 scripts/gpu_day_breakdown.py --da         # a DA cycle
    python3 scripts/gpu_day_breakdown.py --site       # the site engine

Reference scope (66,560 cells, float32): times the CUDA day kernel at
zd09_every 8 and 1 (alternating), the whole ``day_step`` with the kernel,
and profiles ``day_step`` with torch.profiler: device-busy share of the
profiled window, launches per day and device time by kernel name.

``--flagship`` (69,632 cells, float32, ``Config()`` as it stands, on the
winter state that 30 days from 1 January leave): the same for the
flagship ``day_step``, and the launches and device time of each part of
the day profiled on its own: snow and impedance, the hydrology day
kernel, growth, routing, soil heat with the phase change, carbon.  The
kernel's branches make its time depend on the state and the forcing, so
the kernel day (with the impedance operand and the absorptivity) and the
whole day step are also timed on the initial state under the day-180
forcing of ``build_flagship_case`` and under 1 January's, and the kernel
day on the first 33,792 to 69,632 cells of it (one thread block more
must not cost a round of blocks more).

``--year`` (the flagship case through ``Simulation.run_year`` with
``forcing="device-synthetic"``): three years in one process, the first
and the later ones apart (seconds, forcing wait); the year loop's day
(``block_step`` with its daily sums, on a 10-day block of on-card
forcing) profiled: launches and device time per day; the on-card
generator of a 365-day block timed on its own; and the host generator
of the same block (``SyntheticForcingProvider.host_block``) and its copy
to the card, each timed alone.

``--switches`` (69,632 cells, float32, the flagship case's soil): for
``Config()`` and each of its non-default switches (hydrology-only,
two-layer snow, lateral groundwater, Muskingum-Cunge on the grid, the
packed kinematic router, the packed linear reservoir), the ``day_step``
on the winter state that 30 days from 1 January leave under that switch:
its time by CUDA events, and profiled, its launches per day and the
device-busy share.

``--da`` (``Config()`` at 0.5 degrees, 16 members folded: 1,114,112
cells, float32): one cycle of ``assimilate`` (the folded forecast and the
EnSRF analysis, ``assimilate._enkf_cycle``) and the analysis alone
(``enkf_update_scalar_obs`` on that forecast), each by CUDA events in two
passes, from the first draw and the initial state under day 180's
forcing.  Run from two trees in one call, it holds the analysis of one
against the other's.

``--site`` (one column, ``nisurf=48``): ``cli.main(["site", "--engine",
"kernel"])`` on the card over the 20 summer days of ``chip_smoke.py``'s
phase 13 (the default site's synthetic climate from day 180), three times
in one process; ms a site day of each.  Like ``--da``, run from two trees
in one call to hold one tree's site day against the other's.

Needs a CUDA device; prints the card's name and power limit beside the
numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from hybrid9_tpu_torch import step  # noqa: E402
from hybrid9_tpu_torch.config import Config  # noqa: E402
from hybrid9_tpu_torch.data.synthetic import (  # noqa: E402
    synthetic_forcing_block, synthetic_forcing_day)
from hybrid9_tpu_torch.entry import (build_flagship_case,  # noqa: E402
                                     build_reference_case)
from hybrid9_tpu_torch.physics import day_kernel  # noqa: E402
from hybrid9_tpu_torch.physics.snow import snow_step  # noqa: E402
from hybrid9_tpu_torch.run import Simulation  # noqa: E402
from hybrid9_tpu_torch.physics.soiltemp import (  # noqa: E402
    freeze_impedance_from_ice)
from hybrid9_tpu_torch.state import AnnualAccumulators, Forcing  # noqa: E402

N_CELLS = 66_560
WINTER_DAYS = 30


def _event_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _profile(fn, reps):
    """``(device kernel events, wall ms)`` of ``reps`` calls of ``fn``
    under torch.profiler."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return kernels, wall_ms


def _profile_day(label, fn, days=5, top=12):
    kernels, wall_ms = _profile(fn, days)
    busy_ms = sum(e.device_time for e in kernels) / 1e3
    print(f"profiled {days} {label}: wall {wall_ms:.2f} ms, device busy "
          f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f} %), "
          f"{len(kernels) / days:.0f} kernel launches per day")
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.device_time / 1e3, n + 1)
    print(f"device ms per day by kernel (top {top}):")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[
            :top]:
        print(f"  {t / days:8.3f} ms  {n // days:5d} launches  {name[:90]}")
    return busy_ms / days, len(kernels) / days


def reference_scope(card: str) -> None:
    case = build_reference_case(N_CELLS, "float32")
    st, cfg = case.state, case.cfg
    args = (st.soil, st.veg, case.params, case.forcing, case.geom, cfg.dt,
            cfg.nisurf)

    for k in (8, 1, 1, 8):
        ms = _event_ms(lambda: day_kernel.hydrology_day_cuda(
            *args, zd09_every=k), 20)
        print(f"kernel day, zd09_every={k}: {ms:.3f} ms, "
              f"{N_CELLS / (ms * 1e-3):.4g} cell-days/s ({card})")

    def day():
        return step.day_step(st, case.forcing, case.params, case.geom,
                             cfg.dt, cfg.nisurf, zd09_every=cfg.zd09_every)

    print(f"day_step with kernel: {_event_ms(day, 10):.3f} ms ({card})")
    _profile_day("day_steps", day)


def flagship(card: str) -> None:
    case = build_flagship_case()
    sim, kw = case.sim, case.step_kwargs
    cfg, n = sim.cfg, sim.n
    lat = case.land_grid.cell_lat
    dev = sim.device
    block = Forcing.from_numpy(
        synthetic_forcing_block(WINTER_DAYS, n, seed=1, start_doy=1,
                                lat=lat), torch.float32, dev)
    run = (sim.params, sim.geom, cfg.dt, cfg.nisurf)
    winter, _ = step.block_step(
        sim.state, AnnualAccumulators.zeros(n, torch.float32, dev), block,
        *run, **kw)
    forcing = Forcing.from_numpy(
        synthetic_forcing_day(n, 1 + WINTER_DAYS, seed=1, lat=lat),
        torch.float32, dev)
    print(f"flagship: {n} cells, f32, zd09_every={cfg.zd09_every}, winter "
          f"state after {WINTER_DAYS} days ({card})")

    def kernel_day(state, f, params=sim.params):
        imp = freeze_impedance_from_ice(state.soil.h2osoi_liq,
                                        state.h2osoi_ice)
        sw_abs = step.snow_absorptivity(state.swe, *sim.snow_albedo)
        return lambda: day_kernel.hydrology_day_cuda(
            state.soil, state.veg, params, f, sim.geom, cfg.dt,
            cfg.nisurf, imp=imp, zd09_every=cfg.zd09_every, sw_abs=sw_abs)

    jan1 = block.map(lambda x: x[0])
    cases = (("initial state, day-180 forcing", sim.state, case.forcing),
             ("initial state, 1 January forcing", sim.state, jan1),
             ("winter state, 31 January forcing", winter, forcing))
    for order in (cases, cases[::-1]):
        for label, state, f in order:
            ms = _event_ms(kernel_day(state, f), 20)
            step_ms = _event_ms(
                lambda: step.day_step(state, f, *run, **kw), 10)
            print(f"{label}: kernel day with imp {ms:.3f} ms, day_step "
                  f"{step_ms:.3f} ms ({card})")

    # The kernel day by cell count, on the first cells of the initial
    # state: the card holds 71,808 cells of the main-path instance at
    # once (17 one-warp blocks on each of 132 SMs).
    for m in (33_792, 66_560, 67_584, 67_712, n):
        def first(x):
            return x[:m]
        fn = kernel_day(sim.state.map(first), case.forcing.map(first),
                        sim.params.map(first))
        print(f"kernel day with imp, first {m} cells ({-(-m // 32)} "
              f"warps): {_event_ms(fn, 20):.3f} ms ({card})")

    def day():
        return step.day_step(winter, forcing, *run, **kw)

    for _ in range(3):
        ms = _event_ms(day, 10)
        print(f"flagship day_step with kernel: {ms:.3f} ms, "
              f"{n / (ms * 1e-3):.4g} cell-days/s ({card})")
    busy_ms, launches = _profile_day("flagship day_steps", day)

    # Each part of the day on its own, on the inputs the day gives it.
    new_state, diags = day()
    sw_abs = step.snow_absorptivity(winter.swe, *sim.snow_albedo)
    imp = freeze_impedance_from_ice(winter.soil.h2osoi_liq,
                                    winter.h2osoi_ice)
    pr_eff = snow_step(winter.swe, forcing.tas, forcing.pr, sim.snow)[1]
    f_eff = forcing.replace(pr=pr_eff)
    _, _, litterfall, vflux = step._grow(winter.veg, new_state.soil, f_eff,
                                         sim.geom, True)

    def snow_and_impedance():
        step.snow_absorptivity(winter.swe, *sim.snow_albedo)
        snow_step(winter.swe, forcing.tas, forcing.pr, sim.snow)
        return freeze_impedance_from_ice(winter.soil.h2osoi_liq,
                                         winter.h2osoi_ice)

    parts = {
        "snow + impedance": snow_and_impedance,
        "hydrology day (the kernel's wrapper: one launch)":
            lambda: day_kernel.hydrology_day(
                winter.soil, winter.veg, sim.params, f_eff, sim.geom,
                cfg.dt, cfg.nisurf, imp=imp, zd09_every=cfg.zd09_every,
                sw_abs=sw_abs),
        "growth": lambda: step._grow(winter.veg, new_state.soil, f_eff,
                                     sim.geom, True),
        "routing": lambda: step._route(winter.river_store, diags,
                                       kw["routing"]),
        "soil heat + phase change": lambda: step._soil_thermal(
            winter, new_state.soil, sim.params, f_eff, sim.geom, True,
            sw_abs),
        "carbon": lambda: step._carbon(
            winter.carbon, vflux, litterfall, new_state.t_soil,
            new_state.soil, sim.params, sim.geom, True),
    }
    total_n = total_ms = 0.0
    print("parts of the flagship day, each profiled alone (5 calls):")
    for label, fn in parts.items():
        kernels, wall_ms = _profile(fn, 5)
        n_k = len(kernels) / 5
        ms = sum(e.device_time for e in kernels) / 5e3
        total_n += n_k
        total_ms += ms
        print(f"  {n_k:6.0f} launches  {ms:7.3f} ms device  "
              f"{wall_ms / 5:7.3f} ms wall  {label}")
    print(f"  {total_n:6.0f} launches  {total_ms:7.3f} ms device  in the "
          f"parts; the whole day: {launches:.0f} launches, {busy_ms:.3f} ms "
          f"device (the rest is the daily sums and bookkeeping)")


def year(card: str) -> None:
    from hybrid9_tpu_torch.data.device_forcing import \
        DeviceSyntheticForcingProvider
    from hybrid9_tpu_torch.data.forcing import (SyntheticForcingProvider,
                                                to_device)

    case = build_flagship_case()
    sim, grid = case.sim, case.land_grid
    provider = DeviceSyntheticForcingProvider(sim.n, seed=0,
                                              lat=grid.cell_lat)
    for y in (1901, 1902, 1903):
        sim.run_year(y, provider)
    for t in sim.timings:
        print(f"year {t['year']}: {t['seconds']:.3f} s, "
              f"{sim.n * 365 / t['seconds']:.4g} cell-days/s, forcing wait "
              f"{t['forcing_wait_s']:.3f} s ({card})")

    block = provider(1904, 1, 10)
    acc = AnnualAccumulators.zeros(sim.n, torch.float32, sim.device)

    def days():
        return step.block_step(sim.state, acc, block, sim.params, sim.geom,
                               sim.cfg.dt, sim.cfg.nisurf,
                               **case.step_kwargs)[0].soil.zwt

    kernels, wall_ms = _profile(days, 1)
    busy_ms = sum(e.device_time for e in kernels) / 1e3
    print(f"profiled the year loop's day (block_step, 10 days): "
          f"{wall_ms / 10:.3f} ms wall a day, device busy "
          f"{busy_ms / 10:.3f} ms a day ({100 * busy_ms / wall_ms:.1f} %), "
          f"{len(kernels) / 10:.0f} launches a day ({card})")
    print(f"on-card generator, 365-day block: "
          f"{_event_ms(lambda: provider(1904, 1, 365).tas, 3):.2f} ms")
    host = SyntheticForcingProvider(sim.n, seed=0, lat=grid.cell_lat)
    t0 = time.perf_counter()
    arrays = host.host_block(1904, 1, 365)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    to_device(arrays, sim.device).tas.sum().item()
    copy_s = time.perf_counter() - t0
    mbytes = sum(a.nbytes for a in arrays.values()) / 1e6
    print(f"host generator, 365-day block: {gen_s:.2f} s; pinned copy to "
          f"the card {copy_s:.3f} s ({mbytes:.0f} MB)")


SWITCHES = (("Config()", {}), ("hydrology_only", dict(vegetation=False)),
            ("twolayer_snow", dict(snow_scheme="twolayer")),
            ("lateral_groundwater", dict(lateral_groundwater=True)),
            ("muskingum_grid", dict(routing_scheme="muskingum")),
            ("kinematic_packed", dict(routing_form="packed")),
            ("linear_packed", dict(routing_scheme="linear")))


def switches(card: str) -> None:
    case = build_flagship_case()
    n, lat, dev = case.sim.n, case.land_grid.cell_lat, case.sim.device
    block = Forcing.from_numpy(
        synthetic_forcing_block(WINTER_DAYS, n, seed=1, start_doy=1,
                                lat=lat), torch.float32, dev)
    forcing = Forcing.from_numpy(
        synthetic_forcing_day(n, 1 + WINTER_DAYS, seed=1, lat=lat),
        torch.float32, dev)
    rows = {}
    for name, switch in SWITCHES:
        sim = Simulation(Config(**switch), case.sim.params,
                         land_grid=case.land_grid)
        kw = sim.step_kwargs()
        run = (sim.params, sim.geom, sim.cfg.dt, sim.cfg.nisurf)
        winter, _ = step.block_step(
            sim.state, AnnualAccumulators.zeros(n, torch.float32, dev),
            block, *run, **kw)

        def day():
            return step.day_step(winter, forcing, *run, **kw)

        ms = [_event_ms(day, 10) for _ in range(2)]
        busy_ms, launches = _profile_day(f"day_steps, {name}", day, top=4)
        rows[name] = dict(day_step_ms=ms, device_ms=busy_ms,
                          launches=launches, busy_share=busy_ms / min(ms))
        print(f"{name}: day_step {ms[0]:.3f}, {ms[1]:.3f} ms, {launches:.0f} "
              f"launches a day, device busy {busy_ms:.3f} ms ({card})")
    print("switches: " + json.dumps(rows))


def da_cycle(card: str) -> None:
    from hybrid9_tpu_torch import assimilate as da
    from hybrid9_tpu_torch.data.soil import load_soil
    from hybrid9_tpu_torch.ensemble import fold
    from hybrid9_tpu_torch.physics.hydrology import Geometry
    from hybrid9_tpu_torch.state import initial_state
    cfg, m, dev = Config(), 16, torch.device("cuda")
    grid, params = load_soil(cfg, torch.float32, dev)
    n, lg = grid.n_padded, cfg.layer_grid()
    state_m = initial_state(params, lg.dz, lg.zi, torch.float32, dev).map(
        lambda x: fold(x, m))
    params_t = params.map(lambda x: fold(x, m))
    geom = Geometry.from_layer_grid(lg)
    f_day = Forcing.from_numpy(synthetic_forcing_day(n, 180, seed=1,
                                                     lat=grid.cell_lat),
                               torch.float32, dev)
    theta_m = da.first_draw(torch.Generator(device=dev).manual_seed(0), m, n,
                            0.3, torch.float32)
    mask = torch.arange(n, device=dev) < grid.n_land
    obs = torch.full((n,), 1.5, device=dev)
    enkf = da.EnKFConfig(obs_err_std=0.1, rtps=0.6)

    def cycle():
        return da._enkf_cycle(state_m, theta_m, params_t, f_day, obs, mask,
                              geom, cfg.dt, m, cfg.nisurf, cfg.vegetation,
                              None, cfg.zd09_every, enkf)

    forecast, _, y_pred = cycle()
    nl = forecast.soil.h2osoi_liq.shape[1]
    aug = dict(h2osoi=forecast.soil.h2osoi_liq.reshape(n, m, nl)
               .transpose(0, 1), wa=forecast.soil.wa.reshape(n, m).T,
               theta=theta_m)

    def analysis():
        return da.enkf_update_scalar_obs(aug, y_pred, obs, mask,
                                         enkf)["theta"]

    row = dict(cells=n * m,
               cycle_ms=[_event_ms(lambda: cycle()[1], 10) for _ in range(2)],
               analysis_ms=[_event_ms(analysis, 20) for _ in range(2)])
    print(f"DA cycle, {m} members x {n} cells ({card}): " + json.dumps(row))


SITE_DAYS = 20
SITE_FIRST_DOY = 180


def site(card: str) -> None:
    import tempfile

    import numpy as np

    from hybrid9_tpu_torch import cli
    with tempfile.TemporaryDirectory() as tmp:
        clim = os.path.join(tmp, "climate.csv")
        keys = ("tas", "rlds", "rsds", "huss", "ps", "pr", "rhs")
        with open(clim, "w") as f:
            f.write(",".join(keys) + "\n")
            for d in range(SITE_FIRST_DOY, SITE_FIRST_DOY + SITE_DAYS):
                day = synthetic_forcing_day(
                    1, d, seed=17, lat=np.array([Config().site_lat]))
                f.write(",".join(repr(float(day[k][0])) for k in keys)
                        + "\n")
        ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            rc = cli.main(["site", "--climate", clim, "--nisurf", "48",
                           "--engine", "kernel", "--csv-out",
                           os.path.join(tmp, "site.csv")])
            ms.append((time.perf_counter() - t0) / SITE_DAYS * 1e3)
            if rc != 0:
                raise SystemExit(f"site: exit code {rc}")
    print(f"site day, one column, nisurf 48 ({card}): "
          + json.dumps(dict(days=SITE_DAYS, ms_per_site_day=ms)))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--flagship", action="store_true",
                        help="profile the flagship day instead of the "
                             "reference-scope day")
    parser.add_argument("--year", action="store_true",
                        help="time and profile the flagship year loop")
    parser.add_argument("--switches", action="store_true",
                        help="time and profile the flagship day under each "
                             "non-default switch of Config")
    parser.add_argument("--da", action="store_true",
                        help="time a DA cycle and its analysis at 16 "
                             "members")
    parser.add_argument("--site", action="store_true",
                        help="time the site engine's day on the card")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gpu_day_breakdown: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card)
    if args.site:
        site(card)
    elif args.da:
        da_cycle(card)
    elif args.switches:
        switches(card)
    elif args.year:
        year(card)
    else:
        (flagship if args.flagship else reference_scope)(card)


if __name__ == "__main__":
    main()
