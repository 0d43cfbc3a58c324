"""Device slabs of one card: time, launches, syncs.

    python -m hybrid9_tpu_torch.scripts.slab_timing [--slabs 1,2,4]
        [--parts day,loop,fit,spinup] [--days 5] [--reps 2]

On ``Config()`` at 0.5 degrees (69,632 cells) on the card, each part
without ``devices`` (unsharded) and as ``[cuda:0] * k`` for each k of
``--slabs``:

* ``day`` (the default): the flagship day.  Builds
  ``build_flagship_case()``, runs 30 days from 1 January to the winter
  state, and then times ``--days`` days from there through
  ``block_step(devices=...)``;
* ``loop``: the closed loop's days on the first day of 1901: the ensemble
  day (8 members, 557,056 folded cells; ``ensemble._run_annual_folded``
  over one day), the DA forecast and the DA cycle (16 members, 1,114,112
  cells; a day step and ``assimilate._enkf_cycle`` a slab);
* ``fit``: one Adam step of the per-cell hksat fit at 2 degrees (5,120
  cells) over 2 days (``calibrate`` with ``steps=1``): seconds from the
  call to the end of the step, synchronised, and peak device memory;
* ``spinup``: one rehearsal year of ``spinup_carbon`` on
  ``Simulation(devices=...)`` with on-card forcing: seconds and
  day-kernel launches.

``day`` and ``loop`` report ms a day by CUDA events and by the host clock
(each run closed by a synchronize), CUDA kernel launches a day
(``torch.profiler``), device ms a day, day-kernel launches a day and host
synchronisations a day (``torch.cuda.set_sync_debug_mode("warn")``), the
forms in turns (in order, then in reverse).  Prints one JSON line per
part and form, and the card's name and power limit.

The module imports only ``hybrid9_tpu_torch``'s public names, so it can
time another tree's package, e.g. the parent commit's, from its root:
``PYTHONPATH=<tree> python <this file>``.  What ``devices=`` runs is that
tree's: a hydrology day sharded per day, or resident slabs (``day``);
``loop``, ``fit`` and ``spinup`` need a tree whose drivers take
``devices=``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import warnings
from typing import NamedTuple, Optional, Sequence

import torch

from hybrid9_tpu_torch import assimilate as da
from hybrid9_tpu_torch import ensemble as ens
from hybrid9_tpu_torch.calibrate import (CalibrationSpec, apply_multipliers,
                                         calibrate, simulate_daily_et)
from hybrid9_tpu_torch.cli import _stacked_forcing
from hybrid9_tpu_torch.config import Config
from hybrid9_tpu_torch.data.device_forcing import \
    DeviceSyntheticForcingProvider
from hybrid9_tpu_torch.data.soil import load_soil
from hybrid9_tpu_torch.data.synthetic import synthetic_forcing_block
from hybrid9_tpu_torch.entry import build_flagship_case
from hybrid9_tpu_torch.parallel.sharding import DeviceSlabs
from hybrid9_tpu_torch.physics import day_kernel
from hybrid9_tpu_torch.physics.hydrology import Geometry
from hybrid9_tpu_torch.run import Simulation
from hybrid9_tpu_torch.spinup import spinup_carbon
from hybrid9_tpu_torch.state import AnnualAccumulators, Forcing, initial_state
from hybrid9_tpu_torch.step import block_step, day_step

WINTER_DAYS = 30
ENSEMBLE_MEMBERS = 8          # the ensemble command's default
DA_MEMBERS = 16               # the assimilate command's default
FIT_DEG = 2.0
FIT_DAYS = 2
TWIN_LOG_MULT = 0.5           # the observations' hksat log-multiplier


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


def costs(run, days: int, reps: int = 2) -> dict:
    """``run()`` (which returns a tensor, held finite) timed over ``days``
    model days a run: ms a day (CUDA events, and the host clock around
    each synchronised run: their lists over ``reps`` runs), CUDA kernel
    launches, device ms, day-kernel launches and host synchronisations a
    day."""
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
        if not bool(torch.isfinite(out).all()):
            raise RuntimeError("non-finite output in a timed run")
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
    return dict(ms_a_day=event_ms, wall_ms_a_day=wall_ms,
                launches_a_day=len(kernels) / days,
                device_ms_a_day=sum(e.device_time for e in kernels)
                / 1e3 / days,
                day_kernel_launches_a_day=day_launches,
                host_syncs_a_day=syncs / days)


def day_costs(case, state, block, devices, reps: int = 2) -> dict:
    """:func:`costs` of ``block_step`` of ``block`` from ``state`` with
    ``devices``."""
    sim = case.sim

    def run():
        acc = AnnualAccumulators.zeros(sim.n, sim.dtype, sim.device)
        return block_step(state, acc, block, sim.params, sim.geom,
                          sim.cfg.dt, sim.cfg.nisurf,
                          **dict(case.step_kwargs, devices=devices))[
            0].soil.h2osoi_liq

    return dict(slabs=0 if devices is None else len(devices),
                **costs(run, block.tas.shape[0], reps))


def _joined(got: dict, key, new: dict) -> dict:
    """``new`` with the ms lists of an earlier run of the same form
    (``got[key]``) in front."""
    if key in got:
        for name in ("ms_a_day", "wall_ms_a_day"):
            new[name] = got[key][name] + new[name]
    return new


def in_turns(case, state, block, forms, reps: int = 2) -> list:
    """:func:`day_costs` of each of ``forms`` (lists of devices, None for
    the unsharded day), in turns: every form once in order, then in the
    reverse order; a form's ms lists join, its counts are the last
    run's."""
    out = {}
    for devices in list(forms) + list(forms)[::-1]:
        key = None if devices is None else len(devices)
        out[key] = _joined(out, key,
                           day_costs(case, state, block, devices, reps))
    return [out[None if f is None else len(f)] for f in forms]


class LoopProblem(NamedTuple):
    """The closed loop on ``cfg``'s grid: parameters, initial state,
    ``[days, n]`` forcing from 1 January, observations of daily ET and
    their mask (padding lanes unobserved), the ensemble's multipliers and
    the DA prior, cell-major ``[n, m]`` (``assimilate.first_draw``)."""

    cfg: Config
    n_land: int
    params: object
    state0: object
    geom: Geometry
    forcing: Forcing
    obs: torch.Tensor
    mask: torch.Tensor
    theta: dict
    prior: torch.Tensor

    @property
    def step(self) -> dict:
        """The keywords the closed loop's drivers take from ``cfg``."""
        cfg = self.cfg
        return dict(nisurf=cfg.nisurf, vegetation=cfg.vegetation,
                    zd09_every=cfg.zd09_every, use_kernel=cfg.use_kernel)


def loop_problem(cfg: Config, device, days: int) -> LoopProblem:
    """The closed loop's problem on ``cfg`` (host synthetic forcing, as
    the commands read it), with observations made by the configured day
    (the kernel on the card) under hksat log-multiplier
    TWIN_LOG_MULT."""
    dtype = getattr(torch, cfg.dtype)
    grid, params = load_soil(cfg, dtype, device)
    lg = cfg.layer_grid()
    state0 = initial_state(params, lg.dz, lg.zi, dtype, device)
    geom = Geometry.from_layer_grid(lg)
    forcing = _stacked_forcing(cfg, grid, days, dtype, device)
    truth = apply_multipliers(params, {"hksat": torch.tensor(
        TWIN_LOG_MULT, dtype=dtype, device=device)})
    prob = LoopProblem(cfg, grid.n_land, params, state0, geom, forcing,
                       None, None, None, None)
    state, ys = state0, []
    for d in range(days):
        state, diags = day_step(state, forcing.map(lambda x: x[d]), truth,
                                geom, cfg.dt, **prob.step)
        ys.append(diags["evap_day"])
    obs = torch.stack(ys)
    mask = torch.zeros(obs.shape, dtype=torch.bool, device=device)
    mask[:, :grid.n_land] = True
    theta = ens.perturbed_multipliers(
        torch.Generator(device=device).manual_seed(0), ENSEMBLE_MEMBERS,
        fields=("hksat", "bsw", "psi_s"), sigma=0.3, dtype=dtype)
    prior = da.first_draw(torch.Generator(device=device).manual_seed(0),
                          DA_MEMBERS, grid.n_padded, 0.3, dtype).T
    return prob._replace(obs=obs, mask=mask, theta=theta, prior=prior)


ENKF = da.EnKFConfig(obs_err_std=0.1, rtps=0.6)


def loop_days(prob: LoopProblem, devices: Optional[Sequence]) -> dict:
    """The closed loop's day on ``devices`` (None: unsharded), its inputs
    cut and folded once: ``{"ensemble_day", "da_forecast", "da_cycle"}``,
    each a function that runs the day on every slab and returns the last
    slab's ET."""
    cfg, geom, m = prob.cfg, prob.geom, DA_MEMBERS
    slabs = None
    if devices is not None:
        slabs = DeviceSlabs.create(prob.params.n_cells, devices)

    def cut(tree, block=False):
        if slabs is None:
            return [tree]
        return slabs.put_block(tree) if block else slabs.put(tree)

    params, states0 = cut(prob.params), cut(prob.state0)
    folded = [ens._fold_problem(prob.theta, p, s, ENSEMBLE_MEMBERS)
              for p, s in zip(params, states0)]
    day1 = cut(prob.forcing.map(lambda x: x[:1]), block=True)
    tiled = [p.map(lambda x: ens.fold(x, m)) for p in params]
    states = [s.map(lambda x: ens.fold(x, m)) for s in states0]
    thetas = [t.T for t in cut(prob.prior)]
    days = [f.map(lambda x: x[0]) for f in day1]
    obs, mask = cut(prob.obs[0]), cut(prob.mask[0])

    def ensemble_day():
        sums = ens._run_annual_folded(
            [s for _, s in folded], day1, [p for p, _ in folded], geom,
            cfg.dt, ENSEMBLE_MEMBERS, cfg.nisurf, cfg.vegetation,
            cfg.use_kernel, cfg.zd09_every)
        return sums[-1]["evap"]

    def da_forecast():
        for p, s, t, f in zip(tiled, states, thetas, days):
            y = day_step(s, f.map(lambda x: ens.fold(x, m)),
                         apply_multipliers(p, {"hksat": t.T.reshape(-1)}),
                         geom, cfg.dt, **prob.step)[1]["evap_day"]
        return y

    def da_cycle():
        for p, s, t, f, o, w in zip(tiled, states, thetas, days, obs, mask):
            y = da._enkf_cycle(s, t, p, f, o, w, geom, cfg.dt, m,
                               cfg.nisurf, cfg.vegetation, cfg.use_kernel,
                               cfg.zd09_every, ENKF)[2]
        return y

    return dict(ensemble_day=ensemble_day, da_forecast=da_forecast,
                da_cycle=da_cycle)


def loop_costs(prob: LoopProblem, forms, reps: int = 2) -> dict:
    """:func:`costs` of each day of :func:`loop_days` on each of ``forms``
    (lists of devices, None for unsharded), in turns as :func:`in_turns`:
    ``{day: [costs of each form]}``."""
    runs = {None if f is None else len(f): loop_days(prob, f)
            for f in forms}
    out = {}
    for key in list(runs) + list(runs)[::-1]:
        for name, run in runs[key].items():
            got = out.setdefault(name, {})
            got[key] = _joined(got, key, dict(slabs=key or 0,
                                              **costs(run, 1, reps)))
    return {name: [got[k] for k in runs] for name, got in out.items()}


class FitProblem(NamedTuple):
    """A per-cell fit of hksat on ``cfg``'s grid over ``[days, n]``
    forcing, to observations made by the plain day under hksat
    log-multiplier 0.4 (the padding lanes masked)."""

    cfg: Config
    params: object
    state0: object
    geom: Geometry
    forcing: Forcing
    obs: torch.Tensor
    mask: torch.Tensor


def fit_problem(cfg: Config, device, days: int) -> FitProblem:
    dtype = getattr(torch, cfg.dtype)
    grid, params = load_soil(cfg, dtype, device)
    lg = cfg.layer_grid()
    state0 = initial_state(params, lg.dz, lg.zi, dtype, device)
    geom = Geometry.from_layer_grid(lg)
    forcing = _stacked_forcing(cfg, grid, days, dtype, device)
    with torch.no_grad():
        obs = simulate_daily_et(
            {"hksat": torch.tensor(0.4, dtype=dtype, device=device)},
            params, state0, forcing, geom, cfg.nisurf,
            vegetation=cfg.vegetation)
    mask = torch.zeros(obs.shape, dtype=torch.bool, device=device)
    mask[:, :grid.n_land] = True
    return FitProblem(cfg, params, state0, geom, forcing, obs, mask)


def fit_step(prob: FitProblem, devices: Optional[Sequence],
             steps: int = 1) -> dict:
    """``calibrate`` of a per-cell hksat on ``devices`` (None: unsharded)
    for ``steps`` Adam steps: the result; the first step's seconds, from
    the call to the end of the step (the device synchronised); the fit's
    peak device memory (0 off the card); whether every gradient Adam was
    given was finite; day-kernel launches."""
    from torch.optim import optimizer
    device = prob.params.hksat.device
    cuda = device.type == "cuda"
    marks, finite = [], []

    def pre(opt, args, kwargs):
        finite.extend(t.grad is not None and bool(torch.isfinite(
            t.grad).all()) for g in opt.param_groups for t in g["params"])

    def post(opt, args, kwargs):
        if cuda:
            torch.cuda.synchronize(device)
        marks.append(time.perf_counter())
    hooks = [optimizer.register_optimizer_step_pre_hook(pre),
             optimizer.register_optimizer_step_post_hook(post)]
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    launches0 = day_kernel.launches
    t0 = time.perf_counter()
    try:
        res = calibrate(prob.params, prob.state0, prob.forcing, prob.geom,
                        prob.obs, spec=CalibrationSpec(fields=("hksat",),
                                                       per_cell=True),
                        nisurf=prob.cfg.nisurf, steps=steps,
                        obs_mask=prob.mask, devices=devices)
    finally:
        for h in hooks:
            h.remove()
    return dict(result=res, step_s=marks[0] - t0,
                peak_bytes=(torch.cuda.max_memory_allocated(device)
                            if cuda else 0),
                grads_finite=bool(finite) and all(finite),
                launches=day_kernel.launches - launches0)


def rehearsal_year(cfg: Config, params, land_grid, devices) -> dict:
    """One rehearsal year of ``spinup_carbon`` on ``Simulation(cfg,
    params, devices=devices)`` with on-card forcing (seed 0): the report,
    the seconds (the year ends in its host copy), day-kernel launches and
    the simulation."""
    sim = Simulation(cfg, params, land_grid=land_grid, devices=devices)
    provider = DeviceSyntheticForcingProvider(
        sim.n, seed=0, lat=land_grid.cell_lat, dtype=sim.dtype,
        device=sim.device)
    launches0 = day_kernel.launches
    t0 = time.perf_counter()
    report = spinup_carbon(sim, provider, max_loops=1)
    return dict(report=report, seconds=time.perf_counter() - t0,
                launches=day_kernel.launches - launches0, sim=sim)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m hybrid9_tpu_torch.scripts.slab_timing",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--slabs", default="1,2,4")
    ap.add_argument("--parts", default="day",
                    help="comma-separated: day, loop, fit, spinup")
    ap.add_argument("--days", type=int, default=5)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    parts = args.parts.split(",")
    unknown = set(parts) - {"day", "loop", "fit", "spinup"}
    if unknown:
        raise SystemExit(f"slab_timing: unknown parts {sorted(unknown)}")
    if not torch.cuda.is_available():
        raise SystemExit("slab_timing: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    case = build_flagship_case()
    dev = case.sim.device
    forms = [None] + [[dev] * int(k) for k in args.slabs.split(",")]
    if "day" in parts:
        state, forcing = winter(case)
        block = forcing(args.days)
        print(f"slab_timing: {case.sim.n} cells, {args.days} days from day "
              f"{1 + WINTER_DAYS}, {smi}")
        for got in in_turns(case, state, block, forms, args.reps):
            print(json.dumps(got))
    if "loop" in parts:
        prob = loop_problem(case.sim.cfg, dev, 1)
        print(f"slab_timing loop: {case.sim.n} cells, {ENSEMBLE_MEMBERS} "
              f"and {DA_MEMBERS} members, 1 January 1901, {smi}")
        for name, got in loop_costs(prob, forms, args.reps).items():
            for c in got:
                print(json.dumps(dict(day=name, **c)))
    if "fit" in parts:
        prob = fit_problem(Config(resolution_deg=FIT_DEG), dev, FIT_DAYS)
        print(f"slab_timing fit: per-cell hksat at {FIT_DEG} degrees "
              f"({prob.params.n_cells} cells), {FIT_DAYS} days, {smi}")
        fit_step(prob, None)            # the first use of autograd's kernels
        for devices in forms:
            got = fit_step(prob, devices)
            print(json.dumps(dict(
                slabs=0 if devices is None else len(devices),
                **{k: v for k, v in got.items() if k != "result"})))
    if "spinup" in parts:
        sim = case.sim
        print(f"slab_timing spinup: one rehearsal year, {sim.n} cells, {smi}")
        for devices in forms:
            got = rehearsal_year(sim.cfg, sim.params, case.land_grid,
                                 devices)
            print(json.dumps(dict(
                slabs=0 if devices is None else len(devices),
                seconds=got["seconds"], launches=got["launches"],
                report=got["report"])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
