"""The closed loop and the carbon spin-up on device slabs of one process.

Given a device list (here ``["cpu"] * 3``: 32 cells cut 11, 11 and 10),
or a ``CellSharding`` whose rank holds several devices,
``run_ensemble_annual``, ``assimilate``, ``calibrate`` and, on
``Simulation(devices=)``, ``spinup_carbon`` cut their cells once into
``parallel.sharding.DeviceSlabs`` and keep them there:

* in two child processes on ATen's scalar CPU kernels (with AVX a cell's
  last bit depends on its place in a tensor): the slab ensemble's totals, the
  DA posterior, its ``y_pred_mean`` and final folded state, and a
  rehearsal year of the spin-up (its report and the state it leaves) are
  bitwise the unsharded port's; the spin-up on slabs neither reads nor
  writes ``Simulation.state`` and makes one host copy a rehearsal year
  (and one for the final pool means).  The closed loop runs ``LOOP`` and
  the spin-up ``SPIN``: the 24-degree grid, float64, and for the spin-up
  ``Config()``'s physics with its dense kinematic router in 3 row bands,
  at ``nisurf=2`` and ``1``.  The children run beside the tests in this
  process, which read them last;
* the slab ensemble against the JAX package's ``run_ensemble_annual``
  on the 8-device mesh at rtol 1e-9 (the counterpart of
  ``tests/test_sharding.py::test_ensemble_sharded_matches_unsharded``);
* the ensemble and the DA cycles on slabs exchange nothing before the
  final join (the counterpart of
  ``test_assimilate_sharded_cycle_no_collectives``);
* ``calibrate`` on slabs, scalar and per-cell hksat, 2 Adam steps: the
  loss history and the fitted theta within 1e-9 of the unsharded port
  (the loss adds the slabs' partial sums, another order), a per-cell
  theta one leaf a slab during the fit;
* a ``CellSharding`` over three devices takes each driver to the slab
  path, and so does ``--shard`` on ``ensemble``, ``assimilate`` and
  ``calibrate --config`` in one process that sees three devices: each
  command writes what it writes without ``--shard``.
"""

import dataclasses
import functools
import os
import subprocess
import sys
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.optim import optimizer

from hybrid9_tpu import ensemble as j_ens
from hybrid9_tpu import state as j_state
from hybrid9_tpu.config import LayerGrid
from hybrid9_tpu.data.synthetic import (synthetic_forcing_day,
                                        synthetic_soil_params)
from hybrid9_tpu.parallel.sharding import CellSharding as JCellSharding
from hybrid9_tpu.physics.hydrology import Geometry as JGeometry
from hybrid9_tpu_torch import assimilate as t_da
from hybrid9_tpu_torch import calibrate as t_cal
from hybrid9_tpu_torch import cli
from hybrid9_tpu_torch import ensemble as t_ens
from hybrid9_tpu_torch.cli import _stacked_forcing
from hybrid9_tpu_torch.config import Config
from hybrid9_tpu_torch.data.soil import load_soil
from hybrid9_tpu_torch.io import netcdf
from hybrid9_tpu_torch.parallel import sharding as parallel
from hybrid9_tpu_torch.parallel.sharding import CellSharding, DeviceSlabs
from hybrid9_tpu_torch.physics.hydrology import Geometry
from hybrid9_tpu_torch.state import initial_state
from hybrid9_tpu_torch.weights import from_reference

from _torch_port import geom_tuples, to_port
from test_torch_parallel import slabs as rank_slabs
from test_torch_parallel import threads  # noqa: F401 (a fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T64 = torch.float64
SLABS = ["cpu"] * 3
LOOP = dict(resolution_deg=24.0, start_year=1901, end_year=1901,
            cell_block=16, nisurf=2, dtype="float64")
# One substep a day: a rehearsal year on 3 slabs costs about three
# unsharded ones of host time on the CPU, and the spin-up's plumbing does
# not depend on the substeps.
SPIN = dict(LOOP, forcing_block_days=92, nisurf=1, carbon=True,
            write_annual=False, checkpoint_every_years=0)
ENS_DAYS, DA_DAYS, FIT_DAYS = 4, 3, 1
MEMBERS, DA_MEMBERS = 4, 6
# The fit on slabs adds its loss in another order than the unsharded fit:
# float64 sums of a few hundred terms part in their last bits, and two Adam
# steps carry that into theta.
FIT_RTOL, FIT_ATOL = 1e-9, 1e-12


@functools.lru_cache(maxsize=None)
def loop_problem(ndays):
    """``(cfg, grid, params, state0, geom, forcing)`` of ``LOOP``: float64
    synthetic soil on the 24-degree grid (32 cells, 31 of them land) and
    ``ndays`` days of the command line's forcing from 1 January, made
    once a module (no driver writes into its inputs)."""
    cfg = Config(**LOOP)
    grid, params = load_soil(cfg, T64, "cpu")
    lg = cfg.layer_grid()
    state0 = initial_state(params, lg.dz, lg.zi, T64, "cpu")
    forcing = _stacked_forcing(cfg, grid, ndays, T64, "cpu")
    return cfg, grid, params, state0, Geometry.from_layer_grid(lg), forcing


def ensemble(devices=None, sharding=None):
    cfg, _, params, state0, geom, forcing = loop_problem(ENS_DAYS)
    theta = t_ens.perturbed_multipliers(torch.Generator().manual_seed(5),
                                        MEMBERS, dtype=T64)
    return t_ens.run_ensemble_annual(theta, params, state0, forcing, geom,
                                     nisurf=cfg.nisurf, devices=devices,
                                     sharding=sharding)


@functools.lru_cache(maxsize=None)
def da_problem():
    """The DA problem: twin observations under hksat log-multiplier 0.5,
    every third land cell and the padding lane unobserved."""
    cfg, grid, params, state0, geom, forcing = loop_problem(DA_DAYS)
    with torch.no_grad():
        obs = t_cal.simulate_daily_et({"hksat": torch.tensor(0.5, dtype=T64)},
                                      params, state0, forcing, geom,
                                      cfg.nisurf)
    mask = torch.zeros(obs.shape, dtype=torch.bool)
    mask[:, :grid.n_land] = True
    mask[:, :grid.n_land:3] = False
    return cfg, params, state0, geom, forcing, obs, mask


def assimilate(devices=None, sharding=None):
    cfg, params, state0, geom, forcing, obs, mask = da_problem()
    return t_da.assimilate(params, state0, forcing, obs, geom,
                           n_members=DA_MEMBERS, obs_mask=mask,
                           nisurf=cfg.nisurf, theta_spread=0.3, seed=1,
                           cfg=t_da.EnKFConfig(obs_err_std=0.1, rtps=0.6),
                           devices=devices, sharding=sharding)


def leaves(*trees):
    got = []
    for t in trees:
        t.map(lambda x: got.append(x) or x)
    return got


def tensors(out: dict) -> list:
    """A driver's outputs as a flat list of tensors (a state's leaves
    included), in key order."""
    return [x for k in sorted(out) for x in (
        [out[k]] if isinstance(out[k], torch.Tensor) else leaves(out[k]))]


_CHILD = r"""
import sys
import torch
sys.path.insert(0, "tests")
import test_torch_slab_loop as me
from hybrid9_tpu_torch import run as t_run
from hybrid9_tpu_torch.config import Config
from hybrid9_tpu_torch.data.forcing import SyntheticForcingProvider
from hybrid9_tpu_torch.data.soil import load_soil
from hybrid9_tpu_torch.parallel import sharding as parallel
from hybrid9_tpu_torch.spinup import spinup_carbon

part, path = sys.argv[1:]
torch.set_num_threads(1)
out = {"capability": torch.backends.cpu.get_cpu_capability()}
devices = me.SLABS if part == "slabs" else None
if devices is None:
    ens = [me.ensemble(d) for d in (None, me.SLABS)]
    out["ensemble"] = {k: torch.equal(ens[0][k], ens[1][k]) for k in ens[0]}
    out["ensemble_spread"] = float(ens[0]["evap"].std(dim=0).max())
    da = [me.assimilate(d) for d in (None, me.SLABS)]
    out["da"] = {k: torch.equal(da[0][k], da[1][k])
                 for k in ("theta_mean", "theta_std", "y_pred_mean")}
    out["da_state"] = [i for i, (a, b) in enumerate(zip(
        me.leaves(da[0]["state"]), me.leaves(da[1]["state"])))
        if not torch.equal(a, b)]
    out["da_moved"] = float((da[0]["theta_std"] - 0.3).abs().max())

cfg = Config(**me.SPIN)
grid, params = load_soil(cfg, torch.float64, "cpu")
provider = SyntheticForcingProvider(grid.n_padded, seed=0, lat=grid.cell_lat,
                                    dtype=torch.float64, device="cpu")
state = t_run.Simulation.state
access, copies = [], []
to_host = torch.Tensor.cpu


def read(self):
    access.append("read")
    return state.fget(self)


def write(self, value):
    access.append("write")
    state.fset(self, value)


def cpu(self, *a, **kw):
    copies.append(tuple(self.shape))
    return to_host(self, *a, **kw)


sim = t_run.Simulation(cfg, params, land_grid=grid, devices=devices)
if devices is not None:
    # The router's row bands, cut once a Simulation (a host copy of the
    # lanes' grid indices) before its first day.
    sim.routing.split(sim.slabs)
t_run.Simulation.state = property(read, write)
torch.Tensor.cpu = cpu
parallel.collectives.clear()
try:
    out["spin_report"] = spinup_carbon(sim, provider, max_loops=1)
finally:
    t_run.Simulation.state = state
    torch.Tensor.cpu = to_host
out["spin_census"] = dict(parallel.collectives)
out["spin_access"] = list(access)
out["spin_copies"] = list(copies)
out["spin_leaves"] = me.leaves(sim.state)
out["ny"] = grid.ny
torch.save(out, path)
"""

#: The child processes' parts: the closed loop's comparisons and the
#: unsharded rehearsal year in one, the rehearsal year on slabs (the
#: longest) in the other, so that the two run side by side.
CHILD_PARTS = ("whole", "slabs")


@pytest.fixture(scope="module", autouse=True)
def child():
    """The bitwise comparisons in two child processes on ATen's scalar CPU
    kernels (``CHILD_PARTS``), started with the module so that they run
    beside the tests in this process; the last tests read them
    (``scalar_kernel_run``)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["ATEN_CPU_CAPABILITY"] = "default"
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        try:
            for part in CHILD_PARTS:
                err = open(os.path.join(tmp, part + ".err"), "w+")
                procs[part] = (subprocess.Popen(
                    [sys.executable, "-c", _CHILD, part,
                     os.path.join(tmp, part + ".pt")], cwd=ROOT, env=env,
                    stdout=err, stderr=subprocess.STDOUT, text=True), err)
            yield tmp, procs
        finally:
            for proc, err in procs.values():
                proc.kill()
                proc.wait()
                err.close()


# --- in this process -------------------------------------------------------

N_JAX = 16
JAX_DAYS = 3
JAX_NISURF = 4


def test_slab_ensemble_matches_jax_on_the_mesh():
    """The port's ensemble on 3 slabs against the JAX package's on its
    8-device cell mesh, on the same multipliers (carried across by
    ``weights.from_reference``), every member's totals at rtol 1e-9."""
    grid = LayerGrid.from_interfaces()
    p = synthetic_soil_params(N_JAX, seed=3)
    params = j_state.SoilParams(**{k: jnp.asarray(v, jnp.float64)
                                   for k, v in p.items()})
    state0 = j_state.initial_state(params, grid.dz, grid.zi, jnp.float64)
    days = [synthetic_forcing_day(N_JAX, 120 + d, seed=3)
            for d in range(JAX_DAYS)]
    forcing = j_state.Forcing(**{k: jnp.stack([jnp.asarray(d[k], jnp.float64)
                                               for d in days])
                                 for k in days[0]})
    geom = geom_tuples(grid)
    theta_np = {k: v.numpy() for k, v in t_ens.perturbed_multipliers(
        torch.Generator().manual_seed(7), MEMBERS, sigma=0.4,
        dtype=T64).items()}
    cs = JCellSharding.create()
    assert cs.n_devices == 8
    want = j_ens.run_ensemble_annual(
        {k: jnp.asarray(v) for k, v in theta_np.items()}, params, state0,
        forcing, JGeometry(*geom), nisurf=JAX_NISURF, sharding=cs)
    parallel.collectives.clear()
    got = t_ens.run_ensemble_annual(
        from_reference("theta", theta_np, T64, "cpu"), to_port(params),
        to_port(state0), to_port(forcing), Geometry(*geom),
        nisurf=JAX_NISURF, devices=SLABS)
    assert dict(parallel.collectives) == {"result": 1}
    for k in ("evap", "runoff", "npp"):
        assert got[k].shape == (MEMBERS, N_JAX), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-9, atol=1e-12, err_msg=k)


def _census_at_join(monkeypatch):
    """Record the exchanges counted when the first ``DeviceSlabs.gather``
    begins: everything before the final join."""
    seen = []
    gather = DeviceSlabs.gather

    def first(self, *a, **kw):
        if not seen:
            seen.append(dict(parallel.collectives))
        return gather(self, *a, **kw)
    monkeypatch.setattr(DeviceSlabs, "gather", first)
    parallel.collectives.clear()
    return seen


def three_devices(n):
    """A one-process ``CellSharding`` of ``n`` cells over ``SLABS``."""
    cs = CellSharding.create(n, "cpu", devices=SLABS)
    assert cs.n_devices == 3 and (cs.lo, cs.hi) == (0, n)
    return cs


@pytest.mark.parametrize("driver", ["ensemble", "assimilate"])
def test_slab_loop_exchanges_nothing_before_the_final_join(monkeypatch,
                                                           driver):
    """Every day of the ensemble and every DA cycle (forecast and
    analysis) stays on its slab: no exchange is counted before the one
    join of the outputs, given ``devices=`` or a ``CellSharding`` over
    three devices, whose run is the ``devices=`` run's."""
    run = ensemble if driver == "ensemble" else assimilate
    n = loop_problem(ENS_DAYS)[2].n_cells
    outs = []
    for where in (dict(devices=SLABS), dict(sharding=three_devices(n))):
        seen = _census_at_join(monkeypatch)
        outs.append(run(**where))
        assert seen == [{}], where
        assert dict(parallel.collectives) == {"result": 1}, where
    (got, want) = outs
    assert all(bool(torch.isfinite(x).all()) for x in tensors(want))
    assert sorted(got) == sorted(want)
    assert all(torch.equal(a, b) for a, b in zip(tensors(got), tensors(want)))


@pytest.fixture(scope="module")
def fit_problem():
    """Twin observations of ``FIT_DAYS`` days under hksat
    log-multipliers that vary by cell, the padding lane masked."""
    cfg, grid, params, state0, geom, forcing = loop_problem(FIT_DAYS)
    truth = torch.linspace(-0.4, 0.6, params.n_cells, dtype=T64)
    with torch.no_grad():
        obs = t_cal.simulate_daily_et({"hksat": truth}, params, state0,
                                      forcing, geom, cfg.nisurf)
    mask = torch.zeros(obs.shape, dtype=torch.bool)
    mask[:, :grid.n_land] = True
    return cfg, params, state0, geom, forcing, obs, mask


FIT_STEPS = 2


def fit(problem, per_cell, steps=FIT_STEPS, **where):
    """``calibrate`` of hksat on ``problem``, with the parameters Adam
    was given at each step (their shapes and devices)."""
    cfg, params, state0, geom, forcing, obs, mask = problem
    given = []

    def pre(opt, args, kwargs):
        given.append([(tuple(t.shape), str(t.device), t.is_leaf)
                      for g in opt.param_groups for t in g["params"]])
    hook = optimizer.register_optimizer_step_pre_hook(pre)
    try:
        res = t_cal.calibrate(
            params, state0, forcing, geom, obs,
            spec=t_cal.CalibrationSpec(fields=("hksat",), per_cell=per_cell),
            nisurf=cfg.nisurf, steps=steps, learning_rate=0.1,
            obs_mask=mask, **where)
    finally:
        hook.remove()
    return res, given


@pytest.fixture(scope="module")
def unsharded_fits(fit_problem):
    """The unsharded fit of each theta, scalar and per-cell."""
    return {per_cell: fit(fit_problem, per_cell)
            for per_cell in (False, True)}


@pytest.fixture(scope="module")
def slab_fits(fit_problem):
    """The fit of each theta on 3 slabs, with the exchanges it counted."""
    fits = {}
    for per_cell in (False, True):
        parallel.collectives.clear()
        fits[per_cell] = fit(fit_problem, per_cell, devices=SLABS) + (
            dict(parallel.collectives),)
    return fits


@pytest.mark.parametrize("per_cell", [False, True],
                         ids=["scalar", "per_cell"])
def test_slab_fit_matches_the_unsharded_fit(fit_problem, unsharded_fits,
                                            slab_fits, per_cell):
    """Two Adam steps on 3 slabs: the loss history (the first loss, each
    step's and the fitted one) and the fitted theta within FIT_RTOL of
    the unsharded fit; the loss falls; a per-cell theta is one leaf a
    slab during the fit (11, 11 and 10 cells), a scalar one leaf, and the
    fitted theta comes back whole on the first device."""
    want, given0 = unsharded_fits[per_cell]
    got, given, census = slab_fits[per_cell]
    n = fit_problem[1].n_cells
    slabs = DeviceSlabs.create(n, SLABS)
    shapes = ([(hi - lo,) for lo, hi in slabs.bounds] if per_cell
              else [()])
    assert given == [[(s, "cpu", True) for s in shapes]] * FIT_STEPS
    assert given0 == [[((n,) if per_cell else (), "cpu", True)]] * FIT_STEPS
    assert census == ({"result": 1} if per_cell else {})
    hist = got.loss_history.numpy()
    assert hist.shape == (FIT_STEPS + 1,) and hist[-1] < hist[0]
    np.testing.assert_allclose(hist, want.loss_history.numpy(),
                               rtol=FIT_RTOL, atol=FIT_ATOL)
    theta, want_theta = got.theta["hksat"], want.theta["hksat"]
    assert theta.shape == want_theta.shape and not theta.requires_grad
    np.testing.assert_allclose(theta.numpy(), want_theta.numpy(),
                               rtol=FIT_RTOL, atol=FIT_ATOL)
    assert float(theta.abs().max()) > 0.05
    np.testing.assert_allclose(got.params.hksat.numpy(),
                               want.params.hksat.numpy(), rtol=FIT_RTOL,
                               atol=FIT_ATOL)


def test_a_sharding_of_several_devices_takes_the_slab_path(fit_problem,
                                                           slab_fits):
    """``CellSharding.create(n, "cpu", devices=["cpu"] * 3)`` handed to
    ``calibrate`` cuts its cells over those devices: a per-cell theta is a
    leaf a slab, and the fit is the ``devices=`` fit, joined once
    ("result").  (The ensemble's and the filter's are in
    ``test_slab_loop_exchanges_nothing_before_the_final_join``.)"""
    cs = three_devices(fit_problem[1].n_cells)
    want, want_given, _ = slab_fits[True]
    parallel.collectives.clear()
    got, given = fit(fit_problem, True, sharding=cs)
    assert given == want_given and len(given[0]) == 3
    assert parallel.collectives["result"] == 1
    assert torch.equal(got.loss_history, want.loss_history)
    assert torch.equal(got.theta["hksat"], want.theta["hksat"])


@pytest.mark.parametrize("per_cell", [False, True],
                         ids=["scalar", "per_cell"])
def test_a_rank_of_two_devices_fits_its_slab_over_them(fit_problem,
                                                       unsharded_fits,
                                                       threads, per_cell):
    """Two ranks (threads of this process), each holding two devices: a
    rank cuts its slab over them, keeps the ranks' all-reduces (the mask's
    denominator a loss, a scalar theta's gradient a step, the history once)
    and the fit is one process's within FIT_RTOL."""
    cfg, params, state0, geom, forcing, obs, mask = fit_problem
    n = params.n_cells
    want, _ = unsharded_fits[per_cell]
    ranks = [dataclasses.replace(sh, devices=("cpu", "cpu"))
             for sh in rank_slabs(n, 2)]
    group = threads(2)
    parallel.collectives.clear()
    got = group.run(lambda r: fit(fit_problem, per_cell, sharding=ranks[r]))
    # A rank's: a denominator a loss, the history, a gradient a step.
    reduces = (FIT_STEPS + 1) + 1 + (0 if per_cell else FIT_STEPS)
    assert group.calls == ["all_reduce"] * (2 * reduces)
    joins = {"result": 2} if per_cell else {}
    assert dict(parallel.collectives) == dict(joins, calibrate=2 * reduces)
    for res, given in got:
        shapes = [(t[0], t[2]) for t in given[0]]
        assert shapes == ([((n // 4,), True)] * 2 if per_cell
                          else [((), True)])
        np.testing.assert_allclose(res.loss_history.numpy(),
                                   want.loss_history.numpy(),
                                   rtol=FIT_RTOL, atol=FIT_ATOL)
    theta = (torch.cat([res.theta["hksat"] for res, _ in got]) if per_cell
             else got[0][0].theta["hksat"])
    np.testing.assert_allclose(theta.numpy(), want.theta["hksat"].numpy(),
                               rtol=FIT_RTOL, atol=FIT_ATOL)


#: Each command's arguments beyond ``--config`` and ``--out`` (the
#: sizes of the drivers' tests), and the exchanges it counts with
#: ``--shard`` besides its outputs' gathers: the joins on slabs (the
#: ensemble's; the twin observations' and the driver's), and the fit's
#: all-reduces of one rank (the mask's denominator a loss, the history).
COMMANDS = {
    "ensemble": (["--members", str(MEMBERS), "--days", str(ENS_DAYS)],
                 {"result": 1}),
    "assimilate": (["--members", str(DA_MEMBERS), "--days", str(DA_DAYS),
                    "--obs-twin", "0.5", "--spread", "0.3"], {"result": 2}),
    "calibrate": (["--per-cell", "--fields", "hksat", "--obs-twin", "0.4",
                   "--days", str(FIT_DAYS), "--steps", str(FIT_STEPS)],
                  {"result": 2, "calibrate": FIT_STEPS + 2}),
}
ENSEMBLE_FIELDS = [f"{k}_{s}" for k in ("evap", "runoff", "npp")
                   for s in ("mean", "std", "control")]


def _written(path):
    """What a command wrote: the ensemble's NetCDF fields, or the npz."""
    if path.endswith(".nc"):
        return netcdf.read_grid_file(path, ENSEMBLE_FIELDS)
    with np.load(path) as d:
        return dict(d)


@pytest.mark.parametrize("command", sorted(COMMANDS))
def test_shard_in_one_process_of_three_devices_takes_the_slab_path(
        tmp_path, monkeypatch, command):
    """``COMMAND --config c.json --shard`` in one process whose sharding
    holds three devices (as on a box of three cards): the twin
    observations and the driver run on the slabs (their joins counted as
    "result"; the ranks' exchanges are those of one rank), and the file
    it writes is
    the one the command writes without ``--shard`` (rtol 1e-9 for the
    ensemble and the filter, FIT_RTOL for the fit: the loss is summed in
    another order)."""
    argv, exchanges = COMMANDS[command]
    path = tmp_path / "c.json"
    path.write_text(Config(output_path=str(tmp_path), **LOOP).to_json())
    suffix = ".nc" if command == "ensemble" else ".npz"
    outs = {}
    sharding = cli._sharding

    def three(shard, n, device):
        got = sharding(shard, n, device)
        return got and dataclasses.replace(got, devices=tuple(SLABS))
    for shard in (False, True):
        out = str(tmp_path / f"{command}_{shard}{suffix}")
        flags = ["--shard"] if shard else []
        if shard:
            monkeypatch.setattr(cli, "_sharding", three)
        parallel.collectives.clear()
        assert cli.main([command, "--config", str(path), "--device", "cpu",
                         *argv, *flags, "--out", out]) == 0
        census = dict(parallel.collectives)
        census.pop("output", None)
        assert census == (exchanges if shard else {}), census
        outs[shard] = _written(out)
    rtol = FIT_RTOL if command == "calibrate" else 1e-9
    assert sorted(outs[True]) == sorted(outs[False])
    for k, want in outs[False].items():
        np.testing.assert_allclose(outs[True][k], want, rtol=rtol,
                                   atol=1e-12, err_msg=k)


# --- from the child process ----------------------------------------------

@pytest.fixture(scope="module")
def scalar_kernel_run(child):
    """The bitwise comparisons' results, from the child processes: the
    whole run's, and the two rehearsal years' (``_1`` unsharded, ``_2``
    on slabs) side by side."""
    tmp, procs = child
    got = []
    for part in CHILD_PARTS:
        proc, err = procs[part]
        rc = proc.wait(timeout=600)
        err.seek(0)
        assert rc == 0, f"{part}: " + err.read()
        res = torch.load(os.path.join(tmp, part + ".pt"))
        assert res["capability"] in ("DEFAULT", "NO AVX"), res["capability"]
        got.append(res)
    run = dict(got[0])
    for i, res in enumerate(got, 1):
        for k in ("census", "access", "copies"):
            run[f"spin_{k}_{i}"] = res[f"spin_{k}"]
    run["spin_reports"] = [res["spin_report"] for res in got]
    one, three = (res["spin_leaves"] for res in got)
    run["spin_state"] = [i for i, (a, b) in enumerate(zip(one, three))
                         if not torch.equal(a, b)]
    run["spin_leaves"] = len(one) if len(one) == len(three) else -1
    return run


def test_slab_ensemble_is_bitwise_the_unsharded_ensemble(scalar_kernel_run):
    run = scalar_kernel_run
    assert run["ensemble"] == {"evap": True, "runoff": True, "npp": True}
    assert run["ensemble_spread"] > 0.0


def test_slab_assimilation_is_bitwise_the_unsharded_filter(
        scalar_kernel_run):
    """The posterior multipliers, the innovations' ``y_pred_mean`` and
    every field of the final folded state."""
    run = scalar_kernel_run
    assert run["da"] == {"theta_mean": True, "theta_std": True,
                         "y_pred_mean": True}
    assert run["da_state"] == []
    assert run["da_moved"] > 0.0


def test_slab_spinup_year_is_bitwise_the_unsharded_year(scalar_kernel_run):
    """One rehearsal year: the report (loops included) and every leaf of
    the state the jump leaves; the router split into 3 row bands."""
    run = scalar_kernel_run
    one, three = run["spin_reports"]
    assert one == three and three["loops"] == 1
    assert run["spin_leaves"] > 20 and run["spin_state"] == []
    assert run["ny"] >= 3
    census = run["spin_census_2"]
    assert census["reshard"] > 0 and census["halo"] > 0
    assert run["spin_census_1"] == {}


def test_slab_spinup_keeps_the_state_on_its_slabs(scalar_kernel_run):
    """On slabs the spin-up neither reads nor writes ``Simulation.state``
    (which would gather or cut the slabs), joins the slabs' rows once a
    rehearsal year and once for the pool means ("result"), and copies to
    the host once for each: the ``[2, land]`` drift and NEE, the
    ``[3, land]`` pools."""
    run = scalar_kernel_run
    assert run["spin_access_2"] == []
    assert run["spin_census_2"]["result"] == 2
    assert "state" not in run["spin_census_2"]
    assert [c[0] for c in run["spin_copies_2"]] == [2, 3]
    assert [c[0] for c in run["spin_copies_1"]] == [2, 3]
