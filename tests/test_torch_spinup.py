"""The port's carbon spin-up against the JAX package's.

Mirrors tests/test_spinup.py: ``run --spinup-carbon 2`` through both
command lines from Config files alike but for the forcing block
(24-degree grid, ``nisurf=2``, float64; the port reads 92-day blocks, the
JAX package a year in one, which compiles its block once), with the
report of the two rehearsal years and the pools they leave held at rtol
1e-9; the turnover sums of a forcing block, the ratio jump and its fixed
points against the JAX package's; and the refusal without carbon.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hybrid9_tpu.data.forcing as j_forcing
import hybrid9_tpu.data.soil as j_soil
import hybrid9_tpu.run as j_run
import hybrid9_tpu.spinup as j_spinup
from hybrid9_tpu import state as j_state
from hybrid9_tpu.cli import main as j_main
from hybrid9_tpu.config import Config as JConfig
from hybrid9_tpu_torch import run as t_run
from hybrid9_tpu_torch import spinup
from hybrid9_tpu_torch.cli import main
from hybrid9_tpu_torch.config import Config
from hybrid9_tpu_torch.data.soil import load_soil
from hybrid9_tpu_torch.data.synthetic import synthetic_forcing_block
from hybrid9_tpu_torch.state import Forcing

from _torch_port import SWITCH_GRID, assert_tree_close, to_port, tree_np

SPIN_KW = dict(resolution_deg=24.0, start_year=1901, end_year=1901,
               forcing_block_days=92, cell_block=16, nisurf=2, carbon=True,
               dtype="float64", write_annual=False, checkpoint_every_years=0)


def _sims(**kw):
    """The same float64 ``Simulation`` in both packages on the 12-degree
    grid, the JAX initial state carried across; and the land grid."""
    kw = dict(SWITCH_GRID, dtype="float64", **kw)
    jcfg = JConfig(use_pallas=False, **kw)
    jgrid, jparams = j_soil.load_soil(jcfg, jnp.float64)
    jsim = j_run.Simulation(jcfg, jparams, land_grid=jgrid)
    grid, params = load_soil(Config(**kw), torch.float64, "cpu")
    sim = t_run.Simulation(Config(**kw), params,
                           state=to_port(jsim.state), land_grid=grid)
    return jsim, sim, grid


@pytest.fixture(scope="module")
def sims():
    return _sims()


def _captured(monkeypatch, module, sim_cls, into):
    """Wrap ``module.spinup_carbon`` to keep its report and the state it
    leaves, and stop ``sim_cls.run`` there: the run after the spin-up is
    the year path's, tested elsewhere."""
    inner = module.spinup_carbon

    def wrapped(sim, provider, **kw):
        into["report"] = inner(sim, provider, **kw)
        into["state"] = tree_np(sim.state)
        into["kw"] = kw
        return into["report"]

    monkeypatch.setattr(module, "spinup_carbon", wrapped)
    monkeypatch.setattr(sim_cls, "run", lambda self, *a, **k: [])


def test_spinup_command_line_matches_jax(tmp_path, monkeypatch):
    """``run --spinup-carbon 2`` on the CPU: the report of the two
    rehearsal years and the carbon and vegetation pools they leave equal
    the JAX package's at rtol 1e-9.  The JAX command line makes its soil
    parameters and synthetic forcing in float32 whatever the run's dtype;
    here it makes them in float64, as the port's does, so that both
    integrate the same inputs."""
    cfg, j_cfg = tmp_path / "spin.json", tmp_path / "jax_spin.json"
    cfg.write_text(JConfig(use_pallas=False, output_path=str(tmp_path),
                           **SPIN_KW).to_json())
    j_cfg.write_text(JConfig(use_pallas=False, output_path=str(tmp_path),
                             **dict(SPIN_KW,
                                    forcing_block_days=366)).to_json())
    got, want = {}, {}
    _captured(monkeypatch, spinup, t_run.Simulation, got)
    _captured(monkeypatch, j_spinup, j_run.Simulation, want)
    monkeypatch.setattr(j_forcing, "SyntheticForcingProvider",
                        functools.partial(j_forcing.SyntheticForcingProvider,
                                          dtype=jnp.float64))
    monkeypatch.setattr(j_soil, "load_soil",
                        functools.partial(j_soil.load_soil,
                                          dtype=jnp.float64))
    argv = ["--spinup-carbon", "2", "--spinup-tol", "0.5"]
    with torch.inference_mode():      # no autograd bookkeeping: faster
        assert main(["run", "--config", str(cfg), *argv, "--device",
                     "cpu"]) == 0
    assert j_main(["run", "--config", str(j_cfg), *argv, "--cache-dir",
                   ""]) == 0
    assert got["kw"] == want["kw"] == dict(max_loops=2, tol_slow=0.5)
    rep, j_rep = got["report"], want["report"]
    assert set(rep) == set(j_rep) and rep["loops"] == j_rep["loops"] == 2
    for k in rep:
        np.testing.assert_allclose(rep[k], j_rep[k], rtol=1e-9, err_msg=k)
    assert rep["mean_slow"] > 5000.0          # moved off the cold start
    for part in ("carbon", "veg"):
        assert_tree_close(got["state"][part], want["state"][part], 1e-9,
                          1e-9, part)


def test_spinup_block_sums_match_jax(sims):
    """The turnover record of five days (every accumulator of
    ``_DIAG_KEY``) and the state they end in, in float64 at 1e-9: the
    port's days as the spin-up takes them (``Simulation.days``, on a copy
    of the shared Simulation) against JAX's ``_spinup_block``."""
    assert spinup._DIAG_KEY == j_spinup._DIAG_KEY
    jsim, shared, grid = sims
    sim = t_run.Simulation(shared.cfg, shared.params, state=shared.state,
                           land_grid=grid)
    block = synthetic_forcing_block(5, sim.n, seed=3, start_doy=150,
                                    lat=grid.cell_lat)
    sums = {k: torch.zeros(sim.n, dtype=torch.float64)
            for k in spinup._DIAG_KEY}
    for diags in sim.days(Forcing.from_numpy(block, torch.float64, "cpu")):
        sums = spinup._add_day(sums, diags[0])
    state = sim.state
    jcfg = jsim.cfg
    j_state_, j_sums = j_spinup._spinup_block(
        jsim.state, {k: jnp.zeros(jsim.n) for k in j_spinup._DIAG_KEY},
        j_state.Forcing(**{k: jnp.asarray(v) for k, v in block.items()}),
        jsim.params, jsim.geom, jcfg.dt, jcfg.nisurf, **jsim.step_kwargs())
    assert float(sums["lit_in"].max()) > 0.0
    assert_tree_close(tree_np(sums), tree_np(j_sums), 1e-9, 1e-9, "sums")
    assert_tree_close(tree_np(state), tree_np(j_state_), 1e-9, 1e-9,
                      "state")


@pytest.mark.parametrize("spin_vegetation", [False, True])
def test_ratio_update_matches_jax(sims, spin_vegetation):
    """The jump on random turnover sums, with pools whose in- or outflow
    is below the floor: a pool with neither stays, a pool without input
    goes to 0."""
    rng = np.random.RandomState(7)
    jsim, sim, _ = sims
    n = sim.n
    sums = {k: rng.uniform(0.0, 500.0, n) for k in spinup._DIAG_KEY}
    sums["lit_in"][:3] = 0.0
    sums["d_lit"][:2] = 0.0
    got = spinup._ratio_update(
        sim.state, {k: torch.tensor(v) for k, v in sums.items()},
        spin_vegetation=spin_vegetation)
    want = jax.jit(j_spinup._ratio_update,
                   static_argnames=("spin_vegetation",))(
        jsim.state, {k: jnp.asarray(v) for k, v in sums.items()},
        spin_vegetation=spin_vegetation)
    assert_tree_close(tree_np(got), tree_np(want), 1e-12, 1e-12, "state")
    c0 = tree_np(sim.state.carbon)["c_litter"]
    c1 = tree_np(got.carbon)["c_litter"]
    assert c1[2] == 0.0 and np.array_equal(c1[:2], c0[:2])


def test_ratio_jump_linear_fixed_point(sims):
    """Inflow twice the outflow doubles the pool; balanced fluxes leave
    it; the fast pool's target input is TO_FAST * lit_in."""
    _, sim, _ = sims
    one = torch.ones(sim.n, dtype=torch.float64)
    sums = dict({k: one for k in spinup._DIAG_KEY}, lit_in=2.0 * one)
    st = spinup._ratio_update(sim.state, sums, spin_vegetation=False)
    c0, c1 = tree_np(sim.state.carbon), tree_np(st.carbon)
    np.testing.assert_allclose(c1["c_litter"], 2.0 * c0["c_litter"],
                               rtol=1e-12)
    np.testing.assert_allclose(c1["c_soil_fast"], 0.7 * c0["c_soil_fast"],
                               rtol=1e-12)


def test_spinup_requires_carbon_and_vegetation():
    for off in (dict(carbon=False), dict(vegetation=False)):
        _, sim, _ = _sims(**off)
        with pytest.raises(ValueError, match="carbon"):
            spinup.spinup_carbon(sim, None)
