"""The port's flagship (``Config()`` default) day as a whole against the
JAX package.

``Simulation`` + ``block_step(**step_kwargs())`` over five northern-winter
days on the 4-degree grid, in float64 at rtol 1e-9 on every state field,
daily diagnostic and annual mean, and once in float32; the set-up
(``Simulation``, ``build_flagship_case``, ``Config``), the switches that
still wait, and the entry points' device rule.  Inputs are made with
numpy from a seed and handed to both packages; state crosses over through
``hybrid9_tpu_torch.weights.from_reference``.  The modules one by one are
in test_torch_flagship_modules.py.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid9_tpu import state as j_state
from hybrid9_tpu.config import Config as JConfig
from hybrid9_tpu.data.soil import load_soil as j_load_soil
from hybrid9_tpu.run import Simulation as JSimulation
from hybrid9_tpu.step import _BLOCK_STEP_STATIC, _block_step
from hybrid9_tpu.step import annual_means as j_annual_means
from hybrid9_tpu.step import day_step as j_day_step
from hybrid9_tpu_torch import entry
from hybrid9_tpu_torch import state as t_state
from hybrid9_tpu_torch.config import Config
from hybrid9_tpu_torch.data.soil import load_soil
from hybrid9_tpu_torch.data.synthetic import (synthetic_forcing_block,
                                              synthetic_forcing_day)
from hybrid9_tpu_torch.run import Simulation
from hybrid9_tpu_torch.step import annual_means, block_step, day_step

from _torch_port import assert_tree_close, to_port, tree_np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DAYS = 5
GRID_KW = dict(resolution_deg=4.0, cell_block=256)


def _flagship(dtype, zd09_every, **cfg_kw):
    """The same default-physics run in both packages on the 4-degree
    grid, from the same numpy soil; the JAX state carried across."""
    kw = dict(GRID_KW, dtype=dtype, zd09_every=zd09_every, **cfg_kw)
    jcfg = JConfig(use_pallas=False, **kw)
    jgrid, jparams = j_load_soil(jcfg, jnp.dtype(dtype))
    jsim = JSimulation(jcfg, jparams, land_grid=jgrid)
    cfg = Config(**kw)
    grid, params = load_soil(cfg, getattr(torch, dtype), "cpu")
    sim = Simulation(cfg, params, state=to_port(jsim.state, dtype),
                     land_grid=grid)
    return jsim, sim, grid


def _winter_block(grid, n):
    """Five days from 1 January: snow falls in the north, soil freezes
    there and thaws at the margin."""
    return synthetic_forcing_block(DAYS, n, seed=3, start_doy=1,
                                   lat=grid.cell_lat)


def _run_both(dtype, zd09_every):
    jsim, sim, grid = _flagship(dtype, zd09_every)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    block = _winter_block(grid, sim.n)
    jcfg = jsim.cfg
    want = jax.jit(_block_step, static_argnames=_BLOCK_STEP_STATIC)(
        jsim.state, j_state.AnnualAccumulators.zeros(jsim.n, dtype=jd),
        j_state.Forcing(**{k: jnp.asarray(v, jd) for k, v in block.items()}),
        jsim.params, geom=jsim.geom, dt=jcfg.dt, nisurf=jcfg.nisurf,
        **jsim.step_kwargs())
    got = block_step(
        sim.state, t_state.AnnualAccumulators.zeros(sim.n, td, "cpu"),
        t_state.Forcing.from_numpy(block, td, "cpu"), sim.params, sim.geom,
        sim.cfg.dt, sim.cfg.nisurf, **sim.step_kwargs())
    return jsim, sim, want, got


@pytest.mark.parametrize("zd09_every", [1, 8])
def test_flagship_block_step_matches_jax_f64(zd09_every):
    jsim, sim, (want_state, want_acc), (got_state, got_acc) = \
        _run_both("float64", zd09_every)
    got = tree_np(got_state)
    # The extras really ran.
    assert got["swe"].max() > 1.0 and got["h2osoi_ice"].max() > 1.0
    assert got["river_store"].max() > 0.0
    assert np.abs(got["carbon"]["c_litter"] - 100.0).max() > 0.0
    assert_tree_close(got, tree_np(want_state), 1e-9, 1e-9, "state")
    assert float(got_acc.n_days) == DAYS
    means = tree_np(annual_means(got_acc, sim.cfg.nisurf))
    assert means["discharge"].max() > 0.0 and means["rh"].max() > 0.0
    assert means["max_abs_residual"].max() < 0.1
    assert_tree_close(means,
                      tree_np(j_annual_means(want_acc, jsim.cfg.nisurf)),
                      1e-9, 1e-9, "means")


@pytest.mark.parametrize("zd09_every", [1, 8])
def test_flagship_day_diagnostics_match_jax_f64(zd09_every):
    """Every daily diagnostic of ``day_step``, on the third winter day
    (snow on the ground, ice in the soil): the state is first run two
    days forward in the port and carried back to the JAX package."""
    jsim, sim, grid = _flagship("float64", zd09_every)
    block = _winter_block(grid, sim.n)
    T64 = torch.float64
    state = sim.state
    for d in range(2):
        f = t_state.Forcing.from_numpy({k: v[d] for k, v in block.items()},
                                       T64, "cpu")
        state, _ = day_step(state, f, sim.params, sim.geom, sim.cfg.dt,
                            sim.cfg.nisurf, **sim.step_kwargs())
    day = {k: v[2] for k, v in block.items()}
    got_state, got = day_step(
        state, t_state.Forcing.from_numpy(day, T64, "cpu"), sim.params,
        sim.geom, sim.cfg.dt, sim.cfg.nisurf, **sim.step_kwargs())

    def to_jax(tree, cls):
        kw = {}
        for f, v in tree.items():
            sub = getattr(jsim.state, f, None) if cls is j_state.ModelState \
                else None
            kw[f] = (to_jax(v, type(sub)) if isinstance(v, dict)
                     else jnp.asarray(v))
        return cls(**kw)

    jcfg = jsim.cfg
    want_state, want = jax.jit(lambda s, f: j_day_step(
        s, f, jsim.params, jsim.geom, jcfg.dt, jcfg.nisurf,
        **jsim.step_kwargs()))(
        to_jax(tree_np(state), j_state.ModelState),
        j_state.Forcing(**{k: jnp.asarray(v) for k, v in day.items()}))
    got, want = tree_np(got), tree_np(want)
    assert {"discharge", "rh", "nee", "rnf_day", "evap_day", "npp",
            "c_d_lit", "v_production"} <= set(got)
    assert got["discharge"].max() > 0.0 and got["rh"].max() > 0.0
    res = got.pop("max_abs_residual")
    np.testing.assert_allclose(res, want.pop("max_abs_residual"),
                               rtol=1e-6, atol=1e-9)
    assert_tree_close(got, want, 1e-9, 1e-9, "diags")
    assert_tree_close(tree_np(got_state), tree_np(want_state), 1e-9, 1e-9,
                      "state")
    # rnf_day carries the capped-snow term: a pack over the cap sheds it.
    capped = state.replace(swe=torch.full_like(state.swe, 1200.0))
    _, d2 = day_step(capped, t_state.Forcing.from_numpy(day, T64, "cpu"),
                     sim.params, sim.geom, sim.cfg.dt, sim.cfg.nisurf,
                     **dict(sim.step_kwargs(), snow_albedo=None))
    _, d1 = day_step(state, t_state.Forcing.from_numpy(day, T64, "cpu"),
                     sim.params, sim.geom, sim.cfg.dt, sim.cfg.nisurf,
                     **dict(sim.step_kwargs(), snow_albedo=None))
    assert float((d2["rnf_day"] - d1["rnf_day"]).min()) > 100.0


def test_flagship_block_step_matches_jax_f32():
    """float32 at rtol 5e-4 / atol 5e-3, the soil-water tolerances of
    tests/test_pallas_day.py (the run starts from the initial state,
    water tables below the column, off the float32 knife edges)."""
    jsim, sim, (want_state, want_acc), (got_state, got_acc) = \
        _run_both("float32", 8)
    assert got_state.soil.h2osoi_liq.dtype == torch.float32
    assert got_state.swe.dtype == got_state.river_store.dtype \
        == got_state.h2osoi_ice.dtype == torch.float32
    assert_tree_close(tree_np(got_state), tree_np(want_state), 5e-4, 5e-3,
                      "state")
    assert_tree_close(tree_np(annual_means(got_acc, sim.cfg.nisurf)),
                      tree_np(j_annual_means(want_acc, jsim.cfg.nisurf)),
                      5e-4, 5e-3, "means")


def test_flagship_ramp_proxy_branch_matches_jax():
    """``soil_ice=False``: impedance from the temperature ramp, latent
    heat in the solve; and no snow albedo."""
    jsim, sim, grid = _flagship("float64", 8, soil_ice=False,
                                snow_albedo=False)
    assert sim.step_kwargs()["soil_ice"] is False
    assert sim.step_kwargs()["snow_albedo"] is None
    day = synthetic_forcing_day(sim.n, 20, seed=3, lat=grid.cell_lat)
    state = sim.state.replace(t_soil=sim.state.t_soil - 11.0)
    jstate = jsim.state.replace(t_soil=jsim.state.t_soil - 11.0)
    jcfg = jsim.cfg
    want_state, want = jax.jit(lambda s, f: j_day_step(
        s, f, jsim.params, jsim.geom, jcfg.dt, jcfg.nisurf,
        **jsim.step_kwargs()))(
        jstate, j_state.Forcing(**{k: jnp.asarray(v) for k, v in day.items()}))
    got_state, got = day_step(
        state, t_state.Forcing.from_numpy(day, torch.float64, "cpu"),
        sim.params, sim.geom, sim.cfg.dt, sim.cfg.nisurf,
        **sim.step_kwargs())
    assert float(got_state.h2osoi_ice.abs().max()) == 0.0
    assert_tree_close(tree_np(got_state), tree_np(want_state), 1e-9, 1e-9,
                      "state")


def test_simulation_matches_jax_set_up():
    jsim, sim, grid = _flagship("float32", 8)
    jkw, kw = jsim.step_kwargs(), sim.step_kwargs()
    assert sim.use_kernel is False and kw["use_kernel"] is False
    assert kw["devices"] is None and kw["lateral"] is None
    for k in ("freeze", "vegetation", "soil_ice", "zd09_every",
              "snow_albedo", "carbon"):
        assert kw[k] == jkw[k], k
    assert kw["snow"] == to_port(jkw["snow"])
    r, jr = kw["routing"], jkw["routing"]
    assert (r.n_land, r.ny, r.nx) == (jr.n_land, jr.ny, jr.nx) \
        == (grid.n_land, 45, 90)
    assert np.array_equal(tree_np(r.flat_idx), np.asarray(jr.flat_idx))
    assert int(r.flat_idx[grid.n_land:].min()) == 45 * 90    # padding lanes
    assert np.array_equal(tree_np(r.params.dir_code),
                          np.asarray(jr.params.dir_code))
    assert np.array_equal(tree_np(r.params.flow_length),
                          np.asarray(jr.params.flow_length))
    assert r.params.flow_length.dtype == torch.float32
    assert (r.params.n_substeps, r.params.c0) == (8, 0.8)
    # The port's own initial state agrees with the one carried across.
    own = Simulation(sim.cfg, sim.params, land_grid=grid)
    assert_tree_close(tree_np(own.state), tree_np(jsim.state), 1e-5, 1e-9,
                      "initial state")
    # Switched off, the extras are off in the keyword arguments too.
    off = Simulation(Config(lateral_routing=False, snow=False,
                            frozen_soil=False, carbon=False, **GRID_KW),
                     sim.params, land_grid=grid).step_kwargs()
    assert off["routing"] is None and off["snow"] is None
    assert not off["freeze"] and not off["soil_ice"] and not off["carbon"]
    assert off["snow_albedo"] is None


def test_build_flagship_case_on_the_cpu():
    case = entry.build_flagship_case("cpu", "float64", resolution_deg=4.0)
    assert case.sim.n == case.land_grid.n_padded == 2048
    assert case.sim.cfg == Config(dtype="float64", resolution_deg=4.0)
    assert case.step_kwargs.keys() == case.sim.step_kwargs().keys()
    want = synthetic_forcing_day(2048, 180, seed=1,
                                 lat=case.land_grid.cell_lat)
    assert_tree_close(tree_np(case.forcing), want, 0, 0, "forcing")
    state, diags = day_step(case.sim.state, case.forcing, case.sim.params,
                            case.sim.geom, case.sim.cfg.dt,
                            case.sim.cfg.nisurf, **case.step_kwargs)
    assert state.soil.h2osoi_liq.device.type == "cpu"
    assert float(diags["max_abs_residual"].max()) < 0.1
    assert float(diags["discharge"].max()) > 0.0


def test_config_flagship_defaults_match_jax():
    j, t = JConfig(), Config()
    for f in ("resolution_deg", "cell_block", "lateral_routing",
              "routing_scheme", "routing_form", "routing_network_path",
              "routing_substeps", "routing_celerity", "snow", "snow_scheme",
              "snow_ddf", "snow_albedo", "snow_alpha", "snow_masking_swe",
              "frozen_soil", "soil_ice", "carbon", "vegetation", "nx", "ny",
              "soil_source", "lateral_groundwater"):
        assert getattr(t, f) == getattr(j, f), f
    assert (Config(resolution_deg=4.0).nx, Config(resolution_deg=4.0).ny) \
        == (90, 45)


# --- what still waits -------------------------------------------------------

@pytest.mark.parametrize("cfg_kw,item", [
    (dict(snow_scheme="twolayer"), "A5.6"),
    (dict(routing_scheme="muskingum"), "A5.6"),
    (dict(routing_scheme="linear"), "A5.6"),
    (dict(routing_form="packed"), "A5.6"),
    (dict(lateral_groundwater=True), "A5.6"),
    (dict(routing_network_path="net.nc"), "A6"),
], ids=lambda x: "-".join(map(str, x.values())) if isinstance(x, dict)
    else None)
def test_config_switches_that_wait_raise(cfg_kw, item):
    grid, params = load_soil(Config(**GRID_KW), torch.float32, "cpu")
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        Simulation(Config(**GRID_KW, **cfg_kw), params, land_grid=grid)


def test_other_things_that_wait_raise():
    grid, params = load_soil(Config(**GRID_KW), torch.float32, "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        Simulation(Config(**GRID_KW), params, land_grid=grid,
                   sharding=object())
    with pytest.raises(ValueError, match="routing_form='grid'"):
        Simulation(Config(routing_form="grid", routing_scheme="linear",
                          **GRID_KW), params, land_grid=grid)
    with pytest.raises(ValueError, match="CUDA"):
        Simulation(Config(use_kernel=True, **GRID_KW), params,
                   land_grid=grid)
    sim = Simulation(Config(vegetation=False, **GRID_KW), params,
                     land_grid=grid)
    f = t_state.Forcing.from_numpy(
        synthetic_forcing_day(sim.n, 180, seed=1), torch.float32, "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A5.6"):
        day_step(sim.state, f, sim.params, sim.geom, sim.cfg.dt,
                 sim.cfg.nisurf, **sim.step_kwargs())


# --- entry points and the card ----------------------------------------------

@pytest.mark.parametrize("build", [
    lambda: entry.build_reference_case(8),
    lambda: entry.build_reference_case(8, "float64"),
    lambda: entry.build_flagship_case(resolution_deg=4.0),
], ids=["reference", "reference_f64", "flagship"])
def test_entry_points_without_a_device_need_the_card(build):
    """No ``device`` means the card: where there is none an entry point
    raises and hands back no CPU tensors.  (On a machine with a card the
    tensors must lie on it.)"""
    if torch.cuda.is_available():
        case = build()
        x = (case.params if hasattr(case, "params")
             else case.sim.params).theta_s
        assert x.is_cuda
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()


def test_run_imports_without_jax():
    """``hybrid9_tpu_torch.run`` and the entry points load, and the
    flagship case is built and stepped, in a process where importing JAX
    or the JAX package fails."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', "
        "'hybrid9_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import hybrid9_tpu_torch.run, hybrid9_tpu_torch.entry\n"
        "import hybrid9_tpu_torch.weights, chip_smoke\n"
        "sys.path.insert(0, 'scripts')\n"
        "import gpu_day_breakdown\n"
        "from hybrid9_tpu_torch.step import day_step\n"
        "case = hybrid9_tpu_torch.entry.build_flagship_case('cpu', "
        "resolution_deg=12.0)\n"
        "s = case.sim\n"
        "day_step(s.state, case.forcing, s.params, s.geom, s.cfg.dt, 2, "
        "**case.step_kwargs)\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), \
        out.stdout + out.stderr
