"""The port's day step, block loop and reference case against JAX.

``day_step`` and a 3-day ``block_step`` + ``annual_means`` are held
against JAX's ``day_step`` and ``_block_step`` on identical inputs (the
JAX reference case, handed over through numpy): float64 at rtol 1e-9,
float32 at the tests/test_pallas_day.py tolerances on the soil water
and 1e-5 elsewhere (growth and soil heat run pow/exp of two different
math libraries in float32).  The goldens are in test_torch_goldens.py.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from hybrid9_tpu import state as j_state
from hybrid9_tpu.step import _block_step, annual_means as j_annual_means
from hybrid9_tpu.step import day_step as j_day_step
from hybrid9_tpu_torch import state as t_state
from hybrid9_tpu_torch.config import Config
from hybrid9_tpu_torch.data.synthetic import synthetic_forcing_block
from hybrid9_tpu_torch.entry import build_reference_case
from hybrid9_tpu_torch.physics.hydrology import Geometry
from hybrid9_tpu_torch.step import annual_means, block_step, day_step

from _torch_port import assert_tree_close, tree_np

N = 256
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOIL_F32 = dict(h2osoi_liq=(5e-4, 5e-3), zwt=(5e-4, 1e-5), wa=(5e-4, 5e-3))


def _jax_case(dtype):
    _, state, forcing, params, geom, cfg = ge._build(N, dtype)
    td = getattr(torch, dtype)
    return (state, forcing, params, geom, cfg,
            t_state.ModelState.from_numpy(tree_np(state), td, "cpu"),
            t_state.Forcing.from_numpy(tree_np(forcing), td, "cpu"),
            t_state.SoilParams.from_numpy(tree_np(params), td, "cpu"),
            Geometry(*geom))


def _assert_state_close(got, want, dtype, what):
    """Two nested numpy trees of model state or sums."""
    if dtype == "float64":
        assert_tree_close(got, want, 1e-9, 1e-9, what)
        return
    soil = got.get("soil") if isinstance(got, dict) else None
    if soil is not None:
        for k, (rtol, atol) in SOIL_F32.items():
            np.testing.assert_allclose(soil[k], want["soil"][k], rtol=rtol,
                                       atol=atol, err_msg=f"{what}.soil.{k}")
        got = {k: v for k, v in got.items() if k != "soil"}
        want = {k: v for k, v in want.items() if k != "soil"}
    assert_tree_close(got, want, 1e-5, 1e-5, what)


@pytest.mark.parametrize("zd09_every", [1, 8])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_day_step_matches_jax(dtype, zd09_every):
    state, forcing, params, geom, cfg, t_st, t_f, t_p, t_geom = \
        _jax_case(dtype)
    want_state, want_diags = jax.jit(lambda s, f: j_day_step(
        s, f, params, geom, cfg.dt, cfg.nisurf,
        zd09_every=zd09_every))(state, forcing)
    got_state, got_diags = day_step(t_st, t_f, t_p, t_geom, cfg.dt,
                                    cfg.nisurf, zd09_every=zd09_every)
    _assert_state_close(tree_np(got_state), tree_np(want_state), dtype,
                        "state")
    want = tree_np(want_diags)
    got = tree_np(got_diags)
    for k in ("evap_day", "evap_grnd_day", "rnf_day"):
        rtol, atol = (1e-9, 1e-12) if dtype == "float64" else (5e-3, 1e-3)
        np.testing.assert_allclose(got.pop(k), want.pop(k), rtol=rtol,
                                   atol=atol, err_msg=k)
    res = got.pop("max_abs_residual")
    assert float(res.max()) < 0.1
    want.pop("max_abs_residual")
    _assert_state_close(got, want, dtype, "diags")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_block_step_and_annual_means_match_jax(dtype):
    state, forcing, params, geom, cfg, t_st, t_f, t_p, t_geom = \
        _jax_case(dtype)
    block = synthetic_forcing_block(3, N, seed=1, start_doy=152)
    jd = jnp.dtype(dtype)
    j_block = j_state.Forcing(**{k: jnp.asarray(v, jd)
                                 for k, v in block.items()})
    acc_j = j_state.AnnualAccumulators.zeros(N, dtype=jd)
    want_state, want_acc = jax.jit(
        _block_step, static_argnames=("geom", "dt", "nisurf",
                                      "zd09_every"))(
        state, acc_j, j_block, params, geom=geom, dt=cfg.dt,
        nisurf=cfg.nisurf, zd09_every=8)
    td = getattr(torch, dtype)
    acc_t = t_state.AnnualAccumulators.zeros(N, td, "cpu")
    got_state, got_acc = block_step(
        t_st, acc_t, t_state.Forcing.from_numpy(block, td, "cpu"), t_p, t_geom,
        cfg.dt, cfg.nisurf, zd09_every=8)
    assert float(got_acc.n_days) == 3.0
    _assert_state_close(tree_np(got_state), tree_np(want_state), dtype,
                        "state")
    got_means = tree_np(annual_means(got_acc, cfg.nisurf))
    want_means = tree_np(j_annual_means(want_acc, cfg.nisurf))
    assert float(got_means["max_abs_residual"].max()) < 0.1
    for name in ("max_abs_residual",):
        got_means.pop(name)
        want_means.pop(name)
    if dtype == "float64":
        assert_tree_close(got_means, want_means, 1e-9, 1e-12, "means")
    else:
        # Sums of the day's water fluxes carry the evap_day tolerance.
        for k in ("rnf", "evap"):
            np.testing.assert_allclose(got_means.pop(k), want_means.pop(k),
                                       rtol=5e-3, atol=1e-8, err_msg=k)
        theta = (got_means.pop("theta"), want_means.pop("theta"))
        np.testing.assert_allclose(*theta, rtol=5e-4, atol=5e-5)
        assert_tree_close(got_means, want_means, 1e-5, 1e-5, "means")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_build_reference_case_matches_graft_entry(dtype):
    _, state, forcing, params, geom, cfg = ge._build(N, dtype)
    case = build_reference_case(N, dtype, "cpu")
    # initial_state's pow/exp (plant_length, rootr, smp) in two math
    # libraries: float64 agrees to round-off, float32 to a few ulps, and
    # root fractions below 1e-9 (layers under the shallow initial roots)
    # to an absolute 1e-9.
    rtol, atol = (1e-12, 0) if dtype == "float64" else (1e-5, 1e-9)
    assert_tree_close(tree_np(case.state), tree_np(state), rtol, atol,
                      "state")
    assert_tree_close(tree_np(case.forcing), tree_np(forcing), 0, 0,
                      "forcing")
    assert_tree_close(tree_np(case.params), tree_np(params), 0, 0, "params")
    assert tuple(case.geom) == tuple(geom)
    assert (case.cfg.dt, case.cfg.nisurf, case.cfg.zd09_every) == \
        (cfg.dt, cfg.nisurf, cfg.zd09_every)
    assert case.state.soil.h2osoi_liq.dtype == getattr(torch, dtype)


def test_state_round_trips_through_numpy():
    case = build_reference_case(16, "float64", "cpu")
    arrays = tree_np(case.state)
    again = t_state.ModelState.from_numpy(arrays, torch.float64, "cpu")
    assert_tree_close(tree_np(again.to("cpu")), arrays, 0, 0, "state")
    acc = t_state.AnnualAccumulators.zeros(16, torch.float64, "cpu")
    assert acc.n_days.shape == () and acc.theta_sum.shape == (16, 8)


@pytest.mark.parametrize("extra", [
    dict(routing=object()), dict(lateral=object()), dict(snow=object()),
    dict(focus_idx=3), dict(vegetation=False)],
    ids=lambda e: next(iter(e)))
def test_extras_not_ported_raise(extra):
    """What ``day_step`` still cannot run: routers other than the dense
    kinematic one, lateral groundwater, snow schemes other than the
    degree-day one, the focus-cell trace and the hydrology-only mode.
    (The flagship extras themselves are in test_torch_flagship.py.)"""
    case = build_reference_case(8, "float32", "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        day_step(case.state, case.forcing, case.params, case.geom,
                 case.cfg.dt, case.cfg.nisurf, **extra)
    block = case.forcing.map(lambda x: x[None])
    acc = t_state.AnnualAccumulators.zeros(8, torch.float32, "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        block_step(case.state, acc, block, case.params, case.geom,
                   case.cfg.dt, case.cfg.nisurf, **extra)


def test_config_defaults_match_jax():
    from hybrid9_tpu.config import Config as JConfig
    j, t = JConfig(), Config()
    assert (t.nisurf, t.zi_mm, t.dtype, t.zd09_every, t.dt) == \
        (j.nisurf, j.zi_mm, j.dtype, j.zd09_every, j.dt)
    assert t.use_kernel is None
    np.testing.assert_array_equal(t.layer_grid().zc, j.layer_grid().zc)


def test_port_never_imports_jax():
    """The port, its build helper and chip_smoke.py load without JAX or
    the JAX package."""
    code = ("import sys\n"
            "import hybrid9_tpu_torch.step, hybrid9_tpu_torch.entry\n"
            "import hybrid9_tpu_torch.run, hybrid9_tpu_torch.weights\n"
            "import hybrid9_tpu_torch.kernels, chip_smoke\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'hybrid9_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
