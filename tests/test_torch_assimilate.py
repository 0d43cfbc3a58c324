"""The port's EnSRF data assimilation (``hybrid9_tpu_torch/assimilate.py``)
against the JAX package's ``assimilate.py``.

Against JAX in float64 on the same numpy inputs: ``enkf_update_scalar_obs``
on random ``[m, n]`` and ``[m, n, l]`` ensembles at 1e-12, and one
``_enkf_cycle`` (a folded forecast day, the analysis, the guards and the
recomputed ``smp``) from the same ``theta_m`` at 1e-9.

On the port alone, as ``tests/test_assimilate.py`` holds the JAX package
(the port draws its ensemble from ``torch.Generator``, a stream of its
own): the analysis moves a correlated variable toward the observation and
leaves masked cells bit for bit; never-observed cells keep their spread;
the twin experiment moves the posterior toward the truth in the cells
whose ET carries information; and the 90-cycle soak keeps the ensemble
healthy, with the never-observed cells' multipliers bitwise their first
draw from the port's own generator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from hybrid9_tpu import assimilate as j_da
from hybrid9_tpu import state as j_state
from hybrid9_tpu.config import LayerGrid
from hybrid9_tpu.data.synthetic import (synthetic_forcing_day,
                                        synthetic_soil_params)
from hybrid9_tpu.physics.hydrology import Geometry as JGeometry
from hybrid9_tpu_torch import assimilate as t_da
from hybrid9_tpu_torch.calibrate import apply_multipliers, simulate_daily_et
from hybrid9_tpu_torch.cli import _stacked_forcing
from hybrid9_tpu_torch.config import Config
from hybrid9_tpu_torch.data.soil import load_soil
from hybrid9_tpu_torch.ensemble import fold
from hybrid9_tpu_torch.physics.hydrology import Geometry
from hybrid9_tpu_torch.state import initial_state
from hybrid9_tpu_torch.step import day_step
from hybrid9_tpu_torch.weights import from_reference

from _torch_port import geom_tuples, to_port, tree_np

TRUTH = 0.5
NDAYS = 25


def _randn(gen, *shape):
    return torch.randn(shape, generator=gen, dtype=torch.float64)


def test_enkf_update_matches_jax():
    rng = np.random.RandomState(11)
    m, n, nl = 9, 7, 3
    x = rng.standard_normal((m, n))
    h = rng.standard_normal((m, n, nl))
    y = 2.0 * x + 0.3 * rng.standard_normal((m, n))
    obs = rng.standard_normal(n) + 1.0
    mask = np.array([True, True, False, True, True, False, True])
    cfg = j_da.EnKFConfig(obs_err_std=0.2, rtps=0.6)
    want = j_da.enkf_update_scalar_obs(
        {"x": jnp.asarray(x), "h": jnp.asarray(h)}, jnp.asarray(y),
        jnp.asarray(obs), jnp.asarray(mask), cfg)
    got = t_da.enkf_update_scalar_obs(
        {"x": torch.tensor(x), "h": torch.tensor(h)}, torch.tensor(y),
        torch.tensor(obs), torch.tensor(mask),
        from_reference("EnKFConfig", cfg._asdict(), torch.float64, "cpu"))
    for k in ("x", "h"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-12, atol=1e-12, err_msg=k)
    assert np.array_equal(got["x"].numpy()[:, ~mask], x[:, ~mask])
    assert np.array_equal(got["h"].numpy()[:, ~mask], h[:, ~mask])


def test_enkf_cycle_matches_jax():
    """One DA cycle in float64, 12 cells x 4 members, from the same prior
    multipliers: the folded forecast, the analysis and the guards."""
    n, m, nisurf = 12, 4, 4
    grid = LayerGrid.from_interfaces()
    p = synthetic_soil_params(n, seed=3)
    params = j_state.SoilParams(**{k: jnp.asarray(v, jnp.float64)
                                   for k, v in p.items()})
    state0 = j_state.initial_state(params, grid.dz, grid.zi, jnp.float64)
    f_day = synthetic_forcing_day(n, 150, seed=3)
    rng = np.random.RandomState(5)
    theta_m = 0.3 * rng.standard_normal((m, n))
    obs = rng.uniform(0.5, 3.0, n)
    mask = np.arange(n) % 3 != 0
    geom = geom_tuples(grid)
    cfg = j_da.EnKFConfig(obs_err_std=0.1, rtps=0.6)
    dt = 86400.0 / nisurf

    def jfold(x):
        return jnp.repeat(x, m, axis=0)
    with jax.disable_jit():
        want = j_da._enkf_cycle(
            jax.tree_util.tree_map(jfold, state0), jnp.asarray(theta_m),
            jax.tree_util.tree_map(jfold, params),
            j_state.Forcing(**{k: jnp.asarray(v, jnp.float64)
                               for k, v in f_day.items()}),
            jnp.asarray(obs), jnp.asarray(mask), JGeometry(*geom), dt, m,
            nisurf, True, False, 1024, 1, cfg)
    tp, ts = to_port(params), to_port(state0)
    got = t_da._enkf_cycle(
        ts.map(lambda x: fold(x, m)), torch.tensor(theta_m),
        tp.map(lambda x: fold(x, m)),
        to_port(j_state.Forcing(**{k: jnp.asarray(v, jnp.float64)
                                   for k, v in f_day.items()})),
        torch.tensor(obs), torch.tensor(mask), Geometry(*geom), dt, m,
        nisurf, True, None, 1,
        from_reference("EnKFConfig", cfg._asdict(), torch.float64, "cpu"))
    w_state, w_theta, w_y = want
    g_state, g_theta, g_y = got
    np.testing.assert_allclose(g_y.numpy(), np.asarray(w_y), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(g_theta.numpy(), np.asarray(w_theta),
                               rtol=1e-9, atol=1e-12)
    want_soil, got_soil = tree_np(w_state.soil), tree_np(g_state.soil)
    for k in ("h2osoi_liq", "wa", "zwt", "smp"):
        np.testing.assert_allclose(got_soil[k], want_soil[k], rtol=1e-9,
                                   atol=1e-9, err_msg=k)
    # Unobserved cells keep their prior multipliers bit for bit.
    assert np.array_equal(g_theta.numpy()[:, ~mask], theta_m[:, ~mask])


def test_enkf_update_moves_toward_obs():
    """A correlated augmented variable moves toward the observation, an
    uncorrelated one does not, masked cells are bit-identical and the
    analysis tightens where observed."""
    gen = torch.Generator().manual_seed(0)
    m, n = 64, 5
    x = _randn(gen, m, n)                       # correlated with y
    y = 2.0 * x + 0.1 * _randn(gen, m, n)
    z = _randn(gen, m, n)                       # independent of y
    obs = torch.full((n,), 4.0, dtype=torch.float64)
    mask = torch.ones(n, dtype=torch.bool)
    cfg = t_da.EnKFConfig(obs_err_std=0.1, rtps=0.0)
    out = t_da.enkf_update_scalar_obs({"x": x, "z": z}, y, obs, mask, cfg)
    assert float(out["x"].mean()) > 1.5
    assert abs(float(out["z"].mean())) < 0.3
    assert float(out["x"].std()) < float(x.std())
    out_r = t_da.enkf_update_scalar_obs(
        {"x": x}, y, obs, mask, t_da.EnKFConfig(obs_err_std=0.1, rtps=0.5))
    assert (float(out["x"].std()) <= float(out_r["x"].std()) + 1e-6
            and float(out_r["x"].std()) < float(x.std()))
    out2 = t_da.enkf_update_scalar_obs({"x": x}, y, obs,
                                       torch.zeros(n, dtype=torch.bool), cfg)
    assert torch.equal(out2["x"], x)


def test_enkf_unobserved_spread_is_static():
    """Repeated analyses do not grow spread in never-observed cells."""
    gen = torch.Generator().manual_seed(3)
    m, n = 32, 6
    x = _randn(gen, m, n)
    y = x + 0.05 * _randn(gen, m, n)
    obs = torch.zeros(n, dtype=torch.float64)
    mask = torch.tensor([True, True, True, False, False, False])
    cfg = t_da.EnKFConfig(obs_err_std=0.2, rtps=0.7)
    cur = {"x": x}
    for _ in range(30):
        cur = t_da.enkf_update_scalar_obs(cur, y, obs, mask, cfg)
    sig = cur["x"].std(dim=0, correction=0).numpy()
    sig0 = x.std(dim=0, correction=0).numpy()
    np.testing.assert_allclose(sig[3:], sig0[3:], rtol=1e-6)
    assert np.all(sig[:3] < sig0[:3])


def _problem(ndays, nisurf):
    cfg = Config(resolution_deg=24.0, start_year=1901, end_year=1901,
                 cell_block=16, nisurf=nisurf)
    grid, params = load_soil(cfg, torch.float32, "cpu")
    lg = cfg.layer_grid()
    state0 = initial_state(params, lg.dz, lg.zi, torch.float32, "cpu")
    forcing = _stacked_forcing(cfg, grid, ndays, torch.float32, "cpu")
    return cfg, grid, params, state0, Geometry.from_layer_grid(lg), forcing


def _model_et(cfg, params, state0, geom, forcing, log_mult):
    """The daily-ET trajectory under one hksat log-multiplier."""
    p = apply_multipliers(params, {"hksat": torch.tensor(log_mult)})
    state, ys = state0, []
    for d in range(forcing.tas.shape[0]):
        state, diags = day_step(state, forcing.map(lambda x: x[d]), p, geom,
                                86400.0 / cfg.nisurf, cfg.nisurf)
        ys.append(diags["evap_day"])
    return torch.stack(ys)


def test_enkf_twin_recovers_multiplier():
    """Obs from the model under a known hksat log-multiplier; the filter
    moves the posterior toward it in the cells where the truth changes ET
    (chosen from the prior sensitivity, before any assimilation), tightens
    the spread there, and the innovations shrink."""
    cfg, grid, params, state0, geom, forcing = _problem(NDAYS, 4)
    obs = _model_et(cfg, params, state0, geom, forcing, TRUTH)
    prior_et = _model_et(cfg, params, state0, geom, forcing, 0.0)
    sens = (obs - prior_et).abs().mean(dim=0).numpy()
    res = t_da.assimilate(params, state0, forcing, obs, geom, n_members=16,
                          nisurf=cfg.nisurf, theta_spread=0.3, seed=1,
                          cfg=t_da.EnKFConfig(obs_err_std=0.05, rtps=0.6))
    n_land = grid.n_land
    tm = res["theta_mean"].numpy()[:n_land]
    ts = res["theta_std"].numpy()[:n_land]
    assert np.all(np.isfinite(tm)) and np.all(np.isfinite(ts))
    informative = np.argsort(-sens[:n_land])[:max(1, n_land // 2)]
    med = float(np.median(tm[informative]))
    assert med > 0.1, f"posterior median {med} did not move toward {TRUTH}"
    assert float(np.median(ts[informative])) < 0.3
    err = (res["y_pred_mean"] - obs).abs().numpy()
    assert float(np.mean(err[-5:, :n_land])) < float(np.mean(err[:5,
                                                                 :n_land]))


def test_season_length_da_soak_ensemble_health():
    """90 daily cycles: the posterior spread in observed cells neither
    collapses nor exceeds the prior, cells never observed keep their
    multiplier ensemble bitwise the first draw, and the innovation is
    stationary or shrinking.  At 3 substeps a day (tests/test_assimilate.py
    takes 6): the ensemble's health does not depend on them."""
    ndays, m, spread, seed = 90, 8, 0.3, 3
    cfg, grid, params, state0, geom, forcing = _problem(ndays, 3)
    n = grid.n_padded
    with torch.no_grad():
        obs = simulate_daily_et({"hksat": torch.tensor(TRUTH)}, params,
                                state0, forcing, geom, cfg.nisurf)
    mask = np.zeros((ndays, n), bool)
    observed = np.arange(grid.n_land) % 2 == 0
    mask[:, :grid.n_land] = observed[None, :]
    res = t_da.assimilate(params, state0, forcing, obs, geom, n_members=m,
                          nisurf=cfg.nisurf, obs_mask=torch.tensor(mask),
                          theta_spread=spread, seed=seed,
                          cfg=t_da.EnKFConfig(obs_err_std=0.1, rtps=0.6))
    ts = res["theta_std"].numpy()[:grid.n_land]
    assert np.all(np.isfinite(ts))
    # The first draw, recomputed from the same generator on the same
    # device.
    theta0 = t_da.first_draw(torch.Generator().manual_seed(seed), m, n,
                             spread, torch.float32)
    std0 = theta0.std(dim=0, correction=0).numpy()[:grid.n_land]
    np.testing.assert_array_equal(ts[~observed], std0[~observed])
    tso = ts[observed]
    assert np.all(tso <= std0[observed] + 1.0e-6)
    assert np.median(tso) < 0.9 * np.median(std0[observed])
    assert np.median(tso) > 0.02
    err = (res["y_pred_mean"] - obs).abs().numpy()
    err = err[:, :grid.n_land][:, observed]
    assert float(np.mean(err[-30:])) <= float(np.mean(err[:30])) * 1.05
