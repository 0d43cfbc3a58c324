"""The port's non-default physics switches against the JAX package:
hydrology-only (``vegetation=False``), two-layer snow and lateral
groundwater.

Each switch runs ``Simulation`` + ``block_step(**step_kwargs())`` over
five days from 1 January on the 12-degree grid in both packages, from the
same numpy soil and state, in float64 at rtol 1e-9 on every state field
and annual mean (and the two-layer scheme once in float32 at the
soil-water tolerances of tests/test_pallas_day.py).  The modules one by
one mirror tests/test_snow_twolayer.py and tests/test_lateral.py:26-72,
113 (the sharded cases wait for ROADMAP A9).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid9_tpu import state as j_state
from hybrid9_tpu.grids.grid import make_land_grid as j_make_land_grid
from hybrid9_tpu.grids.grid import synthetic_land_mask as j_land_mask
from hybrid9_tpu.physics import lateral as j_lateral
from hybrid9_tpu.physics import snow as j_snow
from hybrid9_tpu_torch import entry
from hybrid9_tpu_torch import state as t_state
from hybrid9_tpu_torch.grids.grid import make_land_grid, synthetic_land_mask
from hybrid9_tpu_torch.physics import constants as c
from hybrid9_tpu_torch.physics.lateral import (LateralParams,
                                               lateral_groundwater_step,
                                               make_lateral_params)
from hybrid9_tpu_torch.physics.snow import (SnowParams, TwoLayerSnowParams,
                                            snow_step, snow_step_two_layer)
from hybrid9_tpu_torch.step import day_step

from _torch_port import assert_tree_close, run_both, to_port, tree_np

T64 = torch.float64


def _at_work_hydrology_only(sim, got, block):
    init = tree_np(sim.state)
    assert np.array_equal(got["veg"]["lai"], init["veg"]["lai"])
    assert np.array_equal(got["veg"]["rootr"], init["veg"]["rootr"])
    assert np.array_equal(got["carbon"]["c_soil_slow"],
                          init["carbon"]["c_soil_slow"])
    kw = sim.step_kwargs()
    assert kw["vegetation"] is False and kw["carbon"] is False


def _at_work_twolayer(sim, got, block):
    pack = got["snowpack"]
    total = pack["swe_surf"] + pack["swe_base"] + pack["w_liq"]
    assert np.array_equal(got["swe"], total)
    assert got["swe"].max() > 1.0 and pack["t_surf"].min() < c.TF


def _at_work_lateral(sim, got, block):
    assert isinstance(sim.lateral, LateralParams)
    wa, net = lateral_groundwater_step(
        torch.tensor(got["soil"]["wa"]), torch.tensor(got["soil"]["zwt"]),
        sim.lateral)
    land = net[:sim.n_land]
    assert float(land.abs().max()) > 1e-3
    assert abs(float(land.sum())) < 1e-9 * float(land.abs().sum())


SWITCHES = {
    "hydrology_only": (dict(vegetation=False), _at_work_hydrology_only),
    "twolayer": (dict(snow_scheme="twolayer"), _at_work_twolayer),
    "lateral": (dict(lateral_groundwater=True, lateral_k=1.0e-4),
                _at_work_lateral),
}


@pytest.mark.parametrize("name", sorted(SWITCHES))
def test_switch_block_matches_jax_f64(name):
    switch, at_work = SWITCHES[name]
    jsim, sim, (want, want_means), (got, means), block = run_both(
        "float64", **switch)
    at_work(sim, got, block)
    assert means["max_abs_residual"].max() < 0.1
    assert_tree_close(got, want, 1e-9, 1e-9, "state")
    assert_tree_close(means, want_means, 1e-9, 1e-9, "means")


def test_hydrology_only_day_has_no_growth_fluxes():
    """``vegetation=False``: npp and litterfall are 0 and no growth or
    carbon flux is in the day's diagnostics, as in the JAX package."""
    case = entry.build_reference_case(16, "float64", "cpu")
    state, diags = day_step(case.state, case.forcing, case.params,
                            case.geom, case.cfg.dt, 4, vegetation=False,
                            carbon=True)
    assert float(diags["npp"].abs().max()) == 0.0
    assert not {k for k in diags if k.startswith("v_")}
    assert torch.equal(state.veg.lai, case.state.veg.lai)
    # The cascade still decays with no production.
    assert float(diags["rh"].min()) > 0.0
    np.testing.assert_array_equal(tree_np(diags["nee"]),
                                  tree_np(diags["rh"]))


def test_twolayer_block_matches_jax_f32():
    jsim, sim, (want, want_means), (got, means), _ = run_both(
        "float32", snow_scheme="twolayer")
    assert got["snowpack"]["swe_surf"].dtype == np.float32
    assert_tree_close(got, want, 5e-4, 5e-3, "state")
    assert_tree_close(means, want_means, 5e-4, 5e-3, "means")


# --- two-layer snow, module by module (tests/test_snow_twolayer.py) ---------

def _pack(n=1, surf=0.0, base=0.0, liq=0.0, t_surf=c.TF, t_base=c.TF):
    return t_state.SnowpackState(
        swe_surf=torch.full((n,), surf, dtype=T64),
        swe_base=torch.full((n,), base, dtype=T64),
        w_liq=torch.full((n,), liq, dtype=T64),
        t_surf=torch.full((n,), t_surf, dtype=T64),
        t_base=torch.full((n,), t_base, dtype=T64))


def _total(pk):
    return (pk.swe_surf + pk.swe_base + pk.w_liq).numpy()


def _random_packs(n=512, seed=3):
    rng = np.random.RandomState(seed)
    return dict(swe_surf=rng.rand(n) * 120.0, swe_base=rng.rand(n) * 150.0,
                w_liq=rng.rand(n) * 5.0, t_surf=c.TF - rng.rand(n) * 20.0,
                t_base=c.TF - rng.rand(n) * 10.0), \
        250.0 + rng.rand(n) * 40.0, rng.rand(n) * 30.0 / c.SDAY


@pytest.mark.parametrize("dtype,rtol", [("float64", 1e-9),
                                        ("float32", 1e-5)])
def test_snow_step_two_layer_matches_jax_and_conserves(dtype, rtol):
    """Every output of the scheme against the JAX package on random
    packs, and ``d(ice + liquid) + outflow + capped == pr``."""
    packs, tas, pr = _random_packs()
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    p_j = j_snow.TwoLayerSnowParams(swe_cap=200.0)
    p_t = to_port(p_j, dtype)
    assert p_t == TwoLayerSnowParams(swe_cap=200.0)
    want = jax.jit(j_snow.snow_step_two_layer)(
        j_state.SnowpackState(**{k: jnp.asarray(v, jd)
                                 for k, v in packs.items()}),
        jnp.asarray(tas, jd), jnp.asarray(pr, jd), p_j)
    pk0 = t_state.SnowpackState.from_numpy(packs, td, "cpu")
    got = snow_step_two_layer(pk0, torch.tensor(tas, dtype=td),
                              torch.tensor(pr, dtype=td), p_t)
    assert_tree_close(tree_np(got), tree_np(want), rtol, rtol, "two-layer")
    pk1, pr_eff, melt, capped = got
    lhs = (_total(pk1) - _total(pk0) + pr_eff.numpy() * c.SDAY
           + capped.numpy())
    np.testing.assert_allclose(lhs, pr * c.SDAY, rtol=1e-9 if
                               dtype == "float64" else 1e-5,
                               atol=1e-9 if dtype == "float64" else 1e-3)
    for f in (pk1.swe_surf, pk1.swe_base, pk1.w_liq):
        assert float(f.min()) >= 0.0
    assert float(pk1.t_surf.max()) <= float(torch.tensor(c.TF, dtype=td))


def test_two_layer_ripening_delay_vs_degree_day():
    """A cold pack releases no water on the first warm day (the energy
    warms it) where the degree-day store melts at once; a ripe pack
    melts, and a hot day drains it."""
    p2 = TwoLayerSnowParams()
    cold = _pack(surf=100.0, base=100.0, t_surf=c.TF - 20.0,
                 t_base=c.TF - 20.0)
    tas = torch.full((1,), c.TF + 2.0, dtype=T64)
    pr = torch.zeros(1, dtype=T64)
    pk1, pr_eff, melt, _ = snow_step_two_layer(cold, tas, pr, p2)
    assert float(melt[0]) == 0.0 and float(pr_eff[0]) == 0.0
    assert float(pk1.t_surf[0]) > c.TF - 20.0
    _, _, melt1, _ = snow_step(torch.full((1,), 200.0, dtype=T64), tas, pr,
                               SnowParams())
    assert float(melt1[0]) > 0.0
    ripe = _pack(surf=100.0, base=100.0)
    _, _, melt_r, _ = snow_step_two_layer(ripe, tas, pr, p2)
    assert float(melt_r[0]) > 0.0
    hot = torch.full((1,), c.TF + 10.0, dtype=T64)
    _, pr_eff_h, melt_h, _ = snow_step_two_layer(ripe, hot, pr, p2)
    assert float(melt_h[0]) > float(melt_r[0]) and float(pr_eff_h[0]) > 0.0


def test_two_layer_rain_on_snow_refreezes():
    p = TwoLayerSnowParams()
    pr = torch.full((1,), 5.0 / c.SDAY, dtype=T64)
    tas = torch.full((1,), c.TF + 4.0, dtype=T64)
    cold = _pack(surf=80.0, base=120.0, t_surf=c.TF - 15.0,
                 t_base=c.TF - 15.0)
    pk1, pr_eff, _, _ = snow_step_two_layer(cold, tas, pr, p)
    assert float(pk1.swe_surf[0] + pk1.swe_base[0]) > 200.0
    assert float(pr_eff[0]) * c.SDAY < 0.5
    ripe = _pack(surf=80.0, base=120.0, liq=p.hold_frac * 200.0)
    _, pr_eff2, _, _ = snow_step_two_layer(ripe, tas, pr, p)
    assert float(pr_eff2[0]) * c.SDAY > 5.0 * 0.9


def test_two_layer_overflow_and_cap_on_the_total_pack():
    """The surface layer overflows into the base; past ``swe_cap`` ice
    leaves as capped runoff, and the cap bounds ice AND retained liquid
    (the reference's fault: liquid riding hold_frac * cap above it)."""
    p = TwoLayerSnowParams(surf_max=100.0, swe_cap=300.0)
    tas = torch.full((1,), 250.0, dtype=T64)
    pr = torch.full((1,), 150.0 / c.SDAY, dtype=T64)
    pk1, _, _, capped = snow_step_two_layer(_pack(), tas, pr, p)
    assert float(pk1.swe_surf[0]) <= 100.0 + 1e-9
    np.testing.assert_allclose(_total(pk1), 150.0, rtol=1e-9)
    assert float(capped[0]) == 0.0
    pk2, _, _, capped2 = snow_step_two_layer(_pack(surf=100.0, base=260.0),
                                             tas, pr, p)
    assert float(pk2.swe_surf[0] + pk2.swe_base[0]) <= 300.0 + 1e-9
    assert float(capped2[0]) > 0.0
    # A ripe pack at the cap with liquid in it, on a warm rainy day.
    full = _pack(surf=100.0, base=200.0, liq=10.0)
    warm = torch.full((1,), c.TF + 5.0, dtype=T64)
    rain = torch.full((1,), 20.0 / c.SDAY, dtype=T64)
    pk3, pr_eff3, _, capped3 = snow_step_two_layer(full, warm, rain, p)
    assert float(_total(pk3)[0]) <= 300.0 + 1e-9
    np.testing.assert_allclose(
        _total(pk3) - _total(full) + pr_eff3.numpy() * c.SDAY
        + capped3.numpy(), 20.0, rtol=1e-9)


def test_day_step_twolayer_mirrors_the_pack_total():
    case = entry.build_reference_case(64, "float32", "cpu")
    cold = case.forcing.replace(
        tas=torch.full((64,), 250.0), pr=torch.full((64,), 8.0 / c.SDAY))
    st, diags = day_step(case.state, cold, case.params, case.geom,
                         case.cfg.dt, case.cfg.nisurf,
                         snow=TwoLayerSnowParams())
    np.testing.assert_allclose(tree_np(st.snowpack.swe_surf), 8.0,
                               rtol=1e-5)
    np.testing.assert_allclose(tree_np(st.swe), 8.0, rtol=1e-5)
    assert float(st.snowpack.t_surf.max()) < c.TF
    assert float(diags["max_abs_residual"].max()) < 0.1


def test_scheme_switch_preserves_legacy_swe():
    """A degree-day state (500 mm in ``swe``, an empty pack) resumed
    under the two-layer scheme banks its snow in the base layer; a pack
    that ``swe`` fell below is scaled down to it, never resurrected."""
    case = entry.build_reference_case(64, "float32", "cpu")
    cold = case.forcing.replace(tas=torch.full((64,), 250.0),
                                pr=torch.zeros(64))
    state = case.state.replace(swe=torch.full((64,), 500.0))
    run = (case.params, case.geom, case.cfg.dt, case.cfg.nisurf)
    st, _ = day_step(state, cold, *run, snow=TwoLayerSnowParams())
    np.testing.assert_allclose(tree_np(st.swe), 500.0, rtol=1e-6)
    np.testing.assert_allclose(tree_np(st.snowpack.swe_base), 500.0,
                               rtol=1e-6)
    stale = st.replace(swe=torch.full((64,), 200.0),
                       snowpack=st.snowpack.replace(
                           swe_base=torch.full((64,), 300.0)))
    st2, _ = day_step(stale, cold, *run, snow=TwoLayerSnowParams())
    np.testing.assert_allclose(tree_np(st2.swe), 200.0, rtol=1e-5)


# --- lateral groundwater (tests/test_lateral.py) ----------------------------

def _lateral_case(dtype="float32"):
    mask = synthetic_land_mask(resolution_deg=6.0, seed=3)
    grid = make_land_grid(mask, 6.0, pad_multiple=64)
    p = make_lateral_params(grid, "cpu", k_lat=5.0e-4)
    rng = np.random.RandomState(0)
    wa = rng.uniform(1000.0, 5000.0, grid.n_padded)
    zwt = rng.uniform(0.5, 10.0, grid.n_padded)
    td = getattr(torch, dtype)
    return grid, p, torch.tensor(wa, dtype=td), torch.tensor(zwt, dtype=td)


@pytest.mark.parametrize("dtype,rtol", [("float64", 1e-9),
                                        ("float32", 1e-6)])
def test_lateral_step_matches_jax(dtype, rtol):
    grid, p, wa, zwt = _lateral_case(dtype)
    jgrid = j_make_land_grid(j_land_mask(resolution_deg=6.0, seed=3), 6.0,
                             pad_multiple=64)
    p_j = j_lateral.make_lateral_params(jgrid, k_lat=5.0e-4)
    got_p, want_p = tree_np(p), tree_np(p_j)
    for k in want_p:
        assert np.array_equal(got_p[k], want_p[k]), k
    assert p.z_surf.dtype == torch.float32
    handed = to_port(p_j, dtype)
    assert handed.z_surf.dtype == torch.float32
    assert handed.land_mask.dtype == torch.bool
    jd = jnp.dtype(dtype)
    want = jax.jit(j_lateral.lateral_groundwater_step)(
        jnp.asarray(wa.numpy(), jd), jnp.asarray(zwt.numpy(), jd), p_j)
    got = lateral_groundwater_step(wa, zwt, p)
    assert got[0].dtype == wa.dtype
    assert_tree_close(tree_np(lateral_groundwater_step(wa, zwt, handed)),
                      tree_np(got), 0, 0, "handed over")
    assert_tree_close(tree_np(got), tree_np(want), rtol, rtol * 1e-2,
                      "lateral")


def test_lateral_conserves_and_limits_outflow():
    grid, p, wa, zwt = _lateral_case()
    n = grid.n_land
    wa1, net = lateral_groundwater_step(wa, zwt, p)
    np.testing.assert_allclose(float(net[:n].sum()), 0.0, atol=1e-2)
    np.testing.assert_allclose(float(wa1[:n].sum()), float(wa[:n].sum()),
                               rtol=1e-6)
    assert float(wa1[:n].min()) >= -1e-4
    assert torch.equal(wa1[n:], wa[n:])
    target = n // 3
    wa[target], zwt[target] = 0.5, 0.01      # empty aquifer, high head
    wa2, _ = lateral_groundwater_step(wa, zwt, p)
    assert float(wa2[target]) >= -1e-5
    np.testing.assert_allclose(float(wa2[:n].sum()), float(wa[:n].sum()),
                               rtol=1e-6)


def test_lateral_water_flows_downhill():
    ny = nx = 8
    p = LateralParams(land_flat_idx=torch.arange(ny * nx),
                      land_mask=torch.ones((ny, nx), dtype=torch.bool),
                      z_surf=torch.zeros((ny, nx)), k_lat=1.0e-3,
                      n_padded=ny * nx)
    zwt = torch.full((ny * nx,), 5.0)
    centre = 3 * nx + 3
    zwt[centre] = 0.5                        # shallow table = high head
    _, net = lateral_groundwater_step(torch.full((ny * nx,), 3000.0), zwt, p)
    assert float(net[centre]) < 0.0
    for nb in (centre - 1, centre + 1, centre - nx, centre + nx):
        assert float(net[nb]) > 0.0
    np.testing.assert_allclose(float(net.sum()), 0.0, atol=1e-3)


def test_day_step_with_lateral():
    """Mirror of tests/test_lateral.py::test_day_step_with_lateral: the
    exchange moves water between cells and keeps the land total."""
    grid = make_land_grid(synthetic_land_mask(resolution_deg=12.0, seed=2),
                          12.0, pad_multiple=64)
    case = entry.build_reference_case(grid.n_padded, "float32", "cpu")
    lat = make_lateral_params(grid, "cpu", k_lat=1e-3)
    run = (case.params, case.geom, case.cfg.dt, 8)
    st, _ = day_step(case.state, case.forcing, *run, lateral=lat)
    st2, _ = day_step(case.state, case.forcing, *run)
    n = grid.n_land
    wa1, wa2 = st.soil.wa[:n].double(), st2.soil.wa[:n].double()
    assert bool(torch.isfinite(st.soil.wa).all())
    np.testing.assert_allclose(float(wa1.sum()), float(wa2.sum()),
                               rtol=1e-5)
    assert not torch.allclose(wa1, wa2)
