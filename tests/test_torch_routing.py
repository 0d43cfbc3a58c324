"""The port's land grid, flow network and dense kinematic router against
the JAX package.

The host-side numpy builders (grids/grid.py, grids/routing.py,
data/soil.py) must give exactly the JAX package's arrays; the router
(physics/routing.py) is held against ``route_kinematic_day_grid`` and
``route_grid_day`` in float64 at rtol 1e-9 on inputs with NaN fill cells,
negative runoff and padding lanes.  The reference's own regression tests
for the dense kinematic router are ported with it (NaN fill values,
negative-runoff reclaim days).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid9_tpu.config import Config as JConfig
from hybrid9_tpu.data import soil as j_soil
from hybrid9_tpu.grids import grid as j_grid
from hybrid9_tpu.grids import routing as j_net
from hybrid9_tpu.physics import routing as j_routing
from hybrid9_tpu_torch.config import Config
from hybrid9_tpu_torch.data import soil as t_soil
from hybrid9_tpu_torch.grids import grid as t_grid
from hybrid9_tpu_torch.grids import routing as t_net
from hybrid9_tpu_torch.physics import routing as t_routing

from _torch_port import assert_close, to_port, tree_np

RES = 4.0          # 45 x 90 grid
T64 = torch.float64


def _grids(pad=256):
    mask = j_grid.synthetic_land_mask(RES)
    return (j_grid.make_land_grid(mask, RES, pad),
            t_grid.make_land_grid(t_grid.synthetic_land_mask(RES), RES, pad))


def _field(g, seed=0):
    return np.random.RandomState(seed).rand(g.ny, g.nx)


HOST_CASES = {
    "cell_centres": lambda jg, tg: (
        np.concatenate(j_grid.cell_centres(RES)),
        np.concatenate(t_grid.cell_centres(RES))),
    "synthetic_land_mask": lambda jg, tg: (
        j_grid.synthetic_land_mask(RES, seed=3, land_fraction=0.4),
        t_grid.synthetic_land_mask(RES, seed=3, land_fraction=0.4)),
    "make_land_grid": lambda jg, tg: (
        np.concatenate([jg.land_idx, [jg.n_padded, jg.nx, jg.ny],
                        jg.valid, jg.cell_lat, jg.cell_lon]),
        np.concatenate([tg.land_idx, [tg.n_padded, tg.nx, tg.ny],
                        tg.valid, tg.cell_lat, tg.cell_lon])),
    "pack": lambda jg, tg: (jg.pack(_field(jg), fill=-1.0),
                            tg.pack(_field(tg), fill=-1.0)),
    "pack_layers_int": lambda jg, tg: (
        jg.pack((_field(jg)[..., None] * [1, 2, 3]).astype(np.int32), 7),
        tg.pack((_field(tg)[..., None] * [1, 2, 3]).astype(np.int32), 7)),
    "scatter": lambda jg, tg: (
        jg.scatter(np.arange(jg.n_padded, dtype=np.float32)),
        tg.scatter(np.arange(tg.n_padded, dtype=np.float32))),
    "row_band": lambda jg, tg: (
        np.concatenate([np.r_[b[:2], b[2]] for b in (
            jg.row_band(100, 300), jg.row_band(jg.n_land - 5, jg.n_padded),
            jg.row_band(jg.n_land, jg.n_padded))]),
        np.concatenate([np.r_[b[:2], b[2]] for b in (
            tg.row_band(100, 300), tg.row_band(tg.n_land - 5, tg.n_padded),
            tg.row_band(tg.n_land, tg.n_padded))])),
    "cell_index_of": lambda jg, tg: (
        np.array([jg.cell_index_of(*p) for p in
                  ((-120.95, 38.41), (179.9, -10.0), (10.0, 60.0))]),
        np.array([tg.cell_index_of(*p) for p in
                  ((-120.95, 38.41), (179.9, -10.0), (10.0, 60.0))])),
    "synthetic_elevation": lambda jg, tg: (
        j_net.synthetic_elevation(j_grid.synthetic_land_mask(RES), seed=2),
        t_net.synthetic_elevation(t_grid.synthetic_land_mask(RES), seed=2)),
    "build_downstream_index": lambda jg, tg: (
        j_net.build_downstream_index(jg, seed=1),
        t_net.build_downstream_index(tg, seed=1)),
    "load_network": lambda jg, tg: (
        np.concatenate([x.reshape(-1) for x in j_net.load_network(jg, None)]),
        np.concatenate([x.reshape(-1) for x in t_net.load_network(tg, None)])),
    "flow_length_m": lambda jg, tg: (
        j_net.flow_length_m(jg, j_net.build_downstream_index(jg)),
        t_net.flow_length_m(tg, t_net.build_downstream_index(tg))),
    "direction_codes": lambda jg, tg: (
        j_net.direction_codes(jg, j_net.build_downstream_index(jg)),
        t_net.direction_codes(tg, t_net.build_downstream_index(tg))),
}


@pytest.mark.parametrize("name", sorted(HOST_CASES))
def test_host_side_arrays_equal_the_jax_packages(name):
    want, got = HOST_CASES[name](*_grids())
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want, equal_nan=True)


def test_break_cycles_equals_the_jax_packages():
    rng = np.random.RandomState(4)
    n = 200
    down = rng.randint(0, n + 1, size=n)      # random functional graph
    a, b = down.copy(), down.copy()
    assert j_net._break_cycles(a, n) == t_net._break_cycles(b, n) > 0
    assert np.array_equal(a, b)
    assert t_net._break_cycles(b, n) == 0     # now acyclic


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_load_soil_synthetic_equals_the_jax_packages(dtype):
    kw = dict(resolution_deg=RES, cell_block=256)
    jg, jp = j_soil.load_soil(JConfig(**kw), jnp.dtype(dtype))
    tg, tp = t_soil.load_soil(Config(**kw), getattr(torch, dtype), "cpu")
    assert (tg.n_land, tg.n_padded) == (jg.n_land, jg.n_padded)
    assert np.array_equal(tg.land_idx, jg.land_idx)
    want, got = tree_np(jp), tree_np(tp)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k]), k
    # A grid handed in is used as it is.
    tg2, _ = t_soil.load_soil(Config(**kw), T64, "cpu", land_grid=tg)
    assert tg2 is tg


def _kinematic(fill, n_substeps=4, dtype="float64"):
    """The synthetic network as (JAX, port) GridKinematicParams, the
    hop length scattered with ``fill`` off-land."""
    jg, tg = _grids()
    down = j_net.build_downstream_index(jg)
    jd = jnp.dtype(dtype)
    p_j = j_routing.GridKinematicParams(
        dir_code=jnp.asarray(j_net.direction_codes(jg, down)),
        flow_length=jnp.asarray(
            jg.scatter(j_net.flow_length_m(jg, down), fill=fill), jd),
        n_substeps=n_substeps)
    return jg, p_j, to_port(p_j, dtype)


def _dense_water(g, seed, negative=False):
    """[ny, nx] store and runoff (mm), zero off-land; with ``negative``
    the runoff has reclaim (negative) cells over nearly-empty rivers."""
    rng = np.random.RandomState(seed)
    store = rng.rand(g.n_padded) * (1.0e-3 if negative else 10.0)
    local = (rng.rand(g.n_padded) * 2.0e-4 - 1.0e-4 if negative
             else rng.rand(g.n_padded) * 2.0)
    return g.scatter(store, fill=0.0), g.scatter(local, fill=0.0)


@pytest.mark.parametrize("negative", [False, True],
                         ids=["runoff", "negative_runoff"])
@pytest.mark.parametrize("fill", [1.0, float("nan")],
                         ids=["fill_1", "fill_nan"])
def test_route_kinematic_day_grid_matches_jax(fill, negative):
    jg, p_j, p_t = _kinematic(fill)
    store, local = _dense_water(jg, 12, negative)
    s_j, s_t = jnp.asarray(store), torch.tensor(store)
    for day in range(3):
        s_j, d_j = j_routing.route_kinematic_day_grid(
            s_j, jnp.asarray(local), p_j)
        s_t, d_t = t_routing.route_kinematic_day_grid(
            s_t, torch.tensor(local), p_t)
        assert_close(s_t, s_j, 1e-9, 1e-12, f"store day {day}")
        assert_close(d_t, d_j, 1e-9, 1e-12, f"discharge day {day}")
    assert float(d_t.sum()) > 0.0 or negative
    assert bool(torch.isfinite(s_t).all())


def _grid_routing(dtype="float64"):
    jg, p_j, _ = _kinematic(1.0, n_substeps=8, dtype=dtype)
    flat_idx = np.full(jg.n_padded, jg.ny * jg.nx, np.int64)
    flat_idx[:jg.n_land] = jg.land_idx
    r_j = j_routing.GridRouting(
        params=p_j, flat_idx=jnp.asarray(flat_idx, jnp.int32),
        n_land=jg.n_land, ny=jg.ny, nx=jg.nx)
    return jg, r_j, to_port(r_j, dtype)


@pytest.mark.parametrize("dtype,rtol", [("float64", 1e-9), ("float32", 1e-5)])
def test_route_grid_day_matches_jax(dtype, rtol):
    """Packed in, packed out, with padding lanes that carry the
    out-of-range index: they keep their store and discharge nothing."""
    jg, r_j, r_t = _grid_routing(dtype)
    assert jg.n_padded > jg.n_land
    rng = np.random.RandomState(3)
    store = rng.rand(jg.n_padded) * 10.0       # padding lanes hold water
    local = rng.rand(jg.n_padded) * 2.0 - 0.1
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    s_j, s_t = jnp.asarray(store, jd), torch.tensor(store, dtype=td)
    for day in range(2):
        s_j, d_j = j_routing.route_grid_day(s_j, jnp.asarray(local, jd), r_j)
        s_t, d_t = t_routing.route_grid_day(
            s_t, torch.tensor(local, dtype=td), r_t)
        assert s_t.dtype == d_t.dtype == td
        assert_close(s_t, s_j, rtol, rtol * 1e-3, f"store day {day}")
        assert_close(d_t, d_j, rtol, rtol * 1e-3, f"discharge day {day}")
    pad = slice(jg.n_land, None)
    assert torch.equal(s_t[pad], torch.tensor(store, dtype=td)[pad])
    assert float(d_t[pad].abs().max()) == 0.0


def test_grid_router_tolerates_nan_fill_values():
    """Port of tests/test_routing.py::
    test_grid_routers_tolerate_nan_fill_values (kinematic case): the dense
    form multiplies by float masks, so a NaN fill value on a non-land
    cell would poison a land neighbour's inflow (0 * NaN = NaN) unless
    the off-land hop length is sanitised."""
    jg, _, p_t = _kinematic(float("nan"), dtype="float32")
    assert bool(torch.isnan(p_t.flow_length).any())
    store, local = _dense_water(jg, 12)
    s, d = t_routing.route_kinematic_day_grid(
        torch.tensor(store, dtype=torch.float32),
        torch.tensor(local, dtype=torch.float32), p_t)
    assert bool(torch.isfinite(s).all()) and bool(torch.isfinite(d).all())
    np.testing.assert_allclose(float(s.sum() + d.sum()),
                               float(store.sum() + local.sum()), rtol=1e-5)


def test_grid_router_honors_negative_runoff_reclaim():
    """Port of tests/test_routing.py::
    test_routers_honor_negative_runoff_reclaim for the dense kinematic
    router: negative local runoff debits the store and is conserved, any
    negative balance stays bounded by the cumulative reclaim, and the
    ``(s - out) + local + inflow`` order keeps ordinary stores from
    rounding below zero."""
    jg, _, r_t = _grid_routing("float32")
    n = jg.n_padded
    rng = np.random.RandomState(5)
    real = torch.arange(n) < jg.n_land
    store = torch.tensor(rng.rand(n) * 1.0e-3, dtype=torch.float32) * real
    s0 = float(store.double().sum())
    total_in = total_out = 0.0
    for day in range(15):
        local = torch.tensor(rng.rand(n) * 2.0e-4 - 1.0e-4,
                             dtype=torch.float32) * real
        store, dis = t_routing.route_grid_day(store, local, r_t)
        total_in += float(local.double().sum())
        total_out += float(dis.double().sum())
    np.testing.assert_allclose(float(store.double().sum()) - s0,
                               total_in - total_out, rtol=1e-4, atol=1e-6)
    assert float(store.min()) > -2.0e-3
    assert float(dis.min()) >= 0.0


def test_grid_router_wraps_longitude_not_latitude():
    """Water leaving through the east edge arrives on the west edge;
    nothing is carried from row 0 to row ny-1 or back, whatever the
    direction codes on those rows say."""
    ny, nx = 6, 8
    codes = torch.full((ny, nx), 8, dtype=torch.int32)
    codes[2, nx - 1] = 4          # east, across the date line
    codes[0, 3] = 6               # row 0 drains south
    codes[ny - 1, 3] = 1          # last row drains north
    p = t_routing.GridKinematicParams(
        dir_code=codes, flow_length=torch.full((ny, nx), 1.0, dtype=T64),
        n_substeps=1)             # 1 m hops: a substep moves everything
    store = torch.zeros((ny, nx), dtype=T64)
    store[2, nx - 1] = store[0, 3] = store[ny - 1, 3] = 5.0
    s, d = t_routing.route_kinematic_day_grid(store, torch.zeros_like(store),
                                              p)
    assert float(s[2, 0]) == 5.0 and float(s[2, nx - 1]) == 0.0
    assert float(s[1, 3]) == 5.0 and float(s[ny - 2, 3]) == 5.0
    assert float(s[0, 3]) == 0.0 and float(s[ny - 1, 3]) == 0.0
    assert float(s.sum() + d.sum()) == 15.0
    # The network builder never points a cell across a pole: codes on
    # row 0 have dy >= 0 and on row ny-1 dy <= 0.
    _, tg = _grids()
    real = t_net.direction_codes(tg, t_net.build_downstream_index(tg))
    dy = np.array([o[0] for o in t_routing._D8] + [0])
    assert np.all(dy[real[0][real[0] >= 0]] >= 0)
    assert np.all(dy[real[-1][real[-1] >= 0]] <= 0)


def test_stencil_is_made_once_per_network():
    _, _, p_t = _kinematic(1.0)
    assert p_t.stencil is p_t.stencil
    land, masks, landf, oceanf, length = p_t.stencil
    assert len(masks) == 8 and all(m.dtype == T64 for m in masks)
    assert torch.equal(landf, sum(masks) + oceanf)
    assert float(length[~land].min()) == 1.0 == float(length[~land].max())


def test_route_grid_day_raises_on_params_it_does_not_have():
    _, _, r_t = _grid_routing()
    bad = t_routing.GridRouting(params=object(), flat_idx=r_t.flat_idx,
                                n_land=r_t.n_land, ny=r_t.ny, nx=r_t.nx)
    z = torch.zeros(r_t.flat_idx.shape[0], dtype=T64)
    with pytest.raises(TypeError, match="no dense router for object"):
        t_routing.route_grid_day(z, z, bad)


def test_network_file_raises():
    """A network or soil file that is not there raises; reading files
    that are is in test_torch_io.py."""
    _, tg = _grids()
    with pytest.raises(FileNotFoundError):
        t_net.load_network(tg, "no_such_network.nc")
    with pytest.raises(FileNotFoundError):
        t_soil.load_soil(Config(soil_source="netcdf",
                                soil_path="no_such_soil.nc"), T64, "cpu")
