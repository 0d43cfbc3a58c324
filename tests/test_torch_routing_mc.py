"""The port's Muskingum-Cunge and packed routers, and their reach
geometry, against the JAX package.

The host-side geometry (grids/routing.py) must give exactly the JAX
package's arrays; the packed routers (``route_daily``,
``route_kinematic_day``, ``route_muskingum_day``) and the dense
Muskingum-Cunge router are held against theirs in float64 at rtol 1e-9,
and the dense forms against the packed ones as tests/test_routing.py:168,
205 do.  The reference's own regression tests come with them: NaN fill
values (:262) and negative-runoff reclaim days (:804) for the Muskingum
and packed routers, the flat reach (:521), conservation (:444), wave
attenuation (:466) and Flint's-law slopes for a network file without a
DEM (:696).  ``Simulation`` builds every router from ``Config`` and runs
five days of each against the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid9_tpu.grids import grid as j_grid
from hybrid9_tpu.grids import routing as j_net
from hybrid9_tpu.physics import routing as j_routing
from hybrid9_tpu_torch.config import Config
from hybrid9_tpu_torch.data.soil import load_soil
from hybrid9_tpu_torch.grids import grid as t_grid
from hybrid9_tpu_torch.grids import routing as t_net
from hybrid9_tpu_torch.io.netcdf import write_grid_file
from hybrid9_tpu_torch.physics import routing as t_routing
from hybrid9_tpu_torch.run import Simulation

from _torch_port import assert_close, assert_tree_close, run_both, to_port, \
    tree_np

RES = 4.0
T64 = torch.float64


def _grids():
    mask = j_grid.synthetic_land_mask(resolution_deg=RES, seed=1)
    return (j_grid.make_land_grid(mask, RES, pad_multiple=64),
            t_grid.make_land_grid(
                t_grid.synthetic_land_mask(resolution_deg=RES, seed=1), RES,
                pad_multiple=64))


GEOMETRY = {
    "cell_area_m2": lambda m, g, down: m.cell_area_m2(g),
    "reach_slope": lambda m, g, down: m.reach_slope(g, down),
    "reach_slope_elevation": lambda m, g, down: m.reach_slope(
        g, down, elevation=np.linspace(0.0, 900.0, g.ny * g.nx).reshape(
            g.ny, g.nx)),
    "flow_accumulation": lambda m, g, down: m.flow_accumulation(g, down),
    "slope_from_accumulation": lambda m, g, down: m.slope_from_accumulation(
        m.flow_accumulation(g, down)),
    "bankfull_width_m": lambda m, g, down: m.bankfull_width_m(
        m.flow_accumulation(g, down)),
}


@pytest.mark.parametrize("name", sorted(GEOMETRY))
def test_reach_geometry_equals_the_jax_packages(name):
    jg, tg = _grids()
    want = GEOMETRY[name](j_net, jg, j_net.build_downstream_index(jg))
    got = GEOMETRY[name](t_net, tg, t_net.build_downstream_index(tg))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def test_reach_geometry_is_physical():
    """Mirror of tests/test_routing.py::test_reach_geometry_builders."""
    _, grid = _grids()
    down = t_net.build_downstream_index(grid)
    n = grid.n_land
    area = t_net.cell_area_m2(grid)
    res_m = RES * 6.371e6 * np.pi / 180.0
    assert np.all(area[:n] > 0.0) and np.all(area[:n] <= res_m ** 2 * 1.001)
    slope = t_net.reach_slope(grid, down)
    assert np.all(slope >= 1e-5) and np.all(slope <= 0.1)
    acc = t_net.flow_accumulation(grid, down)
    assert np.all(acc[:n] >= area[:n] * 0.999)
    internal = down[:n] < n
    assert np.all(acc[down[:n][internal]] >= acc[:n][internal] * 0.999)
    np.testing.assert_allclose(acc[:n][~internal].sum(), area[:n].sum(),
                               rtol=1e-5)
    width = t_net.bankfull_width_m(acc)
    assert np.all(width >= 5.0) and np.all(width <= 3000.0)
    big = acc[:n] > np.median(acc[:n])
    assert width[:n][big].mean() >= width[:n][~big].mean()


def test_receiver_table_lists_each_cells_senders_in_order():
    rng = np.random.RandomState(2)
    n = 300
    down = rng.randint(0, n + 5, size=n)       # >= n: the ocean outlet
    table = t_routing.receiver_table(down)
    assert table.shape[0] == n
    for j in range(n):
        senders = np.flatnonzero(down == j)
        row = table[j]
        assert np.array_equal(row[:senders.size], senders)
        assert np.all(row[senders.size:] == n)
    # Its sums are the segment sum's.
    out = rng.rand(n)
    want = np.zeros(n + 1)
    np.add.at(want, np.minimum(down, n), out)
    got = t_routing._segment_inflow(torch.tensor(out), torch.tensor(table))
    np.testing.assert_allclose(got.numpy(), want[:n], rtol=1e-15)
    assert t_routing.receiver_table(np.full(4, 4)).shape == (4, 1)


# --- the packed routers and the dense Muskingum-Cunge router ----------------

def _packed_params(jg, n_substeps=4):
    """(JAX, port) pairs of the three packed routers on the synthetic
    network, the port's handed over as numpy."""
    down = j_net.build_downstream_index(jg)
    acc = j_net.flow_accumulation(jg, down)
    length = jnp.asarray(j_net.flow_length_m(jg, down))
    pairs = {
        "linear": j_routing.RoutingParams(
            downstream=jnp.asarray(down, jnp.int32), k=0.25),
        "kinematic": j_routing.KinematicParams(
            downstream=jnp.asarray(down, jnp.int32), flow_length=length,
            n_substeps=n_substeps),
        "muskingum": j_routing.MuskingumParams(
            downstream=jnp.asarray(down, jnp.int32), flow_length=length,
            slope=jnp.asarray(j_net.reach_slope(jg, down)),
            width=jnp.asarray(j_net.bankfull_width_m(acc)),
            cell_area=jnp.asarray(j_net.cell_area_m2(jg)),
            n_substeps=n_substeps),
    }
    return {k: (p, to_port(p)) for k, p in pairs.items()}


PACKED = {"linear": ("route_daily", "RoutingParams"),
          "kinematic": ("route_kinematic_day", "KinematicParams"),
          "muskingum": ("route_muskingum_day", "MuskingumParams")}


@pytest.mark.parametrize("negative", [False, True],
                         ids=["runoff", "negative_runoff"])
@pytest.mark.parametrize("scheme", sorted(PACKED))
def test_packed_router_matches_jax(scheme, negative):
    """Three days of the packed router in float64 at rtol 1e-9, padding
    lanes included; with ``negative`` nearly empty rivers and reclaim
    days."""
    jg, _ = _grids()
    pairs = _packed_params(jg)
    p_j, p_t = pairs[scheme]
    assert type(p_t).__name__ == PACKED[scheme][1]
    route_j = jax.jit(getattr(j_routing, PACKED[scheme][0]))
    route_t = getattr(t_routing, PACKED[scheme][0])
    rng = np.random.RandomState(12)
    n = jg.n_padded
    store = rng.rand(n) * (1.0e-3 if negative else 10.0)
    s_j, s_t = jnp.asarray(store), torch.tensor(store)
    for day in range(3):
        local = (rng.rand(n) * 2.0e-4 - 1.0e-4 if negative
                 else rng.rand(n) * 2.0)
        s_j, d_j = route_j(s_j, jnp.asarray(local), p_j)
        s_t, d_t = route_t(s_t, torch.tensor(local), p_t)
        assert_close(s_t, s_j, 1e-9, 1e-12, f"store day {day}")
        assert_close(d_t, d_j, 1e-9, 1e-12, f"discharge day {day}")
    assert float(d_t.sum()) > 0.0 or negative


def _grid_muskingum(jg, fill, n_substeps=4, dtype="float64"):
    """(JAX, port) GridMuskingumParams, the geometry scattered with
    ``fill`` off-land (the slope with 1e-3 unless ``fill`` is NaN)."""
    down = j_net.build_downstream_index(jg)
    acc = j_net.flow_accumulation(jg, down)
    jd = jnp.dtype(dtype)
    nan = np.isnan(fill)

    def dense(packed, own):
        return jnp.asarray(jg.scatter(packed, fill=np.nan if nan else own),
                           jd)

    p_j = j_routing.GridMuskingumParams(
        dir_code=jnp.asarray(j_net.direction_codes(jg, down)),
        flow_length=dense(j_net.flow_length_m(jg, down), fill),
        slope=dense(j_net.reach_slope(jg, down), 1.0e-3),
        width=dense(j_net.bankfull_width_m(acc), fill),
        cell_area=dense(j_net.cell_area_m2(jg), fill),
        n_substeps=n_substeps)
    return p_j, to_port(p_j, dtype)


def _dense_water(g, seed, negative=False):
    rng = np.random.RandomState(seed)
    store = rng.rand(g.n_padded) * (1.0e-3 if negative else 10.0)
    local = (rng.rand(g.n_padded) * 2.0e-4 - 1.0e-4 if negative
             else rng.rand(g.n_padded) * 2.0)
    return g.scatter(store, fill=0.0), g.scatter(local, fill=0.0)


@pytest.mark.parametrize("negative", [False, True],
                         ids=["runoff", "negative_runoff"])
@pytest.mark.parametrize("fill", [1.0, float("nan")],
                         ids=["fill_1", "fill_nan"])
def test_route_muskingum_day_grid_matches_jax(fill, negative):
    jg, _ = _grids()
    p_j, p_t = _grid_muskingum(jg, fill)
    assert isinstance(p_t, t_routing.GridMuskingumParams)
    store, local = _dense_water(jg, 12, negative)
    s_j, s_t = jnp.asarray(store), torch.tensor(store)
    route_j = jax.jit(j_routing.route_muskingum_day_grid)
    for day in range(3):
        s_j, d_j = route_j(s_j, jnp.asarray(local), p_j)
        s_t, d_t = t_routing.route_muskingum_day_grid(
            s_t, torch.tensor(local), p_t)
        assert_close(s_t, s_j, 1e-9, 1e-12, f"store day {day}")
        assert_close(d_t, d_j, 1e-9, 1e-12, f"discharge day {day}")
    assert bool(torch.isfinite(s_t).all()) and bool(torch.isfinite(d_t).all())


def _packed_water(g, seed):
    rng = np.random.RandomState(seed)
    store = (rng.rand(g.n_padded) * 10.0).astype(np.float32)
    local = (rng.rand(g.n_padded) * 3.0).astype(np.float32)
    store[g.n_land:] = local[g.n_land:] = 0.0
    return store, local


@pytest.mark.parametrize("scheme", ["kinematic", "muskingum"])
def test_dense_form_matches_packed(scheme):
    """Mirror of tests/test_routing.py::test_grid_kinematic_matches_packed
    and ::test_grid_muskingum_matches_packed, in the port, float32."""
    jg, grid = _grids()
    down = t_net.build_downstream_index(grid)
    f32 = torch.float32
    if scheme == "kinematic":
        length = t_net.flow_length_m(grid, down)
        packed = t_routing.KinematicParams(
            downstream=torch.tensor(down, dtype=torch.int64),
            flow_length=torch.tensor(length), n_substeps=4)
        dense = t_routing.GridKinematicParams(
            dir_code=torch.tensor(t_net.direction_codes(grid, down)),
            flow_length=torch.tensor(grid.scatter(length, fill=1.0),
                                     dtype=f32), n_substeps=4)
        route_p = t_routing.route_kinematic_day
        route_g = t_routing.route_kinematic_day_grid
    else:
        _, dense = _grid_muskingum(jg, 1.0, dtype="float32")
        packed = to_port(_packed_params(jg)["muskingum"][0], "float32")
        route_p = t_routing.route_muskingum_day
        route_g = t_routing.route_muskingum_day_grid
    store, local = _packed_water(grid, 9)
    s_p, d_p = route_p(torch.tensor(store), torch.tensor(local), packed)
    s_g, d_g = route_g(torch.tensor(grid.scatter(store, fill=0.0)),
                       torch.tensor(grid.scatter(local, fill=0.0)), dense)
    np.testing.assert_allclose(s_g.reshape(-1)[grid.land_idx].numpy(),
                               s_p[:grid.n_land].numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(d_g.sum()), float(d_p.sum()), rtol=1e-5)
    np.testing.assert_allclose(float(s_g.sum() + d_g.sum()),
                               float(store.sum() + local.sum()), rtol=1e-5)


def test_grid_muskingum_tolerates_nan_fill_values():
    """Port of tests/test_routing.py::
    test_grid_routers_tolerate_nan_fill_values, Muskingum case, float32:
    ``LandGrid.scatter``'s default fill is NaN, and the mask-multiply
    algebra must not carry it into a land neighbour."""
    jg, grid = _grids()
    _, p = _grid_muskingum(jg, float("nan"), dtype="float32")
    assert bool(torch.isnan(p.flow_length).any())
    store, local = _dense_water(grid, 12)
    s, d = t_routing.route_muskingum_day_grid(
        torch.tensor(store, dtype=torch.float32),
        torch.tensor(local, dtype=torch.float32), p)
    land = p.dir_code >= 0
    assert bool(torch.isfinite(s[land]).all())
    assert bool(torch.isfinite(d[land]).all())
    np.testing.assert_allclose(float(s[land].sum() + d[land].sum()),
                               float(store.sum() + local.sum()), rtol=1e-5)


@pytest.mark.parametrize("scheme", sorted(PACKED) + ["muskingum_grid"])
def test_routers_honor_negative_runoff_reclaim(scheme):
    """Port of tests/test_routing.py::
    test_routers_honor_negative_runoff_reclaim for the packed routers
    and the dense Muskingum-Cunge one, float32: reclaim days are
    conserved, a negative balance stays bounded by the cumulative
    reclaim, and discharge is never negative."""
    jg, grid = _grids()
    n = grid.n_padded
    rng = np.random.RandomState(5)
    if scheme == "muskingum_grid":
        flat_idx = np.full(n, grid.ny * grid.nx, np.int64)
        flat_idx[:grid.n_land] = grid.land_idx
        p = t_routing.GridRouting(
            params=_grid_muskingum(jg, 1.0, dtype="float32")[1],
            flat_idx=torch.tensor(flat_idx), n_land=grid.n_land,
            ny=grid.ny, nx=grid.nx)
        route = t_routing.route_grid_day
        real = torch.arange(n) < grid.n_land
    else:
        p = to_port(_packed_params(jg)[scheme][0], "float32")
        route = getattr(t_routing, PACKED[scheme][0])
        real = torch.ones(n, dtype=torch.bool)
    store = torch.tensor(rng.rand(n) * 1.0e-3, dtype=torch.float32) * real
    s0 = float(store.double().sum())
    total_in = total_out = 0.0
    for day in range(15):
        local = torch.tensor(rng.rand(n) * 2.0e-4 - 1.0e-4,
                             dtype=torch.float32) * real
        store, dis = route(store, local, p)
        total_in += float(local.double().sum())
        total_out += float(dis.double().sum())
    np.testing.assert_allclose(float(store.double().sum()) - s0,
                               total_in - total_out, rtol=1e-4, atol=1e-6)
    assert float(store.min()) > -2.0e-3
    assert float(dis.min()) >= 0.0


def test_muskingum_conserves_mass():
    jg, _ = _grids()
    p = to_port(_packed_params(jg, n_substeps=6)["muskingum"][0])
    n = jg.n_padded
    rng = np.random.RandomState(8)
    store = torch.tensor(rng.rand(n) * 10.0)
    s0 = float(store.sum())
    total_in = total_out = 0.0
    for day in range(20):
        local = torch.tensor(rng.rand(n) * 2.0)
        store, dis = t_routing.route_muskingum_day(store, local, p)
        total_in += float(local.sum())
        total_out += float(dis.sum())
    np.testing.assert_allclose(float(store.sum()) - s0,
                               total_in - total_out, rtol=1e-5)
    assert total_out > 0.0 and float(store.min()) >= -1e-6


def _chain(n, slope, **kw):
    return t_routing.MuskingumParams(
        downstream=torch.arange(1, n + 1),
        flow_length=torch.full((n,), kw.get("length", 20000.0), dtype=T64),
        slope=torch.full((n,), slope, dtype=T64),
        width=torch.full((n,), 50.0, dtype=T64),
        cell_area=torch.full((n,), kw.get("area", 1.0e8), dtype=T64),
        n_substeps=kw.get("n_substeps", 8))


def test_muskingum_translates_and_attenuates():
    """A flood pulse on a flat lowland chain moves downstream and
    spreads: the diffusion the kinematic wave lacks."""
    n = 32
    p = _chain(n, 1e-4)
    store = torch.zeros(n, dtype=T64)
    store[2] = 20.0
    for day in range(3):
        store, _ = t_routing.route_muskingum_day(
            store, torch.zeros(n, dtype=T64), p)
    s = store.numpy()
    np.testing.assert_allclose(s.sum(), 20.0, rtol=1e-5)
    assert int(np.argmax(s)) > 2 and s.max() < 10.0
    assert np.sum(s > 0.01 * s.max()) >= 5


def test_muskingum_zero_slope_no_nan():
    """Port of tests/test_routing.py::test_muskingum_zero_slope_no_nan: a
    flat reach with an empty store gives no NaN (the router floors the
    slope that a direct constructor leaves at 0), and with water it
    conserves."""
    p = _chain(4, 0.0, length=5.0e4, area=2.0e9, n_substeps=4)
    z = torch.zeros(4, dtype=T64)
    s, dis = t_routing.route_muskingum_day(z, z, p)
    assert bool(torch.isfinite(s).all()) and bool(torch.isfinite(dis).all())
    s, dis = t_routing.route_muskingum_day(torch.full((4,), 5.0, dtype=T64),
                                           torch.full((4,), 1.0, dtype=T64),
                                           p)
    assert bool(torch.isfinite(s).all())
    np.testing.assert_allclose(float(s.sum() + dis.sum()), 24.0, rtol=1e-5)


def test_packed_routers_add_in_a_fixed_order():
    """A packed day repeated is bit for bit the same, and the receiver
    table is made once per network."""
    jg, _ = _grids()
    pairs = _packed_params(jg)
    rng = np.random.RandomState(4)
    store = torch.tensor(rng.rand(jg.n_padded) * 10.0, dtype=torch.float32)
    local = torch.tensor(rng.rand(jg.n_padded), dtype=torch.float32)
    for scheme, (route, kind) in PACKED.items():
        p = to_port(pairs[scheme][0], "float32")
        assert p.network is p.network
        a = getattr(t_routing, route)(store, local, p)
        b = getattr(t_routing, route)(store, local, p)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), scheme


# --- the routers through Simulation -----------------------------------------

ROUTED = {
    "muskingum_grid": dict(routing_scheme="muskingum"),
    "muskingum_packed": dict(routing_scheme="muskingum",
                             routing_form="packed"),
    "kinematic_packed": dict(routing_scheme="kinematic",
                             routing_form="packed"),
    "linear": dict(routing_scheme="linear"),
}
ROUTER_TYPES = dict(muskingum_grid="GridMuskingumParams",
                    muskingum_packed="MuskingumParams",
                    kinematic_packed="KinematicParams",
                    linear="RoutingParams")


@pytest.mark.parametrize("name", sorted(ROUTED))
def test_routed_block_matches_jax_f64(name):
    """``Simulation`` builds the router ``Config`` names, with operands
    equal to the JAX package's, and five days of ``block_step`` equal
    the JAX package's at rtol 1e-9."""
    jsim, sim, (want, want_means), (got, means), _ = run_both(
        "float64", routing_substeps=4, **ROUTED[name])
    r, jr = sim.routing, jsim.routing
    if name == "muskingum_grid":
        r, jr = r.params, jr.params
    assert type(r).__name__ == type(jr).__name__ == ROUTER_TYPES[name]
    got_r, want_r = tree_np(r), tree_np(jr)
    for k in want_r:
        if k != "dense_sharding":
            np.testing.assert_array_equal(got_r[k], want_r[k], err_msg=k)
    assert means["discharge"].max() > 0.0
    assert means["max_abs_residual"].max() < 0.1
    assert_tree_close(got, want, 1e-9, 1e-9, "state")
    assert_tree_close(means, want_means, 1e-9, 1e-9, "means")


def test_flowdir_only_network_uses_flints_law(tmp_path):
    """Port of tests/test_routing.py::
    test_flowdir_only_slope_uses_flints_law: a network file with flow
    directions and no elevation gives Muskingum slopes from the drainage
    area, not from synthetic terrain."""
    cfg = Config(resolution_deg=12.0, cell_block=32,
                 routing_scheme="muskingum", routing_form="packed")
    grid, params = load_soil(cfg, T64, "cpu")
    land = np.zeros(grid.ny * grid.nx, bool)
    land[grid.land_idx] = True
    elev = t_net.synthetic_elevation(land.reshape(grid.ny, grid.nx), seed=0)
    codes = t_net.direction_codes(
        grid, t_net.build_downstream_index(grid, elevation=elev))
    esri = (32, 64, 128, 16, 1, 8, 4, 2)     # the D8 table's order
    fd = np.zeros(codes.shape)
    for k, code in enumerate(esri):
        fd[codes == k] = code
    lon, lat = t_grid.cell_centres(cfg.resolution_deg)
    path = str(tmp_path / "fd_only.nc")
    write_grid_file(path, {"flowdir": fd}, lon, lat)
    sim = Simulation(Config(**{**cfg.__dict__,
                               "routing_network_path": path}),
                     params, land_grid=grid)
    down = t_net.downstream_from_flowdir(grid, fd)
    acc = t_net.flow_accumulation(grid, down)
    got = tree_np(sim.routing.slope)
    np.testing.assert_allclose(got, t_net.slope_from_accumulation(acc),
                               rtol=1e-6)
    a, s = acc[:grid.n_land], got[:grid.n_land]
    assert s[np.argmax(a)] <= s[np.argmin(a)]
