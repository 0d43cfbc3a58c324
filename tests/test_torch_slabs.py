"""Device slabs in one process (``parallel.sharding.DeviceSlabs``).

The cells cut once into one slab a device, resident from day to day, with
the dense routers and lateral groundwater split into row bands that
exchange halo rows.  On the CPU with ``devices=["cpu"] * k``:

* the split kinematic and Muskingum-Cunge routers and the split lateral
  exchange bitwise their global functions (the routers at k in {1, 2, 3,
  4, 8} on a 2-degree grid with land on both pole rows, uneven bands
  included), with the halo rows counted;
* the split router within 1e-9 of the JAX package's ``route_grid_day``
  with a row ``dense_sharding`` on the 8-device mesh, the split exchange
  of its ``lateral_groundwater_step`` on the 2 x 4 mesh, and
  ``slab_day_step`` of its ``day_step`` under ``CellSharding.create()``;
* ten flagship days (16 substeps) through ``block_step`` on 3 slabs
  bitwise the unsharded block, and a checkpoint of 3 slabs resumed on 1
  and 2 (in a child process on ATen's scalar CPU kernels: with AVX the
  twin's last bit depends on a cell's place in its tensor);
* the comms census of a split day, ``Simulation.state`` round trips, and
  the errors of a device list that cannot hold the run.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hybrid9_tpu.data.synthetic import (synthetic_forcing_day as
                                        j_forcing_day,
                                        synthetic_soil_params as
                                        j_soil_params)
from hybrid9_tpu.grids import routing as j_net
from hybrid9_tpu.grids.grid import make_land_grid, synthetic_land_mask
from hybrid9_tpu.parallel.sharding import CellSharding as JCellSharding
from hybrid9_tpu.physics import lateral as j_lateral
from hybrid9_tpu.physics import routing as j_routing
from hybrid9_tpu.physics.hydrology import Geometry as JGeometry
from hybrid9_tpu.state import Forcing as JForcing
from hybrid9_tpu.state import SoilParams as JSoilParams
from hybrid9_tpu.state import initial_state as j_initial_state
from hybrid9_tpu.step import day_step as j_day_step
from hybrid9_tpu_torch import state as t_state
from hybrid9_tpu_torch.config import Config
from hybrid9_tpu_torch.data.soil import load_soil
from hybrid9_tpu_torch.data.synthetic import synthetic_forcing_day
from hybrid9_tpu_torch.parallel import sharding as parallel
from hybrid9_tpu_torch.parallel.sharding import DeviceSlabs
from hybrid9_tpu_torch.physics import lateral as t_lateral
from hybrid9_tpu_torch.physics import routing as t_routing
from hybrid9_tpu_torch.physics.hydrology import Geometry
from hybrid9_tpu_torch.run import Simulation
from hybrid9_tpu_torch.step import slab_day_step

from _torch_port import assert_tree_close, geom_tuples, tree_np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T64 = torch.float64
CPU = torch.device("cpu")
ROUTER_SLABS = (1, 2, 3, 4, 8)
SUBSTEPS = 4
# Hydrology substeps of the flagship days on slabs, each SDAY /
# FLAGSHIP_NISURF long: a slab's cells compute what they compute alone at
# any count; 16 keep two ZD09 refreshes a day.
FLAGSHIP_NISURF = 16
SMALL = dict(resolution_deg=12.0, cell_block=32, dtype="float64", nisurf=2,
             routing_substeps=2)


def pole_grid_routing(scheme, dtype):
    """A dense router of ``Simulation`` on the 2-degree grid (90 rows:
    bands of 22 and 23 rows at k=4) whose land reaches both pole rows,
    and a store and runoff on its packed lanes (seeded)."""
    mask = synthetic_land_mask(resolution_deg=2.0, seed=1)
    mask[0, 20:70] = True
    mask[-1, 100:140] = True
    grid = make_land_grid(mask, 2.0, pad_multiple=64)
    td = getattr(torch, dtype)
    params = t_state.SoilParams.from_numpy(
        j_soil_params(grid.n_padded, seed=0), td, CPU)
    cfg = Config(resolution_deg=2.0, dtype=dtype, routing_scheme=scheme,
                 routing_form="grid", routing_substeps=SUBSTEPS)
    routing = Simulation(cfg, params, land_grid=grid).routing
    rng = np.random.RandomState(4)
    store = torch.tensor(rng.uniform(-0.01, 60.0, grid.n_padded), dtype=td)
    rnf = torch.tensor(rng.uniform(-1.0, 6.0, grid.n_padded), dtype=td)
    return grid, routing, store, rnf


_CHILD = r"""
import json, sys, tempfile
import numpy as np
import torch
sys.path.insert(0, "tests")
import test_torch_slabs as me
from hybrid9_tpu_torch import state as t_state
from hybrid9_tpu_torch.data.synthetic import synthetic_forcing_block
from hybrid9_tpu_torch.entry import build_flagship_case
from hybrid9_tpu_torch.io.checkpoint import Checkpointer
from hybrid9_tpu_torch.parallel import sharding as parallel
from hybrid9_tpu_torch.physics.routing import route_grid_day, \
    route_grid_day_split
from hybrid9_tpu_torch.step import block_step

torch.set_num_threads(1)
out = {"capability": torch.backends.cpu.get_cpu_capability()}
for scheme in ("kinematic", "muskingum"):
    for dtype in ("float32", "float64"):
        grid, routing, store, rnf = me.pole_grid_routing(scheme, dtype)
        want = route_grid_day(store, rnf, routing)
        for k in me.ROUTER_SLABS:
            slabs = parallel.DeviceSlabs.create(store.shape[0], ["cpu"] * k)
            parallel.collectives.clear()
            got = [torch.cat(x) for x in route_grid_day_split(
                slabs.put(store), slabs.put(rnf), routing.split(slabs))]
            out[f"{scheme}-{dtype}-{k}"] = dict(
                equal=[torch.equal(g, w) for g, w in zip(got, want)],
                census=dict(parallel.collectives),
                rows=[list(r) for r in slabs.row_bands(grid.ny)])

def leaves(*trees):
    got = []
    for t in trees:
        t.map(lambda x: got.append(x) or x)
    return got

case = build_flagship_case("cpu", "float64", resolution_deg=4.0)
sim = case.sim
block = t_state.Forcing.from_numpy(
    synthetic_forcing_block(10, sim.n, seed=3, start_doy=1,
                            lat=case.land_grid.cell_lat), torch.float64, "cpu")
runs = []
for devices in (None, ["cpu"] * 3):
    acc = t_state.AnnualAccumulators.zeros(sim.n, torch.float64, "cpu")
    parallel.collectives.clear()
    runs.append(leaves(*block_step(
        sim.state, acc, block, sim.params, sim.geom,
        86400.0 / me.FLAGSHIP_NISURF, me.FLAGSHIP_NISURF,
        **dict(case.step_kwargs, devices=devices))))
out["flagship_census"] = dict(parallel.collectives)
out["flagship_leaves"] = len(runs[0])
out["flagship"] = [i for i, (a, b) in enumerate(zip(*runs))
                   if not torch.equal(a, b)]
out["flagship_moved"] = [float((runs[0][i] - b).abs().max()) for i, b in
                         enumerate(leaves(sim.state))]

# A checkpoint written on 3 slabs, resumed on 1 and 2.
from hybrid9_tpu_torch.config import Config
from hybrid9_tpu_torch.data.soil import load_soil
from hybrid9_tpu_torch.run import Simulation
cfg = Config(**me.SMALL)
grid, params = load_soil(cfg, torch.float64, "cpu")
blocks = [t_state.Forcing.from_numpy(
    synthetic_forcing_block(5, grid.n_padded, seed=5, start_doy=d,
                            lat=grid.cell_lat), torch.float64, "cpu")
    for d in (1, 6)]
with tempfile.TemporaryDirectory() as tmp:
    three = Simulation(cfg, params, land_grid=grid, devices=["cpu"] * 3)
    three.advance(blocks[0], three.accumulators())
    Checkpointer(tmp).save(1901, three.state)
    three.advance(blocks[1], three.accumulators())
    want = leaves(three.state)
    for k in (1, 2):
        template = Simulation(cfg, params, land_grid=grid).state
        _, state = Checkpointer(tmp).restore(template)
        sim_k = Simulation(cfg, params, state=state, land_grid=grid,
                           devices=["cpu"] * k)
        sim_k.advance(blocks[1], sim_k.accumulators())
        out[f"resume-{k}"] = [i for i, (a, b) in enumerate(
            zip(leaves(sim_k.state), want)) if not torch.equal(a, b)]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def scalar_kernel_run():
    """The bitwise comparisons, in a child process on ATen's scalar CPU
    kernels."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["ATEN_CPU_CAPABILITY"] = "default"
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["capability"] in ("DEFAULT", "NO AVX"), res["capability"]
    return res


@pytest.mark.parametrize("k", ROUTER_SLABS)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("scheme", ["kinematic", "muskingum"])
def test_split_router_is_bitwise_the_global_router(scalar_kernel_run,
                                                   scheme, dtype, k):
    """Store and discharge of every lane, those on the pole rows too;
    ``2 (k - 1)`` halo rows an inflow pass (one pass a substep for the
    kinematic wave, two for Muskingum-Cunge) and one reshard each way."""
    run = scalar_kernel_run[f"{scheme}-{dtype}-{k}"]
    assert run["equal"] == [True, True]
    passes = SUBSTEPS * (1 if scheme == "kinematic" else 2)
    want = {"reshard": 2}
    if k > 1:
        want["halo"] = 2 * (k - 1) * passes
    assert run["census"] == want
    sizes = {r1 - r0 for r0, r1 in run["rows"]}
    assert run["rows"][0][0] == 0 and run["rows"][-1][1] == 90
    if k == 4:
        assert sizes == {22, 23}


def test_pole_rows_carry_land_and_water():
    grid, routing, store, rnf = pole_grid_routing("kinematic", "float64")
    rows = grid.land_idx // grid.nx
    assert (rows == 0).any() and (rows == grid.ny - 1).any()
    new, discharge = t_routing.route_grid_day(store, rnf, routing)
    pole = np.flatnonzero((rows == 0) | (rows == grid.ny - 1))
    assert not torch.equal(new[pole], store[pole])


def test_resident_flagship_block_is_bitwise_the_unsharded_block(
        scalar_kernel_run):
    """Ten flagship days (snow, soil ice, carbon, dense kinematic
    routing; 16 substeps) at 4 degrees through ``block_step(devices=[cpu]
    * 3)``: every state field and annual sum bitwise; a router census of
    two reshards and ``2 (k - 1)`` halo rows a substep a day, and two
    state exchanges (the gathers at the block's end)."""
    run = scalar_kernel_run
    assert run["flagship_leaves"] > 40
    assert run["flagship"] == []
    assert max(run["flagship_moved"]) > 0.0
    assert run["flagship_census"] == {"reshard": 20, "halo": 320,
                                      "state": 2}


@pytest.mark.parametrize("k", [1, 2])
def test_checkpoint_of_three_slabs_resumes_on_fewer(scalar_kernel_run, k):
    assert scalar_kernel_run[f"resume-{k}"] == []


# --- against the JAX package's sharded functions ------------------------

@pytest.fixture(scope="module")
def mesh_grid():
    """The 1.5-degree grid of test_no_accidental_comms.py (120 rows: the
    8-device mesh splits them) and its network, as numpy."""
    mask = synthetic_land_mask(resolution_deg=1.5, seed=1)
    grid = make_land_grid(mask, 1.5, pad_multiple=64)
    down = j_net.build_downstream_index(grid)
    acc = j_net.flow_accumulation(grid, down)
    fields = dict(
        codes=j_net.direction_codes(grid, down),
        length=grid.scatter(j_net.flow_length_m(grid, down), fill=1.0),
        slope=grid.scatter(j_net.reach_slope(grid, down), fill=1.0e-3),
        width=grid.scatter(j_net.bankfull_width_m(acc), fill=1.0),
        area=grid.scatter(j_net.cell_area_m2(grid), fill=1.0))
    return grid, fields


@pytest.mark.parametrize("scheme", ["kinematic", "muskingum"])
def test_split_router_matches_jax_row_sharded(mesh_grid, scheme):
    grid, f = mesh_grid
    n = grid.n_padded
    cs = JCellSharding.create()
    assert cs.n_devices == 8 and grid.ny % 8 == 0
    dense_sh = NamedSharding(cs.mesh, P(cs.axis, None))

    def jdense(a, dtype=jnp.float64):
        return jax.device_put(jnp.asarray(a, dtype), dense_sh)

    def tdense(a, dtype=T64):
        return torch.tensor(np.asarray(a), dtype=dtype)

    if scheme == "kinematic":
        jp = j_routing.GridKinematicParams(
            dir_code=jdense(f["codes"], jnp.int32),
            flow_length=jdense(f["length"]), n_substeps=SUBSTEPS)
        tp = t_routing.GridKinematicParams(
            dir_code=tdense(f["codes"], torch.int32),
            flow_length=tdense(f["length"]), n_substeps=SUBSTEPS)
    else:
        jp = j_routing.GridMuskingumParams(
            dir_code=jdense(f["codes"], jnp.int32),
            flow_length=jdense(f["length"]), slope=jdense(f["slope"]),
            width=jdense(f["width"]), cell_area=jdense(f["area"]),
            n_substeps=SUBSTEPS)
        tp = t_routing.GridMuskingumParams(
            dir_code=tdense(f["codes"], torch.int32),
            flow_length=tdense(f["length"]), slope=tdense(f["slope"]),
            width=tdense(f["width"]), cell_area=tdense(f["area"]),
            n_substeps=SUBSTEPS)
    flat_idx = np.full(n, grid.ny * grid.nx, np.int64)
    flat_idx[:grid.n_land] = grid.land_idx
    jr = j_routing.GridRouting(
        params=jp, flat_idx=cs.put(jnp.asarray(flat_idx, jnp.int32)),
        n_land=grid.n_land, ny=grid.ny, nx=grid.nx, dense_sharding=dense_sh)
    tr = t_routing.GridRouting(params=tp, flat_idx=torch.tensor(flat_idx),
                               n_land=grid.n_land, ny=grid.ny, nx=grid.nx)
    rng = np.random.RandomState(11)
    store = rng.uniform(0.0, 60.0, n)
    rnf = rng.uniform(-0.5, 6.0, n)
    want = jax.jit(j_routing.route_grid_day)(
        cs.put(jnp.asarray(store)), cs.put(jnp.asarray(rnf)), jr)
    slabs = DeviceSlabs.create(n, ["cpu"] * 8)
    got = t_routing.route_grid_day_split(
        slabs.put(torch.tensor(store)), slabs.put(torch.tensor(rnf)),
        tr.split(slabs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(torch.cat(g).numpy(), np.asarray(w),
                                   rtol=1e-9, atol=1e-12)
    assert np.asarray(want[1]).sum() > 0.0


@pytest.fixture(scope="module")
def lateral_case():
    """test_lateral.py's 6-degree case (30 x 60 rows, k_lat 5e-4) in
    float64: the JAX params and the port's built from the same arrays."""
    mask = synthetic_land_mask(resolution_deg=6.0, seed=3)
    grid = make_land_grid(mask, 6.0, pad_multiple=64)
    jp = j_lateral.make_lateral_params(grid, k_lat=5.0e-4)
    tp = t_lateral.LateralParams(
        land_flat_idx=torch.tensor(np.asarray(jp.land_flat_idx),
                                   dtype=torch.int64),
        land_mask=torch.tensor(np.asarray(jp.land_mask)),
        z_surf=torch.tensor(np.asarray(jp.z_surf)), k_lat=jp.k_lat,
        n_padded=jp.n_padded)
    rng = np.random.RandomState(0)
    wa = rng.uniform(1000.0, 5000.0, grid.n_padded)
    zwt = rng.uniform(0.5, 10.0, grid.n_padded)
    wa[3] = 0.5                  # a nearly empty aquifer under high head
    zwt[3] = 0.01
    return grid, jp, tp, wa, zwt


@pytest.mark.parametrize("k", [2, 3, 4, 8])
def test_split_lateral_is_bitwise_the_global_step(lateral_case, k):
    """Bitwise on ATen's vector kernels too (the exchange has no
    transcendental), with ``4 (k - 1)`` halo rows and two reshards."""
    grid, _, tp, wa, zwt = lateral_case
    wa, zwt = torch.tensor(wa), torch.tensor(zwt)
    want = t_lateral.lateral_groundwater_step(wa, zwt, tp)
    slabs = DeviceSlabs.create(grid.n_padded, ["cpu"] * k)
    parallel.collectives.clear()
    got = t_lateral.lateral_groundwater_step_split(
        slabs.put(wa), slabs.put(zwt), tp.split(slabs))
    assert dict(parallel.collectives) == {"reshard": 2, "halo": 4 * (k - 1)}
    for g, w in zip(got, want):
        assert torch.equal(torch.cat(g), w)
    assert want[1].abs().max() > 1.0


def test_split_lateral_matches_jax_on_the_2x4_mesh(lateral_case):
    grid, jp, tp, wa, zwt = lateral_case
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4),
                ("laty", "lonx"))
    grid_sh = NamedSharding(mesh, P("laty", "lonx"))
    jp = j_lateral.LateralParams(
        land_flat_idx=jp.land_flat_idx,
        land_mask=jax.device_put(jp.land_mask, grid_sh),
        z_surf=jax.device_put(jp.z_surf, grid_sh), k_lat=jp.k_lat,
        n_padded=jp.n_padded)
    want = jax.jit(j_lateral.lateral_groundwater_step)(
        jnp.asarray(wa), jnp.asarray(zwt), jp)
    slabs = DeviceSlabs.create(grid.n_padded, ["cpu"] * 8)
    got = t_lateral.lateral_groundwater_step_split(
        slabs.put(torch.tensor(wa)), slabs.put(torch.tensor(zwt)),
        tp.split(slabs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(torch.cat(g).numpy(), np.asarray(w),
                                   rtol=1e-9, atol=1e-9)


def test_slab_day_matches_jax_day_under_cell_sharding(layer_grid):
    """test_sharding.py's day under ``CellSharding.create()`` (8 x 16
    cells, day 180, 48 substeps) in float64 against ``slab_day_step``
    over eight CPU slabs, at rtol 1e-9."""
    n = 8 * 16
    raw = j_soil_params(n, seed=0)
    day = j_forcing_day(n, 180, seed=2)
    jparams = JSoilParams(**{k: jnp.asarray(v, jnp.float64)
                             for k, v in raw.items()})
    jstate = j_initial_state(jparams, layer_grid.dz, layer_grid.zi,
                             jnp.float64)
    cs = JCellSharding.create()
    jgeom = JGeometry.from_layer_grid(layer_grid, jnp.float64)
    params_sh = cs.put(jparams)
    want_state, want = jax.jit(lambda s, f: j_day_step(
        s, f, params_sh, jgeom, 1800.0, 48))(
        cs.put(jstate), cs.put(JForcing(**{k: jnp.asarray(v, jnp.float64)
                                           for k, v in day.items()})))
    params = t_state.SoilParams.from_numpy(raw, T64, CPU)
    state = t_state.ModelState.from_numpy(tree_np(jstate), T64, CPU)
    forcing = t_state.Forcing.from_numpy(day, T64, CPU)
    slabs = DeviceSlabs.create(n, ["cpu"] * 8)
    parallel.collectives.clear()
    states, diags = slab_day_step(
        slabs, slabs.put(state), slabs.put(forcing), slabs.put(params),
        Geometry(*geom_tuples(layer_grid)), 1800.0, 48)
    assert dict(parallel.collectives) == {}
    got_state = slabs.gather(states, "state")
    got = slabs.gather(diags, "state")
    assert_tree_close(tree_np(got_state), tree_np(want_state), 1e-9, 1e-9,
                      "state")
    for key in ("evap_day", "rnf_day", "npp", "discharge"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-9, atol=1e-12, err_msg=key)


# --- the resident Simulation ---------------------------------------------

@pytest.fixture(scope="module")
def small_grid():
    return load_soil(Config(**SMALL), T64, CPU)


@pytest.mark.parametrize("switches,want", [
    ({}, {"reshard": 2, "halo": 8}),
    ({"routing_scheme": "muskingum"}, {"reshard": 2, "halo": 16}),
    ({"lateral_groundwater": True}, {"reshard": 4, "halo": 16}),
    ({"routing_form": "packed"}, {"gather": 1}),
    ({"lateral_routing": False}, {}),
], ids=["config", "muskingum", "lateral", "packed", "no-routing"])
def test_the_census_of_a_split_day(small_grid, switches, want):
    """One ``Config()`` day on three slabs exchanges only the halo rows
    (``2 (k - 1)`` an inflow pass) and the two reshards of the dense
    router, four more halo rows a band edge and two reshards for lateral
    groundwater, one gather for a packed router, and nothing for the
    cell-local modules."""
    grid, params = small_grid
    sim = Simulation(Config(**SMALL, **switches), params, land_grid=grid,
                     devices=["cpu"] * 3)
    day = synthetic_forcing_day(grid.n_padded, 20, seed=1,
                                lat=grid.cell_lat)
    block = t_state.Forcing.from_numpy({k: v[None] for k, v in day.items()},
                                       T64, CPU)
    parts = sim.slabs.put_block(block)
    parallel.collectives.clear()
    sim.advance(parts, sim.accumulators())
    assert dict(parallel.collectives) == want


def test_state_round_trips_and_stays_on_the_slabs(small_grid):
    grid, params = small_grid
    sim = Simulation(Config(**SMALL), params, land_grid=grid,
                     devices=["cpu"] * 3)
    assert [s.soil.zwt.shape[0] for s in sim._state] == [
        hi - lo for lo, hi in sim.slabs.bounds]
    rng = np.random.RandomState(2)
    state = sim.state.map(
        lambda x: x + torch.tensor(rng.uniform(0.0, 1.0, x.shape)))
    sim.state = state
    back = sim.state
    leaves = [[], []]
    state.map(lambda x: leaves[0].append(x) or x)
    back.map(lambda x: leaves[1].append(x) or x)
    assert all(torch.equal(a, b) for a, b in zip(*leaves))
    block = sim.forcing_block(
        lambda y, d, m: t_state.Forcing.from_numpy(
            {k: np.broadcast_to(v, (m, grid.n_padded)).copy() for k, v in
             synthetic_forcing_day(grid.n_padded, d, seed=1).items()},
            T64, CPU), 1901, 1, 2)
    sim.advance(block, sim.accumulators())
    assert len(sim._state) == 3


def test_a_device_list_that_cannot_hold_the_run_raises(small_grid):
    grid, params = small_grid
    with pytest.raises(ValueError, match="one type"):
        DeviceSlabs.create(10, ["cpu", torch.device("cuda", 0)])
    with pytest.raises(ValueError, match="cannot cut 15 grid rows"):
        DeviceSlabs.create(grid.n_padded, ["cpu"] * 16).row_bands(15)
    with pytest.raises(ValueError, match="cannot cut"):
        DeviceSlabs.create(2, ["cpu"] * 3)
    with pytest.raises(ValueError, match="cannot be cut over"):
        Simulation(Config(**SMALL), params, land_grid=grid,
                   devices=[torch.device("meta")] * 2)
