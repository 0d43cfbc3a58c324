"""The port's multi-process layer in one process (``parallel/``).

``host_shard_bounds`` against the JAX package's, ``CellSharding``'s slabs,
and the exchange the physics uses (gather -> global -> slice) over 2 and
4 ranks simulated by threads of this process (``torch.distributed``'s
``all_gather`` and ``all_reduce`` answered by a barrier among the
threads): every router form and lateral groundwater bitwise the global
function on each slab; the comms audit of a sharded ``Config()`` day
(the port's analog of ``test_no_accidental_comms.py``); the spin-up's
global convergence measure; one rank's checkpoint, part files and device
forcing; and the build lock of ``kernels.py`` with a stand-in compiler.
Real processes: ``tests/test_torch_multiprocess.py``.
"""

import concurrent.futures
import dataclasses
import os
import sys
import threading

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from hybrid9_tpu.parallel import launch as j_launch
from hybrid9_tpu_torch import kernels, step
from hybrid9_tpu_torch.config import Config
from hybrid9_tpu_torch.data.device_forcing import \
    DeviceSyntheticForcingProvider
from hybrid9_tpu_torch.data.soil import load_soil
from hybrid9_tpu_torch.data.synthetic import synthetic_forcing_day
from hybrid9_tpu_torch.io.checkpoint import Checkpointer
from hybrid9_tpu_torch.io.writer import AnnualWriter, ShardedAnnualWriter
from hybrid9_tpu_torch.parallel import launch, sharding as parallel
from hybrid9_tpu_torch.parallel.sharding import CellSharding, Gathered
from hybrid9_tpu_torch.physics.lateral import (lateral_groundwater_step,
                                               make_lateral_params)
from hybrid9_tpu_torch.run import Simulation
from hybrid9_tpu_torch.spinup import _max_abs, _means
from hybrid9_tpu_torch.state import Forcing, initial_state

from _torch_port import tree_np

T64 = torch.float64
CPU = torch.device("cpu")
GRID_KW = dict(resolution_deg=12.0, cell_block=32, dtype="float64",
               nisurf=2, routing_substeps=2)


class Threads:
    """``k`` ranks as threads of this process: each collective of
    ``torch.distributed`` meets at a barrier and answers from every
    thread's contribution, in rank order.  A rank that raises breaks the
    barrier, so its peers raise too instead of waiting; no wait lasts
    longer than ``TIMEOUT_S``."""

    TIMEOUT_S = 120.0

    def __init__(self, k: int):
        self.k = k
        self.barrier = threading.Barrier(k, timeout=self.TIMEOUT_S)
        self.slots = [None] * k
        self.local = threading.local()
        self.calls = []

    def _meet(self, x):
        r = self.local.rank
        self.slots[r] = x.clone()
        self.barrier.wait()
        got = list(self.slots)
        self.barrier.wait()
        return got

    def all_gather(self, parts, x):
        self.calls.append("all_gather")
        for p, v in zip(parts, self._meet(x)):
            p.copy_(v)

    def all_reduce(self, x, op=dist.ReduceOp.SUM):
        self.calls.append("all_reduce")
        got = torch.stack(self._meet(x))
        x.copy_(got.sum(0) if op == dist.ReduceOp.SUM else got.amax(0))

    def run(self, fn):
        """``[fn(0), ..., fn(k - 1)]``, each in its own thread."""
        def body(r):
            self.local.rank = r
            try:
                return fn(r)
            except BaseException:
                self.barrier.abort()
                raise
        with concurrent.futures.ThreadPoolExecutor(self.k) as pool:
            futures = [pool.submit(body, r) for r in range(self.k)]
            return [f.result(timeout=self.TIMEOUT_S) for f in futures]


@pytest.fixture
def threads(monkeypatch):
    """A factory of simulated groups; any other collective raises."""
    def make(k):
        group = Threads(k)
        monkeypatch.setattr(dist, "all_gather", group.all_gather)
        monkeypatch.setattr(dist, "all_reduce", group.all_reduce)
        return group

    def refuse(*args, **kwargs):
        raise AssertionError("an unexpected collective")

    for name in ("broadcast", "barrier", "reduce_scatter", "all_to_all"):
        monkeypatch.setattr(dist, name, refuse)
    return make


def slabs(n: int, k: int):
    """The ``CellSharding`` of each of ``k`` ranks over ``n`` cells."""
    per = n // k
    return [CellSharding(lo=r * per, hi=(r + 1) * per, n=n, devices=(CPU,),
                         rank=r, world=k) for r in range(k)]


@pytest.fixture(scope="module")
def grid_params():
    return load_soil(Config(**GRID_KW), T64, "cpu")


# --- launch ------------------------------------------------------------------

def test_host_shard_bounds_is_jaxs(monkeypatch):
    """The indivisible count fails with JAX's message (its
    ``test_multiprocess.py:225-237`` case), and the slabs are JAX's."""
    for module in (launch, jax):
        monkeypatch.setattr(module, "process_count", lambda: 3)
        monkeypatch.setattr(module, "process_index", lambda: 1)
    messages = []
    for fn in (launch.host_shard_bounds, j_launch.host_shard_bounds):
        with pytest.raises(ValueError, match="multiple of 3") as err:
            fn(64)
        messages.append(str(err.value))
        assert fn(96) == (32, 64)
    assert messages[0] == messages[1]


def test_one_process_needs_no_group(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    launch.initialize_distributed()
    assert not dist.is_initialized()
    assert (launch.process_count(), launch.process_index()) == (1, 0)
    sh = CellSharding.create(64, "cpu")
    assert (sh.lo, sh.hi, sh.n, sh.devices, sh.world) == (0, 64, 64, (CPU,),
                                                          1)


# --- CellSharding ------------------------------------------------------------

def test_put_cuts_the_slab_and_passes_slabs_through(grid_params):
    grid, params = grid_params
    n = params.n_cells
    one = CellSharding.create(n, "cpu")
    assert one.put(params) is not params
    assert all(torch.equal(a, b) for a, b in zip(
        _leaves(one.put(params)), _leaves(params)))
    rank1 = slabs(n, 2)[1]
    mine = rank1.put(params)
    assert mine.n_cells == n // 2
    assert torch.equal(mine.psi_s, params.psi_s[n // 2:])
    assert rank1.put(mine).psi_s.data_ptr() == mine.psi_s.data_ptr()
    block = torch.arange(3 * n, dtype=T64).reshape(3, n)
    assert torch.equal(rank1.put_block(block), block[:, n // 2:])
    assert rank1.put_block(block).is_contiguous()
    assert np.array_equal(rank1.host_local(mine.fmax),
                          tree_np(params.fmax)[n // 2:])
    with pytest.raises(ValueError, match="neither"):
        rank1.put(torch.zeros(n + 1))
    with pytest.raises(ValueError, match="not divisible by process count"):
        slabs(96, 3)[0].check_divisible(100)


def _leaves(tree):
    return [getattr(tree, f.name) for f in dataclasses.fields(tree)]


# --- gather -> global -> slice ---------------------------------------------

ROUTERS = {
    "dense-kinematic": dict(routing_scheme="kinematic", routing_form="grid"),
    "dense-muskingum": dict(routing_scheme="muskingum", routing_form="grid"),
    "packed-kinematic": dict(routing_scheme="kinematic",
                             routing_form="packed"),
    "packed-muskingum": dict(routing_scheme="muskingum",
                             routing_form="packed"),
    "packed-linear": dict(routing_scheme="linear", routing_form="packed"),
}


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("form", list(ROUTERS))
def test_router_on_slabs_is_bitwise_the_global_router(grid_params, threads,
                                                      form, k):
    grid, params = grid_params
    n = params.n_cells
    routing = Simulation(Config(**GRID_KW, **ROUTERS[form]), params,
                         land_grid=grid).routing
    rng = np.random.RandomState(k)
    store = torch.tensor(rng.uniform(0.0, 50.0, n), dtype=T64)
    rnf = torch.tensor(rng.uniform(-1.0, 5.0, n), dtype=T64)
    want_store, want = step._route(store, {"rnf_day": rnf}, routing)
    group = threads(k)
    got = group.run(lambda r: step._route(
        store[slabs(n, k)[r].lo:slabs(n, k)[r].hi],
        {"rnf_day": rnf[slabs(n, k)[r].lo:slabs(n, k)[r].hi]},
        Gathered(routing, slabs(n, k)[r])))
    assert group.calls == ["all_gather"] * k
    assert torch.equal(torch.cat([g[0] for g in got]), want_store)
    assert torch.equal(torch.cat([g[1]["discharge"] for g in got]),
                       want["discharge"])
    assert want["discharge"].abs().sum() > 0


@pytest.mark.parametrize("k", [2, 4])
def test_lateral_on_slabs_is_bitwise_the_global_exchange(grid_params,
                                                         threads, k):
    grid, params = grid_params
    n = params.n_cells
    lateral = make_lateral_params(grid, CPU)
    soil = initial_state(params, *_layers(), T64, "cpu").soil
    rng = np.random.RandomState(k)
    soil = soil.replace(
        wa=torch.tensor(rng.uniform(0.0, 5000.0, n), dtype=T64),
        zwt=torch.tensor(rng.uniform(0.1, 12.0, n), dtype=T64))
    want, _ = lateral_groundwater_step(soil.wa, soil.zwt, lateral)
    group = threads(k)
    got = group.run(lambda r: step._lateral(
        slabs(n, k)[r].put(soil), Gathered(lateral, slabs(n, k)[r])).wa)
    assert torch.equal(torch.cat(got), want)
    assert not torch.equal(want, soil.wa)


def _layers():
    lg = Config(**GRID_KW).layer_grid()
    return lg.dz, lg.zi


@pytest.mark.parametrize("switches,want", [
    ({}, {"routing": 1}),
    ({"lateral_groundwater": True}, {"routing": 1, "lateral": 1}),
    ({"lateral_routing": False}, {}),
], ids=["config", "lateral", "no-routing"])
def test_a_sharded_day_issues_only_the_routers_gather(grid_params, threads,
                                                      switches, want):
    """The comms audit: a ``Config()`` day on a rank's slab makes one
    exchange, the router's gather (and lateral groundwater's when it is
    on), and no other collective."""
    grid, params = grid_params
    n = params.n_cells
    cfg = Config(**GRID_KW, **switches)
    sims = [Simulation(cfg, params, land_grid=grid, sharding=sh)
            for sh in slabs(n, 2)]
    forcing = Forcing.from_numpy(synthetic_forcing_day(n, 20, seed=1,
                                                       lat=grid.cell_lat),
                                 T64, "cpu")
    parallel.collectives.clear()
    group = threads(2)
    group.run(lambda r: step.day_step(
        sims[r].state, sims[r].sharding.put(forcing), sims[r].params,
        sims[r].geom, cfg.dt, cfg.nisurf, **sims[r].step_kwargs()))
    assert dict(parallel.collectives) == {k: 2 * v for k, v in want.items()}
    assert group.calls == ["all_gather"] * (2 * sum(want.values()))


def test_a_rank_of_two_devices_cuts_its_slab_and_gathers(grid_params,
                                                        threads):
    """A rank that holds two devices cuts its slab into device slabs, and
    its router keeps the ranks' gather: each day the rank's slabs are
    gathered onto its first device (one "gather") and then over the ranks
    (one "routing"); the two ranks' days are one process's day."""
    grid, params = grid_params
    n = params.n_cells
    cfg = Config(**GRID_KW)
    day = synthetic_forcing_day(n, 20, seed=1, lat=grid.cell_lat)
    block = Forcing.from_numpy({k: v[None] for k, v in day.items()}, T64,
                               "cpu")
    one = Simulation(cfg, params, land_grid=grid)
    one.advance(block, one.accumulators())
    sims = [Simulation(cfg, params, land_grid=grid, sharding=dataclasses.
                       replace(sh, devices=(CPU, CPU)))
            for sh in slabs(n, 2)]
    assert all(s.slabs.k == 2 for s in sims)
    parallel.collectives.clear()
    group = threads(2)
    group.run(lambda r: sims[r].advance(sims[r].sharding.put_block(block),
                                        sims[r].accumulators()))
    assert dict(parallel.collectives) == {"gather": 2, "routing": 2}
    assert group.calls == ["all_gather"] * 2
    got = torch.cat([s.state.soil.h2osoi_liq for s in sims])
    torch.testing.assert_close(got, one.state.soil.h2osoi_liq, rtol=1e-12,
                               atol=1e-12)
    store = torch.cat([s.state.river_store for s in sims])
    torch.testing.assert_close(store, one.state.river_store, rtol=1e-12,
                               atol=1e-12)
    assert store.abs().sum() > 0.0


def test_spinup_convergence_is_global(grid_params, threads):
    """Every rank takes the maximum drift and the means over every rank's
    land cells: the values one process computes (means at 1e-12), the
    same on both ranks, so both stop after the same rehearsal year."""
    grid, params = grid_params
    n, n_land = params.n_cells, grid.n_land
    rng = np.random.RandomState(5)
    drift = rng.normal(0.0, 3.0, n_land)
    rows = rng.normal(100.0, 40.0, (3, n_land))
    one = Simulation(Config(**GRID_KW), params, land_grid=grid)
    want = (_max_abs(one, drift), _means(one, rows))
    sims = [Simulation(Config(**GRID_KW), params, land_grid=grid,
                       sharding=sh) for sh in slabs(n, 2)]

    def rank(r):
        lo = sims[r].host_lo
        land = slice(lo, lo + sims[r]._local_land_count())
        return _max_abs(sims[r], drift[land]), _means(sims[r], rows[:, land])

    got = threads(2).run(rank)
    assert got[0] == got[1]
    assert got[0][0] == want[0]
    np.testing.assert_allclose(got[0][1], want[1], rtol=1e-12)


# --- one rank's files -------------------------------------------------------

def test_each_rank_restores_its_own_slab(grid_params, tmp_path):
    grid, params = grid_params
    n = params.n_cells
    dz, zi = _layers()
    state = initial_state(params, dz, zi, T64, "cpu")
    state = state.replace(swe=torch.linspace(0.0, 9.0, n, dtype=T64))
    path = str(tmp_path / "ck")
    for sh in slabs(n, 2):
        Checkpointer(path, sharding=sh).save(1901, sh.put(state))
    assert sorted(os.listdir(path)) == ["year_1901.rank0of2.pt",
                                        "year_1901.rank1of2.pt"]
    for sh in slabs(n, 2):
        year, got = Checkpointer(path, sharding=sh).restore(
            initial_state(sh.put(params), dz, zi, T64, "cpu"))
        assert year == 1901 and torch.equal(got.swe, sh.local(state.swe))
    template = initial_state(params, dz, zi, T64, "cpu")
    with pytest.raises(ValueError, match="written by 2 rank.*this run has 1"):
        Checkpointer(path).restore(template)
    with pytest.raises(ValueError, match="written by 2 rank.*this run has 4"):
        Checkpointer(path, sharding=slabs(n, 4)[0]).restore(template)


def test_part_files_stitch_to_the_single_writers_file(grid_params, tmp_path):
    grid, params = grid_params
    n = params.n_cells
    rng = np.random.RandomState(2)
    means = {"evap": rng.rand(n), "theta": rng.rand(n, 8)}
    single = AnnualWriter(str(tmp_path / "one"), grid).write_annual(1901,
                                                                    means)
    out = str(tmp_path / "two")
    writers = [ShardedAnnualWriter(out, grid, sh.lo, sh.hi, sh.rank, 2)
               for sh in slabs(n, 2)]
    for sh, w in reversed(list(zip(slabs(n, 2), writers))):
        path = w.write_annual(1901, {k: v[sh.lo:sh.hi]
                                     for k, v in means.items()})
    assert sorted(os.listdir(out)) == ["axy1901.nc"]
    with open(single, "rb") as a, open(path, "rb") as b:
        assert a.read() == b.read()


def test_device_forcing_slab_is_the_global_blocks(grid_params):
    grid, _ = grid_params
    n = grid.n_padded
    whole = DeviceSyntheticForcingProvider(n, seed=3, lat=grid.cell_lat,
                                           dtype=T64, device="cpu")(1901, 1, 4)
    for sh in slabs(n, 4):
        part = DeviceSyntheticForcingProvider(
            n, seed=3, lat=grid.cell_lat, dtype=T64, sharding=sh)(1901, 1, 4)
        for a, b in zip(_leaves(part), _leaves(whole)):
            assert a.shape == (4, n // 4) and torch.equal(a, b[:, sh.lo:sh.hi])


# --- the build lock ---------------------------------------------------------

def test_ranks_that_start_together_build_once(monkeypatch, tmp_path):
    """Three builds of one library at once: the stand-in compiler runs
    one build's worth (a compile of the one unit, then the link, marked
    c and l), and every caller gets its library."""
    count = tmp_path / "count"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        f"open({str(count)!r}, 'a').write("
        "'c' if '-c' in sys.argv else 'l')\n"
        "time.sleep(0.5)\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'wb').write(b'lib')\n")
    nvcc.chmod(0o755)
    src = tmp_path / "k.cu"
    src.write_text("// a kernel\n")
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(kernels, "_BUILD_DIR", tmp_path / "_build")
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        libs = list(pool.map(lambda _: kernels.build("k", [src]), range(3)))
    assert count.read_text() == "cl"
    assert len(set(libs)) == 1 and libs[0].read_bytes() == b"lib"
    assert kernels.build("k", [src]) == libs[0] and count.read_text() == "cl"


# --- the command line --------------------------------------------------------

def test_a_multi_process_launch_needs_shard(monkeypatch, grid_params):
    """Without ``--shard`` every process would redo the whole problem:
    ``run`` and the closed-loop commands refuse, with the JAX package's
    messages."""
    from hybrid9_tpu_torch import cli
    grid, _ = grid_params
    monkeypatch.setattr(launch, "process_count", lambda: 2)
    with pytest.raises(SystemExit, match="multi-host runs require --shard"):
        cli._sharding(False, grid.n_padded, CPU)
    with pytest.raises(SystemExit, match="single-process drivers"):
        cli._single_host_provider(Config(**GRID_KW), grid, T64, CPU)
