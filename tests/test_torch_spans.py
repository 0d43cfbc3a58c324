"""The port's span recorder (``utils/profiling``) on the CPU: off, the
day and the closed loops read no clock; on, their outputs are bitwise
those of a run with it off, and they record each part of the day, the
folded day, the assimilation cycle and the analysis under the right
parents; the garbage collector's collections are spans while it is on;
the ``--spans`` exporter writes a Chrome trace.  Four cells and the plain
day at 2 substeps: the recorder does not depend on the width."""

import gc
import json
import sys
import threading
import time

import pytest
import torch

from hybrid9_tpu_torch import cli
from hybrid9_tpu_torch.assimilate import assimilate
from hybrid9_tpu_torch.config import LayerGrid
from hybrid9_tpu_torch.data.synthetic import (synthetic_forcing_block,
                                              synthetic_soil_params)
from hybrid9_tpu_torch.ensemble import run_ensemble_annual
from hybrid9_tpu_torch.parallel.sharding import DeviceSlabs
from hybrid9_tpu_torch.physics.hydrology import Geometry
from hybrid9_tpu_torch.physics.lateral import LateralParams
from hybrid9_tpu_torch.physics.routing import RoutingParams
from hybrid9_tpu_torch.physics.snow import SnowParams
from hybrid9_tpu_torch.state import Forcing, SoilParams, initial_state
from hybrid9_tpu_torch.step import day_step, slab_day_step
from hybrid9_tpu_torch.utils import profiling

N, DAYS, NISURF = 4, 2, 2
F64 = torch.float64


@pytest.fixture(scope="module")
def problem():
    """Four float64 columns on the canonical grid, their initial state
    and two days of forcing, and the switches' params over a 2 x 2 grid
    (every cell drains to the next; the last to the ocean)."""
    grid = LayerGrid.from_interfaces()
    params = SoilParams.from_numpy(synthetic_soil_params(N, seed=5), F64,
                                   "cpu")
    state = initial_state(params, grid.dz, grid.zi, F64, "cpu")
    block = Forcing.from_numpy(synthetic_forcing_block(DAYS, N, seed=5,
                                                       start_doy=20),
                               F64, "cpu")
    switches = dict(
        snow=SnowParams(), freeze=True, carbon=True,
        routing=RoutingParams(downstream=torch.arange(1, N + 1)),
        lateral=LateralParams(land_flat_idx=torch.arange(N),
                              land_mask=torch.ones((2, 2), dtype=bool),
                              z_surf=torch.zeros((2, 2)), n_padded=N))
    return params, state, block, Geometry.from_layer_grid(grid), switches


@pytest.fixture
def recorder():
    """The recorder on for one test, off after it."""
    profiling.record(True)
    yield
    profiling.record(False)


def _day(problem, **switches):
    params, state, block, geom, _ = problem
    return day_step(state, block.map(lambda x: x[0]), params, geom,
                    86400.0 / NISURF, NISURF, **switches)


def _ensemble(problem):
    params, state, block, geom, _ = problem
    theta = {"hksat": torch.tensor([0.0, 0.3], dtype=F64)}
    return run_ensemble_annual(theta, params, state, block, geom,
                               nisurf=NISURF, zd09_every=1)


def _window(problem):
    params, state, block, geom, _ = problem
    obs = torch.full((DAYS, N), 1.5, dtype=F64)
    return assimilate(params, state, block, obs, geom, n_members=3,
                      nisurf=NISURF)


def _flat(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _flat(x)]
    return [t for x in vars(tree).values() for t in _flat(x)]


def _runs(problem):
    return (_day(problem), _day(problem, **problem[4]), _ensemble(problem),
            _window(problem))


def test_off_reads_no_clock(problem, monkeypatch):
    """Off, a span is the shared no-op, and the day (with every switch),
    the ensemble and a DA window never read the clock."""
    profiling.record(False)
    assert profiling.span("day") is profiling.span("ensemble.day")

    def no_clock():
        raise AssertionError("a clock was read with the recorder off")
    monkeypatch.setattr(time, "time_ns", no_clock)
    _runs(problem)


def test_on_is_bitwise_off(problem, recorder):
    on = _flat(_runs(problem))
    assert profiling.spans()
    profiling.record(False)
    off = _flat(_runs(problem))
    assert len(on) == len(off)
    assert all(torch.equal(a, b) for a, b in zip(on, off))


def _names(spans):
    return [(s.name, s.parent.name if s.parent else None) for s in spans
            if s.name != "python.gc"]


def test_spans_and_parents(problem, recorder):
    _day(problem, **problem[4])
    parts = ["day.snow", "day.impedance", "day.hydrology", "day.grow",
             "day.route", "day.lateral", "day.soil_heat", "day.carbon"]
    assert _names(profiling.spans()) == [("day", None)] + [
        (p, "day") for p in parts]
    for s in profiling.spans():
        assert s.start_ns <= s.end_ns and s.events is None   # CPU tensors

    profiling.record(False)
    profiling.record(True)
    _ensemble(problem)
    day = [("day", "ensemble.day")] + [
        (p, "day") for p in ("day.hydrology", "day.grow", "day.soil_heat")]
    assert _names(profiling.spans()) == [("ensemble.run", None)] + (
        [("ensemble.day", "ensemble.run")] + day) * DAYS

    profiling.record(False)
    profiling.record(True)
    _window(problem)
    day = [("day", "assimilate.cycle")] + [
        (p, "day") for p in ("day.hydrology", "day.grow", "day.soil_heat")]
    assert _names(profiling.spans()) == [("assimilate.window", None)] + (
        [("assimilate.cycle", "assimilate.window")] + day
        + [("assimilate.analysis", "assimilate.cycle")]) * DAYS


def test_slab_day_spans(problem, recorder):
    """On two slabs the day is one ``day`` span; each slab's cell-local
    parts are spans of their own, and the router and lateral exchange,
    which cross the slabs, one each."""
    params, state, block, geom, switches = problem
    slabs = DeviceSlabs.create(N, ["cpu", "cpu"])
    slab_day_step(slabs, slabs.put(state),
                  slabs.put(block.map(lambda x: x[0])), slabs.put(params),
                  geom, 86400.0 / NISURF, NISURF, **switches)
    local = ["day.snow", "day.impedance", "day.hydrology", "day.grow"]
    after = ["day.soil_heat", "day.carbon"]
    assert _names(profiling.spans()) == [("day", None)] + [
        (p, "day") for p in local * 2 + ["day.route", "day.lateral"]
        + after * 2]


@pytest.mark.parametrize("soil_ice", [False, True], ids=["band", "ice"])
def test_soil_heat_span_names_its_instance(problem, recorder, soil_ice):
    """On CPU tensors ``day.soil_heat`` names the plain twin that ran it,
    with its layer count, dtype and ice mode, in a day and in each slab's
    day."""
    params, state, block, geom, _ = problem
    _day(problem, soil_ice=soil_ice)
    slabs = DeviceSlabs.create(N, ["cpu", "cpu"])
    slab_day_step(slabs, slabs.put(state),
                  slabs.put(block.map(lambda x: x[0])), slabs.put(params),
                  geom, 86400.0 / NISURF, NISURF, soil_ice=soil_ice)
    heat = [s.attrs for s in profiling.spans() if s.name == "day.soil_heat"]
    assert heat == [dict(instance="plain", nl=8, dtype="float64",
                         soil_ice=soil_ice)] * 3


def test_an_exception_closes_its_span(recorder):
    with pytest.raises(ZeroDivisionError):
        with profiling.span("day"):
            with profiling.span("day.grow"):
                1 / 0
    with profiling.span("day.soil_heat"):
        pass
    day, grow, heat = [s for s in profiling.spans() if s.name != "python.gc"]
    assert grow.parent is day and heat.parent is None
    assert day.end_ns >= grow.end_ns >= grow.start_ns >= day.start_ns


def test_each_thread_nests_its_own_spans(recorder):
    """Threads that record at once keep apart: each span's parent is its
    own thread's open span."""
    def work(k):
        for _ in range(50):
            with profiling.span(f"outer{k}"):
                with profiling.span(f"inner{k}"):
                    pass
    threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    got = [s for s in profiling.spans() if s.name != "python.gc"]
    assert len(got) == 8 * 50 * 2
    for s in got:
        if s.name.startswith("inner"):
            assert s.parent.name == "outer" + s.name[5:]
            assert s.parent.thread == s.thread
        else:
            assert s.parent is None


def test_spanned_calls_and_annotations():
    """A ``spanned`` function keeps its name and module and is one span a
    call, its device pair picked from its arguments; ``annotate`` gives
    the innermost open span its attributes; off, or with no span open,
    nothing is recorded."""
    @profiling.spanned("outer", device=lambda x: x)
    def outer(x):
        with profiling.span("day.hydrology"):
            profiling.annotate(rounds=8)
            profiling.annotate(grid=17408)
        return x + 1

    assert (outer.__name__, outer.__module__) == ("outer", __name__)
    profiling.record(False)
    profiling.annotate(rounds=8)
    assert outer(1) == 2
    profiling.record(True)
    try:
        profiling.annotate(rounds=8)
        assert outer(torch.ones(2)).tolist() == [2.0, 2.0]
        got = [s for s in profiling.spans() if s.name != "python.gc"]
        assert [(s.name, s.attrs) for s in got] == [
            ("outer", {}), ("day.hydrology", dict(rounds=8, grid=17408))]
        assert got[1].parent is got[0]
        assert all(s.end_ns is not None for s in got)
        assert profiling.device_ms(got[0]) is None
    finally:
        profiling.record(False)


def test_collections_are_spans_and_off_unhooks(recorder):
    with profiling.span("outer"):
        gc.collect()
    got = [s for s in profiling.spans() if s.name == "python.gc"]
    assert got and got[-1].attrs["generation"] == 2
    assert got[-1].parent.name == "outer"
    assert got[-1].attrs["collected"] >= 0
    assert got[-1].start_ns <= got[-1].end_ns
    assert profiling._on_gc in gc.callbacks
    profiling.record(False)
    assert profiling._on_gc not in gc.callbacks
    before = len(profiling.spans())
    gc.collect()
    assert len(profiling.spans()) == before


def test_chrome_trace_of_a_day(problem, recorder, tmp_path):
    t0 = time.time_ns()
    _day(problem, **problem[4])
    path = tmp_path / "spans.json"
    assert profiling.write_trace(str(path)) == len(profiling.spans())
    events = json.loads(path.read_text())["traceEvents"]
    names = [e["name"] for e in events]
    assert names[:3] == ["day", "day.snow", "day.impedance"]
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events)
    assert t0 / 1e3 <= events[0]["ts"] <= time.time_ns() / 1e3
    assert "parent_id" not in events[0]["args"]
    assert all(e["args"]["parent_id"] == events[0]["args"]["id"]
               for e in events[1:] if e["name"] != "python.gc")


@pytest.mark.parametrize("command", ["run", "ensemble", "assimilate"])
def test_spans_flag(command, tmp_path, monkeypatch):
    """``--spans PATH`` switches the recorder on for the command and
    writes its spans at exit; without it nothing is recorded."""
    def fake(args):
        assert profiling.recording()
        with profiling.span("day"):
            pass
        return 0
    monkeypatch.setattr(cli, f"cmd_{command}", fake)
    path = tmp_path / "trace.json"
    argv = [command, "--config", "c.json", "--spans", str(path)]
    assert cli.main(argv) == 0
    assert not profiling.recording()
    assert [e["name"] for e in json.loads(path.read_text())["traceEvents"]
            if e["name"] != "python.gc"] == ["day"]
    monkeypatch.setattr(cli, f"cmd_{command}",
                        lambda args: int(profiling.recording()))
    assert cli.main(argv[:3]) == 0
