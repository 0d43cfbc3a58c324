"""The CUDA day kernel against its plain twin, the flagship day and the
sharded launcher, on the card.

Needs a CUDA device and the CUDA toolkit; skips elsewhere.  It imports
neither JAX nor the JAX package, so on a machine without JAX it runs
with the suite's conftest left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

It reuses chip_smoke.py's cases at 1,024 cells: every output of the day
(soil water, water table, aquifer, matric potential and the three daily
sums) in float32 at the tests/test_pallas_day.py tolerances on the
reference case's states, on columns across regimes and on the edge
states (knife-edge cells held to finiteness and the water balance only),
and in float64 at 1e-9 on columns across regimes and the edge states,
the residual included, at 8 and 20 layers (the fixed builds) and at 5,
10 and 32 (``day_kernel_any``), and at both ends of each register build
of ``day_kernel_any`` (``kernels.ANY_BUILDS``) in both dtypes.  The
flagship day (``Config()`` defaults on the 4-degree grid) runs three winter days
through ``block_step`` with one kernel launch per day and is held against
the plain twin; the sharded launcher is held bitwise against the
unsharded kernel for 1 and 4 slabs of a ragged cell count.  The kernel
takes ragged cell counts around a warp and around the 0.5-degree grid,
slab views ``x[lo:hi]`` without a copy (bitwise the same cells of the
whole tensor's day), refuses views whose rows are not contiguous or not
aligned, and two launches on the same inputs agree bitwise.  With a
focus cell the kernel writes that cell's water table after each substep
(held against the twin's trace) and changes no other output.  A source
that does not build and a launch the C entry refuses raise; two years of
the hot climate run finite and conserving on the kernel.  A day's
``day.hydrology`` span holds its launch on the profiler's clock, and the
closed loops make no host sync.  The soil-heat kernel (``csrc/soil_heat.cu``)
is held to ``step._soil_thermal``'s plain twin at every build in float64
and at 8 and 10 layers in float32, keeps each layer's water through the
phase change, counts one launch a call, refuses what it does not take and
reads slab views in place.
"""

import pytest
import torch

import chip_smoke
from hybrid9_tpu_torch import kernels
from hybrid9_tpu_torch.data.synthetic import synthetic_forcing_block
from hybrid9_tpu_torch.entry import build_flagship_case
from hybrid9_tpu_torch.physics import day_kernel
from hybrid9_tpu_torch.state import AnnualAccumulators, Forcing
from hybrid9_tpu_torch.step import block_step


@pytest.mark.cuda
@pytest.mark.parametrize("zd09_every", [1, 8])
@pytest.mark.parametrize(
    "dtype,regime,nl", [(d, r, nl) for nl in (8, 20, 5, 10, 32)
                        for d, r in chip_smoke.regimes_at(nl)],
    ids=lambda x: str(x).replace("torch.", ""))
def test_day_kernel_matches_plain_twin(dtype, regime, nl, zd09_every):
    """The fixed builds at 8 and 20 layers, ``day_kernel_any`` at 5, 10
    and 32 (float32 on the varied columns only above
    ``chip_smoke.COARSE_NL`` layers), on every regime."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the day kernel has no CPU form")
    case = chip_smoke.check_case(1024, nl, dtype, torch.device("cuda"),
                                 regime)
    for use_imp in (False, True):
        before = day_kernel.launches
        _, res, _ = chip_smoke.check_kernel(
            f"{regime} nl={nl} imp={use_imp}", case, regime, zd09_every,
            use_imp)
        assert day_kernel.launches == before + 1
        assert res < 0.1


# The fewest and the most layers each register build serves, in both
# dtypes (the count goes to whichever form serves it in the other dtype).
_BUILD_ENDS = sorted({nl for _, _, counts in kernels.ANY_BUILDS
                      for nl in (min(counts), max(counts))})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,regime,nl", [
    (d, r, nl) for nl in _BUILD_ENDS for d, r in chip_smoke.regimes_at(nl)
    if r in ("varied", "varied_off_interfaces")
    or (r == "reference" and nl <= chip_smoke.COARSE_NL)],
    ids=lambda x: str(x).replace("torch.", ""))
def test_each_register_build_at_the_ends_of_its_range(dtype, regime, nl):
    """``day_kernel_any`` at the fewest and the most layers of each
    register build against the twin: float64 at 1e-9, float32 within
    F32_TOL with ``check_kernel``'s set-asides; one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the day kernel has no CPU form")
    case = chip_smoke.check_case(1024, nl, dtype, torch.device("cuda"),
                                 regime)
    for use_imp in (False, True):
        before = day_kernel.launches
        _, res, _ = chip_smoke.check_kernel(
            f"{regime} nl={nl} imp={use_imp}", case, regime, 8, use_imp,
            instances=(True,))
        assert day_kernel.launches == before + 1
        assert res < 0.1


@pytest.mark.cuda
def test_day_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the day kernel has no CPU form")
    soil, veg, params, forcing, geom, imp = chip_smoke.check_case(
        256, 8, torch.float32, torch.device("cuda"), "reference")
    args = (veg, params, forcing, geom, 1800.0, 48)
    with pytest.raises(ValueError, match="no instance"):
        day_kernel.hydrology_day_cuda(soil.map(lambda x: x.half()), *args)
    with pytest.raises(ValueError, match="expected"):
        day_kernel.hydrology_day_cuda(soil, *args, imp=imp[:, :4])


def _day_outputs(day):
    soil, diags = day
    return dict(h2osoi_liq=soil.h2osoi_liq, zwt=soil.zwt, wa=soil.wa,
                smp=soil.smp, **diags)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 33, 69_630])
def test_ragged_cell_counts_match_the_plain_twin(n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the day kernel has no CPU form")
    case = chip_smoke.check_case(n, 8, torch.float32, torch.device("cuda"),
                                 "reference")
    before = day_kernel.launches
    _, res, _ = chip_smoke.check_kernel(f"{n} cells", case, "reference", 8,
                                        True)
    assert day_kernel.launches == before + 1
    assert res < 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,nl", [(torch.float32, 8),
                                      (torch.float64, 20),
                                      (torch.float32, 10)],
                         ids=["float32-nl8", "float64-nl20", "float32-nl10"])
def test_slab_views_go_in_without_a_copy(dtype, nl):
    """A slab ``x[lo:hi]`` of every operand, as the sharded launcher cuts
    them, is read in place: the day of the slab is bitwise the same cells
    of the whole tensor's day.  At 10 layers in float32 the slabs starting
    at an odd cell start on 8-byte addresses (``day_kernel_any``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the day kernel has no CPU form")
    soil, veg, params, forcing, geom, imp = chip_smoke.check_case(
        2048, nl, dtype, torch.device("cuda"), "varied")
    sw_abs = torch.linspace(0.3, 0.92, 2048, device=imp.device, dtype=dtype)
    rest = (geom, 1800.0, 48)
    whole = _day_outputs(day_kernel.hydrology_day_cuda(
        soil, veg, params, forcing, *rest, imp=imp, sw_abs=sw_abs,
        zd09_every=8))
    for lo, hi in ((0, 33), (31, 1055), (2047, 2048)):
        def cut(x):
            view = x[lo:hi]
            assert view.data_ptr() == x.data_ptr() + lo * x.stride(0) \
                * x.element_size()
            return view
        part = _day_outputs(day_kernel.hydrology_day_cuda(
            soil.map(cut), veg.map(cut), params.map(cut), forcing.map(cut),
            *rest, imp=cut(imp), sw_abs=cut(sw_abs), zd09_every=8))
        for name, x in part.items():
            assert torch.equal(x, whole[name][lo:hi]), (name, lo, hi)


@pytest.mark.cuda
def test_views_with_broken_rows_are_refused():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the day kernel has no CPU form")
    soil, veg, params, forcing, geom, imp = chip_smoke.check_case(
        256, 8, torch.float32, torch.device("cuda"), "reference")
    args = (veg, params, forcing, geom, 1800.0, 48)
    before = day_kernel.launches
    layer_major = imp.t().contiguous().t()      # [n, nl] over [nl, n] data
    assert layer_major.shape == imp.shape
    with pytest.raises(ValueError, match="rows of imp are not contiguous"):
        day_kernel.hydrology_day_cuda(soil, *args, imp=layer_major)
    with pytest.raises(ValueError, match="rows of h2osoi_liq are not"):
        day_kernel.hydrology_day_cuda(
            soil.replace(h2osoi_liq=soil.h2osoi_liq.t().contiguous().t()),
            *args)
    wide = torch.ones(256, 9, device=imp.device)
    with pytest.raises(ValueError, match="16-byte"):
        day_kernel.hydrology_day_cuda(soil, *args, imp=wide[:, 1:])
    assert day_kernel.launches == before


@pytest.mark.cuda
def test_two_launches_on_the_same_inputs_are_bitwise_equal():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the day kernel has no CPU form")
    soil, veg, params, forcing, geom, imp = chip_smoke.check_case(
        69_630, 8, torch.float32, torch.device("cuda"), "varied")
    args = (soil, veg, params, forcing, geom, 1800.0, 48)
    first = _day_outputs(day_kernel.hydrology_day_cuda(
        *args, imp=imp, zd09_every=8))
    again = _day_outputs(day_kernel.hydrology_day_cuda(
        *args, imp=imp, zd09_every=8))
    for name, x in first.items():
        assert torch.equal(x, again[name]), name


def _flagship_blocks(days, **overrides):
    """``days`` winter days of the flagship case at 4 degrees on the card
    through ``block_step``; ``overrides`` replace keyword arguments of
    the day step."""
    case = build_flagship_case(resolution_deg=4.0)
    sim = case.sim
    assert sim.device.type == "cuda" and sim.use_kernel
    block = Forcing.from_numpy(
        synthetic_forcing_block(days, sim.n, seed=3, start_doy=1,
                                lat=case.land_grid.cell_lat),
        torch.float32, sim.device)
    acc = AnnualAccumulators.zeros(sim.n, torch.float32, sim.device)
    return sim, block_step(sim.state, acc, block, sim.params, sim.geom,
                           sim.cfg.dt, sim.cfg.nisurf,
                           **dict(case.step_kwargs, **overrides))


@pytest.mark.cuda
def test_flagship_block_runs_on_the_kernel_and_matches_the_twin():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the day kernel has no CPU form")
    days = 3
    before = day_kernel.launches
    sim, got = _flagship_blocks(days)
    assert day_kernel.launches == before + days
    _, want = _flagship_blocks(days, use_kernel=False)
    assert day_kernel.launches == before + days
    state, acc = got
    assert float(state.swe.max()) > 0 and float(state.h2osoi_ice.max()) > 0
    assert float(acc.discharge_sum.max()) > 0 and float(acc.rh_sum.max()) > 0
    assert float(acc.max_abs_residual.max()) < 0.1
    chip_smoke.compare_blocks("flagship block vs plain twin", got, want,
                              sim.params.bsw)


@pytest.mark.cuda
@pytest.mark.parametrize("slabs", [1, 4])
def test_sharded_day_is_bitwise_the_unsharded_kernel(slabs):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the day kernel has no CPU form")
    dev = torch.device("cuda", 0)
    soil, veg, params, forcing, geom, imp = chip_smoke.check_case(
        1023, 8, torch.float32, dev, "varied")
    sw_abs = torch.linspace(0.3, 0.92, 1023, device=dev)
    args = (soil, veg, params, forcing, geom, 1800.0, 48)
    kw = dict(imp=imp, sw_abs=sw_abs, zd09_every=8)
    edge = chip_smoke.knife_edge_cells(
        *args[:5], day_kernel.hydrology_day_plain(*args, **kw), **kw)
    chip_smoke.check_sharded(f"{slabs} slabs of 1023 cells", args, kw,
                             [dev] * slabs, ~edge)


@pytest.mark.cuda
def test_sharded_day_raises_on_a_cpu_device_for_cuda_tensors():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the day kernel has no CPU form")
    dev = torch.device("cuda", 0)
    soil, veg, params, forcing, geom, imp = chip_smoke.check_case(
        64, 8, torch.float32, dev, "reference")
    with pytest.raises(ValueError, match="cannot be cut over"):
        day_kernel.hydrology_day_sharded(soil, veg, params, forcing, geom,
                                         1800.0, 48, devices=[dev, "cpu"])


@pytest.mark.cuda
def test_sharded_flagship_block_is_bitwise_the_unsharded_block():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the day kernel has no CPU form")
    before = day_kernel.launches
    _, got = _flagship_blocks(2, devices=[torch.device("cuda", 0)] * 4)
    assert day_kernel.launches == before + 8
    _, want = _flagship_blocks(2)
    for x, y in zip(chip_smoke._state_leaves(got[0])
                    + chip_smoke._state_leaves(got[1]),
                    chip_smoke._state_leaves(want[0])
                    + chip_smoke._state_leaves(want[1])):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,regime",
                         [x for x in chip_smoke.CHECK_REGIMES
                          if x[1] != "edge"],
                         ids=lambda x: str(x).replace("torch.", ""))
def test_focus_trace_matches_the_twin(dtype, regime):
    """The kernel's per-substep trace of a focus cell against the twin's
    trace of that cell (off knife edges in float32), and every other
    output bitwise the day without a focus, for cells in the first and
    last warp and one past a warp boundary."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the day kernel has no CPU form")
    dev = torch.device("cuda", 0)
    n = 1023
    soil, veg, params, forcing, geom, imp = chip_smoke.check_case(
        n, 8, dtype, dev, regime)
    args = (soil, veg, params, forcing, geom, 1800.0, 48)
    kw = dict(imp=imp, zd09_every=8)
    held = torch.ones(n, dtype=torch.bool, device=dev)
    if regime != "reference" and dtype == torch.float32:
        held = ~chip_smoke.knife_edge_cells(
            *args[:5], day_kernel.hydrology_day_plain(*args, **kw), **kw)
    cells = [0, 31, 32, 517, n - 1]
    _, n_held = chip_smoke.check_focus(f"{regime} focus", args, kw, cells,
                                       held)
    assert n_held >= len(cells) - 1


@pytest.mark.cuda
def test_focus_outside_the_cells_is_refused():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the day kernel has no CPU form")
    soil, veg, params, forcing, geom, _ = chip_smoke.check_case(
        64, 8, torch.float32, torch.device("cuda"), "reference")
    args = (soil, veg, params, forcing, geom, 1800.0, 48)
    for bad in (-1, 64):
        with pytest.raises(ValueError, match="focus_idx"):
            day_kernel.hydrology_day_cuda(*args, focus_idx=bad)


@pytest.mark.cuda
def test_focus_rows_of_a_flagship_block_come_from_the_kernel():
    """``block_step(focus_idx=...)`` on the card: one launch a day, the
    rows' traces from the kernel, and the state bitwise the block run
    without a focus."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the day kernel has no CPU form")
    before = day_kernel.launches
    sim, got = _flagship_blocks(2, focus_idx=7)
    assert day_kernel.launches == before + 2
    state, acc, rows = got
    assert rows["wt_substeps"].shape == (2, sim.cfg.nisurf)
    assert rows["wt_substeps"].is_cuda
    assert torch.equal(rows["wt_substeps"][-1, -1], state.soil.zwt[7])
    _, want = _flagship_blocks(2)
    for x, y in zip(chip_smoke._state_leaves(state)
                    + chip_smoke._state_leaves(acc),
                    chip_smoke._state_leaves(want[0])
                    + chip_smoke._state_leaves(want[1])):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [s[0] for s in chip_smoke.SWITCHES])
def test_switch_blocks_on_the_card(name):
    """Each non-default switch on the 4-degree grid: three winter days
    through ``block_step`` with one kernel launch a day, held against
    the plain twin; the packed routers' blocks bitwise repeatable."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the day kernel has no CPU form")
    from hybrid9_tpu_torch.config import Config
    from hybrid9_tpu_torch.run import Simulation
    switch = dict(chip_smoke.SWITCHES)[name]
    case = build_flagship_case(resolution_deg=4.0)
    sim = Simulation(Config(resolution_deg=4.0, **switch), case.sim.params,
                     land_grid=case.land_grid)
    n = sim.n
    block = Forcing.from_numpy(
        synthetic_forcing_block(3, n, seed=1, start_doy=1,
                                lat=case.land_grid.cell_lat),
        torch.float32, sim.device)
    acc = AnnualAccumulators.zeros(n, torch.float32, sim.device)
    run = (sim.params, sim.geom, sim.cfg.dt, sim.cfg.nisurf)
    kw = sim.step_kwargs()
    before = day_kernel.launches
    got = block_step(sim.state, acc, block, *run, **kw)
    assert day_kernel.launches == before + 3
    want = block_step(sim.state, acc, block, *run,
                      **dict(kw, use_kernel=False))
    chip_smoke.compare_blocks(name, got, want, sim.params.bsw)
    if name.endswith("packed"):
        again = block_step(sim.state, acc, block, *run, **kw)
        for x, y in zip(chip_smoke._state_leaves(got[0]),
                        chip_smoke._state_leaves(again[0])):
            assert torch.equal(x, y)


@pytest.mark.cuda
def test_site_kernel_engine_on_the_card_matches_the_oracle():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np
    from hybrid9_tpu_torch.config import Config
    from hybrid9_tpu_torch.site import run_site
    cfg = Config(nisurf=8, dtype="float64", zd09_every=1, snow=False)
    from hybrid9_tpu_torch.data.synthetic import synthetic_forcing_day
    from hybrid9_tpu_torch.physics import reference_column as ref
    climate = [ref.DailyForcing(**{k: float(v[0]) for k, v in
                                   synthetic_forcing_day(
                                       1, d, seed=17,
                                       lat=np.array([38.41])).items()})
               for d in range(180, 184)]
    kernel = run_site(cfg, climate=climate, engine="kernel")
    assert kernel.state.soil.zwt.is_cuda
    oracle = run_site(cfg, climate=climate, engine="oracle")
    for key in ("evap_day", "theta1", "theta4", "lai", "w_i", "f_t"):
        np.testing.assert_allclose([r[key] for r in kernel.daily],
                                   [r[key] for r in oracle.daily],
                                   rtol=1e-5, atol=1e-7, err_msg=key)


@pytest.mark.cuda
def test_kernel_raises_under_autograd():
    """The kernel has no backward: an input that requires a gradient
    raises, naming ``use_kernel=False``, and nothing is launched; under
    ``torch.no_grad()`` the same call launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the day kernel has no CPU form")
    soil, veg, params, forcing, geom, _ = chip_smoke.check_case(
        256, 8, torch.float32, torch.device("cuda"), "reference")
    tracked = params.replace(hksat=params.hksat.clone().requires_grad_())
    args = (soil, veg, tracked, forcing, geom, 1800.0, 48)
    before = day_kernel.launches
    with pytest.raises(RuntimeError, match="use_kernel=False"):
        day_kernel.hydrology_day_cuda(*args)
    assert day_kernel.launches == before
    with torch.no_grad():
        day_kernel.hydrology_day_cuda(*args)
    assert day_kernel.launches == before + 1


@pytest.mark.cuda
def test_folded_kernel_day_is_the_unfolded_control():
    """Members folded into the cell axis (``j = cell*m + member``): the
    kernel day's member 0 (theta = 0) is bitwise the unfolded day of
    ``apply_multipliers(params, zeros)``, every output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the day kernel has no CPU form")
    from hybrid9_tpu_torch.calibrate import apply_multipliers
    from hybrid9_tpu_torch.ensemble import (fold, perturbed_multipliers,
                                            unfold)
    dev = torch.device("cuda", 0)
    n, m = 1023, 4
    soil, veg, params, forcing, geom, _ = chip_smoke.check_case(
        n, 8, torch.float32, dev, "varied_off_interfaces")
    theta = perturbed_multipliers(torch.Generator(device=dev).manual_seed(0),
                                  m, sigma=0.3)

    def folded(x):
        return fold(x, m)
    params_m = apply_multipliers(params.map(folded),
                                 {f: v.repeat(n) for f, v in theta.items()})
    got = _day_outputs(day_kernel.hydrology_day_cuda(
        soil.map(folded), veg.map(folded), params_m, forcing.map(folded),
        geom, 1800.0, 48, zd09_every=8))
    control = apply_multipliers(params, {f: torch.zeros((), device=dev)
                                         for f in theta})
    want = _day_outputs(day_kernel.hydrology_day_cuda(
        soil, veg, control, forcing, geom, 1800.0, 48, zd09_every=8))
    for name, x in want.items():
        assert torch.equal(unfold(got[name], m)[0], x), name


@pytest.mark.cuda
def test_a_failed_build_or_launch_raises(tmp_path, monkeypatch):
    """No fallback to the twin: a source nvcc refuses raises from the
    build, and a launch the C entry refuses (a grid short of the cells)
    raises from the wrapper without counting a launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the day kernel has no CPU form")
    from hybrid9_tpu_torch import kernels
    broken = tmp_path / "day_kernel.cu"
    broken.write_text("#error a source that does not build\n"
                      + kernels.DAY_KERNEL_SOURCE.read_text())
    monkeypatch.setattr(kernels, "_BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        kernels.build("h9broken", [broken])
    monkeypatch.undo()
    soil, veg, params, forcing, geom, imp = chip_smoke.check_case(
        256, 10, torch.float32, torch.device("cuda"), "reference")
    monkeypatch.setattr(day_kernel, "launch_grid", lambda n, block: 1)
    before = day_kernel.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        day_kernel.hydrology_day_cuda(soil, veg, params, forcing, geom,
                                      1800.0, 48, imp=imp)
    assert day_kernel.launches == before


@pytest.mark.cuda
def test_hot_climate_on_the_kernel():
    """Two years at 318 K on 64 reference cells through ``day_step`` on
    the kernel: finite, plant mass and root depth positive, every day's
    residual under 0.1 mm (DEVIATIONS.md #9)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the day kernel has no CPU form")
    out = chip_smoke.hot_climate(torch.device("cuda", 0))
    assert out["launches"] == chip_smoke.HOT_DAYS == 730


def _closed_loop_case(n, days):
    """Synthetic float32 columns on the canonical grid, their initial
    state and ``days`` days of forcing, on the card."""
    from hybrid9_tpu_torch.config import LayerGrid
    from hybrid9_tpu_torch.data.synthetic import synthetic_soil_params
    from hybrid9_tpu_torch.physics.hydrology import Geometry
    from hybrid9_tpu_torch.state import SoilParams, initial_state
    dev = torch.device("cuda", 0)
    grid = LayerGrid.from_interfaces()
    params = SoilParams.from_numpy(synthetic_soil_params(n, seed=7),
                                   torch.float32, dev)
    state = initial_state(params, grid.dz, grid.zi, torch.float32, dev)
    block = Forcing.from_numpy(synthetic_forcing_block(days, n, seed=7,
                                                       start_doy=150),
                               torch.float32, dev)
    return params, state, block, Geometry.from_layer_grid(grid)


def _ns(event, what):
    """A profiler event's ``start`` or ``duration`` in nanoseconds."""
    got = getattr(event, what + "_ns", None)
    return int(got()) if got else int(getattr(event, what + "_us")() * 1000)


@pytest.mark.cuda
def test_hydrology_span_holds_its_launch():
    """The ``day.hydrology`` span of a day on the card contains the start
    of its kernel's ``cudaLaunchKernel`` in a CUDA-only profiler session
    (the span and the profiler share the epoch clock), its event pair
    holds at least the kernel's device time, and it carries the launch's
    instance, grid and rounds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the day kernel has no CPU form")
    from hybrid9_tpu_torch.step import day_step
    from hybrid9_tpu_torch.utils import profiling
    params, state, block, geom = _closed_loop_case(4096, 1)
    day = block.map(lambda x: x[0])
    day_step(state, day, params, geom, 1800.0, 48, zd09_every=8)
    torch.cuda.synchronize()
    profiling.record(True)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            day_step(state, day, params, geom, 1800.0, 48, zd09_every=8)
            torch.cuda.synchronize()
    finally:
        profiling.record(False)
    span, = [s for s in profiling.spans() if s.name == "day.hydrology"]
    events = list(prof.profiler.kineto_results.events())
    kernel, = [e for e in events if "CUDA" in str(e.device_type())
               and "day_kernel" in e.name()]
    launch, = [e for e in events if "CUDA" not in str(e.device_type())
               and e.correlation_id() == kernel.correlation_id()]
    assert span.start_ns <= _ns(launch, "start") <= span.end_ns
    assert profiling.device_ms(span) >= _ns(kernel, "duration") / 1e6
    block_threads = span.attrs["block"]
    assert span.attrs["instance"] == "day_kernel"
    assert (span.attrs["nl"], span.attrs["dtype"]) == (8, "float32")
    assert span.attrs["imp"] is False
    assert span.attrs["grid"] == day_kernel.launch_grid(4096, block_threads)
    assert span.attrs["rounds"] == 1 and span.attrs["blocks_per_sm"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("record", [False, True])
def test_closed_loops_make_no_host_sync(record):
    """A folded ensemble day and a 2-day assimilation window at 1,024
    cells run under ``torch.cuda.set_sync_debug_mode("error")`` up to the
    copy of their outputs to the host: the day path waits on the device
    nowhere, with the span recorder off or on.  One call of each first
    makes what a process makes once (the kernel's build, its residency,
    the layer constants)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the day kernel has no CPU form")
    from hybrid9_tpu_torch.assimilate import assimilate
    from hybrid9_tpu_torch.ensemble import (perturbed_multipliers,
                                            run_ensemble_annual)
    from hybrid9_tpu_torch.utils import profiling
    params, state, block, geom = _closed_loop_case(1024, 2)
    dev = state.soil.zwt.device
    theta = perturbed_multipliers(torch.Generator(device=dev).manual_seed(1),
                                  4, sigma=0.3)
    obs = torch.full((2, 1024), 1.5, device=dev)

    def loops():
        ens = run_ensemble_annual(theta, params, state,
                                  block.map(lambda x: x[:1]), geom,
                                  nisurf=48, zd09_every=8)
        da = assimilate(params, state, block, obs, geom, n_members=4,
                        nisurf=48, zd09_every=8, seed=3)
        return ens, da

    loops()
    torch.cuda.synchronize()
    profiling.record(record)
    torch.cuda.set_sync_debug_mode("error")
    try:
        ens, da = loops()
    finally:
        torch.cuda.set_sync_debug_mode(0)
        profiling.record(False)
    assert bool(torch.isfinite(ens["evap"]).all())
    assert bool(torch.isfinite(da["theta_mean"]).all())


def _heat_case(nl, dtype, regime="varied", n=4096, seed=0):
    return chip_smoke.soil_heat_case(n, nl, dtype, torch.device("cuda", 0),
                                     regime, seed=seed)


def _soil_thermal(inputs, soil_ice, with_sw_abs, use_kernel):
    """``step._soil_thermal`` on the inputs of :func:`_heat_case`, as
    ``(t_soil, liq, ice)``."""
    from types import SimpleNamespace

    from hybrid9_tpu_torch.state import SoilState
    from hybrid9_tpu_torch.step import _soil_thermal
    liq, zero = inputs["liq"], torch.zeros_like(inputs["lai"])
    state = SimpleNamespace(t_soil=inputs["t_soil"], h2osoi_ice=inputs["ice"],
                            veg=SimpleNamespace(lai=inputs["lai"]))
    soil = SoilState(h2osoi_liq=liq, zwt=zero, wa=zero, smp=liq,
                     h2osoi_liq_ma=liq)
    t_soil, soil, ice = _soil_thermal(
        state, soil, SimpleNamespace(theta_s=inputs["theta_s"]),
        inputs["forcing"], inputs["geom"], soil_ice,
        inputs["sw_abs"] if with_sw_abs else None, use_kernel)
    return t_soil, soil.h2osoi_liq, ice


def _kernel_and_twin(inputs, soil_ice, with_sw_abs):
    from hybrid9_tpu_torch.physics import soil_heat
    before = soil_heat.launches
    got = _soil_thermal(inputs, soil_ice, with_sw_abs, None)
    assert soil_heat.launches == before + 1
    want = _soil_thermal(inputs, soil_ice, with_sw_abs, False)
    assert soil_heat.launches == before + 1
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("with_sw_abs", [True, False], ids=["sw_abs", "0.92"])
@pytest.mark.parametrize("soil_ice", [False, True], ids=["band", "ice"])
@pytest.mark.parametrize("nl", [3, 8, 10, 20, 32, 40])
def test_soil_heat_kernel_matches_the_twin_in_float64(nl, soil_ice,
                                                      with_sw_abs):
    """The soil-heat kernel against ``_soil_thermal``'s plain twin
    (``use_kernel=False``) on the same CUDA tensors, in float64, on
    winter columns: every output within 1e-10 of the twin's largest
    magnitude of it, at each build (capacities 8, 16 and 32, and the
    run-time form above them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the soil-heat kernel has no CPU "
                    "form")
    got, want = _kernel_and_twin(_heat_case(nl, torch.float64, "winter"),
                                 soil_ice, with_sw_abs)
    out = chip_smoke.compare_soil_heat(got, want)
    assert max(out["rel_gap"]) <= chip_smoke.SOIL_HEAT_F64_REL, out


@pytest.mark.cuda
@pytest.mark.parametrize("regime", ["winter", "varied"])
@pytest.mark.parametrize("nl", [8, 10])
def test_soil_heat_kernel_matches_the_twin_in_float32(nl, regime):
    """In float32 the kernel does the twin's arithmetic operation for
    operation, and is bitwise the twin on the varied state.  On the winter
    state, where one ulp decides whether a layer's step crosses the
    freezing band (and some 0.5 K follows), no layer takes the other side
    (``chip_smoke.SOIL_HEAT_FLIP_K``) and every temperature is within
    ``chip_smoke.SOIL_HEAT_F32_K`` of the twin's (PERF.md)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the soil-heat kernel has no CPU "
                    "form")
    for soil_ice in (False, True):
        got, want = _kernel_and_twin(
            _heat_case(nl, torch.float32, regime, n=65_536), soil_ice, True)
        out = chip_smoke.compare_soil_heat(got, want)
        if regime == "varied":
            assert out["bitwise_cells"] == 1.0, out
        assert out["flipped_layers"] == 0, out
        assert out["t_gap_outside_flips"] <= chip_smoke.SOIL_HEAT_F32_K, out
        assert max(out["rel_gap"][1:]) <= chip_smoke.SOIL_HEAT_F32_REL, out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_soil_heat_kernel_keeps_each_layers_water(dtype):
    """With the ice store the phase change only moves water between the
    liquid and the ice: ``liq + ice`` of every layer is the day's to
    within a few roundings."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the soil-heat kernel has no CPU "
                    "form")
    inputs = _heat_case(10, dtype, "winter")
    _, liq, ice = _soil_thermal(inputs, True, True, None)
    before = inputs["liq"] + inputs["ice"]
    eps = torch.finfo(dtype).eps
    assert bool(((liq + ice - before).abs() <= 4 * eps * before).all())
    assert bool((ice >= 0).all()) and bool((liq > 0).all())


@pytest.mark.cuda
def test_soil_heat_kernel_refuses_what_it_does_not_take():
    """Half precision, a layer count the day kernel does not take, an
    operand of another layer count, rows that are not contiguous, and an
    input that requires a gradient raise before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the soil-heat kernel has no CPU "
                    "form")
    from hybrid9_tpu_torch.physics import soil_heat
    inputs = _heat_case(8, torch.float32, n=256)

    def launch(**changes):
        kw = dict(inputs, soil_ice=True, latent_ramp=0.0, **changes)
        return soil_heat.soil_heat_cuda(**kw)

    before = soil_heat.launches
    half = {k: inputs[k].half() for k in ("t_soil", "liq", "ice", "theta_s",
                                          "lai", "sw_abs")}
    with pytest.raises(ValueError, match="no instance"):
        launch(**half, forcing=inputs["forcing"].map(lambda x: x.half()))
    with pytest.raises(ValueError, match="nl=2"):
        launch(t_soil=inputs["t_soil"][:, :2], liq=inputs["liq"][:, :2],
               ice=inputs["ice"][:, :2], theta_s=inputs["theta_s"][:, :2])
    with pytest.raises(ValueError, match="theta_s is"):
        launch(theta_s=torch.ones(256, 10, device=inputs["lai"].device))
    layer_major = inputs["ice"].t().contiguous().t()
    with pytest.raises(ValueError, match="rows of h2osoi_ice are not"):
        launch(ice=layer_major)
    with pytest.raises(RuntimeError, match="use_kernel=False"):
        launch(theta_s=inputs["theta_s"].clone().requires_grad_())
    assert soil_heat.launches == before
    with torch.no_grad():
        launch(theta_s=inputs["theta_s"].clone().requires_grad_())
    assert soil_heat.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,nl", [(torch.float32, 8),
                                      (torch.float32, 10),
                                      (torch.float64, 40)],
                         ids=["float32-nl8", "float32-nl10", "float64-nl40"])
def test_soil_heat_slab_views_go_in_without_a_copy(dtype, nl):
    """A slab ``x[lo:hi]`` of every operand, and layered rows of a wider
    tensor, are read in place: the slab's soil heat is bitwise the same
    cells of the whole state's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the soil-heat kernel has no CPU "
                    "form")
    from hybrid9_tpu_torch.physics import soil_heat
    inputs = _heat_case(nl, dtype, "winter", n=2048)
    wide = torch.zeros(2048, nl + 3, dtype=dtype, device=inputs["lai"].device)
    wide[:, 1:nl + 1] = inputs["theta_s"]
    inputs["theta_s"] = wide[:, 1:nl + 1]
    for soil_ice in (False, True):
        kw = dict(soil_ice=soil_ice, latent_ramp=0.0 if soil_ice else 2.0)
        whole = soil_heat.soil_heat_cuda(**inputs, **kw)
        for lo, hi in ((0, 33), (31, 1055), (2047, 2048)):
            def cut(x):
                view = x[lo:hi]
                assert view.data_ptr() == x.data_ptr() + lo * x.stride(0) \
                    * x.element_size()
                return view
            part = soil_heat.soil_heat_cuda(**{
                k: v.map(cut) if k == "forcing" else
                cut(v) if isinstance(v, torch.Tensor) else v
                for k, v in inputs.items()}, **kw)
            for x, y in zip(part, whole):
                assert torch.equal(x, y[lo:hi]), (soil_ice, lo, hi)
