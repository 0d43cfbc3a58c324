"""The CUDA day kernel against its plain twin, the flagship day and the
sharded launcher, on the card.

Needs a CUDA device and the CUDA toolkit; skips elsewhere.  It imports
neither JAX nor the JAX package, so on a machine without JAX it runs
with the suite's conftest left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

It reuses chip_smoke.py's cases at 1,024 cells: every output of the day
(soil water, water table, aquifer, matric potential and the three daily
sums) in float32 at the tests/test_pallas_day.py tolerances on the
reference case's states and on columns across regimes (knife-edge cells
held to finiteness and the water balance only), and in float64 at 1e-9
on columns across regimes, the residual included.  The flagship day
(``Config()`` defaults on the 4-degree grid) runs three winter days
through ``block_step`` with one kernel launch per day and is held against
the plain twin; the sharded launcher is held bitwise against the
unsharded kernel for 1 and 4 slabs of a ragged cell count.  The kernel
takes ragged cell counts around a warp and around the 0.5-degree grid,
slab views ``x[lo:hi]`` without a copy (bitwise the same cells of the
whole tensor's day), refuses views whose rows are not contiguous or not
aligned, and two launches on the same inputs agree bitwise.
"""

import pytest
import torch

import chip_smoke
from hybrid9_tpu_torch.data.synthetic import synthetic_forcing_block
from hybrid9_tpu_torch.entry import build_flagship_case
from hybrid9_tpu_torch.physics import day_kernel
from hybrid9_tpu_torch.state import AnnualAccumulators, Forcing
from hybrid9_tpu_torch.step import block_step


@pytest.mark.cuda
@pytest.mark.parametrize("zd09_every", [1, 8])
@pytest.mark.parametrize("nl", [8, 20])
@pytest.mark.parametrize("dtype,regime", chip_smoke.CHECK_REGIMES,
                         ids=lambda x: str(x).replace("torch.", ""))
def test_day_kernel_matches_plain_twin(dtype, regime, nl, zd09_every):
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
                                      (torch.float64, 20)],
                         ids=["float32-nl8", "float64-nl20"])
def test_slab_views_go_in_without_a_copy(dtype, nl):
    """A slab ``x[lo:hi]`` of every operand, as the sharded launcher cuts
    them, is read in place: the day of the slab is bitwise the same cells
    of the whole tensor's day."""
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
