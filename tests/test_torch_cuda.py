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
unsharded kernel for 1 and 4 slabs of a ragged cell count.
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
