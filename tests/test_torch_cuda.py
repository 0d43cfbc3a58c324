"""The CUDA day kernel against its plain twin, on the card.

Needs a CUDA device and the CUDA toolkit; skips elsewhere.  It imports
neither JAX nor the JAX package, so on a machine without JAX it runs
with the suite's conftest left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

It reuses chip_smoke.py's cases at 1,024 cells: every output of the day
(soil water, water table, aquifer, matric potential and the three daily
sums) in float32 at the tests/test_pallas_day.py tolerances on the
reference case's states and on columns across regimes (knife-edge cells
held to finiteness and the water balance only), and in float64 at 1e-9
on columns across regimes, the residual included.
"""

import pytest
import torch

import chip_smoke
from hybrid9_tpu_torch.physics import day_kernel


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
