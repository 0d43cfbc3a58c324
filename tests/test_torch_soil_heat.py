"""The soil-heat step's dispatch and its plain twin on the CPU.

The CUDA kernel (``csrc/soil_heat.cu``) runs only on the card, where
``tests/test_torch_cuda.py`` holds it to the twin.  Here: on CPU tensors
the day takes the twin, bitwise the step as the day composed it from
``soiltemp`` before the kernel; ``use_kernel=True`` raises; the twin
carries a gradient, as the fit takes it; and what the wrapper decides on
the host (the build, the geometry, the bytes, what it refuses).  A few
columns each: nothing here depends on the width.
"""

from types import SimpleNamespace

import pytest
import torch

from chip_smoke import soil_heat_case as case
from hybrid9_tpu_torch.physics import bounds
from hybrid9_tpu_torch.physics import constants as c
from hybrid9_tpu_torch.physics import soil_heat
from hybrid9_tpu_torch.physics.day_kernel import layer_cap
from hybrid9_tpu_torch.physics.soiltemp import (phase_change,
                                                soil_temperature_step)
from hybrid9_tpu_torch.state import SoilState
from hybrid9_tpu_torch.step import _soil_thermal


def _thermal(inputs, soil_ice, with_sw_abs, use_kernel=None):
    """``step._soil_thermal`` on the inputs of
    ``chip_smoke.soil_heat_case``, as ``(t_soil, liq, ice)``."""
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


def _composed(inputs, soil_ice, with_sw_abs):
    """The day's soil heat as ``step._soil_thermal`` composed it from
    ``soiltemp`` before the soil-heat kernel."""
    f, lai = inputs["forcing"], inputs["lai"]
    a = inputs["sw_abs"] if with_sw_abs else 0.92
    t2 = f.tas * f.tas
    rnet = a * f.rsds + f.rlds - c.STBO * (t2 * t2)
    g_flux = 0.2 * rnet * torch.exp(-0.7 * lai)
    raa = torch.where(lai <= 4.0,
                      0.25 * lai * 42.0 + 0.25 * (4.0 - lai) * 34.0, 42.0)
    h_surf = f.ps / (c.RGAS * f.tas) * c.CP_AIR / bounds.maximum(raa, 1.0)
    geom = inputs["geom"]
    water = inputs["liq"]
    if soil_ice:
        water = water + inputs["ice"]
    dz = torch.tensor(geom.dz_soil, dtype=water.dtype)
    t_soil = soil_temperature_step(
        inputs["t_soil"], water / (dz[None, :] * c.RHOW / 1.0e3),
        inputs["theta_s"], g_flux, geom.dz_soil, geom.zc_soil, c.SDAY,
        t_air=f.tas, h_surf=h_surf, latent_ramp=0.0 if soil_ice else 2.0)
    if not soil_ice:
        return t_soil, inputs["liq"], inputs["ice"]
    return phase_change(t_soil, inputs["liq"], inputs["ice"],
                        inputs["theta_s"], geom.dz_soil)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("with_sw_abs", [True, False], ids=["sw_abs", "0.92"])
@pytest.mark.parametrize("soil_ice", [False, True], ids=["band", "ice"])
def test_cpu_day_takes_the_twin_bitwise(soil_ice, with_sw_abs, dtype):
    inputs = case(64, 8, dtype, "cpu", "winter", seed=3)
    got = _thermal(inputs, soil_ice, with_sw_abs)
    want = _composed(inputs, soil_ice, with_sw_abs)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_use_kernel_true_on_cpu_raises():
    inputs = case(4, 8, torch.float32, "cpu")
    with pytest.raises(ValueError, match="no CPU form"):
        _thermal(inputs, False, True, use_kernel=True)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        soil_heat.soil_heat_cuda(**inputs, soil_ice=False, latent_ramp=2.0)
    same = _thermal(inputs, False, True, use_kernel=False)
    assert torch.equal(same[0], _thermal(inputs, False, True)[0])


@pytest.mark.parametrize("soil_ice", [False, True], ids=["band", "ice"])
def test_gradient_flows_through_the_twin(soil_ice):
    """``use_kernel=False``, as the fit calls the day: the step's
    temperatures are differentiable in the water and the porosity, and
    the gradient is the float64 finite difference's."""
    inputs = case(3, 4, torch.float64, "cpu", "varied", seed=1)
    inputs["geom"] = inputs["geom"]._replace(
        dz_soil=inputs["geom"].dz_soil[:4], zc_soil=inputs["geom"].zc_soil[:4])
    for k in ("t_soil", "liq", "ice", "theta_s"):
        inputs[k] = inputs[k][:, :4].contiguous()

    def f(liq, theta_s):
        kw = dict(inputs, liq=liq, theta_s=theta_s)
        return _thermal(kw, soil_ice, True, use_kernel=False)[0]

    assert torch.autograd.gradcheck(
        f, (inputs["liq"].clone().requires_grad_(),
            inputs["theta_s"].clone().requires_grad_()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_each_layer_count_has_one_build(dtype):
    caps = [soil_heat.capacity(dtype, nl)
            for nl in range(3, layer_cap(dtype) + 1)]
    assert caps[:6] == [8] * 6 and caps[6:14] == [16] * 8
    assert caps[14:30] == [32] * 16
    assert set(caps[30:]) == {soil_heat.ANY}
    assert soil_heat.instance_name(16) == "soil_heat_kernel capacity 16"
    assert soil_heat.instance_name(soil_heat.ANY) == "soil_heat_kernel any"
    for nl in (2, layer_cap(dtype) + 1):
        with pytest.raises(ValueError, match=f"nl={nl}"):
            soil_heat.capacity(dtype, nl)
    with pytest.raises(ValueError, match="no instance"):
        soil_heat.capacity(torch.float16, 8)


def test_geometry_and_bytes():
    """The geometry the kernel takes folds as ``soil_temperature_step``
    folds it, and a cell-day moves 148 bytes at 8 float32 layers and 180
    at 10 (the temperature, water and porosity rows and five surface
    fields in, the temperature row out)."""
    dz, zc = (20.0, 30.0, 50.0), (10.0, 35.0, 75.0)
    assert soil_heat.geometry(dz, zc) == (
        20.0, 30.0, 50.0, 20.0 / 1000.0, 30.0 / 1000.0, 50.0 / 1000.0,
        1.0 / (35.0 / 1000.0 - 10.0 / 1000.0),
        1.0 / (75.0 / 1000.0 - 35.0 / 1000.0), 0.0)
    assert soil_heat.cell_bytes(8, 4, False, False) == 148
    assert soil_heat.cell_bytes(10, 4, False, False) == 180
    assert soil_heat.cell_bytes(8, 4, True, True) == 4 * (7 * 8 + 6)
