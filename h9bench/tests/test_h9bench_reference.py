"""The frozen copies against the program they were copied from: the
operation count, and the plain column reference against the program's
plain day in float64 (both follow the reference Fortran, so they agree to
rounding)."""

import math

import numpy as np
import pytest
import torch

from h9bench import inputs, oracle, reference, roofline


@pytest.mark.parametrize("nl", [8, 10])
def test_frozen_day_operations_equal_the_programs(nl):
    from hybrid9_tpu_torch.physics.day_kernel import day_operations

    for zd09_every in (1, 8):
        for with_imp in (False, True):
            for jwt in range(nl + 1):
                assert roofline.day_operations(
                    nl, 48, zd09_every, with_imp, jwt) == day_operations(
                        nl, 48, zd09_every, with_imp, jwt)


def test_least_cell_day_is_the_cheapest_path():
    least = roofline.least_cell_day(8, 48, 8, 4)
    counts = [sum(roofline.day_operations(8, 48, 8, False, j))
              for j in range(9)]
    assert least["operations"] == min(counts)
    assert least["bound_by"] == "operations"
    assert least["seconds"] == pytest.approx(min(counts) / 67.0e12)


ZI = {8: [0.0, 45.0, 91.0, 166.0, 289.0, 493.0, 829.0, 1383.0, 2296.0,
          5000.0],
      10: [0.0, 17.51, 45.09, 90.56, 165.53, 289.13, 492.91, 828.89,
           1382.83, 2296.12, 3801.88, 5000.0]}


@pytest.mark.parametrize("nl", [8, 10])
def test_oracle_follows_the_programs_plain_day(nl):
    """Ten days of 6 columns, growth and soil heat included, in float64."""
    from hybrid9_tpu_torch.physics.hydrology import Geometry
    from hybrid9_tpu_torch.step import day_step

    from h9bench import traffic

    n, days = 6, 10
    geo = inputs.geometry(ZI[nl])
    params = inputs.soil(7, n, nl, torch.float64, "cpu")
    state = inputs.initial_state(params, geo)
    lat = torch.linspace(-40.0, 60.0, n, dtype=torch.float64)
    block = inputs.forcing_block(7, 1901, 150, days, lat)
    program = traffic._model_state(state)
    soil = traffic._soil_params(params)
    forcing = traffic._forcing(block)
    geom = Geometry(zi=tuple(geo["zi"]), dz_soil=tuple(geo["dz"][:nl]),
                    zc_soil=tuple(geo["zc"][:nl]))
    sums = np.zeros((2, n))
    with torch.inference_mode():
        for d in range(days):
            program, diags = day_step(program, forcing.map(lambda x: x[d]),
                                      soil, geom, 1800.0, 48, zd09_every=8)
            sums += np.stack([diags["evap_day"].numpy(),
                              diags["rnf_day"].numpy()])
    g = oracle.Geometry(ZI[nl])
    for c in range(n):
        col = {k: params[k][c].tolist() for k in ("theta_s", "hksat", "bsw",
                                                  "psi_s")}
        col.update(fmax=float(params["fmax"][c]),
                   h=state["h2osoi_liq"][c].tolist(),
                   smp=state["smp"][c].tolist(),
                   rootr=state["rootr"][c].tolist(),
                   t_soil=state["t_soil"][c].tolist(),
                   **{k: float(state[k][c]) for k in (
                       "zwt", "wa", "lai", "lai_litter", "plant_mass",
                       "plant_foliage_mass")})
        column = oracle.Column(col)
        evap = runoff = 0.0
        for d in range(days):
            day = oracle.run_day(column, {k: float(block[k][d, c])
                                          for k in block}, g, 48, 8)
            evap += day["evap"]
            runoff += day["runoff"]
        assert evap == pytest.approx(sums[0, c], rel=1e-11)
        assert runoff == pytest.approx(sums[1, c], rel=1e-9, abs=1e-12)
        assert column.h == pytest.approx(
            program.soil.h2osoi_liq[c].tolist(), rel=1e-10)
        assert column.t_soil == pytest.approx(program.t_soil[c].tolist(),
                                              rel=1e-12)
        assert column.lai == pytest.approx(float(program.veg.lai[c]),
                                           rel=1e-12)


def test_bfloat16_rounds_every_result():
    x = oracle.BF16(1.0) + 1.0e-3
    assert float(x) == 1.0
    assert float(oracle.BF16(3.0) / 7.0) == pytest.approx(3.0 / 7.0,
                                                          rel=2**-8)
    assert isinstance(2.0 * oracle.BF16(1.5), oracle.BF16)
    assert math.isinf(float(oracle.BF16(1e39)))


def test_gap_reads_the_widest_relative_gap():
    assert reference.gap([1.0, 2.0, 3.3], [1.0, 2.0, 3.0]) == pytest.approx(
        0.1)
    # A reference number near zero is held against the median magnitude.
    assert reference.gap([1e-3, 2.0], [0.0, 2.0]) == pytest.approx(1e-3)
    assert math.isinf(reference.gap([math.nan], [1.0]))
    assert math.isinf(reference.gap([1.0], [1.0, 2.0]))


def test_inputs_repeat_for_a_seed_and_differ_between_seeds():
    a = inputs.soil(2**31 + 5, 64, 8, torch.float32, "cpu")
    b = inputs.soil(2**31 + 5, 64, 8, torch.float32, "cpu")
    c = inputs.soil(2**31 + 6, 64, 8, torch.float32, "cpu")
    assert torch.equal(a["hksat"], b["hksat"])
    assert not torch.equal(a["hksat"], c["hksat"])
    lat, n_land = inputs.land_latitudes(0.5, 0.29, 1024)
    assert (lat.shape[0], n_land) == (69632, 69322)
