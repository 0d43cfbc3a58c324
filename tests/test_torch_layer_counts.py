"""The port's day at layer counts other than the canonical 8, against the
JAX package.

The Pallas day kernel takes any layer count (``pallas_day.py`` reads it
from the state's shape), so the port's plain twin, which the CUDA
kernel's run-time-layer-count build (``day_kernel_any``) is held against
on the card, is held here against JAX's Pallas kernel in interpret mode
at 5 and 10 layers (float64, with the impedance, at 1e-9) and against
JAX's XLA substeps in float32 at 10 layers.  The flagship block of three
days runs on a 10-layer soil made as a user makes it (a raw archive
regridded by ``prepare_soil``) in both packages at 1e-9.  Two limits of
the reference are reproduced: fewer than 3 layers fail in both packages'
day (infiltration reads the top three layers), and synthetic soil ignores
the layer grid, so a 10-layer ``zi_mm`` on synthetic soil fails in both
with the same shape error.  What the wrapper decides of a layer count is
held in test_torch_day_launch.py.
"""

import numpy as np
import pytest
import torch

from hybrid9_tpu.physics.pallas_day import pallas_hydrology_day
from hybrid9_tpu.physics.hydrology import Geometry as JGeometry
from hybrid9_tpu.step import _xla_day_substeps
from hybrid9_tpu_torch.config import exponential_interfaces
from hybrid9_tpu_torch.physics.day_kernel import hydrology_day_plain
from hybrid9_tpu_torch.physics.hydrology import Geometry

from _torch_port import (DT, F64_TOL, NISURF, assert_tree_close, check_day,
                         check_plain_day_against_xla, day_case, run_both)

CELLS = 64


@pytest.mark.parametrize("nl", [5, 10])
def test_plain_day_matches_pallas_interpret_f64(nl):
    """The twin against the TPU kernel itself at a layer count the CUDA
    kernel has no build of its own for: varied columns, the impedance,
    ZD09 refreshed every 8 substeps, float64 at 1e-9."""
    j, t, geom = day_case(nl, "float64", varied=True, n=CELLS)
    soil_j, diags_j = pallas_hydrology_day(
        j["soil"], j["veg"], j["params"], j["forcing"], JGeometry(*geom),
        DT, NISURF, block=CELLS, interpret=True, imp=j["imp"], zd09_every=8)
    soil_t, diags_t = hydrology_day_plain(
        t["soil"], t["veg"], t["params"], t["forcing"], Geometry(*geom), DT,
        NISURF, imp=t["imp"], zd09_every=8)
    want = dict(h2osoi_liq=soil_j.h2osoi_liq, zwt=soil_j.zwt, wa=soil_j.wa,
                smp=soil_j.smp, **diags_j)
    check_day(soil_t, diags_t, want, F64_TOL)


def test_plain_day_matches_xla_day_substeps_f32_10_layers():
    check_plain_day_against_xla("float32", 8, True, 10)


@pytest.mark.parametrize("package", ["jax", "port"])
def test_two_layers_fail_in_both_packages(package):
    """The reference's day reads the top three layers' conductivity for
    infiltration, so two layers fail there and in the twin alike (the
    CUDA wrapper refuses them before a launch, with MIN_NL)."""
    j, t, geom = day_case(2, "float64", varied=False, n=8)
    with pytest.raises(IndexError):
        if package == "jax":
            _xla_day_substeps(j["soil"], j["veg"], j["params"],
                              j["forcing"], JGeometry(*geom), DT, NISURF,
                              None, 1, None, None)
        else:
            hydrology_day_plain(t["soil"], t["veg"], t["params"],
                                t["forcing"], Geometry(*geom), DT, NISURF)


def test_flagship_block_on_a_10_layer_soil_matches_jax_f64(tmp_path):
    """``Config()``'s physics for three winter days on the soil a user
    makes with ``prep-soil --layers 10`` (a synthetic raw archive at 12
    degrees, regridded by each package): the state and the means at
    1e-9."""
    from hybrid9_tpu_torch.data.synthetic import synthesize_raw_soil_archive
    arch = synthesize_raw_soil_archive(str(tmp_path / "raw"),
                                       resolution_deg=12.0, factor=2,
                                       n_layers=10)
    jsim, sim, (want, want_means), (got, means), _ = run_both(
        "float64", days=3, zi_mm=tuple(exponential_interfaces(10)),
        soil_source="raw", soil_hwsd_path=arch["hwsd"],
        soil_bnu_dir=arch["bnu_dir"], soil_fmax_path=arch["fmax"],
        output_path=str(tmp_path / "out"))
    assert sim.state.soil.h2osoi_liq.shape == (sim.n, 10)
    assert got["swe"].max() > 1.0 and got["h2osoi_ice"].max() > 1.0
    assert means["max_abs_residual"].max() < 0.1
    assert_tree_close(got, want, 1e-9, 1e-9, "state")
    assert_tree_close(means, want_means, 1e-9, 1e-9, "means")


def test_synthetic_soil_ignores_the_layer_grid_in_both_packages():
    """Synthetic soil is made with 8 layers whatever ``zi_mm`` says
    (``hybrid9_tpu/data/soil.py:153-154``), so a 10-layer grid on it fails
    in the JAX package's initial state with a shape error; the port
    reproduces the fault.  A layer count other than 8 needs a NetCDF or
    raw soil."""
    import jax.numpy as jnp
    from hybrid9_tpu.config import Config as JConfig
    from hybrid9_tpu.data.soil import load_soil as j_load_soil
    from hybrid9_tpu.run import Simulation as JSimulation
    from hybrid9_tpu_torch.config import Config
    from hybrid9_tpu_torch.data.soil import load_soil
    from hybrid9_tpu_torch.run import Simulation
    kw = dict(resolution_deg=24.0, cell_block=16, nisurf=2, dtype="float64",
              zi_mm=tuple(exponential_interfaces(10)))
    jcfg = JConfig(use_pallas=False, **kw)
    jgrid, jparams = j_load_soil(jcfg, jnp.float64)
    assert jparams.theta_s.shape[1] == 8
    with pytest.raises(TypeError, match=r"\(\d+, 8\), \(1, 10\)"):
        JSimulation(jcfg, jparams, land_grid=jgrid)
    cfg = Config(**kw)
    grid, params = load_soil(cfg, torch.float64, "cpu")
    assert params.theta_s.shape[1] == 8
    with pytest.raises(RuntimeError, match=r"\(8\) must match .* \(10\)"):
        Simulation(cfg, params, land_grid=grid)
    np.testing.assert_array_equal(grid.cell_lat, jgrid.cell_lat)
