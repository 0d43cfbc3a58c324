"""The port's day on the edge states, against the JAX package.

The columns of tests/test_edge_states.py::_build_edge_ensemble sit on the
branch boundaries of the drainage and water-table walks: tables exactly
on each interface, at the surface, at the 80 m clamp and 1e-6 m below the
column; every layer at WATMIN; a saturated column; the top or the bottom
layer at half WATMIN.  ``chip_smoke.check_case(..., "edge")`` builds them
with numpy in the port's own code, under the three forcings of that test
(deluge, dry heat, frozen calm), at any layer count.  Here the plain twin
of the CUDA day kernel is held against JAX's XLA substep loop
(``step._xla_day_substeps``) on the same columns, in float64 at 1e-9, at
the canonical 8 layers and on the 10- and 20-layer grids; the card holds
the kernel against the twin on the same columns (test_torch_cuda.py,
chip_smoke.py phase 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from hybrid9_tpu import state as j_state
from hybrid9_tpu.physics.hydrology import Geometry as JGeometry
from hybrid9_tpu.step import _xla_day_substeps
from hybrid9_tpu_torch.physics import constants as c
from hybrid9_tpu_torch.physics.day_kernel import hydrology_day_plain

from _torch_port import DT, F64_TOL, NISURF, check_day, tree_np

CELLS = chip_smoke.EDGE_COLUMNS * len(chip_smoke.EDGE_FORCINGS)


def test_edge_columns_are_the_reference_tests_at_8_layers():
    """At 8 layers the columns are _build_edge_ensemble's: tables on the
    interfaces 1 to 9, at 0, at 80 m and 1e-6 m below the column, and the
    four special fills."""
    soil, veg, params, forcing, geom, _ = chip_smoke.check_case(
        CELLS, 8, torch.float64, "cpu", "edge")
    zwt = soil.zwt.numpy()[:chip_smoke.EDGE_COLUMNS]
    h = soil.h2osoi_liq.numpy()[:chip_smoke.EDGE_COLUMNS]
    k = np.arange(chip_smoke.EDGE_COLUMNS) % 16
    zi_m = np.asarray(geom.zi) / 1000.0
    np.testing.assert_array_equal(zwt[k < 9], zi_m[1 + k[k < 9]])
    assert (zwt[k == 9] == 0.0).all() and (zwt[k == 10] == 80.0).all()
    np.testing.assert_array_equal(zwt[k == 11], zi_m[8] + 1e-6)
    assert (h[k == 12] == c.WATMIN).all()
    dz = np.asarray(geom.dz_soil)
    np.testing.assert_allclose(h[k == 13], params.theta_s.numpy()[
        :chip_smoke.EDGE_COLUMNS][k == 13] * dz, rtol=1e-15)
    assert (h[k == 14, -1] == 0.5 * c.WATMIN).all()
    assert (h[k == 15, 0] == 0.5 * c.WATMIN).all()
    tas = forcing.tas.numpy()
    assert sorted(set(tas)) == [258.0, 288.0, 313.0]


@pytest.mark.parametrize("nl,zd09_every,imp", [(8, 1, False), (10, 8, True),
                                               (20, 8, True)])
def test_plain_day_matches_xla_day_substeps_on_edge_states(nl, zd09_every,
                                                           imp):
    soil, veg, params, forcing, geom, imp_t = chip_smoke.check_case(
        CELLS, nl, torch.float64, "cpu", "edge")
    zi_m = np.asarray(geom.zi[1:nl + 2]) / 1000.0
    assert set(zi_m) <= set(soil.zwt.numpy())

    def jax_of(cls, obj):
        return cls(**{k: jnp.asarray(v, jnp.float64)
                      for k, v in tree_np(obj).items()})
    j_soil = jax_of(j_state.SoilState, soil)
    want_soil, evap, evap_grnd, rnf, max_res, _ = _xla_day_substeps(
        j_soil, jax_of(j_state.VegState, veg),
        jax_of(j_state.SoilParams, params),
        jax_of(j_state.Forcing, forcing), JGeometry(*geom), DT, NISURF,
        jnp.asarray(imp_t.numpy()) if imp else None, zd09_every, None,
        None)
    with torch.inference_mode():      # no autograd bookkeeping: faster
        got_soil, got_diags = hydrology_day_plain(
            soil, veg, params, forcing, geom, DT, NISURF,
            imp=imp_t if imp else None, zd09_every=zd09_every)
    want = dict(h2osoi_liq=want_soil.h2osoi_liq, zwt=want_soil.zwt,
                wa=want_soil.wa, smp=want_soil.smp, evap_day=evap,
                evap_grnd_day=evap_grnd, rnf_day=rnf)
    check_day(got_soil, got_diags, want, F64_TOL)
    np.testing.assert_allclose(tree_np(got_diags["max_abs_residual"]),
                               np.asarray(max_res), rtol=1e-6, atol=1e-9)
