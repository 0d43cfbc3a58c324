"""The port's hydrology day in float32 against the JAX package.

``hydrology_day_plain`` (the plain twin of the CUDA day kernel) against
JAX's ``step._xla_day_substeps`` in float32, at the tolerances of
tests/test_pallas_day.py, on initial states (water tables below the
column, where float32 is well conditioned; the regimes are covered in
float64 by test_torch_day_kernel.py), and the knife-edge water-table
regression of tests/test_zd09_refresh.py run through the port.
"""

import pytest
import torch

from hybrid9_tpu_torch.entry import build_reference_case
from hybrid9_tpu_torch.step import day_step

from _torch_port import check_plain_day_against_xla


@pytest.mark.parametrize("nl", [8, 20])
@pytest.mark.parametrize("imp", [False, True])
@pytest.mark.parametrize("zd09_every", [1, 8])
def test_plain_day_matches_xla_day_substeps_f32(zd09_every, imp, nl):
    check_plain_day_against_xla("float32", zd09_every, imp, nl)


def test_knife_edge_water_table_survives_zd09_interval():
    """Port of tests/test_zd09_refresh.py:150: a column whose water table
    sits exactly on the column-bottom interface stays finite and
    conserving for 30 days at zd09_every=8 in float32."""
    n, nl = 64, 8
    case = build_reference_case(n, "float32", "cpu")
    state, params, geom, cfg = case.state, case.params, case.geom, case.cfg
    dz = torch.tensor(geom.dz_soil, dtype=torch.float32)
    state = state.replace(soil=state.soil.replace(
        h2osoi_liq=params.theta_s * 0.97 * dz[None, :],
        zwt=torch.full((n,), geom.zi[nl] / 1000.0, dtype=torch.float32),
        wa=torch.full((n,), 4500.0, dtype=torch.float32)))
    worst = 0.0
    for _ in range(30):
        state, diags = day_step(state, case.forcing, params, geom, cfg.dt,
                                cfg.nisurf, zd09_every=8)
        worst = max(worst, float(diags["max_abs_residual"].max()))
    for x in (state.soil.wa, state.soil.zwt, state.soil.h2osoi_liq):
        assert bool(torch.isfinite(x).all())
    assert worst < 0.1
