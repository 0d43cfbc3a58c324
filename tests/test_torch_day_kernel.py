"""The port's hydrology day (physics/day_kernel.py) against the JAX package.

``hydrology_day_plain``, the plain twin of the CUDA day kernel, is held
against JAX's Pallas day kernel (interpret mode) and, in float64 on
columns spread across regimes, against JAX's XLA substep loop
``step._xla_day_substeps`` at rtol 1e-9 (the float32 cases are in
test_torch_day_kernel_f32.py).  The dispatch sends CPU tensors to the
twin and never falls back; the CUDA kernel itself is compared with the
twin on the card (test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from hybrid9_tpu.physics.pallas_day import pallas_hydrology_day
from hybrid9_tpu_torch.entry import build_reference_case
from hybrid9_tpu_torch.physics import day_kernel
from hybrid9_tpu_torch.physics import soilwater as t_sw
from hybrid9_tpu_torch.step import day_step

from _torch_port import F32_TOL, N, check_day, check_plain_day_against_xla


@pytest.mark.parametrize("nl", [8, 20])
@pytest.mark.parametrize("imp", [False, True])
@pytest.mark.parametrize("zd09_every", [1, 8])
def test_plain_day_matches_xla_day_substeps_f64(zd09_every, imp, nl):
    check_plain_day_against_xla("float64", zd09_every, imp, nl)


def test_plain_day_matches_pallas_interpret():
    """The twin against the TPU kernel itself (Pallas interpret mode),
    on the reference case at zd09_every=8 in float32."""
    _, state, forcing, params, geom, cfg = ge._build(N)
    soil_j, diags_j = pallas_hydrology_day(
        state.soil, state.veg, params, forcing, geom, cfg.dt, cfg.nisurf,
        block=N, interpret=True, zd09_every=8)
    case = build_reference_case(N, "float32", "cpu")
    soil_t, diags_t = day_kernel.hydrology_day_plain(
        case.state.soil, case.state.veg, case.params, case.forcing,
        case.geom, case.cfg.dt, case.cfg.nisurf, zd09_every=8)
    want = dict(h2osoi_liq=soil_j.h2osoi_liq, zwt=soil_j.zwt, wa=soil_j.wa,
                **diags_j)
    check_day(soil_t, diags_t, want, F32_TOL)


def test_cached_profile_aquifer_entry_is_fresh():
    """Port of tests/test_zd09_refresh.py:88: a cached ZD09 profile taken
    with the table in the column keeps a zeroed aquifer entry; the port's
    soil_water_update must recompute that entry when the table has moved
    below the column."""
    n, nl = 64, 8
    case = build_reference_case(n, "float64", "cpu")
    params, geom = case.params, case.geom
    dz = geom.dz_soil

    def cols(x):
        return [x[:, i] for i in range(x.shape[1])]

    h = params.theta_s * 0.95 * torch.tensor(dz, dtype=torch.float64)
    zi_bot = geom.zi[nl] / 1000.0
    zwt_in = torch.full((n,), zi_bot - 0.01, dtype=torch.float64)
    zwt_below = torch.full((n,), zi_bot + 0.05, dtype=torch.float64)
    ts, ps, bs = cols(params.theta_s), cols(params.psi_s), cols(params.bsw)
    infl = torch.full((n,), 1.0e-6, dtype=torch.float64)
    tran = torch.full((n,), 1.0e-7, dtype=torch.float64)

    def run(zwt_now, zq):
        return t_sw.soil_water_update(
            cols(h), [h[:, i] / dz[i] for i in range(nl)], zwt_now, ts,
            cols(params.hksat), ps, bs, infl, tran,
            cols(case.state.veg.rootr), geom.zi, dz, geom.zc_soil,
            case.cfg.dt, zq=zq)

    zq_stale = t_sw.compute_equilibrium_zq(zwt_in, ts, ps, bs, geom.zi)
    zq_fresh = t_sw.compute_equilibrium_zq(zwt_below, ts, ps, bs, geom.zi)
    assert float(zq_stale[nl].abs().max()) == 0.0
    assert float(zq_fresh[nl].abs().min()) > 100.0
    qs = run(zwt_below, zq_stale).qcharge.numpy()
    qf = run(zwt_below, zq_fresh).qcharge.numpy()
    assert np.all(np.isfinite(qs))
    assert np.all(np.sign(qs) == np.sign(qf))
    np.testing.assert_allclose(qs, qf, rtol=0.5)


def test_dispatch_sends_cpu_tensors_to_the_twin():
    case = build_reference_case(32, "float64", "cpu")
    args = (case.state.soil, case.state.veg, case.params, case.forcing,
            case.geom, case.cfg.dt, case.cfg.nisurf)
    before = day_kernel.launches
    got = day_kernel.hydrology_day(*args, zd09_every=8)
    want = day_kernel.hydrology_day_plain(*args, zd09_every=8)
    assert day_kernel.launches == before
    torch.testing.assert_close(got[0].h2osoi_liq, want[0].h2osoi_liq,
                               rtol=0, atol=0)


def test_use_kernel_on_cpu_tensors_raises():
    case = build_reference_case(32, "float32", "cpu")
    args = (case.state.soil, case.state.veg, case.params, case.forcing,
            case.geom, case.cfg.dt, case.cfg.nisurf)
    with pytest.raises(ValueError, match="CUDA"):
        day_kernel.hydrology_day(*args, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        day_kernel.hydrology_day_cuda(*args)
    with pytest.raises(ValueError, match="CUDA"):
        day_step(case.state, case.forcing, case.params, case.geom,
                 case.cfg.dt, case.cfg.nisurf, use_kernel=True)
