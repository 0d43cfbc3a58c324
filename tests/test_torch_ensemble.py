"""The port's parameter ensembles (``hybrid9_tpu_torch/ensemble.py``)
against the JAX package's ``ensemble.py``.

The members ride the folded cell axis (``j = cell*m + member``).  Against
JAX in float64 on the same multipliers (carried across by
``weights.from_reference``): ``run_ensemble_annual``'s member totals at
rtol 1e-9.  On the port alone, as ``tests/test_calibrate.py`` holds the
JAX package: member 0 (theta = 0) is the control run unfolded, and the
annual totals are the sums of the stacked dailies.  On the CPU a cell's
last bit can depend on its place in a tensor (ATen's vector body and
scalar tail), so member 0 is held at JAX's rtol 1e-10 here; on the card
it is bitwise (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid9_tpu import ensemble as j_ens
from hybrid9_tpu import state as j_state
from hybrid9_tpu.config import LayerGrid
from hybrid9_tpu.data.synthetic import (synthetic_forcing_day,
                                        synthetic_soil_params)
from hybrid9_tpu.physics.hydrology import Geometry as JGeometry
from hybrid9_tpu_torch import ensemble as t_ens
from hybrid9_tpu_torch.calibrate import apply_multipliers
from hybrid9_tpu_torch.physics import constants as c
from hybrid9_tpu_torch.physics.hydrology import Geometry
from hybrid9_tpu_torch.step import day_step
from hybrid9_tpu_torch.weights import from_reference

from _torch_port import geom_tuples, to_port

N = 12
NDAYS = 4
NISURF = 8


@pytest.fixture(scope="module")
def problem():
    """Float64 synthetic soils (seed 3), the initial state and day 120-123
    forcing, as JAX's and as the port's."""
    grid = LayerGrid.from_interfaces()
    p = synthetic_soil_params(N, seed=3)
    params = j_state.SoilParams(**{k: jnp.asarray(v, jnp.float64)
                                   for k, v in p.items()})
    state0 = j_state.initial_state(params, grid.dz, grid.zi, jnp.float64)
    days = [synthetic_forcing_day(N, 120 + d, seed=3) for d in range(NDAYS)]
    forcing = j_state.Forcing(**{k: jnp.stack([jnp.asarray(d[k], jnp.float64)
                                               for d in days])
                                 for k in days[0]})
    geom = geom_tuples(grid)
    return ((params, state0, forcing, JGeometry(*geom)),
            (to_port(params), to_port(state0), to_port(forcing),
             Geometry(*geom)))


def _theta(seed, m=3, sigma=0.4):
    g = torch.Generator().manual_seed(seed)
    return t_ens.perturbed_multipliers(g, m, sigma=sigma,
                                       dtype=torch.float64)


def test_perturbed_multipliers_keep_a_control():
    theta = _theta(0, m=5)
    assert set(theta) == {"hksat", "psi_s", "bsw"}
    for v in theta.values():
        assert v.shape == (5,) and float(v[0]) == 0.0
        assert float(v[1:].abs().min()) > 0.0
    again = _theta(0, m=5)
    assert all(torch.equal(theta[k], again[k]) for k in theta)
    with pytest.raises(ValueError):
        t_ens.perturbed_multipliers(torch.Generator(), 3, fields=("theta_s",))


def test_fold_is_cell_major():
    x = torch.arange(6.0).reshape(3, 2)
    folded = t_ens.fold(x, 4)
    assert folded.shape == (12, 2)
    assert torch.equal(folded[4 * 1 + 3], x[1])
    assert torch.equal(t_ens.unfold(folded, 4)[2], x)


def test_annual_ensemble_matches_jax(problem):
    """The folded annual ensemble on the same multipliers: every member's
    ET, runoff and NPP totals at rtol 1e-9."""
    (jp, js, jf, jg), (tp, ts, tf, tg) = problem
    theta_np = {k: v.numpy() for k, v in _theta(7).items()}
    want = j_ens.run_ensemble_annual(
        {k: jnp.asarray(v) for k, v in theta_np.items()}, jp, js, jf, jg,
        nisurf=NISURF)
    got = t_ens.run_ensemble_annual(
        from_reference("theta", theta_np, torch.float64, "cpu"), tp, ts, tf,
        tg, nisurf=NISURF)
    for k in ("evap", "runoff", "npp"):
        assert got[k].shape == (3, N), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-9, atol=1e-12, err_msg=k)


def test_ensemble_member0_matches_control(problem):
    """Member 0 (theta = 0) equals the plain day loop of the control."""
    _, (params, state0, forcing, geom) = problem
    res = t_ens.run_ensemble(_theta(0), params, state0, forcing, geom,
                             nisurf=NISURF)
    assert res.evap.shape == (3, NDAYS, N)
    assert res.final_states.soil.h2osoi_liq.shape == (3, N, 8)
    dt = c.SDAY / NISURF
    zero = torch.zeros((), dtype=torch.float64)
    control = apply_multipliers(params, {f: zero
                                         for f in ("hksat", "psi_s", "bsw")})
    state, evap = state0, []
    for d in range(NDAYS):
        state, diags = day_step(state, forcing.map(lambda x: x[d]), control,
                                geom, dt, NISURF)
        evap.append(diags["evap_day"])
    np.testing.assert_allclose(res.evap[0].numpy(), torch.stack(evap).numpy(),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(res.final_states.soil.zwt[0].numpy(),
                               state.soil.zwt.numpy(), rtol=1e-10, atol=1e-12)
    # Perturbed members genuinely differ from the control.
    mean, std = t_ens.ensemble_spread(res.evap)
    assert mean.shape == (NDAYS, N)
    assert float(std.max()) > 0.0
    np.testing.assert_allclose(std.numpy(), res.evap.numpy().std(axis=0),
                               rtol=1e-12, atol=1e-15)


def test_ensemble_annual_folded_matches_stacked(problem):
    """The annual totals are the stacked dailies summed, member for
    member."""
    _, (params, state0, forcing, geom) = problem
    theta = _theta(7)
    full = t_ens.run_ensemble(theta, params, state0, forcing, geom,
                              nisurf=NISURF)
    ann = t_ens.run_ensemble_annual(theta, params, state0, forcing, geom,
                                    nisurf=NISURF)
    assert ann["evap"].shape == (3, N)
    for k, daily in (("evap", full.evap), ("runoff", full.runoff),
                     ("npp", full.npp)):
        np.testing.assert_allclose(ann[k].numpy(), daily.sum(dim=1).numpy(),
                                   rtol=1e-10, atol=1e-10, err_msg=k)
