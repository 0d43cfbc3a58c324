"""The port's adjoint calibration (``hybrid9_tpu_torch/calibrate.py``) on
the port alone, held to the properties ``tests/test_calibrate.py`` holds
the JAX package to: the float32 stress case whose ``beta`` near 1e-20 once
gave Inf gradients, the Adam fit recovering a perturbation (2 days at
nisurf 2 and 10 steps, where JAX runs 5 days at nisurf 16 and 30 steps),
and the mask's weight.  The comparisons with JAX are in
tests/test_torch_calibrate.py.
"""

import numpy as np
import torch

from hybrid9_tpu_torch import calibrate as t_cal
from hybrid9_tpu_torch.config import LayerGrid
from hybrid9_tpu_torch.data.synthetic import (synthetic_forcing_day,
                                              synthetic_soil_params)
from hybrid9_tpu_torch.physics.hydrology import Geometry
from hybrid9_tpu_torch.state import Forcing, SoilParams, initial_state

N = 12
NDAYS = 2
NISURF = 2
FIELDS = ("hksat", "bsw", "psi_s")

# Small tensors beside other test processes: one intra-op thread.
torch.set_num_threads(1)


def _port_problem(dtype=torch.float64, days=NDAYS, seed=3):
    grid = LayerGrid.from_interfaces()
    params = SoilParams.from_numpy(synthetic_soil_params(N, seed=seed), dtype,
                                   "cpu")
    state0 = initial_state(params, grid.dz, grid.zi, dtype, "cpu")
    blk = [synthetic_forcing_day(N, 120 + d, seed=seed) for d in range(days)]
    forcing = Forcing.from_numpy({k: np.stack([b[k] for b in blk])
                                  for k in blk[0]}, dtype, "cpu")
    return params, state0, forcing, Geometry.from_layer_grid(grid)


def test_sensitivity_gradients_flow():
    """float32 under extreme stress: a parched column's stomatal ``beta``
    near 1e-20 once overflowed ``1/beta`` to Inf in the adjoint (JAX
    physics/et.py:126-132).  The per-cell sensitivities stay finite and
    bsw moves ET somewhere."""
    from hybrid9_tpu_torch.physics import constants as c
    params, state0, forcing, geom = _port_problem(torch.float32)
    dry = torch.full_like(state0.soil.smp, c.SMPMIN)
    dry[::2] = state0.soil.smp[::2]       # half the cells parched
    state0 = state0.replace(soil=state0.soil.replace(smp=dry))
    sens = t_cal.parameter_sensitivity(params, state0, forcing, geom,
                                       fields=FIELDS, nisurf=NISURF)
    for f, g in sens.items():
        assert g.shape == (N,) and g.dtype == torch.float32, f
        assert bool(torch.isfinite(g).all()), f
    assert float(sens["bsw"].abs().max()) > 0.0


def test_calibration_recovers_perturbation():
    """Obs from perturbed-truth params; fitting from zero cuts the ET
    misfit well over half and moves toward the truth."""
    params, state0, forcing, geom = _port_problem()
    truth = {"bsw": torch.tensor(0.35, dtype=torch.float64),
             "psi_s": torch.tensor(-0.5, dtype=torch.float64)}
    with torch.no_grad():
        obs = t_cal.simulate_daily_et(truth, params, state0, forcing, geom,
                                      nisurf=NISURF)
    res = t_cal.calibrate(params, state0, forcing, geom, obs,
                          spec=t_cal.CalibrationSpec(fields=("bsw",
                                                             "psi_s")),
                          nisurf=NISURF, steps=10, learning_rate=0.1)
    hist = res.loss_history.numpy()
    assert hist.shape == (11,) and np.all(np.isfinite(hist))
    assert hist[-1] < 0.4 * hist[0], (hist[0], hist[-1])
    assert float(res.theta["bsw"]) > 0.0
    assert float(res.theta["psi_s"]) < 0.0


def test_obs_mask_weights_loss():
    params, state0, forcing, geom = _port_problem()
    theta = t_cal.CalibrationSpec(fields=("hksat",)).init_theta(
        N, torch.float64, "cpu")
    obs = torch.zeros((NDAYS, N), dtype=torch.float64)
    with torch.no_grad():
        full = t_cal.et_loss(theta, params, state0, forcing, geom, obs,
                             nisurf=NISURF)
        none = t_cal.et_loss(theta, params, state0, forcing, geom, obs,
                             nisurf=NISURF,
                             obs_mask=torch.zeros((NDAYS, N), dtype=bool))
    assert float(full) > 0.0
    assert float(none) == 0.0
