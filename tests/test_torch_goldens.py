"""The port's plain day against the committed column goldens.

Port of tests/test_goldens.py's vector-kernel case: 30 days of the plain
hydrology day (zd09_every=1) and daily growth, in float64, for the
8-layer and 20-layer columns, against the float64 oracle's trajectory
(tests/goldens/*.npz), at that test's tolerances.
"""

import os

import numpy as np
import pytest
import torch

from hybrid9_tpu_torch import state as t_state
from hybrid9_tpu_torch.config import LayerGrid
from hybrid9_tpu_torch.data.synthetic import synthetic_forcing_day
from hybrid9_tpu_torch.physics.day_kernel import hydrology_day_plain
from hybrid9_tpu_torch.physics.grow import grow_daily
from hybrid9_tpu_torch.physics.hydrology import Geometry

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


@pytest.mark.parametrize("tag", ["8layer", "20layer"])
def test_plain_day_matches_golden(tag):
    d = np.load(os.path.join(GOLDEN_DIR, f"column_{tag}.npz"))
    g = LayerGrid.from_interfaces(tuple(d["zi"]))
    nl = g.nsoil
    f64 = torch.float64
    params = t_state.SoilParams.from_numpy(dict(
        theta_s=d["theta_s"][None], hksat=d["hksat"][None],
        lambda_=d["lambda_"][None], bsw=d["bsw"][None],
        psi_s=d["psi_s"][None], theta_m=np.zeros((1, nl)),
        fmax=[d["fmax"]]), f64, "cpu")
    soil = t_state.SoilState.from_numpy(dict(
        h2osoi_liq=d["h0"][None], zwt=[2.0], wa=[4000.0],
        smp=d["smp0"][None], h2osoi_liq_ma=np.zeros((1, nl))), f64, "cpu")
    veg = t_state.VegState.from_numpy(dict(
        plant_mass=[10.0], plant_foliage_mass=[1.5 / 0.023],
        plant_length=[100.0], rdepth=[30.0], lai=[1.5], lai_litter=[0.2],
        rootr=d["rootr"][None], c_labile=[0.0], n_labile=[0.0],
        p_labile=[0.0]), f64, "cpu")
    geom = Geometry.from_layer_grid(g)
    for day in range(int(d["n_days"])):
        f = t_state.Forcing.from_numpy(
            synthetic_forcing_day(1, day + 1, seed=int(d["seed"])), f64,
            "cpu")
        soil, _ = hydrology_day_plain(soil, veg, params, f, geom, 1800.0,
                                      48)
        veg, _, _ = grow_daily(veg, soil.smp, f.tas, geom.zi)
    np.testing.assert_allclose(soil.h2osoi_liq[0].numpy(), d["h"][-1],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(soil.zwt[0]), d["zwt"][-1], rtol=1e-6)
    np.testing.assert_allclose(float(veg.lai[0]), d["lai"][-1], rtol=1e-6)
