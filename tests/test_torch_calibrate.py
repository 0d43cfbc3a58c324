"""The port's adjoint calibration (``hybrid9_tpu_torch/calibrate.py``)
against the JAX package's ``calibrate.py``.

Against JAX in float64 on the same numpy inputs (N = 12 cells, 2 days,
nisurf 2): ``apply_multipliers`` (identity bitwise), one
``simulate_daily_et`` forward and ``et_loss`` with a mask at rtol 1e-9,
the per-cell gradient of ``et_loss`` with respect to hksat, bsw and psi_s
at rtol 1e-8 on columns that include a full aquifer, a saturated top
layer and a LAI on its floor, and the first Adam step against
``-lr g / (|g| + 1e-8)`` from JAX's gradient.  The JAX gradient is taken
under ``jax.disable_jit()``: the same value as the jitted one, without
minutes of compiling the nested scans' adjoint.  The gradient where a
value sits exactly on a bound is held at the module level, where the tie
is made on purpose: JAX's ``maximum``/``minimum``/``clip`` give half the
gradient there, ``torch.clamp`` all of it.

The cases held on the port alone are in tests/test_torch_calibrate_fit.py,
the site ``calibrate`` command in tests/test_torch_calibrate_cli.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid9_tpu import calibrate as j_cal
from hybrid9_tpu import state as j_state
from hybrid9_tpu.config import LayerGrid
from hybrid9_tpu.data.synthetic import (synthetic_forcing_day,
                                        synthetic_soil_params)
from hybrid9_tpu.physics.hydrology import Geometry as JGeometry
from hybrid9_tpu_torch import calibrate as t_cal
from hybrid9_tpu_torch.physics.hydrology import Geometry
from hybrid9_tpu_torch.weights import from_reference

from _torch_port import geom_tuples, to_port, tree_np

N = 12
NDAYS = 2
NISURF = 2
FIELDS = ("hksat", "bsw", "psi_s")
LR = 0.1


def _jax_case():
    """Float64 JAX inputs: synthetic soils (seed 3), the initial state with
    a full aquifer (wa = 5,000 mm) in cells 0, 3, 6, 9, a saturated top
    layer in cells 1, 4, 7, 10 and a LAI on its 0.001 floor in cells 2,
    5, 8, 11; day 120-121 forcing (seed 3); obs of 1 mm/day with four
    cells unobserved on the first day."""
    grid = LayerGrid.from_interfaces()
    nl = grid.nsoil
    p = synthetic_soil_params(N, seed=3)
    params = j_state.SoilParams(**{k: jnp.asarray(v, jnp.float64)
                                   for k, v in p.items()})
    s0 = j_state.initial_state(params, grid.dz, grid.zi, jnp.float64)
    h = np.array(s0.soil.h2osoi_liq)
    wa = np.array(s0.soil.wa)
    lai = np.array(s0.veg.lai)
    wa[0::3] = 5000.0
    h[1::3, 0] = p["theta_s"][1::3, 0] * grid.dz[0]
    lai[2::3] = 0.001
    s0 = s0.replace(
        soil=s0.soil.replace(h2osoi_liq=jnp.asarray(h), wa=jnp.asarray(wa)),
        veg=s0.veg.replace(lai=jnp.asarray(lai)))
    days = [synthetic_forcing_day(N, 120 + d, seed=3) for d in range(NDAYS)]
    forcing = j_state.Forcing(**{k: jnp.stack([jnp.asarray(d[k], jnp.float64)
                                               for d in days])
                                 for k in days[0]})
    obs = np.ones((NDAYS, N))
    mask = np.ones((NDAYS, N), bool)
    mask[0, ::4] = False
    return params, s0, forcing, JGeometry(*geom_tuples(grid)), obs, mask


@pytest.fixture(scope="module")
def case():
    """Both packages' inputs, and JAX's loss, per-cell gradient and daily
    ET on them."""
    params, s0, forcing, geom, obs, mask = _jax_case()
    theta = {f: jnp.zeros((N,), jnp.float64) for f in FIELDS}
    with jax.disable_jit():
        loss, grad = jax.value_and_grad(j_cal.et_loss)(
            theta, params, s0, forcing, geom, jnp.asarray(obs), NISURF,
            jnp.asarray(mask))
    evap = jax.jit(j_cal.simulate_daily_et, static_argnums=(4, 5))(
        theta, params, s0, forcing, geom, NISURF)
    port = dict(params=to_port(params), state=to_port(s0),
                forcing=to_port(forcing), geom=Geometry(*geom),
                obs=torch.tensor(obs), mask=torch.tensor(mask))
    return port, dict(loss=float(loss), evap=np.asarray(evap),
                      grad={k: np.asarray(v) for k, v in grad.items()})


def _theta(per_cell=True, requires_grad=False):
    return {f: torch.zeros(N if per_cell else (), dtype=torch.float64,
                           requires_grad=requires_grad) for f in FIELDS}


def test_apply_multipliers_identity_and_consistency(case):
    port, _ = case
    params = port["params"]
    same = t_cal.apply_multipliers(params, _theta(per_cell=False))
    for f in ("hksat", "psi_s", "bsw", "theta_s"):
        assert torch.equal(getattr(same, f), getattr(params, f)), f
    # A per-cell theta broadcasts over the layers, bsw keeps lambda_ =
    # 1/bsw, psi_s keeps its sign; the same numbers as JAX's.
    theta_np = dict(bsw=np.linspace(-0.4, 0.4, N), psi_s=np.full(N, 0.2),
                    fmax=np.linspace(0.1, -0.1, N))
    scaled = t_cal.apply_multipliers(
        params, from_reference("theta", theta_np, torch.float64, "cpu"))
    want = j_cal.apply_multipliers(
        j_state.SoilParams(**{k: jnp.asarray(v) for k, v in
                              tree_np(params).items()}),
        {k: jnp.asarray(v) for k, v in theta_np.items()})
    for f in ("bsw", "lambda_", "psi_s", "fmax", "hksat"):
        np.testing.assert_allclose(tree_np(getattr(scaled, f)),
                                   np.asarray(getattr(want, f)), rtol=1e-15,
                                   atol=0, err_msg=f)
    np.testing.assert_allclose(tree_np(scaled.lambda_),
                               1.0 / tree_np(scaled.bsw), rtol=1e-12)
    assert bool((scaled.psi_s < 0.0).all())
    with pytest.raises(ValueError):
        t_cal.apply_multipliers(params, {"theta_s": torch.zeros(())})


def test_forward_and_masked_loss_match_jax(case):
    port, want = case
    args = (port["params"], port["state"], port["forcing"], port["geom"])
    with torch.no_grad():
        evap = t_cal.simulate_daily_et(_theta(), *args, NISURF)
        loss = t_cal.et_loss(_theta(), *args, port["obs"], NISURF,
                             port["mask"])
    np.testing.assert_allclose(evap.numpy(), want["evap"], rtol=1e-9,
                               atol=1e-12)
    assert float(loss) == pytest.approx(want["loss"], rel=1e-9)


def test_per_cell_gradient_matches_jax(case):
    """The adjoint through two days of the plain day, checkpointed per
    day, against ``jax.grad`` at rtol 1e-8."""
    port, want = case
    theta = _theta(requires_grad=True)
    loss = t_cal.et_loss(theta, port["params"], port["state"],
                         port["forcing"], port["geom"], port["obs"], NISURF,
                         port["mask"])
    grads = torch.autograd.grad(loss, list(theta.values()))
    for f, g in zip(FIELDS, grads):
        assert np.all(np.isfinite(g.numpy())), f
        assert np.max(np.abs(want["grad"][f])) > 0.0, f
        np.testing.assert_allclose(g.numpy(), want["grad"][f], rtol=1e-8,
                                   atol=0, err_msg=f)


def test_first_adam_step_is_optax_first_step(case):
    """Adam's first update is ``-lr g / (|g| + eps)`` (bias-corrected
    moments of one gradient), torch's and optax's alike."""
    port, want = case
    spec = from_reference(
        "CalibrationSpec",
        j_cal.CalibrationSpec(fields=FIELDS, per_cell=True)._asdict(),
        torch.float64, "cpu")
    assert spec == t_cal.CalibrationSpec(fields=FIELDS, per_cell=True)
    res = t_cal.calibrate(port["params"], port["state"], port["forcing"],
                          port["geom"], port["obs"], spec=spec,
                          nisurf=NISURF, steps=1, learning_rate=LR,
                          obs_mask=port["mask"])
    assert res.loss_history.shape == (2,)
    assert float(res.loss_history[0]) == pytest.approx(want["loss"],
                                                       rel=1e-9)
    for f in FIELDS:
        g = want["grad"][f]
        np.testing.assert_allclose(res.theta[f].numpy(),
                                   -LR * g / (np.abs(g) + 1e-8), rtol=1e-8,
                                   atol=0, err_msg=f)


# --- the gradient where a value sits on a bound -----------------------------

def _tie_conductivity():
    """Saturated layers (theta == theta_s exactly): s_node and s1 sit on
    their bound of 1.  d sum(hk + smp) / d theta."""
    from hybrid9_tpu.physics.soilwater import _conductivity_and_potential
    from hybrid9_tpu_torch.physics.soilwater import \
        _conductivity_and_potential as t_cond
    p = synthetic_soil_params(6, seed=5)
    theta = p["theta_s"].copy()
    theta[::2] *= 0.7                     # every other cell unsaturated
    rest = [p["theta_s"], p["hksat"], p["psi_s"], p["bsw"]]

    def j_fn(th):
        hk, _, smp, _ = _conductivity_and_potential(
            [th[:, i] for i in range(8)],
            *[[jnp.asarray(a[:, i]) for i in range(8)] for a in rest])
        return sum(jnp.sum(x) for x in hk) + 1e-3 * sum(jnp.sum(x)
                                                        for x in smp)

    def t_fn(th):
        hk, _, smp, _ = t_cond(
            [th[:, i] for i in range(8)],
            *[[torch.tensor(a[:, i]) for i in range(8)] for a in rest])
        return sum(torch.sum(x) for x in hk) + 1e-3 * sum(torch.sum(x)
                                                          for x in smp)
    return theta, j_fn, t_fn


def _tie_aquifer():
    """A full aquifer whose day adds nothing it keeps: with no recharge and
    a table 30 m down, baseflow is below half an ulp of 5,000 mm, so
    ``wa_tmp`` sits exactly on the cap (spill and store both tie).
    d (sum wa + 3 sum h_bottom) / d qcharge."""
    from hybrid9_tpu.physics.drainage import drainage as j_drainage
    from hybrid9_tpu_torch.physics.drainage import drainage as t_drainage
    grid = LayerGrid.from_interfaces()
    nl, n, dt = grid.nsoil, 4, 1800.0
    p = synthetic_soil_params(n, seed=6)
    h = 0.4 * p["theta_s"] * grid.dz[None, :nl]
    zwt = np.full(n, 30.0)
    wa = np.full(n, 5000.0)
    assert 5000.0 - 5.5e-3 * np.exp(-2.5 * 30.0) * dt == 5000.0
    zi, dz = tuple(map(float, grid.zi)), tuple(map(float, grid.dz[:nl]))

    def call(fn, lib, q):
        t = (jnp.asarray if lib is jnp else torch.tensor)
        cols = [[t(a[:, i]) for i in range(nl)]
                for a in (h, p["theta_s"], p["psi_s"], p["bsw"])]
        eff = [lib.maximum(x, t(np.full(n, 0.01))) for x in cols[1]]
        out = fn(cols[0], t(zwt), t(wa), q, cols[1], cols[2], cols[3], eff,
                 zi, dz, dt)
        return lib.sum(out.wa) + 3.0 * lib.sum(out.h2osoi[nl - 1])
    return (np.zeros(n), lambda q: call(j_drainage, jnp, q),
            lambda q: call(t_drainage, torch, q))


def _tie_lai():
    """Growth that brings the LAI exactly onto its 0.001 floor, with
    numbers whose sums and products are exact in any order.
    d sum(lai) / d smp."""
    from hybrid9_tpu.physics.grow import grow_daily as j_grow
    from hybrid9_tpu_torch.physics import constants as c
    from hybrid9_tpu_torch.physics.grow import grow_daily as t_grow
    from hybrid9_tpu_torch.state import VegState
    grid = LayerGrid.from_interfaces()
    nl, n = grid.nsoil, 4
    smp = np.full((n, nl), -100000.0)           # each layer's wi_l is 0.5
    tas = np.full(n, c.TF + 18.0)
    pfm = np.array([4.2, 4.25, 4.3, 4.4])     # losses just above growth
    # grow_daily's arithmetic, operation by operation: w_i = 0.5, f_t,
    # foliage loss 0.1 pfm (w_i < 0.6); then the start LAI whose sum with
    # the day's change rounds to the floor exactly.
    d = tas - c.TF
    warm, cool = np.abs(d - 18.0) / 21.0, np.abs(d - 18.0) / 25.0
    f_t = np.where(d > 18.0, np.maximum(1.0 - warm * warm, 0.0),
                   np.clip(1.0 - cool * cool, 0.0, 1.0))
    grow_fm = (1000.0 / 365.0) * 0.5 * f_t / 3.3
    dlai = (grow_fm - 0.1 * pfm) * c.SLA
    lai0 = 0.001 - dlai
    for _ in range(4):
        lai0 = np.where(lai0 + dlai > 0.001, np.nextafter(lai0, 0.0),
                        np.where(lai0 + dlai < 0.001,
                                 np.nextafter(lai0, 1.0), lai0))
    assert np.all(lai0 + dlai == 0.001)
    veg = dict(plant_mass=np.full(n, 50.0), plant_foliage_mass=pfm,
               plant_length=np.full(n, 100.0), rdepth=np.full(n, 30.0),
               lai=lai0, lai_litter=np.full(n, 0.5),
               rootr=np.full((n, nl), 1.0 / nl), c_labile=np.zeros(n),
               n_labile=np.zeros(n), p_labile=np.zeros(n))

    def j_fn(s):
        v = j_state.VegState(**{k: jnp.asarray(a) for k, a in veg.items()})
        return jnp.sum(j_grow(v, s, jnp.asarray(tas), grid.zi)[0].lai)

    def t_fn(s):
        v = VegState.from_numpy(veg, torch.float64, "cpu")
        return torch.sum(t_grow(v, s, torch.tensor(tas), grid.zi)[0].lai)
    return smp, j_fn, t_fn


@pytest.mark.parametrize("make", [_tie_conductivity, _tie_aquifer, _tie_lai],
                         ids=["saturated_layer", "full_aquifer",
                              "lai_on_its_floor"])
def test_gradient_at_a_bound_is_jaxs(make):
    x, j_fn, t_fn = make()
    want = np.asarray(jax.grad(j_fn)(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    got = torch.autograd.grad(t_fn(xt), xt)[0].numpy()
    assert np.max(np.abs(want)) > 0.0
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
