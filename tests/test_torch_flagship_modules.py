"""The modules of the port's flagship day, each against the JAX package.

Snow (``snow_step``, ``snow_absorptivity``), frozen soil
(``freeze_impedance``, ``freeze_impedance_from_ice``, ``phase_change``
with its two conservation laws, ``column_energy``), carbon
(``decomposition_modifiers``, ``carbon_daily``) and the module that holds
the kernel (``hydrology_day_plain`` with the impedance operand and the
shortwave absorptivity): float64 at rtol 1e-9 on inputs that reach every
branch, float32 at 1e-5 where two math libraries run pow or exp.  The
day as a whole is in test_torch_flagship.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid9_tpu import state as j_state
from hybrid9_tpu.physics import carbon as j_carbon
from hybrid9_tpu.physics import constants as c
from hybrid9_tpu.physics import snow as j_snow
from hybrid9_tpu.physics import soiltemp as j_soiltemp
from hybrid9_tpu.physics.hydrology import Geometry as JGeometry
from hybrid9_tpu.physics.pallas_day import pallas_hydrology_day
from hybrid9_tpu.step import _xla_day_substeps
from hybrid9_tpu.step import snow_absorptivity as j_snow_absorptivity
from hybrid9_tpu_torch.physics import carbon as t_carbon
from hybrid9_tpu_torch.physics import snow as t_snow
from hybrid9_tpu_torch.physics import soiltemp as t_soiltemp
from hybrid9_tpu_torch.physics.day_kernel import hydrology_day_plain
from hybrid9_tpu_torch.physics.hydrology import Geometry
from hybrid9_tpu_torch.step import snow_absorptivity

from _torch_port import (DT, F32_TOL, F64_TOL, NISURF, assert_close,
                         assert_tree_close, check_day, day_case, to_port,
                         tree_np)

N = 384
DZ = (45.0, 46.0, 75.0, 123.0, 204.0, 336.0, 554.0, 913.0)
#: (rtol, atol) per dtype for one elementwise module; float32 runs pow
#: and exp of two math libraries, which differ in the last ulps.
TOL = {"float64": (1e-9, 1e-12), "float32": (1e-5, 1e-6)}


def _both(a, dtype="float64"):
    return jnp.asarray(a, jnp.dtype(dtype)), torch.tensor(
        a, dtype=getattr(torch, dtype))


def _columns(seed=0):
    """Soil columns that reach every branch of the freeze/thaw code:
    temperatures on both sides of TF (and exactly on it), ice with and
    without the heat to melt it, liquid at the WATMIN floor."""
    rng = np.random.RandomState(seed)
    t = c.TF + rng.uniform(-12.0, 12.0, (N, 8))
    t[::9] = c.TF
    t[1::9] = c.TF + rng.uniform(0.0, 0.02, t[1::9].shape)   # little heat
    theta_s = rng.uniform(0.3, 0.55, (N, 8))
    liq = rng.uniform(0.0, 1.0, (N, 8)) * theta_s * np.asarray(DZ)
    liq[2::7] = 0.005                                        # under WATMIN
    ice = rng.uniform(0.0, 0.6, (N, 8)) * theta_s * np.asarray(DZ)
    ice[::5] = 0.0
    return t, liq, ice, theta_s


# --- snow -----------------------------------------------------------------

def _snow_inputs(seed=1):
    rng = np.random.RandomState(seed)
    swe = rng.uniform(0.0, 400.0, N)
    swe[::6] = 0.0
    swe[1::6] = rng.uniform(990.0, 1010.0, len(swe[1::6]))  # at the cap
    tas = c.TF + rng.uniform(-15.0, 15.0, N)                # ramp and past
    tas[::11] = c.TF
    pr = np.where(rng.uniform(size=N) < 0.6, rng.exponential(2e-4, N), 0.0)
    return swe, tas, pr


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_snow_step_matches_jax(dtype):
    swe, tas, pr = _snow_inputs()
    j, t = zip(*(_both(x, dtype) for x in (swe, tas, pr)))
    want = j_snow.snow_step(*j, j_snow.SnowParams(ddf=2.5))
    p = to_port(j_snow.SnowParams(ddf=2.5))
    assert p == t_snow.SnowParams(ddf=2.5)
    got = t_snow.snow_step(*t, p)
    for g, w, name in zip(got, want, ("swe", "pr_eff", "melt", "capped")):
        assert g.dtype == getattr(torch, dtype)
        assert_close(g, w, *TOL[dtype], name)
    swe_new, pr_eff, melt, capped = (tree_np(g) for g in got)
    assert capped.max() > 0.0 and melt.max() > 0.0 and swe_new.max() == 1000.0
    if dtype == "float64":      # swe' - swe + rain_eff + capped = pr
        np.testing.assert_allclose(swe_new - swe + pr_eff * c.SDAY + capped,
                                   pr * c.SDAY, atol=1e-9)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_snow_absorptivity_matches_jax(dtype):
    swe = _snow_inputs()[0]
    j, t = _both(swe, dtype)
    got = snow_absorptivity(t, 0.7, 10.0)
    assert got.dtype == getattr(torch, dtype)
    assert_close(got, j_snow_absorptivity(j, 0.7, 10.0), *TOL[dtype])
    assert float(got.max()) == pytest.approx(0.92) and float(got.min()) < 0.31


# --- frozen soil ------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_freeze_impedance_matches_jax(dtype):
    t = _columns()[0]
    j, tt = _both(t, dtype)
    got = t_soiltemp.freeze_impedance(tt)
    assert got.dtype == getattr(torch, dtype)
    assert_close(got, j_soiltemp.freeze_impedance(j), *TOL[dtype])
    g = tree_np(got)
    assert np.all(g[t >= c.TF] == 1.0) and g.min() == pytest.approx(1e-6)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_freeze_impedance_from_ice_matches_jax(dtype):
    _, liq, ice, _ = _columns()
    liq[3::8], ice[3::8] = 0.0, 0.0           # empty layer: 0 / 1e-12
    (lj, lt), (ij, it) = _both(liq, dtype), _both(ice, dtype)
    got = t_soiltemp.freeze_impedance_from_ice(lt, it)
    assert got.dtype == getattr(torch, dtype)
    assert_close(got, j_soiltemp.freeze_impedance_from_ice(lj, ij),
                 *TOL[dtype])
    assert np.all(tree_np(got)[ice == 0.0] == 1.0)


def test_phase_change_matches_jax_and_conserves():
    t, liq, ice, theta_s = _columns()
    j, tt = zip(*(_both(x) for x in (t, liq, ice, theta_s)))
    want = j_soiltemp.phase_change(*j, DZ)
    got = t_soiltemp.phase_change(*tt, DZ)
    for g, w, name in zip(got, want, ("t", "liq", "ice")):
        assert_close(g, w, 1e-9, 1e-12, name)
    t_new, liq_new, ice_new = (tree_np(g) for g in got)
    froze, melted = (ice_new > ice + 1e-9), (ice_new < ice - 1e-9)
    assert froze.any() and melted.any() and (~froze & ~melted).any()
    # Ice left with the heat spent (T' == TF) and ice all gone (T' > TF).
    assert (melted & (ice_new > 0)).any() and (melted & (ice_new == 0)).any()
    # Total water is invariant ...
    np.testing.assert_allclose(liq_new + ice_new, liq + ice, rtol=1e-13)
    # ... and the sensible heat exchanged is (freeze - melt) * LFUS.
    dz_m = np.asarray(DZ) / 1000.0
    hc = (t_soiltemp.C_SOLID * (1.0 - theta_s)
          + t_soiltemp.C_WATER * liq / (dz_m * 1000.0)
          + t_soiltemp.C_ICE * ice / (dz_m * 1000.0)) * dz_m
    np.testing.assert_allclose(hc * (t_new - t), (ice_new - ice) * c.LFUS,
                               rtol=1e-9, atol=1e-3)
    # No overshoot of TF from either side; the liquid floor is kept.
    assert np.all((t_new - c.TF) * (t - c.TF) >= -1e-9)
    floor = t_soiltemp.WATMIN
    assert np.all(liq_new[liq > floor] >= floor - 1e-12)


def test_column_energy_matches_jax():
    t, liq, _, theta_s = _columns()
    theta = liq / np.asarray(DZ)
    j, tt = zip(*(_both(x) for x in (t, theta, theta_s)))
    assert_close(t_soiltemp.column_energy(*tt, DZ),
                 j_soiltemp.column_energy(*j, DZ), 1e-12, 0.0)


# --- carbon -----------------------------------------------------------------

def _carbon_inputs(seed=2):
    rng = np.random.RandomState(seed)
    t, liq, _, theta_s = _columns(seed)
    theta = liq / np.asarray(DZ)
    theta[::4] = 0.0                          # dry: f_W = 0
    theta[1::4] = theta_s[1::4]               # saturated: anoxic fall
    pools = dict(c_litter=rng.uniform(0, 300, N),
                 c_soil_fast=rng.uniform(0, 3000, N),
                 c_soil_slow=rng.uniform(0, 9000, N))
    prod = rng.uniform(-0.5, 3.0, N)
    litter = rng.uniform(-0.2, 2.0, N)        # negative: clamped to 0
    return t, theta, theta_s, pools, prod, litter


def test_decomposition_modifiers_match_jax():
    t, theta, theta_s, *_ = _carbon_inputs()
    j, tt = zip(*(_both(x) for x in (t, theta, theta_s)))
    got = t_carbon.decomposition_modifiers(*tt)
    for g, w in zip(got, j_carbon.decomposition_modifiers(*j)):
        assert_close(g, w, 1e-9, 1e-12)
    f_w = tree_np(got[1])
    assert f_w.min() == 0.0 and f_w.max() > 0.9 and (f_w == 0.6).any()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_carbon_daily_matches_jax(dtype):
    t, theta, theta_s, pools, prod, litter = _carbon_inputs()
    jd = jnp.dtype(dtype)
    cs_j = j_state.CarbonState(**{k: jnp.asarray(v, jd)
                                  for k, v in pools.items()})
    j, tt = zip(*(_both(x, dtype) for x in (prod, litter, t, theta,
                                             theta_s)))
    want = j_carbon.carbon_daily(cs_j, *j, return_fluxes=True)
    got = t_carbon.carbon_daily(to_port(cs_j, dtype), *tt,
                                return_fluxes=True)
    assert_tree_close(tree_np(got), tree_np(want), *TOL[dtype], "carbon")
    assert len(t_carbon.carbon_daily(to_port(cs_j, dtype), *tt)) == 3
    if dtype == "float64":      # d(pools) = litterfall_C - rh
        new, rh, nee, fx = (tree_np(g) for g in got)
        np.testing.assert_allclose(
            sum(new.values()) - sum(pools.values()), fx["c_lit_in"] - rh,
            atol=1e-9)
        np.testing.assert_allclose(nee, rh - 0.47 * prod, rtol=1e-12)


# --- the module that holds the kernel, with imp and sw_abs -------------------

def _sw_abs(dtype):
    a = np.random.RandomState(7).uniform(0.3, 0.92, 256)
    return _both(a, dtype)


@pytest.mark.parametrize("zd09_every", [1, 8])
def test_plain_day_with_imp_and_sw_abs_matches_xla_f64(zd09_every):
    j, t, geom = day_case(8, "float64", varied=True)
    a_j, a_t = _sw_abs("float64")
    soil, evap, evap_grnd, rnf, max_res, _ = _xla_day_substeps(
        j["soil"], j["veg"], j["params"], j["forcing"], JGeometry(*geom),
        DT, NISURF, j["imp"], zd09_every, a_j, None)
    want = dict(h2osoi_liq=soil.h2osoi_liq, zwt=soil.zwt, wa=soil.wa,
                smp=soil.smp, evap_day=evap, evap_grnd_day=evap_grnd,
                rnf_day=rnf)
    args = (t["soil"], t["veg"], t["params"], t["forcing"], Geometry(*geom),
            DT, NISURF)
    got = hydrology_day_plain(*args, imp=t["imp"], zd09_every=zd09_every,
                              sw_abs=a_t)
    check_day(*got, want, F64_TOL)
    # sw_abs reaches the radiation: without it the day differs.
    plain = hydrology_day_plain(*args, imp=t["imp"], zd09_every=zd09_every)
    assert float((plain[1]["evap_day"] - got[1]["evap_day"]).abs().max()) \
        > 1e-3


def test_plain_day_with_imp_and_sw_abs_matches_pallas_interpret():
    """The twin against the TPU kernel itself (Pallas interpret mode) in
    float32 at zd09_every=8, with the impedance operand and the
    absorptivity, at the tolerances of tests/test_pallas_day.py."""
    j, t, geom = day_case(8, "float32", varied=False)
    a_j, a_t = _sw_abs("float32")
    soil_j, diags_j = pallas_hydrology_day(
        j["soil"], j["veg"], j["params"], j["forcing"], JGeometry(*geom),
        DT, NISURF, block=256, interpret=True, imp=j["imp"], zd09_every=8,
        sw_abs=a_j)
    got = hydrology_day_plain(
        t["soil"], t["veg"], t["params"], t["forcing"], Geometry(*geom),
        DT, NISURF, imp=t["imp"], zd09_every=8, sw_abs=a_t)
    assert got[0].h2osoi_liq.dtype == torch.float32
    check_day(*got, dict(h2osoi_liq=soil_j.h2osoi_liq, zwt=soil_j.zwt,
                         wa=soil_j.wa, **diags_j), F32_TOL)
