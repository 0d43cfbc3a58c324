"""The port's column physics against the JAX package, module by module.

Same numpy inputs through both, in float64, at n = 256 cells: water
tables inside, on and below the column, near-dry layers at the SMPMIN
clamp.  rtol 1e-9 is the oracle parity of tests/test_hydrology_parity.py;
the atol terms cover fields that cross zero.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid9_tpu.physics import et as j_et
from hybrid9_tpu.physics import grow as j_grow
from hybrid9_tpu.physics import hydrology as j_hy
from hybrid9_tpu.physics import layers as j_layers
from hybrid9_tpu.physics import soiltemp as j_st
from hybrid9_tpu.physics import soilwater as j_sw
from hybrid9_tpu import state as j_state
# hybrid9_tpu.physics re-exports the function ``drainage`` under the
# module's name, so take the module from the import system.
j_dr = importlib.import_module("hybrid9_tpu.physics.drainage")
from hybrid9_tpu_torch.physics import drainage as t_dr
from hybrid9_tpu_torch.physics import et as t_et
from hybrid9_tpu_torch.physics import grow as t_grow
from hybrid9_tpu_torch.physics import hydrology as t_hy
from hybrid9_tpu_torch.physics import layers as t_layers
from hybrid9_tpu_torch.physics import soiltemp as t_st
from hybrid9_tpu_torch.physics import soilwater as t_sw
from hybrid9_tpu_torch import state as t_state

from _torch_port import (assert_close, assert_tree_close, columns, geom_tuples,
                         grid_for, jnp_list, t_list, tree_np)

N = 256
RTOL = 1e-9
F64 = jnp.float64
T64 = torch.float64


def _inputs(nl=8, seed=0):
    col = columns(N, nl, seed)
    zi, dz, zc = geom_tuples(grid_for(nl))
    p = col["params"]
    j = dict(h=jnp_list(col["h"]), smp=jnp_list(col["smp"]),
             rootr=jnp_list(col["rootr"]), imp=jnp_list(col["imp"]),
             **{k: jnp_list(p[k]) for k in ("theta_s", "hksat", "psi_s",
                                             "bsw")},
             **{k: jnp.asarray(col[k], F64)
                for k in ("zwt", "wa", "lai", "lai_litter")},
             fmax=jnp.asarray(p["fmax"], F64),
             forcing=j_state.Forcing(**{k: jnp.asarray(v, F64)
                                        for k, v in col["forcing"].items()}))
    t = dict(h=t_list(col["h"]), smp=t_list(col["smp"]),
             rootr=t_list(col["rootr"]), imp=t_list(col["imp"]),
             **{k: t_list(p[k]) for k in ("theta_s", "hksat", "psi_s",
                                           "bsw")},
             **{k: torch.as_tensor(col[k], dtype=T64)
                for k in ("zwt", "wa", "lai", "lai_litter")},
             fmax=torch.as_tensor(p["fmax"], dtype=T64),
             forcing=t_state.Forcing.from_numpy(col["forcing"], T64, "cpu"))
    for d in (j, t):
        d["theta"] = [d["h"][i] / dz[i] for i in range(nl)]
    return col, (zi, dz, zc), j, t


def test_layers_select_layer():
    rng = np.random.RandomState(0)
    cols = rng.normal(size=(N, 8))
    idx = rng.randint(-1, 10, size=N)
    got = t_layers.select_layer(t_list(cols), torch.as_tensor(idx), 7.5)
    want = j_layers.select_layer(jnp_list(cols), jnp.asarray(idx), 7.5)
    assert_close(got, want, 0, 0)
    assert_close(t_layers.stack(t_layers.unstack(torch.as_tensor(cols))),
                 cols, 0, 0)


def test_derive_forcing_and_daily_et_context():
    _, _, j, t = _inputs()
    sw_abs = np.linspace(0.3, 0.92, N)
    for a in (None, sw_abs):
        fd_j = j_hy.derive_forcing(
            j["forcing"], None if a is None else jnp.asarray(a, F64))
        fd_t = t_hy.derive_forcing(
            t["forcing"], None if a is None else torch.as_tensor(a))
        for k in fd_j:
            assert_close(fd_t[k], fd_j[k], RTOL, 0, k)
    ctx_j = j_et.daily_et_context(fd_j, j["lai"])
    ctx_t = t_et.daily_et_context(fd_t, t["lai"])
    for k in ctx_j:
        assert_close(ctx_t[k], ctx_j[k], RTOL, 0, k)


@pytest.mark.parametrize("seed", [0, 1])
def test_dual_source_et(seed):
    _, (zi, dz, zc), j, t = _inputs(seed=seed)
    out = []
    for pkg, d, hy in (("jax", j, j_hy), ("torch", t, t_hy)):
        et = (j_et if pkg == "jax" else t_et)
        fd = hy.derive_forcing(d["forcing"])
        out.append(et.dual_source_et(d["theta"], d["theta_s"], d["smp"],
                                     d["rootr"], d["lai"], d["lai_litter"],
                                     zc, dz[0], 1800.0, fd))
    want, got = out
    for k in ("qflx_tran_veg", "qflx_evap_grnd", "beta"):
        assert_close(getattr(got, k), getattr(want, k), RTOL, 1e-18, k)


def _sw_args(d, zi, dz, zc, infl, tran, imp, zq):
    return (d["h"], d["theta"], d["zwt"], d["theta_s"], d["hksat"],
            d["psi_s"], d["bsw"], infl, tran, d["rootr"], zi, dz, zc,
            1800.0), dict(imp=d["imp"] if imp else None, zq=zq)


@pytest.mark.parametrize("nl", [8, 20])
@pytest.mark.parametrize("imp", [False, True])
@pytest.mark.parametrize("cached", [False, True])
def test_soil_water_update(nl, imp, cached):
    col, (zi, dz, zc), j, t = _inputs(nl)
    rng = np.random.RandomState(5)
    infl = rng.uniform(0.0, 2e-3, N)
    tran = rng.uniform(0.0, 5e-5, N)
    # A cached profile taken at another table position: the per-layer
    # entries are served stale, the aquifer entry must come fresh.
    stale = col["zwt"] * rng.uniform(0.8, 1.2, N)
    zq_j = zq_t = None
    if cached:
        zq_j = j_sw.compute_equilibrium_zq(jnp.asarray(stale), j["theta_s"],
                                           j["psi_s"], j["bsw"], zi)
        zq_t = t_sw.compute_equilibrium_zq(torch.as_tensor(stale),
                                           t["theta_s"], t["psi_s"],
                                           t["bsw"], zi)
        assert_close(zq_t, zq_j, RTOL, 1e-12, "zq")
    a, kw = _sw_args(j, zi, dz, zc, jnp.asarray(infl), jnp.asarray(tran),
                     imp, zq_j)
    want = j_sw.soil_water_update(*a, **kw)
    a, kw = _sw_args(t, zi, dz, zc, torch.as_tensor(infl),
                     torch.as_tensor(tran), imp, zq_t)
    got = t_sw.soil_water_update(*a, **kw)
    assert_close(got.h2osoi, want.h2osoi, RTOL, 1e-10, "h2osoi")
    assert_close(got.smp, want.smp, RTOL, 1e-8, "smp")
    assert_close(got.qcharge, want.qcharge, RTOL, 1e-15, "qcharge")
    assert_close(got.dwat_aq, want.dwat_aq, RTOL, 1e-15, "dwat_aq")
    assert_close(got.jwt, want.jwt, 0, 0, "jwt")
    # The SMPMIN clamp is reached by the near-dry layers.
    assert float(min(s.min() for s in got.smp)) == -1.0e8


def test_thomas_solve_refined():
    rng = np.random.RandomState(2)
    m = 9
    a, cc = rng.uniform(-1, 0, (N, m)), rng.uniform(-1, 0, (N, m))
    b = 2.5 + rng.uniform(0, 1, (N, m))
    r = rng.normal(size=(N, m))
    got = t_sw._thomas_solve_refined(t_list(a), t_list(b), t_list(cc),
                                     t_list(r))
    want = j_sw._thomas_solve_refined(jnp_list(a), jnp_list(b),
                                      jnp_list(cc), jnp_list(r))
    assert_close(got, want, RTOL, 1e-14)


@pytest.mark.parametrize("nl", [8, 20])
@pytest.mark.parametrize("with_sy", [False, True])
def test_drainage(nl, with_sy):
    col, (zi, dz, zc), j, t = _inputs(nl)
    rng = np.random.RandomState(9)
    qcharge = rng.normal(0.0, 2e-4, N)
    qcharge[::3] = 0.0
    # Some layers short of watmin, some above saturation.
    h = col["h"].copy()
    h[::5, 0] = 0.004
    h[1::5, nl - 1] = 0.002
    h[2::5, 1] = col["params"]["theta_s"][2::5, 1] * dz[1] * 1.05
    out = []
    for d, dr, lst, arr in ((j, j_dr, jnp_list, jnp.asarray),
                            (t, t_dr, t_list, torch.as_tensor)):
        eff = [(jnp.maximum if dr is j_dr else torch.clamp_min)(x, 0.01)
               for x in d["theta_s"]]
        sy = (dr.compute_specific_yields(d["zwt"], d["theta_s"],
                                         d["psi_s"], d["bsw"])
              if with_sy else None)
        out.append(dr.drainage(lst(h), d["zwt"], d["wa"], arr(qcharge),
                               d["theta_s"], d["psi_s"], d["bsw"], eff,
                               zi, dz, 1800.0, s_y_prof=sy))
    want, got = out
    assert_close(got.h2osoi, want.h2osoi, RTOL, 1e-10, "h2osoi")
    assert_close(got.rnff, want.rnff, RTOL, 1e-15, "rnff")
    for k in ("zwt", "wa", "rsub_top", "qflx_rsub_sat"):
        assert_close(getattr(got, k), getattr(want, k), RTOL, 1e-15, k)


def test_compute_specific_yields():
    _, _, j, t = _inputs()
    got = t_dr.compute_specific_yields(t["zwt"], t["theta_s"], t["psi_s"],
                                       t["bsw"])
    want = j_dr.compute_specific_yields(j["zwt"], j["theta_s"],
                                        j["psi_s"], j["bsw"])
    assert_close(got, want, RTOL, 0)


@pytest.mark.parametrize("nl", [8, 20])
@pytest.mark.parametrize("imp", [False, True])
@pytest.mark.parametrize("cached", [False, True])
def test_substep_values(nl, imp, cached):
    col, (zi, dz, zc), j, t = _inputs(nl)
    geom_j = j_hy.Geometry(zi=zi, dz_soil=dz, zc_soil=zc)
    geom_t = t_hy.Geometry(zi=zi, dz_soil=dz, zc_soil=zc)
    out = []
    for d, hy, et, sw, dr, geom in (
            (j, j_hy, j_et, j_sw, j_dr, geom_j),
            (t, t_hy, t_et, t_sw, t_dr, geom_t)):
        fd = hy.derive_forcing(d["forcing"])
        kw = dict(imp=d["imp"] if imp else None)
        if cached:
            kw.update(
                zq=sw.compute_equilibrium_zq(d["zwt"], d["theta_s"],
                                             d["psi_s"], d["bsw"], zi),
                sy=dr.compute_specific_yields(d["zwt"], d["theta_s"],
                                              d["psi_s"], d["bsw"]),
                et_ctx=et.daily_et_context(fd, d["lai"]))
        out.append(hy.substep_values(
            d["h"], d["smp"], d["zwt"], d["wa"], d["rootr"], d["lai"],
            d["lai_litter"], d["theta_s"], d["hksat"], d["psi_s"],
            d["bsw"], d["fmax"], fd, geom, 1800.0, **kw))
    want, got = out
    for k in want:
        atol = 1e-8 if k in ("smp", "residual") else 1e-12
        assert_close(got[k], want[k], RTOL, atol, k)


def test_hydrology_substep_on_states():
    col, (zi, dz, zc), j, t = _inputs()
    nl = 8
    arrays = dict(h2osoi_liq=col["h"], zwt=col["zwt"], wa=col["wa"],
                  smp=col["smp"], h2osoi_liq_ma=np.zeros((N, nl)))
    soil_j = j_state.SoilState(**{k: jnp.asarray(v, F64)
                                  for k, v in arrays.items()})
    soil_t = t_state.SoilState.from_numpy(arrays, T64, "cpu")
    p = dict(col["params"])
    params_j = j_state.SoilParams(**{k: jnp.asarray(v, F64)
                                     for k, v in p.items()})
    params_t = t_state.SoilParams.from_numpy(p, T64, "cpu")
    veg = dict(plant_mass=col["plant_mass"], plant_foliage_mass=col["lai"],
               plant_length=col["lai"], rdepth=col["lai"], lai=col["lai"],
               lai_litter=col["lai_litter"], rootr=col["rootr"],
               c_labile=col["lai"], n_labile=col["lai"], p_labile=col["lai"])
    veg_j = j_state.VegState(**{k: jnp.asarray(v, F64)
                                for k, v in veg.items()})
    veg_t = t_state.VegState.from_numpy(veg, T64, "cpu")
    geom = (zi, dz, zc)
    s_j, fx_j = j_hy.hydrology_substep(
        soil_j, veg_j, params_j, j_hy.derive_forcing(j["forcing"]),
        j_hy.Geometry(*geom), 1800.0)
    s_t, fx_t = t_hy.hydrology_substep(
        soil_t, veg_t, params_t, t_hy.derive_forcing(t["forcing"]),
        t_hy.Geometry(*geom), 1800.0)
    assert_tree_close(tree_np(s_t), tree_np(s_j), RTOL, 1e-8, "soil")
    assert_tree_close(tree_np(fx_t), tree_np(fx_j), RTOL, 1e-8, "fluxes")


@pytest.mark.parametrize("vegetation_regime", ["cold", "warm"])
def test_grow_daily(vegetation_regime):
    col, (zi, dz, zc), j, t = _inputs()
    lo, hi = (250.0, 290.0) if vegetation_regime == "cold" else (285.0, 320.0)
    tas = np.linspace(lo, hi, N)
    veg = dict(plant_mass=col["plant_mass"],
               plant_foliage_mass=np.maximum(col["lai"], 1e-3) / 0.023,
               plant_length=np.full(N, 100.0), rdepth=np.full(N, 30.0),
               lai=col["lai"], lai_litter=col["lai_litter"],
               rootr=col["rootr"], c_labile=np.zeros(N),
               n_labile=np.zeros(N), p_labile=np.zeros(N))
    veg_j = j_state.VegState(**{k: jnp.asarray(v, F64)
                                for k, v in veg.items()})
    veg_t = t_state.VegState.from_numpy(veg, T64, "cpu")
    v_j, npp_j, lf_j, fx_j = j_grow.grow_daily(
        veg_j, jnp.asarray(col["smp"]), jnp.asarray(tas), zi,
        return_fluxes=True)
    v_t, npp_t, lf_t, fx_t = t_grow.grow_daily(
        veg_t, torch.as_tensor(col["smp"]), torch.as_tensor(tas), zi,
        return_fluxes=True)
    # plant_length and rdepth (and rootr through rdepth): the port takes
    # x ** (1/3) where JAX takes cbrt; the two round differently in the
    # last bits, which rtol 1e-12 admits and bitwise equality would not.
    assert_tree_close(tree_np(v_t), tree_np(v_j), 1e-12, 1e-15, "veg")
    assert_close(npp_t, npp_j, RTOL, 1e-15, "npp")
    assert_close(lf_t, lf_j, RTOL, 1e-15, "litterfall")
    assert_tree_close(tree_np(fx_t), tree_np(fx_j), RTOL, 1e-15, "fluxes")


@pytest.mark.parametrize("latent_ramp", [0.0, 2.0])
def test_soil_temperature_step(latent_ramp):
    col, (zi, dz, zc), j, t = _inputs()
    rng = np.random.RandomState(4)
    nl = 8
    t_soil = 273.16 + rng.uniform(-6.0, 6.0, (N, nl))   # around freezing
    theta = col["h"] / np.asarray(dz)[None, :]
    g_flux = rng.normal(0.0, 40.0, N)
    t_air = 273.16 + rng.uniform(-15.0, 15.0, N)
    h_surf = rng.uniform(5.0, 40.0, N)
    ts = col["params"]["theta_s"]
    want = j_st.soil_temperature_step(
        jnp.asarray(t_soil), jnp.asarray(theta), jnp.asarray(ts),
        jnp.asarray(g_flux), dz, zc, 86400.0, t_air=jnp.asarray(t_air),
        h_surf=jnp.asarray(h_surf), latent_ramp=latent_ramp)
    got = t_st.soil_temperature_step(
        torch.as_tensor(t_soil), torch.as_tensor(theta), torch.as_tensor(ts),
        torch.as_tensor(g_flux), dz, zc, 86400.0,
        t_air=torch.as_tensor(t_air), h_surf=torch.as_tensor(h_surf),
        latent_ramp=latent_ramp)
    assert_close(got, want, RTOL, 0)
