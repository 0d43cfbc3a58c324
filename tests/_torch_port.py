"""Shared helpers of the tests that hold the PyTorch port against JAX.

Inputs are made once with numpy from a seed and handed to both packages;
results come back to numpy for the comparison.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from hybrid9_tpu import state as j_state
from hybrid9_tpu.config import LayerGrid, exponential_interfaces
from hybrid9_tpu.data.synthetic import (synthetic_forcing_day,
                                        synthetic_soil_params)
from hybrid9_tpu.physics import constants as c
from hybrid9_tpu_torch import state as t_state
from hybrid9_tpu_torch.weights import from_reference

# The port's CPU tests run small tensors beside other test processes: one
# intra-op thread per process keeps them from contending for the cores.
torch.set_num_threads(1)

N = 256          # cells of the day-level parity cases
DT = 1800.0
NISURF = 48
# tests/test_pallas_day.py
F32_TOL = dict(h2osoi_liq=(5e-4, 5e-3), zwt=(5e-4, 1e-5), wa=(5e-4, 5e-3),
               evap_day=(5e-3, 1e-3))
F64_TOL = dict(h2osoi_liq=(1e-9, 1e-10), zwt=(1e-9, 1e-12),
               wa=(1e-9, 1e-10), evap_day=(1e-9, 1e-12),
               evap_grnd_day=(1e-9, 1e-12), rnf_day=(1e-9, 1e-12),
               smp=(1e-9, 1e-6))


def grid_for(nl: int) -> LayerGrid:
    """The canonical 8-layer grid, or the exponential one for ``nl``."""
    if nl == 8:
        return LayerGrid.from_interfaces()
    return LayerGrid.from_interfaces(exponential_interfaces(nl))


def geom_tuples(grid: LayerGrid):
    """(zi, dz_soil, zc_soil) as tuples of Python floats."""
    nl = grid.nsoil
    return (tuple(map(float, grid.zi)), tuple(map(float, grid.dz[:nl])),
            tuple(map(float, grid.zc[:nl])))


def columns(n: int, nl: int, seed: int) -> dict:
    """Column states across regimes, as float64 numpy arrays.

    Water tables from near the surface to well below the column, and
    exactly on an interior interface and on the column bottom; layers
    from near-dry (matric potential at the SMPMIN clamp) to
    near-saturated.
    """
    grid = grid_for(nl)
    zi, dz = grid.zi, grid.dz
    rng = np.random.RandomState(seed)
    p = synthetic_soil_params(n, seed, n_layers=nl)
    frac = rng.uniform(0.15, 0.98, size=(n, nl))
    frac[::4, 0] = 0.02                       # dry top layer
    frac[1::5, nl // 2] = 0.015               # dry middle layer
    zwt = 10.0 ** rng.uniform(np.log10(0.03), np.log10(12.0), size=n)
    zwt[::6] = zi[nl] / 1000.0                # on the column bottom
    zwt[1::6] = zi[3] / 1000.0                # on an interior interface
    zwt[2::6] = rng.uniform(zi[nl] / 1000.0 + 0.01, 12.0, size=len(zwt[2::6]))
    s = np.clip(frac, 0.01, 1.0)
    lai = rng.uniform(0.001, 5.0, size=n)
    lai[::7] = 0.0                            # bare cells
    plant_mass = rng.uniform(0.5, 400.0, size=n)
    rdepth = 0.3 * np.cbrt(400.0 * plant_mass / 3.142e-3)
    decay = np.exp(np.log(0.1) / (rdepth / 10.0))
    rootr = (decay[:, None] ** (zi[None, :nl] / 10.0)
             - decay[:, None] ** (zi[None, 1:nl + 1] / 10.0))
    return dict(
        params=p,
        h=frac * p["theta_s"] * dz[None, :nl],
        smp=np.maximum(c.SMPMIN, p["psi_s"] * s ** (-p["bsw"])),
        zwt=zwt,
        wa=rng.uniform(2500.0, 5000.0, size=n),
        lai=lai,
        lai_litter=rng.uniform(0.001, 2.0, size=n),
        rootr=rootr,
        plant_mass=plant_mass,
        imp=rng.uniform(0.05, 1.0, size=(n, nl)),
        forcing=synthetic_forcing_day(n, 100 + seed, seed),
    )


def tree_np(x):
    """A state dataclass (or dict, or tuple of them) of either package as
    nested numpy dicts."""
    if isinstance(x, tuple):
        return {str(i): tree_np(v) for i, v in enumerate(x)}
    if isinstance(x, dict):
        return {k: tree_np(v) for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        return {f.name: tree_np(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_port(obj, dtype: str = "float64"):
    """An object of the JAX package (a state dataclass, ``SnowParams``,
    ``GridRouting``, ...) as the port's, on the CPU in ``dtype``, carried
    across as numpy by ``hybrid9_tpu_torch.weights.from_reference``."""
    return from_reference(type(obj).__name__, tree_np(obj),
                          getattr(torch, dtype), "cpu")


def jnp_list(a: np.ndarray, dtype=jnp.float64):
    """[n, L] numpy -> list of L [n] JAX arrays."""
    return [jnp.asarray(a[:, i], dtype) for i in range(a.shape[1])]


def t_list(a: np.ndarray, dtype=torch.float64):
    """[n, L] numpy -> list of L [n] torch tensors."""
    return [torch.as_tensor(a[:, i], dtype=dtype) for i in range(a.shape[1])]


def assert_close(got, want, rtol, atol, what=""):
    """``got`` (torch, list of torch, or numpy) against ``want`` (JAX,
    list of JAX, or numpy)."""
    if isinstance(got, (list, tuple)):
        got = np.stack([np.asarray(tree_np(g)) for g in got], axis=-1)
        want = np.stack([np.asarray(w) for w in want], axis=-1)
    np.testing.assert_allclose(np.asarray(tree_np(got)), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=what)


def assert_tree_close(got, want, rtol, atol, what=""):
    """Every leaf of two nested numpy dicts (see :func:`tree_np`)."""
    if isinstance(want, dict):
        assert set(got) == set(want), (what, set(got) ^ set(want))
        for k in want:
            assert_tree_close(got[k], want[k], rtol, atol, f"{what}.{k}")
        return
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)


def day_case(nl, dtype, varied, seed=0, n=N):
    """Identical (JAX, torch) inputs of a one-day case of ``n`` cells, and
    the geometry tuples.  ``varied=False``: the state of ``initial_state``
    (built by JAX, handed over through numpy) with water tables below the
    column; ``varied=True``: the :func:`columns` states across regimes.
    """
    grid = grid_for(nl)
    jd = jnp.float64 if dtype == "float64" else jnp.float32
    td = getattr(torch, dtype)
    col = columns(n, nl, seed)
    params_j = j_state.SoilParams(**{k: jnp.asarray(v, jd)
                                     for k, v in col["params"].items()})
    state_j = j_state.initial_state(params_j, grid.dz, grid.zi, jd)
    soil = tree_np(state_j.soil)
    veg = tree_np(state_j.veg)
    if varied:
        soil.update(h2osoi_liq=col["h"], zwt=col["zwt"], wa=col["wa"],
                    smp=col["smp"])
        veg.update(lai=col["lai"], lai_litter=col["lai_litter"],
                   rootr=col["rootr"])
    j = dict(soil=j_state.SoilState(**{k: jnp.asarray(v, jd)
                                       for k, v in soil.items()}),
             veg=j_state.VegState(**{k: jnp.asarray(v, jd)
                                     for k, v in veg.items()}),
             params=params_j,
             forcing=j_state.Forcing(**{k: jnp.asarray(v, jd)
                                        for k, v in col["forcing"].items()}),
             imp=jnp.asarray(col["imp"], jd))
    t = dict(soil=t_state.SoilState.from_numpy(soil, td, "cpu"),
             veg=t_state.VegState.from_numpy(veg, td, "cpu"),
             params=t_state.SoilParams.from_numpy(tree_np(params_j), td,
                                                  "cpu"),
             forcing=t_state.Forcing.from_numpy(col["forcing"], td, "cpu"),
             imp=torch.tensor(col["imp"], dtype=td))
    return j, t, geom_tuples(grid)


def check_day(got_soil, got_diags, want, tol):
    """The port's day (a SoilState and the daily sums) against ``want``,
    a dict of numpy or JAX arrays, field by field at ``tol``; and the
    water balance within 0.1 mm."""
    got = dict(h2osoi_liq=got_soil.h2osoi_liq, zwt=got_soil.zwt,
               wa=got_soil.wa, smp=got_soil.smp, **got_diags)
    for name, (rtol, atol) in tol.items():
        np.testing.assert_allclose(tree_np(got[name]), np.asarray(want[name]),
                                   rtol=rtol, atol=atol, err_msg=name)
    assert float(got_diags["max_abs_residual"].max()) < 0.1


def check_plain_day_against_xla(dtype, zd09_every, imp, nl):
    """``hydrology_day_plain`` against JAX's ``step._xla_day_substeps``:
    float64 on varied columns at rtol 1e-9, float32 on initial states at
    the tests/test_pallas_day.py tolerances."""
    from hybrid9_tpu.physics.hydrology import Geometry as JGeometry
    from hybrid9_tpu.step import _xla_day_substeps
    from hybrid9_tpu_torch.physics.day_kernel import hydrology_day_plain
    from hybrid9_tpu_torch.physics.hydrology import Geometry

    varied = dtype == "float64"
    j, t, geom = day_case(nl, dtype, varied)
    soil, evap, evap_grnd, rnf, max_res, _ = _xla_day_substeps(
        j["soil"], j["veg"], j["params"], j["forcing"], JGeometry(*geom),
        DT, NISURF, j["imp"] if imp else None, zd09_every, None, None)
    want = dict(h2osoi_liq=soil.h2osoi_liq, zwt=soil.zwt, wa=soil.wa,
                smp=soil.smp, evap_day=evap, evap_grnd_day=evap_grnd,
                rnf_day=rnf)
    got_soil, got_diags = hydrology_day_plain(
        t["soil"], t["veg"], t["params"], t["forcing"], Geometry(*geom),
        DT, NISURF, imp=t["imp"] if imp else None, zd09_every=zd09_every)
    check_day(got_soil, got_diags, want, F64_TOL if varied else F32_TOL)
    if varied:
        np.testing.assert_allclose(tree_np(got_diags["max_abs_residual"]),
                                   np.asarray(max_res), rtol=1e-6,
                                   atol=1e-9)
