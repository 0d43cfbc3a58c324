"""Ensemble Kalman data assimilation (EnSRF) for states and parameters.

Port of ``hybrid9_tpu/assimilate.py``: observed daily ET is assimilated
sequentially into a running parameter-perturbed ensemble, updating both
the soil water and per-cell hksat log-multipliers.  The reference's only
use of observations was a visual model-vs-obs comparison at one site
(HYBRID9.f90:449).

- **Cell-local scalar-observation square-root filter** (Whitaker & Hamill
  2002).  Cells are independent and the observation at a cell is a scalar,
  so per cell, with moments over the member axis,

      K_i     = cov_m(x_i, y_i) / (var_m(y_i) + r_i)       (mean gain)
      K~_i    = K_i / (1 + sqrt(r_i / (var_m(y_i) + r_i)))  (anomaly)
      mean_i += K_i  (obs_i - mean(y_i))
      dx_i   -= K~_i dy_i

  on ``[m, n]`` tensors: elementwise over cells, no solves.
- **Relaxation to prior spread (RTPS)** (Whitaker & Hamill 2012): the
  posterior spread is ``(1-a)·sigma_analysis + a·sigma_prior``, and cells
  without an observation come back bit for bit, so their spread cannot
  drift.
- **Augmented state**: soil water, the aquifer and the log-multipliers;
  the parameters change only through their covariance with predicted ET.
- **The forecast is the folded ensemble** (ensemble.py, cell-major
  ``j = cell*m + member``): on the card one launch of the CUDA day kernel
  at ``members x cells`` a cycle.  The window is a Python loop over days;
  nothing differentiates it.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from .calibrate import apply_multipliers
from .ensemble import fold
from .parallel.sharding import DeviceSlabs, slab_devices
from .physics import bounds
from .physics import constants as c
from .physics.hydrology import Geometry
from .physics.layers import layer_tensor
from .state import Forcing, ModelState, SoilParams
from .step import day_step


class EnKFConfig(NamedTuple):
    obs_err_std: float = 0.3     # observation error, mm/day
    rtps: float = 0.5            # relaxation-to-prior-spread coefficient
    theta_min: float = -2.0      # clamp on log-multipliers
    theta_max: float = 2.0


def _moments(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Member-axis (mean, anomaly) of an ``[m, ...]`` tensor."""
    mean = torch.mean(x, dim=0, keepdim=True)
    return mean, x - mean


def enkf_update_scalar_obs(aug: Dict[str, torch.Tensor],
                           y_pred: torch.Tensor,
                           obs: torch.Tensor,
                           obs_mask: torch.Tensor,
                           cfg: EnKFConfig = EnKFConfig()
                           ) -> Dict[str, torch.Tensor]:
    """One cell-local scalar-observation EnSRF analysis step.

    ``aug``: the augmented ensemble, a dict of ``[m, n]`` (or
    ``[m, n, l]``) tensors; ``y_pred``: ``[m, n]`` predicted observation
    per member (daily ET); ``obs``: ``[n]`` observed values; ``obs_mask``:
    ``[n]`` validity.  Returns the analysis ensemble (same structure).
    Cells where ``obs_mask`` is false are returned bit for bit: no mean
    shift, no anomaly scaling.
    """
    m = y_pred.shape[0]
    y_mean, dy = _moments(y_pred)
    var_y = torch.sum(dy * dy, dim=0) / (m - 1)          # [n]
    r = cfg.obs_err_std ** 2
    denom = var_y + r                                    # [n]
    # Scalar-obs square-root anomaly factor (Whitaker & Hamill 2002
    # Eq. 13): the anomaly gain is the mean gain shrunk by this.
    sqrt_fac = 1.0 / (1.0 + torch.sqrt(r / denom))       # [n]
    innov = obs.to(y_pred.dtype) - y_mean[0]             # [n]

    def update(x):
        mean, dx = _moments(x)
        if x.dim() == 3:                                 # [m, n, l]
            # A sum over the member axis, not einsum: cuBLAS's batched
            # product adds in an order that depends on the cell count, so
            # a rank's slab would part from the whole axis on the card.
            cov = torch.sum(dy[:, :, None] * dx, dim=0) / (m - 1)
            gain = cov / denom[:, None]
            mean_a = mean + (gain * innov[:, None])[None]
            dx_a = dx - (sqrt_fac[:, None] * gain)[None] * dy[:, :, None]
            mask = obs_mask[None, :, None]
        else:                                            # [m, n]
            cov = torch.sum(dy * dx, dim=0) / (m - 1)
            gain = cov / denom
            mean_a = mean + (gain * innov)[None]
            dx_a = dx - (sqrt_fac * gain)[None] * dy
            mask = obs_mask[None, :]
        # RTPS: sigma_post = (1-a)·sigma_a + a·sigma_f; the factor is
        # exactly 1 where the update was a no-op.
        sig_f = torch.sqrt(torch.sum(dx * dx, dim=0) / (m - 1))
        sig_a = torch.sqrt(torch.sum(dx_a * dx_a, dim=0) / (m - 1))
        relax = 1.0 + cfg.rtps * (sig_f - sig_a) / bounds.maximum(sig_a,
                                                                  1.0e-12)
        x_a = mean_a + dx_a * relax[None]
        return torch.where(mask, x_a, x)

    return {k: update(v) for k, v in aug.items()}


def _enkf_cycle(state_m: ModelState, theta_m: torch.Tensor,
                params_tiled: SoilParams, f_day: Forcing,
                obs: torch.Tensor, obs_mask: torch.Tensor,
                geom: Geometry, dt: float, m: int, nisurf: int,
                vegetation: bool, use_kernel, zd09_every: int,
                cfg: EnKFConfig):
    """Forecast one day at ensemble width, then analyse.

    ``state_m``: the cell-major folded ``[n*m]`` model state; ``theta_m``:
    ``[m, n]`` per-cell hksat log-multipliers (best laid out as
    :func:`first_draw` lays them out, which the analysis keeps);
    ``params_tiled``: the base
    params folded to ``[n*m]`` (the multipliers are applied here, so the
    analysed theta takes effect on the next forecast); ``f_day``: ``[n]``
    forcing shared by the members.  Returns ``(state_m', theta_m',
    y_pred)``.  The member views are reshapes and transposes of the folded
    axis.
    """
    n = obs.shape[0]
    p = apply_multipliers(params_tiled,
                          {"hksat": theta_m.T.reshape(n * m)})
    f_m = f_day.map(lambda x: fold(x, m))
    state_m, diags = day_step(state_m, f_m, p, geom, dt, nisurf,
                              use_kernel=use_kernel, zd09_every=zd09_every,
                              vegetation=vegetation)
    y_pred = diags["evap_day"].reshape(n, m).T

    nl = state_m.soil.h2osoi_liq.shape[1]
    aug = dict(
        h2osoi=state_m.soil.h2osoi_liq.reshape(n, m, nl).transpose(0, 1),
        wa=state_m.soil.wa.reshape(n, m).T,
        theta=theta_m,
    )
    aug = enkf_update_scalar_obs(aug, y_pred, obs, obs_mask, cfg)

    # Physical guards: non-negative stores, bounded multipliers.
    h = bounds.maximum(aug["h2osoi"], 1.0e-3).transpose(0, 1) \
        .reshape(n * m, nl)
    wa = bounds.clip(aug["wa"], 0.0, 5000.0).T.reshape(n * m)
    theta_m = bounds.clip(aug["theta"], cfg.theta_min, cfg.theta_max)
    # smp from the ANALYSED moisture (Clapp-Hornberger, as initial_state;
    # O13 Eqn 7.94): it is a carry the next substep's beta-stress reads
    # (HYDROLOGY.f90:271).  The prior zwt is kept, as the JAX package
    # keeps it (ROADMAP §C).
    dz = layer_tensor(geom.dz_soil, h.dtype, h.device)
    s_node = bounds.clip((h / dz[None, :]) / p.theta_s, 0.01, 1.0)
    smp = bounds.maximum(p.psi_s * s_node ** (-p.bsw), c.SMPMIN)
    state_m = state_m.replace(soil=state_m.soil.replace(
        h2osoi_liq=h, wa=wa, smp=smp))
    return state_m, theta_m, y_pred


def first_draw(generator: torch.Generator, m: int, n: int,
               theta_spread: float, dtype: torch.dtype) -> torch.Tensor:
    """The ``[m, n]`` prior hksat log-multipliers: ``theta_spread`` times
    standard normals from ``generator``, on its device, drawn member by
    member and laid out cell-major, the member axis fastest (the ``[n,
    m]`` tensor's transpose), as the fold lays out the ensemble.  The
    filter keeps that layout, so its sums over the members run along
    memory, one cell after another, in an order that does not depend on
    how many cells a tensor holds (a sum across the cells' axis does on
    the CPU): a slab of cells sums its members as the whole axis does."""
    draw = theta_spread * torch.randn((m, n), generator=generator,
                                      dtype=dtype, device=generator.device)
    return draw.T.contiguous().T


@torch.no_grad()
def assimilate(params: SoilParams, state0: ModelState,
               forcing_days: Forcing, obs_et: torch.Tensor,
               geom: Geometry, n_members: int = 16,
               obs_mask: Optional[torch.Tensor] = None,
               nisurf: int = c.NISURF_DEFAULT,
               theta_spread: float = 0.3, seed: int = 0,
               vegetation: bool = True, use_kernel=None,
               zd09_every: int = 1,
               cfg: EnKFConfig = EnKFConfig(),
               sharding=None,
               devices: Optional[Sequence] = None) -> Dict[str, torch.Tensor]:
    """Sequential EnSRF over a daily-ET observation record.

    ``forcing_days``: ``[days, n]`` Forcing; ``obs_et``: ``[days, n]``
    observed daily ET (mm/day); ``obs_mask``: ``[days, n]`` validity
    (default: all valid); ``n_members``: the ensemble width m;
    ``theta_spread``: the std of the prior hksat log-multipliers, drawn by
    :func:`first_draw` from a ``torch.Generator`` seeded with ``seed`` on
    the device of ``state0`` (the CPU's and the card's generators give
    different streams).  ``use_kernel`` as in ``step.day_step``.

    With ``sharding`` (one rank of a multi-process run) the inputs are cut
    to the rank's slab (a slab given passes through) and the outputs are
    the slab's.  The prior is drawn for every cell and cut, so a slab's
    multipliers are bitwise those of one process; the forecast and the
    cell-local analysis need no exchange.

    With ``devices`` (a device may repeat), or a ``sharding`` whose rank
    holds several devices, the cells are cut once into device slabs
    (``parallel.sharding.DeviceSlabs``), each folded on its own device
    with its cut of the prior: each cycle is one forecast and one
    analysis a slab (on the card one kernel launch a slab), nothing
    crosses the slabs, and the outputs are joined on the first device
    once, after the last cycle.

    Returns the posterior ``theta_mean``/``theta_std`` ``[n]``, the final
    folded ensemble state and the ``[days, n]`` ensemble-mean predicted ET
    (for innovation diagnostics).
    """
    if sharding is not None:
        params, state0 = sharding.put(params), sharding.put(state0)
        forcing_days = sharding.put_block(forcing_days)
        obs_et = sharding.put_block(obs_et)
        if obs_mask is not None:
            obs_mask = sharding.put_block(obs_mask)
    devices = slab_devices(sharding, devices)
    m = n_members
    lai = state0.veg.lai
    n = lai.shape[0]
    ndays = obs_et.shape[0]
    if obs_mask is None:
        obs_mask = torch.ones((ndays, n), dtype=torch.bool, device=lai.device)
    generator = torch.Generator(device=lai.device).manual_seed(seed)
    # The prior, cell-major ([n, m]): cut on its cell axis, each slab
    # keeps the members fastest (first_draw).
    if sharding is None:
        prior = first_draw(generator, m, n, theta_spread, lai.dtype).T
    else:
        prior = sharding.put(first_draw(generator, m, sharding.n,
                                        theta_spread, lai.dtype).T)
    slabs = None
    parts = [(params, state0, forcing_days, obs_et, obs_mask, prior)]
    if devices is not None:
        slabs = DeviceSlabs.create(n, devices)
        parts = list(zip(slabs.put(params), slabs.put(state0),
                         slabs.put_block(forcing_days),
                         slabs.put_block(obs_et), slabs.put_block(obs_mask),
                         slabs.put(prior)))
    params_tiled = [p.map(lambda x: fold(x, m)) for p, *_ in parts]
    states = [s.map(lambda x: fold(x, m)) for _, s, *_ in parts]
    thetas = [t.T for *_, t in parts]
    dt = c.SDAY / nisurf
    y_means = [[] for _ in parts]
    for d in range(ndays):
        for i, (_, _, f, obs, mask, _) in enumerate(parts):
            states[i], thetas[i], y_pred = _enkf_cycle(
                states[i], thetas[i], params_tiled[i],
                f.map(lambda x: x[d]), obs[d], mask[d], geom, dt, m, nisurf,
                vegetation, use_kernel, zd09_every, cfg)
            y_means[i].append(torch.mean(y_pred, dim=0))
    out = [dict(theta_mean=torch.mean(t, dim=0),
                theta_std=torch.std(t, dim=0, correction=0),
                state=s, y_pred_mean=torch.stack(y, dim=1))
           for t, s, y in zip(thetas, states, y_means)]
    # The folded states join in cell order: slab by slab, cell-major.
    out = out[0] if slabs is None else slabs.gather(out, "result")
    out["y_pred_mean"] = out["y_pred_mean"].T.contiguous()
    return out
