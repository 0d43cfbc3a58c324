"""Gradient-based parameter calibration (adjoint sensitivity).

Port of ``hybrid9_tpu/calibrate.py``.  The sensitivity of simulated daily
ET to the soil parameters is one ``torch.autograd.grad`` away, so fitting
the parameters to observations is first-order optimisation instead of the
reference's hand-tuning loop (reference notes.txt Nov-Dec 2016; the LCLIM
harness compares model and observed ET by eye, HYBRID9.f90:449).

- Parameters are fitted through **log-space multipliers** on the positive
  soil properties (``hksat``, ``|psi_s|``, ``bsw``, ``fmax``): a zero
  multiplier is the identity, and ``lambda_ = 1/bsw`` is kept consistent.
- The forward model is the plain day (``step.day_step`` with
  ``use_kernel=False`` and ``zd09_every=1``), as the JAX package
  differentiates its XLA path and never its Pallas kernel; the CUDA day
  kernel has no backward and raises under autograd.  Each day runs under
  ``torch.utils.checkpoint``, so the tape holds one day's substeps at a
  time and the backward pass recomputes them.
- The optimiser is ``torch.optim.Adam`` with its defaults, which are
  optax's.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .parallel.sharding import DeviceSlabs, slab_devices
from .physics import bounds
from .physics import constants as c
from .physics.hydrology import Geometry
from .state import Forcing, ModelState, SoilParams
from .step import day_step

# Fields eligible for log-multiplier calibration.  theta_s / theta_m are
# left out: scaling them can violate theta_m < theta_s and the saturation
# bound that initial_state assumes.
CALIBRATABLE = ("hksat", "psi_s", "bsw", "fmax")


class CalibrationSpec(NamedTuple):
    """Which parameters to fit and whether multipliers are per-cell.

    ``fields``: subset of CALIBRATABLE.  ``per_cell``: False -> one scalar
    multiplier per field (the robust default for short records); True ->
    one multiplier per packed cell (a spatial inversion; needs dense obs).
    """

    fields: Tuple[str, ...] = ("hksat", "psi_s", "bsw")
    per_cell: bool = False

    def init_theta(self, n_cells: int, dtype: torch.dtype, device
                   ) -> Dict[str, torch.Tensor]:
        shape = (n_cells,) if self.per_cell else ()
        return {f: torch.zeros(shape, dtype=dtype, device=device)
                for f in self.fields}


def apply_multipliers(params: SoilParams,
                      theta: Dict[str, torch.Tensor]) -> SoilParams:
    """Scale soil parameters by ``exp(theta)`` per field.

    ``psi_s`` is negative (mm); multiplying by ``exp(theta) > 0`` scales
    its magnitude and keeps the sign.  Scaling ``bsw`` updates ``lambda_ =
    1/bsw`` (INIT.f90:611-631 derives bsw from lambda the same way).  A
    per-cell ``[n]`` theta broadcasts over a field's layers.
    """
    updates = {}
    for field, t in theta.items():
        if field not in CALIBRATABLE:
            raise ValueError(f"{field} is not calibratable "
                             f"(allowed: {CALIBRATABLE})")
        base = getattr(params, field)
        mult = torch.exp(t)
        if mult.dim() == 1:                      # per-cell -> broadcast
            mult = mult.reshape((-1,) + (1,) * (base.dim() - 1))
        updates[field] = base * mult
        if field == "bsw":
            updates["lambda_"] = 1.0 / updates[field]
    return params.replace(**updates)


def _day_et(state: ModelState, f_day: Forcing, params: SoilParams,
            geom: Geometry, dt: float, nisurf: int, vegetation: bool):
    state, diags = day_step(state, f_day, params, geom, dt, nisurf,
                            use_kernel=False, zd09_every=1,
                            vegetation=vegetation)
    return state, diags["evap_day"]


def simulate_daily_et(theta: Dict[str, torch.Tensor],
                      params: SoilParams,
                      state0: ModelState,
                      forcing_days: Forcing,
                      geom: Geometry,
                      nisurf: int = c.NISURF_DEFAULT,
                      vegetation: bool = True,
                      devices: Optional[Sequence] = None) -> torch.Tensor:
    """Forward model: daily ET ``[days, n]`` (mm/day) under multipliers.

    ``forcing_days`` holds stacked ``[days, n]`` tensors.  Every day is
    the plain (differentiable) day step, recomputed in the backward pass
    rather than kept (``torch.utils.checkpoint``), so reverse mode over a
    year holds one day's tape.  With ``devices`` (a device may repeat)
    the cells are cut into device slabs (``parallel.sharding.DeviceSlabs``;
    the cut of a per-cell theta is differentiable), each slab runs its
    days on its device, and the ET is joined on the first device.
    """
    if devices is None:
        return _daily_et([theta], [params], [state0], [forcing_days], geom,
                         nisurf, vegetation)[0]
    slabs = DeviceSlabs.create(params.n_cells, devices)
    evap = _daily_et(slabs.put(theta), slabs.put(params), slabs.put(state0),
                     slabs.put_block(forcing_days), geom, nisurf, vegetation)
    return slabs.gather(evap, "result", axis=1)


def _daily_et(thetas, params, states, forcings, geom, nisurf, vegetation):
    """:func:`simulate_daily_et` over slabs (a list each, one tree a slab
    on its device; the whole problem is one slab): day by day, each
    slab's checkpointed plain day.  Returns each slab's ``[days, n_slab]``
    ET."""
    ps = [apply_multipliers(p, t) for p, t in zip(params, thetas)]
    dt = c.SDAY / nisurf
    states = list(states)
    evap = [[] for _ in ps]
    for d in range(forcings[0].tas.shape[0]):
        for i, (f, p) in enumerate(zip(forcings, ps)):
            states[i], et = checkpoint(
                _day_et, states[i], f.map(lambda x: x[d]), p, geom, dt,
                nisurf, vegetation, use_reentrant=False,
                preserve_rng_state=False)
            evap[i].append(et)
    return [torch.stack(e) for e in evap]


def et_loss(theta, params, state0, forcing_days, geom, obs_et,
            nisurf: int = c.NISURF_DEFAULT,
            obs_mask: Optional[torch.Tensor] = None,
            sharding=None, devices: Optional[Sequence] = None
            ) -> torch.Tensor:
    """Mean-squared error of simulated vs observed daily ET (mm/day).

    ``obs_et``: ``[days, n]`` observations (the analog of the LCLIM
    harness's ``evap_obs`` column, HYBRID9.f90:449); ``obs_mask``
    optionally marks valid observations (missing data -> 0 weight).

    On one rank's slab (``sharding``) the loss is the rank's share: its
    own cells' sum over the denominator of every rank's cells, so the
    ranks' losses add up to the global loss.  The denominator is summed
    across the ranks outside the autograd graph.

    With ``devices`` (a device may repeat), or a ``sharding`` whose rank
    holds several devices, the cells are cut into device slabs (else the
    cells are one slab): each slab's squared errors are summed on its
    device, and the loss is built on the first device from those partial
    sums, added in slab order (so it is the unsharded loss up to the
    order of its sum).
    """
    slabs = DeviceSlabs.create(params.n_cells, slab_devices(
        sharding, devices) or [params.hksat.device])
    return _slab_loss(slabs, slabs.put(theta), _SlabProblem.cut(
        slabs, params, state0, forcing_days, obs_et, obs_mask), geom,
        nisurf, sharding)


class _SlabProblem(NamedTuple):
    """A fit's inputs cut over device slabs, one tree a slab: the
    parameters, initial states, ``[days, n_slab]`` forcing, observations
    and masks (None without a mask)."""

    params: list
    states: list
    forcings: list
    obs: list
    masks: Optional[list]

    @classmethod
    def cut(cls, slabs, params, state0, forcing_days, obs_et, obs_mask):
        return cls(slabs.put(params), slabs.put(state0),
                   slabs.put_block(forcing_days), slabs.put_block(obs_et),
                   None if obs_mask is None else slabs.put_block(obs_mask))


def _slab_loss(slabs, thetas, problem: _SlabProblem, geom, nisurf,
               sharding=None) -> torch.Tensor:
    """:func:`et_loss` over ``slabs``, ``thetas`` one dict a slab: each
    slab's sum of (masked) squared errors on its device, the sums added on
    the first device in slab order; the mask's denominator summed over
    the slabs, and under ``sharding`` over the ranks, outside the graph."""
    evap = _daily_et(thetas, problem.params, problem.states,
                     problem.forcings, geom, nisurf, True)
    masks = problem.masks or [None] * slabs.k
    num = den = None
    for sim, obs, mask in zip(evap, problem.obs, masks):
        err2 = (sim - obs) ** 2
        if mask is not None:
            w = mask.to(err2.dtype)
            err2 = err2 * w
            part = torch.sum(w).to(slabs.device)
            den = part if den is None else den + part
        part = torch.sum(err2).to(slabs.device)
        num = part if num is None else num + part
    if den is not None:
        if sharding is not None:
            den = sharding.all_reduce_sum(den, "calibrate")
        return num / bounds.maximum(den, 1.0)
    cells = sharding.n if sharding is not None else slabs.n
    return num / (evap[0].shape[0] * cells)


class CalibrationResult(NamedTuple):
    theta: Dict[str, torch.Tensor]      # fitted log-multipliers
    params: SoilParams                  # calibrated parameter set
    loss_history: torch.Tensor          # [steps + 1] (includes initial)


def calibrate(params: SoilParams,
              state0: ModelState,
              forcing_days: Forcing,
              geom: Geometry,
              obs_et: torch.Tensor,
              spec: CalibrationSpec = CalibrationSpec(),
              nisurf: int = c.NISURF_DEFAULT,
              steps: int = 50,
              learning_rate: float = 0.1,
              obs_mask: Optional[torch.Tensor] = None,
              sharding=None,
              devices: Optional[Sequence] = None) -> CalibrationResult:
    """Fit soil-parameter multipliers to observed daily ET with Adam.

    Each step takes the loss and its gradient at the current multipliers
    and then updates them; ``loss_history`` holds each step's loss before
    its update and, last, the loss at the fitted multipliers.  Everything
    stays on the device of ``params``: the loop never waits for the card.

    ``sharding`` (one rank of a multi-process run): the inputs are cut to
    the rank's slab (a slab given passes through) and so is a per-cell
    theta, whose gradient is then the rank's own; each step's loss is the
    rank's share (:func:`et_loss`), a scalar theta's gradient is summed
    across the ranks after the backward pass, and the loss history is
    summed once at the end, so every rank reports the global loss.

    With ``devices`` (a device may repeat), or a ``sharding`` whose rank
    holds several devices, the (rank's) cells are cut once into device
    slabs: a per-cell theta is one leaf a slab on its device, a scalar
    theta one leaf on the first device that each slab reads through its
    own copy (autograd sums the copies' gradients into the leaf), each
    slab's days run on its device, and the loss is built on the first
    device from the slabs' partial sums (:func:`et_loss`).  The fitted
    theta is joined on the first device at the end.
    """
    if sharding is not None:
        params, state0 = sharding.put(params), sharding.put(state0)
        forcing_days = sharding.put_block(forcing_days)
        obs_et = sharding.put_block(obs_et)
        if obs_mask is not None:
            obs_mask = sharding.put_block(obs_mask)
    ref = params.hksat
    slabs = DeviceSlabs.create(params.n_cells, slab_devices(
        sharding, devices) or [ref.device])
    problem = _SlabProblem.cut(slabs, params, state0, forcing_days, obs_et,
                               obs_mask)

    def leaf(n_cells, device):
        return {k: v.requires_grad_(True) for k, v in spec.init_theta(
            n_cells, ref.dtype, device).items()}
    if spec.per_cell:
        leaves = [leaf(p.n_cells, d)
                  for p, d in zip(problem.params, slabs.devices)]
    else:
        leaves = [leaf(params.n_cells, ref.device)]

    def loss_at(parts):
        """The loss at ``parts``: one theta dict a slab (per-cell), or the
        one dict of a scalar theta, which each slab reads through its own
        copy."""
        if not spec.per_cell:
            parts = slabs.put(parts[0])
        return _slab_loss(slabs, parts, problem, geom, nisurf, sharding)

    opt = torch.optim.Adam([t for p in leaves for t in p.values()],
                           lr=learning_rate)
    losses = []
    scalars = [t for t in leaves[0].values() if t.dim() == 0]
    for _ in range(steps):
        opt.zero_grad()
        loss = loss_at(leaves)
        loss.backward()
        if sharding is not None and scalars:
            grads = sharding.all_reduce_sum(
                torch.stack([t.grad for t in scalars]), "calibrate")
            for t, g in zip(scalars, grads):
                t.grad = g
        opt.step()
        losses.append(loss.detach())
    fitted = [{k: v.detach() for k, v in p.items()} for p in leaves]
    with torch.no_grad():
        losses.append(loss_at(fitted))
    history = torch.stack(losses)
    if sharding is not None:
        history = sharding.all_reduce_sum(history, "calibrate")
    fitted = slabs.gather(fitted, "result") if len(fitted) > 1 else fitted[0]
    return CalibrationResult(theta=fitted,
                             params=apply_multipliers(params, fitted),
                             loss_history=history)


def parameter_sensitivity(params: SoilParams,
                          state0: ModelState,
                          forcing_days: Forcing,
                          geom: Geometry,
                          fields: Sequence[str] = CALIBRATABLE,
                          nisurf: int = c.NISURF_DEFAULT
                          ) -> Dict[str, torch.Tensor]:
    """d(mean ET)/d(log parameter) per cell for each field: a one-call
    adjoint sensitivity analysis, where the Fortran reference would need
    one finite-difference run per parameter per cell."""
    spec = CalibrationSpec(fields=tuple(fields), per_cell=True)
    ref = params.hksat
    theta = {k: v.requires_grad_(True) for k, v in spec.init_theta(
        params.n_cells, ref.dtype, ref.device).items()}
    mean_et = torch.mean(simulate_daily_et(theta, params, state0,
                                           forcing_days, geom, nisurf))
    grads = torch.autograd.grad(mean_et, list(theta.values()),
                                allow_unused=True)
    return {k: torch.zeros_like(t) if g is None else g
            for (k, t), g in zip(theta.items(), grads)}
