"""Lateral routing of runoff: the dense kinematic-wave router.

Port of the dense-grid kinematic path of
``hybrid9_tpu/physics/routing.py``: the day's packed ``[n]`` runoff is
scattered onto the ``[ny, nx]`` lon/lat grid, routed by a sub-daily
kinematic wave whose D8 transfers are per-direction ``torch.roll``
stencils, and gathered back to the packed axis.  Celerity follows the
store, ``c = c0 * (s / s_ref) ** beta`` clipped to ``[c_min, c_max]``,
and each substep moves the CFL-bounded fraction ``min(1, c dt / L)`` of a
cell's store to its downstream neighbour; cells that drain off-land
deliver to the ocean outlet as ``discharge``.

Muskingum-Cunge, the packed segment-sum routers and the daily linear
reservoir are not ported yet (ROADMAP A5.6).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch

# D8 offsets (dy, dx); must match grids/routing.py _D8 order.
_D8 = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0),
       (1, 1))


def _celerity_fraction(store, flow_length, dt_r, c0, s_ref, beta, c_min,
                       c_max):
    """CFL-bounded per-substep transfer fraction f = min(1, c dt / L)."""
    s = torch.clamp(store, min=0.0) / s_ref
    c = torch.clamp(c0 * torch.pow(s + 1e-12, beta), c_min, c_max)
    return torch.clamp(c * dt_r / flow_length, max=1.0)


def _d8_inflow(out, masks):
    """Dense D8 inflow stencil: cells with direction code k send ``out``
    to the (dy, dx) neighbour, i.e. shift their mask-selected outflow by
    (+dy, +dx).  ``masks[k]`` are the float direction weights of
    :attr:`GridKinematicParams.stencil`."""
    inflow = torch.zeros_like(out)
    for k, (dy, dx) in enumerate(_D8):
        inflow = inflow + torch.roll(masks[k] * out, (dy, dx), (0, 1))
    return inflow


@dataclasses.dataclass(frozen=True)
class GridKinematicParams:
    """Dense-grid form of the kinematic-wave router.

    ``dir_code[ny, nx]``: 0..7 = index into the D8 offset table of the
    draining direction, 8 = drains to the ocean outlet, -1 = ocean (from
    grids/routing.py ``direction_codes``).  ``flow_length`` carries the
    dtype the router runs in.
    """

    dir_code: torch.Tensor            # [ny, nx] int32
    flow_length: torch.Tensor         # [ny, nx] hop length (m)
    n_substeps: int = 8
    c0: float = 0.8                   # ref celerity (m/s)
    s_ref: float = 20.0               # ref store (mm)
    beta: float = 0.6                 # celerity exponent
    c_min: float = 0.05               # m/s
    c_max: float = 3.0                # m/s

    @functools.cached_property
    def stencil(self):
        """``(land, masks, landf, oceanf, length)``, made once per
        network and not once per day: the land mask, the eight float
        direction weights, the float land and ocean-outlet weights, and
        the hop length sanitised off-land.  With mask-multiply algebra a
        NaN or zero fill value off-land would poison the transfer
        fraction (0 * NaN is NaN, and one roll carries it into a land
        neighbour's inflow); land values pass through untouched."""
        dtype = self.flow_length.dtype
        land = self.dir_code >= 0
        masks = [(self.dir_code == k).to(dtype) for k in range(8)]
        length = torch.where(land, self.flow_length, 1.0)
        return (land, masks, land.to(dtype),
                (self.dir_code == 8).to(dtype), length)


def route_kinematic_day_grid(store: torch.Tensor, local_mm: torch.Tensor,
                             p: GridKinematicParams
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense ``[ny, nx]`` kinematic-wave day step via roll stencils.

    Longitude wraps (the grid is periodic in lon); D8 never crosses the
    poles because direction codes are built with latitude clamped
    (grids/routing.py ``build_downstream_index``).  Returns
    ``(new_store, discharge)`` as ``[ny, nx]`` fields; ``discharge`` is
    the water each cell delivered to the ocean outlet over the day (mm).
    """
    land, masks, landf, oceanf, length = p.stencil
    dt_r = 86400.0 / p.n_substeps
    local_sub = torch.where(land, local_mm / p.n_substeps, 0.0)
    s, dis = store, torch.zeros_like(store)
    for _ in range(p.n_substeps):
        frac = _celerity_fraction(s, length, dt_r, p.c0, p.s_ref, p.beta,
                                  p.c_min, p.c_max)
        out = landf * frac * torch.clamp(s, min=0.0)
        inflow = _d8_inflow(out, masks)
        # (s - out) first keeps the store non-negative in float32.
        s = (s - out) + local_sub + landf * inflow
        dis = dis + oceanf * out
    return s, dis


@dataclasses.dataclass(frozen=True)
class GridRouting:
    """Packed-axis wrapper around the dense router.

    ``flat_idx[n]``: flattened ``ny * nx`` grid index of each packed
    lane (int64).  Land lanes come first; the padding lanes
    ``lane >= n_land`` carry the out-of-range index ``ny * nx`` and are
    never scattered or gathered.
    """

    params: object                    # GridKinematicParams
    flat_idx: torch.Tensor            # [n] int64 flattened grid index
    n_land: int = 0
    ny: int = 0
    nx: int = 0


def route_grid_day(store: torch.Tensor, local_runoff_mm: torch.Tensor,
                   r: GridRouting) -> Tuple[torch.Tensor, torch.Tensor]:
    """One day of dense routing on the packed axis: scatter packed ->
    dense, run the router of ``r.params``' type, gather dense -> packed.
    Padding lanes keep their store and discharge nothing."""
    if not isinstance(r.params, GridKinematicParams):
        raise NotImplementedError(
            f"dense router for {type(r.params).__name__} is not ported "
            "yet: ROADMAP A5.6 (Muskingum-Cunge)")
    idx = r.flat_idx[:r.n_land]
    nyx = r.ny * r.nx

    def dense(packed):
        out = torch.zeros((nyx,), dtype=store.dtype, device=store.device)
        out[idx] = packed[:r.n_land]
        return out.reshape(r.ny, r.nx)

    s2, dis = route_kinematic_day_grid(dense(store), dense(local_runoff_mm),
                                       r.params)
    new_store = torch.cat([s2.reshape(-1)[idx], store[r.n_land:]])
    discharge = torch.cat([dis.reshape(-1)[idx],
                           torch.zeros_like(store[r.n_land:])])
    return new_store, discharge
