"""Lateral groundwater flow: a 4-neighbour stencil on the lon/lat grid.

Port of ``hybrid9_tpu/physics/lateral.py``.  Groundwater moves between
4-neighbour land cells down water-table head gradients, Darcy style:

    head  h = z_surf - 1000 * zwt                       (mm)
    q_e   = k_lat * (h_i - h_j)                         (mm/day), edge e

The default ``k_lat = 1e-6`` /day is sized for continental relief: head
differences reach ~1e6 mm, so per-edge fluxes are ~1 mm/day.  Fluxes are
computed in flux form on the dense ``[ny, nx]`` grid with ``torch.roll``
neighbour shifts; each cell's total outflow is limited to its aquifer
store by one scale factor on all its edges, so conservation is exact at
the limiter too.  Longitude wraps; fluxes across the polar wrap row are
masked.  The daily step is one scatter, the stencil and one gather of
the first ``n_land`` lanes; padding lanes are never touched.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..grids.routing import synthetic_elevation


@dataclasses.dataclass(frozen=True)
class LateralParams:
    """The grid and head field of the lateral exchange."""

    land_flat_idx: torch.Tensor   # [n_land] int64 flat indices into ny*nx
    land_mask: torch.Tensor       # [ny, nx] bool
    z_surf: torch.Tensor          # [ny, nx] float32 surface elevation (mm)
    k_lat: float = 1.0e-6         # Exchange coefficient            (/day)
    n_padded: int = 0


def make_lateral_params(land_grid, device, elevation_m=None,
                        k_lat: float = 1.0e-6) -> LateralParams:
    """LateralParams on ``device`` from a LandGrid (and an elevation in
    m, the synthetic DEM without one).  ``z_surf`` is float32 whatever
    the run's dtype, as in the JAX package, so a float64 run's head
    promotes the same way."""
    mask = np.zeros(land_grid.ny * land_grid.nx, bool)
    mask[land_grid.land_idx] = True
    mask = mask.reshape(land_grid.ny, land_grid.nx)
    if elevation_m is None:
        elevation_m = synthetic_elevation(mask)
    return LateralParams(
        land_flat_idx=torch.tensor(np.asarray(land_grid.land_idx),
                                   dtype=torch.int64, device=device),
        land_mask=torch.tensor(mask, device=device),
        z_surf=torch.tensor(elevation_m * 1000.0, dtype=torch.float32,
                            device=device),
        k_lat=k_lat, n_padded=land_grid.n_padded)


def lateral_groundwater_step(wa: torch.Tensor, zwt: torch.Tensor,
                             p: LateralParams
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One daily lateral-exchange step on the packed aquifer store:
    ``wa`` (mm) and ``zwt`` (m), both ``[n_padded]``.  Returns
    ``(wa_new, net_gain)``, both ``[n_padded]`` (mm); ``net_gain`` sums
    to 0 over land."""
    ny, nx = p.land_mask.shape
    n_land = p.land_flat_idx.shape[0]
    idx = p.land_flat_idx

    def dense(packed):
        out = torch.zeros((ny * nx,), dtype=packed.dtype,
                          device=packed.device)
        out[idx] = packed[:n_land]
        return out.reshape(ny, nx)

    wa_g = dense(wa)
    head = torch.where(p.land_mask, p.z_surf - 1000.0 * dense(zwt), 0.0)

    # Directed outflow on the 4 edges; an edge is valid only between two
    # land cells, and not across the latitude wrap (the poles).
    lat_ids = torch.arange(ny, device=wa.device)[:, None]
    not_top = lat_ids > 0
    not_bot = lat_ids < ny - 1

    def edge(shift, axis, valid_extra):
        nb_head = torch.roll(head, shift, axis)
        nb_land = torch.roll(p.land_mask, shift, axis)
        valid = p.land_mask & nb_land & valid_extra
        return torch.where(valid, p.k_lat * torch.clamp(head - nb_head,
                                                        min=0.0), 0.0)

    out_e = edge(-1, 1, True)
    out_w = edge(1, 1, True)
    out_n = edge(1, 0, not_top)     # roll +1 on lat brings the row above
    out_s = edge(-1, 0, not_bot)

    total_out = out_e + out_w + out_n + out_s
    # Limit outflow to the available store; scale all four edges alike so
    # antisymmetry, and with it conservation, holds.
    avail = torch.clamp(wa_g, min=0.0)
    scale = torch.where(total_out > 0.0,
                        torch.clamp(avail / torch.clamp(total_out,
                                                        min=1e-30),
                                    max=1.0), 0.0)
    out_e, out_w, out_n, out_s = (out_e * scale, out_w * scale,
                                  out_n * scale, out_s * scale)
    total_out = out_e + out_w + out_n + out_s

    # Inflow = the neighbours' outflow toward this cell (reverse shifts).
    inflow = (torch.roll(out_e, 1, 1) + torch.roll(out_w, -1, 1)
              + torch.roll(out_n, -1, 0) + torch.roll(out_s, 1, 0))
    inflow = torch.where(p.land_mask, inflow, 0.0)

    net = inflow - total_out
    wa_new_g = wa_g + net

    # Gather back to the packed axis (padding lanes unchanged).
    flat_new = wa_new_g.reshape(-1)[idx]
    flat_net = net.reshape(-1)[idx]
    wa_new = torch.cat([flat_new, wa[n_land:]])
    net_gain = torch.cat([flat_net, torch.zeros_like(wa[n_land:])])
    return wa_new, net_gain
