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
the first ``n_land`` lanes; padding lanes are never touched.  The stencil
runs on row bands of the grid, the whole grid being one band; on device
slabs each device holds a band and the rolls across rows read halo rows
copied from the neighbour bands
(:func:`lateral_groundwater_step_split`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from ..grids.routing import synthetic_elevation
from ..parallel.sharding import Band, RowBanded, Split, halo_rows


@dataclasses.dataclass(frozen=True)
class LateralParams(RowBanded):
    """The grid and head field of the lateral exchange; ``split(slabs)``
    cuts it over device slabs (:func:`lateral_groundwater_step_split`)."""

    land_flat_idx: torch.Tensor   # [n_land] int64 flat indices into ny*nx
    land_mask: torch.Tensor       # [ny, nx] bool
    z_surf: torch.Tensor          # [ny, nx] float32 surface elevation (mm)
    k_lat: float = 1.0e-6         # Exchange coefficient            (/day)
    n_padded: int = 0

    @functools.cached_property
    def whole(self) -> tuple:
        """The grid as one row band of every row (:func:`_bands`), made
        once."""
        return _bands(self, ((0, self.land_mask.shape[0]),),
                      (self.land_mask.device,))

    def _grid(self) -> tuple:
        idx = self.land_flat_idx.cpu().numpy()
        return (idx, idx.shape[0]) + tuple(self.land_mask.shape)

    def _bands(self, rows, devices) -> tuple:
        return _bands(self, rows, devices)


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


def _bands(p: LateralParams, rows, devices) -> tuple:
    """``p`` cut into the row bands ``rows[b]`` on ``devices[b]``
    (``parallel.sharding.Band``), with what a day needs that never
    changes: the land mask and ``z_surf`` on the band's rows, and each
    edge's validity (both ends land, and no edge across the latitude wrap:
    ``not_top`` / ``not_bot`` from the global row numbers)."""
    ny, nx = p.land_mask.shape
    off = torch.zeros((1, nx), dtype=torch.bool, device=p.land_mask.device)
    land_ext = torch.cat([off, p.land_mask, off])
    out = []
    for (r0, r1), device in zip(rows, devices):
        land = p.land_mask[r0:r1]
        lat_ids = torch.arange(r0, r1, device=land.device)[:, None]
        fields = dict(
            land=land, z_surf=p.z_surf[r0:r1],
            valid_e=land & torch.roll(land, -1, 1),
            valid_w=land & torch.roll(land, 1, 1),
            valid_n=land & land_ext[r0:r1] & (lat_ids > 0),
            valid_s=land & land_ext[r0 + 2:r1 + 2] & (lat_ids < ny - 1))
        out.append(Band(r0=r0, r1=r1, nx=nx, device=device,
                        fields={k: v.to(device) for k, v in
                                fields.items()}))
    return tuple(out)


def _exchange_bands(wa_g, zwt_g, p: LateralParams, bands):
    """The day's exchange on row bands (one ``[h, nx]`` aquifer store and
    water table a band): two halo exchanges, ``head`` before the four
    edges and the north and south outflows before the inflow.  Returns
    the bands' ``(wa_new, net)`` lists."""
    f = [b.fields for b in bands]
    head = [torch.where(g["land"], g["z_surf"] - 1000.0 * z, 0.0)
            for g, z in zip(f, zwt_g)]
    head_ext = halo_rows(head, bands)

    def edge(h, nb_head, valid):
        return torch.where(valid, p.k_lat * torch.clamp(h - nb_head,
                                                        min=0.0), 0.0)

    outs = []
    for g, h, e, wa in zip(f, head, head_ext, wa_g):
        # Directed outflow on the 4 edges (a roll +1 on rows brings the
        # row above: the halo row above the band on its first row).
        out_e = edge(h, torch.roll(h, -1, 1), g["valid_e"])
        out_w = edge(h, torch.roll(h, 1, 1), g["valid_w"])
        out_n = edge(h, e[:-2], g["valid_n"])
        out_s = edge(h, e[2:], g["valid_s"])
        total_out = out_e + out_w + out_n + out_s
        # Limit outflow to the available store; scale all four edges
        # alike so antisymmetry, and with it conservation, holds.
        avail = torch.clamp(wa, min=0.0)
        scale = torch.where(total_out > 0.0,
                            torch.clamp(avail / torch.clamp(total_out,
                                                            min=1e-30),
                                        max=1.0), 0.0)
        out_e, out_w, out_n, out_s = (out_e * scale, out_w * scale,
                                      out_n * scale, out_s * scale)
        outs.append((out_e, out_w, out_n, out_s,
                     out_e + out_w + out_n + out_s))
    # Inflow = the neighbours' outflow toward this cell (reverse shifts):
    # the north outflow of the row below, the south outflow of the row
    # above.
    from_below = halo_rows([o[2] for o in outs], bands, above=False)
    from_above = halo_rows([o[3] for o in outs], bands, below=False)
    wa_new, nets = [], []
    for g, (out_e, out_w, _, _, total_out), nb, na, wa in zip(
            f, outs, from_below, from_above, wa_g):
        inflow = (torch.roll(out_e, 1, 1) + torch.roll(out_w, -1, 1)
                  + nb[2:] + na[:-2])
        inflow = torch.where(g["land"], inflow, 0.0)
        net = inflow - total_out
        wa_new.append(wa + net)
        nets.append(net)
    return wa_new, nets


def lateral_groundwater_step(wa: torch.Tensor, zwt: torch.Tensor,
                             p: LateralParams
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One daily lateral-exchange step on the packed aquifer store:
    ``wa`` (mm) and ``zwt`` (m), both ``[n_padded]``.  Returns
    ``(wa_new, net_gain)``, both ``[n_padded]`` (mm); ``net_gain`` sums
    to 0 over land.  The whole grid is one row band of the exchange."""
    ny, nx = p.land_mask.shape
    n_land = p.land_flat_idx.shape[0]
    idx = p.land_flat_idx

    def dense(packed):
        out = torch.zeros((ny * nx,), dtype=packed.dtype,
                          device=packed.device)
        out[idx] = packed[:n_land]
        return out.reshape(ny, nx)

    (wa_new_g,), (net,) = _exchange_bands([dense(wa)], [dense(zwt)], p,
                                          p.whole)
    # Gather back to the packed axis (padding lanes unchanged).
    wa_new = torch.cat([wa_new_g.reshape(-1)[idx], wa[n_land:]])
    net_gain = torch.cat([net.reshape(-1)[idx],
                          torch.zeros_like(wa[n_land:])])
    return wa_new, net_gain


def lateral_groundwater_step_split(wa: list, zwt: list, split: Split
                                   ) -> Tuple[list, list]:
    """:func:`lateral_groundwater_step` on device slabs, bitwise its
    result: ``wa`` and ``zwt`` go from the slabs to the row bands in one
    reshard, each band exchanges with its neighbours' halo rows (``4 (k -
    1)`` row copies a day) and ``(wa_new, net_gain)`` come back in one
    reshard.  Returns the slabs' ``(wa_new, net_gain)`` lists."""
    dense = split.reshard.dense([torch.stack([w, z])
                                 for w, z in zip(wa, zwt)])
    wa_g, net = _exchange_bands([d[0] for d in dense],
                                [d[1] for d in dense], split.params,
                                split.bands)
    back = split.reshard.packed(
        [torch.stack([w, n]) for w, n in zip(wa_g, net)],
        [torch.stack([w, torch.zeros_like(w)]) for w in wa])
    return [x[0] for x in back], [x[1] for x in back]
