"""Lateral routing of runoff over the D8 network.

Port of ``hybrid9_tpu/physics/routing.py``.  Each cell carries a river
store (mm over the cell) that takes its own runoff (``rnf_day``) and its
upstream neighbours' outflow and releases water downstream; cells that
drain off-land deliver to the ocean outlet as ``discharge``.  Three
schemes, each in the packed ``[n]`` form over the downstream-index map
and, for the sub-daily two, in a dense ``[ny, nx]`` form whose D8
transfers are per-direction ``torch.roll`` stencils:

1. **Daily linear reservoir** (:func:`route_daily`): ``out = k * S`` once
   a day.
2. **Sub-daily kinematic wave** (:func:`route_kinematic_day`,
   :func:`route_kinematic_day_grid`): ``n_substeps`` transfers a day;
   celerity follows the store, ``c = c0 * (s / s_ref) ** beta`` clipped
   to ``[c_min, c_max]``, and each substep moves the CFL-bounded
   fraction ``min(1, c dt / L)`` of a cell's store downstream.
3. **Variable-parameter Muskingum-Cunge** (:func:`route_muskingum_day`,
   :func:`route_muskingum_day_grid`): per-reach slope, width and length
   set a Manning celerity and a Cunge weighting X per substep
   (:func:`_mc_hydraulics`); outflow from the Muskingum storage
   relation, clipped to ``[0, S]``.

The packed forms add each receiver's inflow in a fixed order: the
downstream map is turned once per network, on the host, into a table of
each cell's upstream senders (``receiver_table``), and a day gathers and
sums its rows.  A scatter-add would add with atomics in no fixed order
on the card, so that a resumed year would not be bit for bit the
straight one.  Mass is conserved in every scheme: ``sum(S') - sum(S) =
sum(local) - discharge``.

The dense forms run on row bands of the grid, each band with one halo
row above and below; the whole grid is one band.  On device slabs
(``GridRouting.split``, :func:`route_grid_day_split`) each device holds a
band, the halo rows are copied from the neighbour bands once an inflow
pass, and the result is bitwise the whole grid's.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from ..parallel.sharding import Band, RowBanded, Split, halo_rows

# D8 offsets (dy, dx); must match grids/routing.py _D8 order.
_D8 = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0),
       (1, 1))


@functools.lru_cache(maxsize=None)
def _exponent(e: float) -> torch.Tensor:
    """``e`` as a 0-d CPU tensor for ``torch.pow``.  With a tensor
    exponent ATen's CPU kernels round every element alike, wherever it
    lies in the tensor, so a router on row bands is bitwise the router on
    the whole grid (with a Python float exponent the scalar CPU kernels
    round a tensor's last elements another way); on the card it is the
    kernel of a float exponent.  Made outside inference mode, as
    ``bounds._constant`` is."""
    with torch.inference_mode(False):
        return torch.tensor(e, dtype=torch.float64)


def _celerity_fraction(store, flow_length, dt_r, c0, s_ref, beta, c_min,
                       c_max):
    """CFL-bounded per-substep transfer fraction f = min(1, c dt / L)."""
    s = torch.clamp(store, min=0.0) / s_ref
    c = torch.clamp(c0 * torch.pow(s + 1e-12, _exponent(beta)), c_min,
                    c_max)
    return torch.clamp(c * dt_r / flow_length, max=1.0)


def _d8_inflow(ext, masks):
    """Dense D8 inflow stencil on a band of rows: cells with direction
    code k send their outflow to the (dy, dx) neighbour, i.e. shift their
    mask-selected outflow by (+dy, +dx).  ``ext`` is the band's ``[h, nx]``
    outflow with one halo row above and one below (``halo_rows``), and
    ``masks[k]`` the direction weights over the same ``h + 2`` rows
    (:func:`_bands`).  The shift across rows reads the halo, the shift
    across columns wraps in longitude."""
    h = ext.shape[0] - 2
    inflow = torch.zeros_like(ext[1:-1])
    for k, (dy, dx) in enumerate(_D8):
        inflow = inflow + torch.roll(masks[k] * ext, dx, 1)[1 - dy:1 - dy + h]
    return inflow


def receiver_table(downstream: np.ndarray) -> np.ndarray:
    """Each cell's upstream senders, ``[n, k]`` int64 with ``k`` the
    largest in-degree (at least 1): row ``j`` lists in ascending order
    the cells ``i`` with ``downstream[i] == j``, padded with ``n``.  An
    index ``>= n`` in ``downstream`` is the ocean outlet and sends to no
    row.  Built on the host, once per network."""
    down = np.asarray(downstream, np.int64)
    n = down.shape[0]
    senders = np.flatnonzero(down < n)
    receivers = down[senders]          # stable sort: senders stay ascending
    order = np.argsort(receivers, kind="stable")
    senders, receivers = senders[order], receivers[order]
    counts = np.bincount(receivers, minlength=n)
    k = max(int(counts.max()) if n else 0, 1)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    table = np.full((n, k), n, np.int64)
    table[receivers, np.arange(receivers.size) - first[receivers]] = senders
    return table


class _PackedNetwork:
    """The downstream map's derived operands, made once per network."""

    @functools.cached_property
    def network(self):
        """``(table, to_ocean)``: :func:`receiver_table` on the map's
        device, and the cells that drain to the ocean outlet."""
        table = receiver_table(self.downstream.cpu().numpy())
        n = self.downstream.shape[0]
        return (torch.tensor(table, device=self.downstream.device),
                self.downstream >= n)


def _segment_inflow(out: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Each cell's inflow: the sum of its senders' ``out`` in the fixed
    order of ``table`` (the port of ``segment_sum(out, downstream,
    n + 1)[:n]``)."""
    ext = torch.cat([out, out.new_zeros(1)])
    return ext[table].sum(dim=1)


@dataclasses.dataclass(frozen=True)
class RoutingParams(_PackedNetwork):
    """Daily linear-reservoir routing."""

    downstream: torch.Tensor  # [n] packed downstream index; >= n = outlet
    k: float = 0.2            # Release fraction per day.


def route_daily(store: torch.Tensor, local_runoff_mm: torch.Tensor,
                routing: RoutingParams) -> Tuple[torch.Tensor, torch.Tensor]:
    """One daily linear-reservoir step on ``[n]`` stores (mm).  Returns
    ``(new_store, discharge)``: ``discharge`` is the water each cell
    delivered to the ocean outlet this day (mm)."""
    table, to_ocean = routing.network
    # A store in reclaim deficit (negative) releases nothing.
    out = routing.k * torch.clamp(store, min=0.0)
    # (store - out) first: out <= store, so no partial sum rounds below
    # zero.
    new_store = (store - out) + local_runoff_mm + _segment_inflow(out, table)
    return new_store, torch.where(to_ocean, out, 0.0)


@dataclasses.dataclass(frozen=True)
class KinematicParams(_PackedNetwork):
    """Packed sub-daily kinematic-wave routing."""

    downstream: torch.Tensor          # [n] packed downstream index
    flow_length: torch.Tensor         # [n] D8 hop length (m)
    n_substeps: int = 8
    c0: float = 0.8                   # ref celerity (m/s)
    s_ref: float = 20.0               # ref store (mm)
    beta: float = 0.6                 # celerity exponent
    c_min: float = 0.05               # m/s
    c_max: float = 3.0                # m/s


def route_kinematic_day(store: torch.Tensor, local_runoff_mm: torch.Tensor,
                        p: KinematicParams
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One day of packed kinematic-wave routing: ``local_runoff_mm`` is
    injected evenly across the substeps.  Returns ``(new_store,
    discharge)`` (mm).

    ``local_runoff_mm`` may be slightly negative on drainage-fixup days
    (the reference takes unmet soil deficits back out of drainage,
    HYDROLOGY.f90:1204-1211); the store is debited and may carry a
    micro-negative balance until runoff returns.  Every router here
    shares that contract.
    """
    table, to_ocean = p.network
    dt_r = 86400.0 / p.n_substeps
    local_sub = local_runoff_mm / p.n_substeps
    s, dis = store, torch.zeros_like(store)
    for _ in range(p.n_substeps):
        out = _celerity_fraction(s, p.flow_length, dt_r, p.c0, p.s_ref,
                                 p.beta, p.c_min, p.c_max) \
            * torch.clamp(s, min=0.0)
        # (s - out) first keeps the store non-negative in float32.
        s = (s - out) + local_sub + _segment_inflow(out, table)
        dis = dis + torch.where(to_ocean, out, 0.0)
    return s, dis


@dataclasses.dataclass(frozen=True)
class MuskingumParams(_PackedNetwork):
    """Packed variable-parameter Muskingum-Cunge routing with per-reach
    geometry (grids/routing.py: ``reach_slope``, ``bankfull_width_m`` of
    ``flow_accumulation``, ``flow_length_m``, ``cell_area_m2``)."""

    downstream: torch.Tensor          # [n] packed downstream index
    flow_length: torch.Tensor         # [n] D8 hop length (m)
    slope: torch.Tensor               # [n] channel slope (-)
    width: torch.Tensor               # [n] bankfull width (m)
    cell_area: torch.Tensor           # [n] cell area (m^2)
    n_substeps: int = 8
    n_manning: float = 0.035          # channel Manning n
    c_min: float = 0.05               # m/s
    c_max: float = 5.0                # m/s


def _mc_hydraulics(s, length, width, area, slope, sqrt_s0, n_manning,
                   c_min, c_max):
    """Per-reach Muskingum-Cunge state from storage, shared by the packed
    and dense forms: depth over the w x L rectangular channel, Manning
    velocity v = h^(2/3) sqrt(S0) / n, kinematic celerity c = (5/3) v,
    travel time K = L / c and Cunge weighting X = 1/2 (1 - q / (S0 c L))
    with q = v h (Cunge 1969).  Returns ``(k_t, x_w)``."""
    vol = torch.clamp(s, min=0.0) * 1.0e-3 * area              # m^3
    h = torch.clamp(vol / (width * length), min=1.0e-4)        # m
    v = torch.pow(h, _exponent(2.0 / 3.0)) * sqrt_s0 / n_manning  # m/s
    cel = torch.clamp(5.0 / 3.0 * v, c_min, c_max)
    k_t = length / cel                                         # s
    x_w = torch.clamp(0.5 * (1.0 - (v * h) / (slope * cel * length)),
                      0.0, 0.5)
    return k_t, x_w


def _sqrt_nearest(x: torch.Tensor) -> torch.Tensor:
    """``sqrt(x)`` rounded to nearest in ``x``'s dtype on every device:
    formed in float64 and rounded once (ATen's vectorised float32 square
    root on the CPU is within half an ulp, not always the nearest)."""
    return torch.sqrt(x.double()).to(x.dtype)


def route_muskingum_day(store: torch.Tensor, local_runoff_mm: torch.Tensor,
                        p: MuskingumParams
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One day of packed Muskingum-Cunge routing.  Per substep: a
    kinematic pass estimates the same-substep inflow I, the storage
    relation S = K [X I + (1-X) O] gives the outflow O, clipped to
    ``[0, S]`` so the update is conservative and keeps the store
    non-negative.  Returns ``(new_store, discharge)`` (mm)."""
    table, to_ocean = p.network
    dt_r = 86400.0 / p.n_substeps
    local_sub = local_runoff_mm / p.n_substeps
    # A flat reach from a direct constructor would give 0/0 in x_w.
    slope = torch.clamp(p.slope, min=1.0e-6)
    sqrt_s0 = _sqrt_nearest(slope)
    s, dis = store, torch.zeros_like(store)
    for _ in range(p.n_substeps):
        k_t, x_w = _mc_hydraulics(s, p.flow_length, p.width, p.cell_area,
                                  slope, sqrt_s0, p.n_manning, p.c_min,
                                  p.c_max)
        # Pass 1: kinematic outflow estimate -> same-substep inflow.
        out_kin = torch.clamp(dt_r / k_t, max=1.0) * s
        i_rate = (_segment_inflow(out_kin, table) + local_sub) / dt_r
        # Pass 2: Muskingum storage relation, conservative clip.
        o_rate = (s / k_t - x_w * i_rate) / (1.0 - x_w)           # mm/s
        out = torch.minimum(torch.clamp(o_rate * dt_r, min=0.0),
                            torch.clamp(s, min=0.0))
        s = (s - out) + local_sub + _segment_inflow(out, table)
        dis = dis + torch.where(to_ocean, out, 0.0)
    return s, dis


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

    @functools.cached_property
    def whole(self) -> tuple:
        """The operands as one row band of every row (:func:`_bands`),
        made once per network."""
        return _whole(self)


def _bands(p, rows, devices) -> tuple:
    """The dense router ``p``'s operands cut into the row bands ``rows[b]``
    on ``devices[b]`` (``parallel.sharding.Band``): the fields of its
    stencil and the land mask on the band's rows, the direction weights on
    them with one halo row above and one below (zero rows beyond the
    poles: the network never points a cell across a pole, so the global
    roll brings exact zeros there too)."""
    fields = _stencil_fields(p)
    zero = torch.zeros_like(fields["masks"][0][:1])
    masks = [torch.cat([zero, m, zero]) for m in fields["masks"]]
    nx = zero.shape[1]
    out = []
    for (r0, r1), device in zip(rows, devices):
        band = {k: v[r0:r1].to(device) for k, v in fields.items()
                if k != "masks"}
        band["masks"] = [m[r0:r1 + 2].to(device) for m in masks]
        out.append(Band(r0=r0, r1=r1, nx=nx, device=device, fields=band))
    return tuple(out)


def _stencil_fields(p) -> dict:
    """The stencil of a dense router's params by name, with its land
    mask."""
    if isinstance(p, GridKinematicParams):
        land, masks, landf, oceanf, length = p.stencil
        return dict(land=land, masks=masks, landf=landf, oceanf=oceanf,
                    length=length)
    masks, landf, oceanf, slope, sqrt_s0, length, width, area = p.stencil
    return dict(land=p.dir_code >= 0, masks=masks, landf=landf,
                oceanf=oceanf, slope=slope, sqrt_s0=sqrt_s0, length=length,
                width=width, area=area)


def _whole(p) -> tuple:
    """``p``'s operands as one band of every row on their own device."""
    return _bands(p, ((0, p.dir_code.shape[0]),), (p.dir_code.device,))


def _kinematic_bands(stores, locals_, p, bands):
    """The kinematic-wave day of :func:`route_kinematic_day_grid` on row
    bands (one ``[h, nx]`` store and runoff a band), one halo exchange a
    substep.  Returns the bands' ``(new_store, discharge)`` lists."""
    dt_r = 86400.0 / p.n_substeps
    f = [b.fields for b in bands]
    local_sub = [torch.where(g["land"], x / p.n_substeps, 0.0)
                 for g, x in zip(f, locals_)]
    s = list(stores)
    dis = [torch.zeros_like(x) for x in s]
    for _ in range(p.n_substeps):
        out = []
        for g, x in zip(f, s):
            frac = _celerity_fraction(x, g["length"], dt_r, p.c0, p.s_ref,
                                      p.beta, p.c_min, p.c_max)
            out.append(g["landf"] * frac * torch.clamp(x, min=0.0))
        ext = halo_rows(out, bands)
        # (s - out) first keeps the store non-negative in float32.
        s = [(x - o) + ls + g["landf"] * _d8_inflow(e, g["masks"])
             for g, x, o, ls, e in zip(f, s, out, local_sub, ext)]
        dis = [d + g["oceanf"] * o for g, d, o in zip(f, dis, out)]
    return s, dis


def route_kinematic_day_grid(store: torch.Tensor, local_mm: torch.Tensor,
                             p: GridKinematicParams
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense ``[ny, nx]`` kinematic-wave day step via roll stencils.

    Longitude wraps (the grid is periodic in lon); D8 never crosses the
    poles because direction codes are built with latitude clamped
    (grids/routing.py ``build_downstream_index``).  Returns
    ``(new_store, discharge)`` as ``[ny, nx]`` fields; ``discharge`` is
    the water each cell delivered to the ocean outlet over the day (mm).
    The whole grid is one row band of :func:`_kinematic_bands`.
    """
    (s,), (dis,) = _kinematic_bands([store], [local_mm], p, p.whole)
    return s, dis


@dataclasses.dataclass(frozen=True)
class GridMuskingumParams:
    """Dense-grid form of the Muskingum-Cunge router: the per-reach
    geometry of :class:`MuskingumParams` scattered onto the ``[ny, nx]``
    grid (the fill cells' values are never used)."""

    dir_code: torch.Tensor            # [ny, nx] int32 (0..7, 8 = outlet,
                                      # -1 = not land)
    flow_length: torch.Tensor         # [ny, nx] D8 hop length (m)
    slope: torch.Tensor               # [ny, nx] channel slope (-)
    width: torch.Tensor               # [ny, nx] bankfull width (m)
    cell_area: torch.Tensor           # [ny, nx] cell area (m^2)
    n_substeps: int = 8
    n_manning: float = 0.035
    c_min: float = 0.05
    c_max: float = 5.0

    @functools.cached_property
    def stencil(self):
        """``(masks, landf, oceanf, slope, sqrt_s0, length, width,
        area)``, made once per network: the direction, land and outlet
        weights as in :attr:`GridKinematicParams.stencil`, and the reach
        geometry with the slope floored as the packed form does and
        off-land values set finite (a NaN fill would reach a land
        neighbour through 0 * NaN); land values pass through as they
        are."""
        dtype = self.flow_length.dtype
        land = self.dir_code >= 0
        masks = [(self.dir_code == k).to(dtype) for k in range(8)]
        slope = torch.where(land, torch.clamp(self.slope, min=1.0e-6), 1.0e-3)
        return (masks, land.to(dtype), (self.dir_code == 8).to(dtype),
                slope, _sqrt_nearest(slope),
                torch.where(land, self.flow_length, 1.0),
                torch.where(land, self.width, 1.0),
                torch.where(land, self.cell_area, 1.0))

    @functools.cached_property
    def whole(self) -> tuple:
        """The operands as one row band of every row (:func:`_bands`),
        made once per network."""
        return _whole(self)


def _muskingum_bands(stores, locals_, p, bands):
    """The Muskingum-Cunge day of :func:`route_muskingum_day_grid` on row
    bands, two halo exchanges a substep (one an inflow pass)."""
    dt_r = 86400.0 / p.n_substeps
    f = [b.fields for b in bands]
    local_sub = [torch.where(g["land"], x / p.n_substeps, 0.0)
                 for g, x in zip(f, locals_)]
    s = list(stores)
    dis = [torch.zeros_like(x) for x in s]
    for _ in range(p.n_substeps):
        hyd = [_mc_hydraulics(x, g["length"], g["width"], g["area"],
                              g["slope"], g["sqrt_s0"], p.n_manning,
                              p.c_min, p.c_max) for g, x in zip(f, s)]
        out_kin = [g["landf"] * torch.clamp(dt_r / k_t, max=1.0) * x
                   for g, x, (k_t, _) in zip(f, s, hyd)]
        ext = halo_rows(out_kin, bands)
        out = []
        for g, x, (k_t, x_w), ls, e in zip(f, s, hyd, local_sub, ext):
            i_rate = (_d8_inflow(e, g["masks"]) + ls) / dt_r
            o_rate = (x / k_t - x_w * i_rate) / (1.0 - x_w)       # mm/s
            out.append(g["landf"] * torch.minimum(
                torch.clamp(o_rate * dt_r, min=0.0), torch.clamp(x, min=0.0)))
        ext = halo_rows(out, bands)
        s = [(x - o) + ls + g["landf"] * _d8_inflow(e, g["masks"])
             for g, x, o, ls, e in zip(f, s, out, local_sub, ext)]
        dis = [d + g["oceanf"] * o for g, d, o in zip(f, dis, out)]
    return s, dis


def route_muskingum_day_grid(store: torch.Tensor, local_mm: torch.Tensor,
                             p: GridMuskingumParams
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense ``[ny, nx]`` Muskingum-Cunge day step: the hydraulics and
    the conservative clip of :func:`route_muskingum_day`, with the two
    inflow passes of each substep on the roll stencil (the whole grid is
    one row band of :func:`_muskingum_bands`)."""
    (s,), (dis,) = _muskingum_bands([store], [local_mm], p, p.whole)
    return s, dis


@dataclasses.dataclass(frozen=True)
class GridRouting(RowBanded):
    """Packed-axis wrapper around the dense routers.

    ``flat_idx[n]``: flattened ``ny * nx`` grid index of each packed
    lane (int64).  Land lanes come first; the padding lanes
    ``lane >= n_land`` carry the out-of-range index ``ny * nx`` and are
    never scattered or gathered.  ``split(slabs)`` cuts the router over
    device slabs (:func:`route_grid_day_split`).
    """

    params: object          # GridKinematicParams | GridMuskingumParams
    flat_idx: torch.Tensor            # [n] int64 flattened grid index
    n_land: int = 0
    ny: int = 0
    nx: int = 0

    def _grid(self) -> tuple:
        return self.flat_idx.cpu().numpy(), self.n_land, self.ny, self.nx

    def _bands(self, rows, devices) -> tuple:
        return _bands(self.params, rows, devices)


_DENSE_ROUTERS = {GridKinematicParams: route_kinematic_day_grid,
                  GridMuskingumParams: route_muskingum_day_grid}
_BAND_ROUTERS = {GridKinematicParams: _kinematic_bands,
                 GridMuskingumParams: _muskingum_bands}


def route_grid_day(store: torch.Tensor, local_runoff_mm: torch.Tensor,
                   r: GridRouting) -> Tuple[torch.Tensor, torch.Tensor]:
    """One day of dense routing on the packed axis: scatter packed ->
    dense, run the router of ``r.params``' type, gather dense -> packed.
    Padding lanes keep their store and discharge nothing.  A params type
    without a dense router raises ``TypeError``."""
    route = _DENSE_ROUTERS.get(type(r.params))
    if route is None:
        raise TypeError(f"route_grid_day: no dense router for "
                        f"{type(r.params).__name__}")
    idx = r.flat_idx[:r.n_land]
    nyx = r.ny * r.nx

    def dense(packed):
        out = torch.zeros((nyx,), dtype=store.dtype, device=store.device)
        out[idx] = packed[:r.n_land]
        return out.reshape(r.ny, r.nx)

    s2, dis = route(dense(store), dense(local_runoff_mm), r.params)
    new_store = torch.cat([s2.reshape(-1)[idx], store[r.n_land:]])
    discharge = torch.cat([dis.reshape(-1)[idx],
                           torch.zeros_like(store[r.n_land:])])
    return new_store, discharge


def route_grid_day_split(stores: list, local_runoff_mm: list,
                         split: Split) -> Tuple[list, list]:
    """:func:`route_grid_day` on device slabs, bitwise its result: each
    slab's ``[n_slab]`` store and runoff go to the row bands in one
    reshard, the router runs band by band on the bands' devices with halo
    rows from the neighbour bands (``2 (k - 1)`` row copies an inflow
    pass: one pass a substep for the kinematic wave, two for
    Muskingum-Cunge), and the new store and discharge come back to the
    slabs in one reshard.  No device holds the whole grid.  Returns the
    slabs' ``(new_store, discharge)`` lists."""
    r = split.params
    route = _BAND_ROUTERS.get(type(r.params))
    if route is None:
        raise TypeError(f"route_grid_day: no dense router for "
                        f"{type(r.params).__name__}")
    dense = split.reshard.dense([torch.stack([s, x]) for s, x in
                                 zip(stores, local_runoff_mm)])
    s2, dis = route([d[0] for d in dense], [d[1] for d in dense], r.params,
                    split.bands)
    back = split.reshard.packed(
        [torch.stack([s, d]) for s, d in zip(s2, dis)],
        [torch.stack([s, torch.zeros_like(s)]) for s in stores])
    return [x[0] for x in back], [x[1] for x in back]
