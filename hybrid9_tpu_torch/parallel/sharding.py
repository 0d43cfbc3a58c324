"""The packed cell axis cut into one slab per process.

Port of ``hybrid9_tpu/parallel/sharding.py``.  The JAX package shards the
packed land-cell axis over a 1-D device mesh, and GSPMD makes every
cross-cell operation global without code.  Here each rank of a
``torch.distributed`` group holds only its slab ``[lo, hi)`` of the axis
(parameters, state, forcing, accumulators), so every exchange is
explicit and goes through :class:`CellSharding`:

* ``all_gather_cells``: the stacked ``[k, n_local]`` operands of a
  cross-cell module become ``[k, n]`` on every rank.  The physics uses
  this one exchange, once a day for the router and once for lateral
  groundwater (:class:`Gathered`); each rank then runs the unchanged
  global function and keeps its slab, so a rank sees the same operands in
  the same order as one process does;
* ``all_reduce_sum`` / ``all_reduce_max``: the calibration loss's
  denominator and a scalar multiplier's gradient, the spin-up's global
  convergence measure.

Tensors cross ranks as host copies (the group runs on gloo,
``parallel/launch.py``).  :data:`collectives` counts the calls by caller,
at any world size (with one rank no data moves), for the comms audit.

Within one process, :class:`DeviceSlabs` cuts the cells it holds (every
cell, or a rank's slab) once into one contiguous slab per device of a
list, the port of a single-controller ``CellSharding`` over every local
device: each slab's state, parameters, forcing and sums stay on its
device from day to day, the cell-local modules run slab by slab, and the
cross-cell modules exchange device-to-device copies (the dense routers'
and lateral groundwater's halo rows and reshards, a packed router's
gather), each counted in :data:`collectives` under its own caller.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..physics.day_kernel import slab_bounds
from ..state import _Tensors
from .launch import host_shard_bounds, process_count, process_index

#: Calls of the exchange in this process, by caller: across ranks
#: "routing", "lateral", "spinup", "calibrate", "output"; between the
#: device slabs of one process "halo" (one halo row copied), "reshard"
#: (the packed slabs to the row bands or back), "gather" (a cross-cell
#: module's operands onto the first device and its result cut back),
#: "state" (a whole state gathered or cut for a caller outside the day)
#: and "result" (a driver's outputs joined onto the first device: the
#: closed loop's at its end, the spin-up's drift and NEE once a
#: rehearsal year).
collectives: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True)
class CellSharding:
    """One rank's slab ``[lo, hi)`` of ``n`` packed cells, on ``devices``
    (the first holds the slab)."""

    lo: int
    hi: int
    n: int
    devices: tuple
    rank: int = 0
    world: int = 1

    @classmethod
    def create(cls, n: int, device,
               devices: Optional[Sequence] = None) -> "CellSharding":
        """This process's slab of ``n`` cells (:func:`host_shard_bounds`)
        on ``device``.  Without ``devices``, one process on the card takes
        every visible card (the single-controller launcher), and a rank of
        several takes its own."""
        device = torch.device(device)
        if devices is None:
            devices = [device]
            if device.type == "cuda" and process_count() == 1:
                devices = [torch.device("cuda", i)
                           for i in range(torch.cuda.device_count())]
        lo, hi = host_shard_bounds(n)
        return cls(lo=lo, hi=hi, n=n,
                   devices=tuple(torch.device(d) for d in devices),
                   rank=process_index(), world=process_count())

    @property
    def n_local(self) -> int:
        return self.hi - self.lo

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    def check_divisible(self, n: int) -> None:
        if n % self.world != 0:
            raise ValueError(
                f"packed cell count {n} not divisible by process count "
                f"{self.world}; raise Config.cell_block")

    def _slab(self, x, axis: int) -> torch.Tensor:
        """The slab of ``x`` on ``axis``, on the rank's device.  A tensor
        that already has the slab's length passes through, and so does one
        without the axis (a scalar)."""
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if x.dim() > axis and x.shape[axis] != self.n_local:
            if x.shape[axis] != self.n:
                raise ValueError(f"cell axis {axis} of {tuple(x.shape)} is "
                                 f"neither {self.n} nor {self.n_local}")
            x = x.narrow(axis, self.lo, self.n_local).contiguous()
        return x.to(self.device)

    def _map(self, tree, axis: int):
        if isinstance(tree, _Tensors):
            return tree.map(lambda x: self._slab(x, axis))
        if isinstance(tree, dict):
            return {k: self._map(v, axis) for k, v in tree.items()}
        return self._slab(tree, axis)

    def put(self, tree):
        """The rank's slab of a state, parameters, a dict or a tensor whose
        leading axis is the cell axis, on the rank's device."""
        return self._map(tree, 0)

    def put_block(self, tree):
        """:meth:`put` for ``[days, n, ...]`` blocks (cells on axis 1)."""
        return self._map(tree, 1)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's slab of a global ``[n, ...]`` tensor."""
        return x[self.lo:self.hi]

    def host_local(self, x: torch.Tensor) -> np.ndarray:
        """A host copy of the rank's slab (``x`` is that slab)."""
        if x.shape[0] != self.n_local:
            raise ValueError(f"expected the slab of {self.n_local} cells, "
                             f"got {tuple(x.shape)}")
        return x.detach().cpu().numpy()

    def all_gather_cells(self, x: torch.Tensor, caller: str) -> torch.Tensor:
        """``x`` with its last axis, this rank's cells, gathered from every
        rank in rank order: ``[..., n_local]`` becomes ``[..., n]``, on
        ``x``'s device."""
        collectives[caller] += 1
        if self.world == 1:
            return x
        host = x.detach().to("cpu").contiguous()
        parts = [torch.empty_like(host) for _ in range(self.world)]
        dist.all_gather(parts, host)
        return torch.cat(parts, dim=-1).to(x.device)

    def _all_reduce(self, x: torch.Tensor, op, caller: str) -> torch.Tensor:
        collectives[caller] += 1
        if self.world == 1:
            return x
        host = x.detach().to("cpu").clone()
        dist.all_reduce(host, op=op)
        return host.to(x.device)

    def all_reduce_sum(self, x: torch.Tensor, caller: str) -> torch.Tensor:
        """``x`` summed over the ranks (outside any autograd graph)."""
        return self._all_reduce(x, dist.ReduceOp.SUM, caller)

    def all_reduce_max(self, x: torch.Tensor, caller: str) -> torch.Tensor:
        """The elementwise maximum of ``x`` over the ranks."""
        return self._all_reduce(x, dist.ReduceOp.MAX, caller)


def slab_devices(sharding: Optional[CellSharding],
                 devices: Optional[Sequence] = None):
    """The devices a driver cuts its cells over as :class:`DeviceSlabs`:
    ``devices`` where given, else those of a ``sharding`` whose rank holds
    several, else None (the cells stay whole on one device)."""
    if devices is None and sharding is not None and sharding.n_devices > 1:
        return sharding.devices
    return devices


@dataclasses.dataclass(frozen=True)
class Gathered:
    """A cross-cell module's operands over the whole cell axis (``params``:
    the router's or lateral groundwater's), for a rank that holds one
    slab of it.  Each day the module's inputs are gathered from every rank,
    the unchanged global function runs on them, and the rank keeps its
    slab (``step._route``, ``step._lateral``)."""

    params: object
    sharding: CellSharding


def _move(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``x`` on ``device``: no copy where it is there already, and between
    two CUDA devices a copy ordered on both devices' current streams
    that does not wait for either."""
    return x.to(device, non_blocking=x.is_cuda and device.type == "cuda")


def _zip_map(fn, parts):
    """``fn`` over the matching tensors of ``parts`` (states, dicts or
    tensors of one structure), as a tree of that structure."""
    first = parts[0]
    if isinstance(first, _Tensors):
        return dataclasses.replace(first, **{
            f.name: _zip_map(fn, [getattr(p, f.name) for p in parts])
            for f in dataclasses.fields(first)})
    if isinstance(first, dict):
        return {k: _zip_map(fn, [p[k] for p in parts]) for k in first}
    return fn(parts)


def _concrete(device) -> torch.device:
    """``device`` with its index: ``cuda`` is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass(frozen=True)
class DeviceSlabs:
    """The ``n`` cells one process holds, cut once into contiguous slabs
    ``bounds[i] = (lo, hi)`` (:func:`slab_bounds`: no divisibility
    needed), slab ``i`` resident on ``devices[i]``.  A device may repeat,
    so one card can hold several slabs; every device is of one type, and
    nothing is moved to another type of device behind the caller.

    A tree cut by :meth:`put` is a list with one tree a slab; each slab is
    copied straight from the source to its device (a slab already there
    is a view).  The cross-cell modules' exchanges are in
    ``physics/routing.py`` and ``physics/lateral.py``; their row bands are
    :meth:`row_bands`."""

    devices: tuple
    bounds: tuple

    @classmethod
    def create(cls, n: int, devices: Sequence) -> "DeviceSlabs":
        devices = tuple(_concrete(d) for d in devices)
        kinds = sorted({d.type for d in devices})
        if len(kinds) != 1:
            raise ValueError(f"device slabs need devices of one type, got "
                             f"{[str(d) for d in devices]}")
        return cls(devices=devices,
                   bounds=tuple(slab_bounds(n, len(devices))))

    @property
    def n(self) -> int:
        return self.bounds[-1][1]

    @property
    def k(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The first device, where a gathered tree lands."""
        return self.devices[0]

    def row_bands(self, ny: int) -> tuple:
        """``(r0, r1)`` of the row band of a ``[ny, nx]`` grid that each
        device holds: :func:`slab_bounds` over the rows, so bands may be
        uneven; more devices than rows raise."""
        if ny < self.k:
            raise ValueError(f"cannot cut {ny} grid rows into {self.k} "
                             f"row bands")
        return tuple(slab_bounds(ny, self.k))

    def _cut(self, x, axis: int, i: int) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        device = self.devices[i]
        if x.dim() <= axis:             # a scalar: the same on every slab
            return _move(x, device)
        if x.shape[axis] != self.n:
            raise ValueError(f"cell axis {axis} of {tuple(x.shape)} is not "
                             f"the {self.n} cells of the slabs")
        lo, hi = self.bounds[i]
        return _move(x.narrow(axis, lo, hi - lo), device).contiguous()

    def _split(self, tree, axis: int) -> list:
        def one(i):
            if isinstance(tree, (_Tensors, dict)):
                return _zip_map(lambda xs: self._cut(xs[0], axis, i), [tree])
            return self._cut(tree, axis, i)
        return [one(i) for i in range(self.k)]

    def put(self, tree) -> list:
        """A state, parameters, a dict or a tensor whose leading axis is
        the cell axis, as one tree a slab on its device."""
        return self._split(tree, 0)

    def put_block(self, tree) -> list:
        """:meth:`put` for ``[days, n, ...]`` blocks (cells on axis 1)."""
        return self._split(tree, 1)

    def gather(self, parts: list, caller: str, device=None, axis: int = 0):
        """The slabs' trees joined in cell order on ``device`` (the first
        device by default), the cells on ``axis``, counted as one exchange
        of ``caller``."""
        collectives[caller] += 1
        device = self.device if device is None else torch.device(device)

        def join(xs):
            if len(xs) == 1 or xs[0].dim() == 0:
                return _move(xs[0], device)
            return torch.cat([_move(x, device) for x in xs], dim=axis)
        return _zip_map(join, parts)

    def host(self, parts: list) -> dict:
        """The slabs' dicts of tensors (annual means) as float64 numpy
        arrays joined in cell order, one device-to-host copy a slab."""
        from ..io.writer import to_host
        hosts = [to_host(p) for p in parts]
        return {k: (hosts[0][k] if hosts[0][k].ndim == 0 else
                    np.concatenate([h[k] for h in hosts]))
                for k in hosts[0]}


@dataclasses.dataclass(frozen=True)
class Reshard:
    """Index lists between the slabs' packed land lanes and the row bands
    of a ``[ny, nx]`` grid (band ``b`` on ``slabs.devices[b]``), made once
    per grid and slabs: ``to_bands[b]`` holds ``(s, lanes, pos)`` for
    every slab ``s`` with land lanes in band ``b`` (the lanes, local to
    the slab, on its device; their flat positions in the band, on the
    band's device), ``to_slabs[s]`` the same pairs from the slab's side.
    Padding lanes, and land lanes past ``n_land``, belong to no band."""

    slabs: DeviceSlabs
    rows: tuple
    nx: int
    to_bands: tuple
    to_slabs: tuple

    @classmethod
    def create(cls, slabs: DeviceSlabs, flat_idx: np.ndarray, n_land: int,
               ny: int, nx: int) -> "Reshard":
        rows = slabs.row_bands(ny)
        to_bands = [[] for _ in rows]
        to_slabs = [[] for _ in slabs.bounds]
        for s, (lo, hi) in enumerate(slabs.bounds):
            lanes = np.arange(lo, max(lo, min(hi, n_land)))
            flat = np.asarray(flat_idx[lanes], np.int64)
            for b, (r0, r1) in enumerate(rows):
                sel = (flat >= r0 * nx) & (flat < r1 * nx)
                if not sel.any():
                    continue
                local = torch.tensor(lanes[sel] - lo,
                                     device=slabs.devices[s])
                pos = torch.tensor(flat[sel] - r0 * nx,
                                   device=slabs.devices[b])
                to_bands[b].append((s, local, pos))
                to_slabs[s].append((b, pos, local))
        return cls(slabs=slabs, rows=rows, nx=nx,
                   to_bands=tuple(map(tuple, to_bands)),
                   to_slabs=tuple(map(tuple, to_slabs)))

    def dense(self, parts: list) -> list:
        """The slabs' ``[c, n_slab]`` packed fields scattered onto the row
        bands, ``[c, rows, nx]`` on each band's device, zero where no land
        lane falls: one "reshard"."""
        collectives["reshard"] += 1
        out = []
        for b, (r0, r1) in enumerate(self.rows):
            device = self.slabs.devices[b]
            c = parts[0].shape[0]
            band = torch.zeros((c, (r1 - r0) * self.nx),
                               dtype=parts[0].dtype, device=device)
            for s, lanes, pos in self.to_bands[b]:
                band.index_copy_(1, pos, _move(
                    parts[s].index_select(1, lanes), device))
            out.append(band.view(c, r1 - r0, self.nx))
        return out

    def packed(self, bands: list, init: list) -> list:
        """The bands' ``[c, rows, nx]`` fields gathered back into the
        slabs' packed lanes, written into ``init`` (one ``[c, n_slab]``
        tensor a slab, which keeps its values on lanes no band holds):
        one "reshard"."""
        collectives["reshard"] += 1
        flat = [x.reshape(x.shape[0], -1) for x in bands]
        for s, out in enumerate(init):
            for b, pos, lanes in self.to_slabs[s]:
                out.index_copy_(1, lanes, _move(flat[b].index_select(1, pos),
                                                out.device))
        return init


@dataclasses.dataclass(frozen=True)
class Split:
    """A cross-cell module's ``params`` over device slabs: the reshard
    between the slabs and the row bands, and the bands (``Band``; band
    ``b`` on the device of slab ``b``)."""

    params: object
    reshard: Reshard
    bands: tuple


class RowBanded:
    """A cross-cell module's params that run on row bands of a grid:
    ``split(slabs)`` cuts them over device slabs once per slabs, from the
    packed lanes' grid (``_grid``) and the module's bands
    (``_bands``)."""

    def _grid(self) -> tuple:
        """``(flat_idx, n_land, ny, nx)``: the packed land lanes' flat
        grid indices (numpy), their count and the grid's shape."""
        raise NotImplementedError

    def _bands(self, rows, devices) -> tuple:
        """The module's static fields cut into the row bands ``rows[b]``
        on ``devices[b]``."""
        raise NotImplementedError

    @functools.cached_property
    def _splits(self) -> dict:
        return {}

    def split(self, slabs: DeviceSlabs) -> Split:
        """These params cut over ``slabs``: the row bands and the
        reshard's index lists, made once per slabs and not once a day."""
        got = self._splits.get(slabs)
        if got is None:
            reshard = Reshard.create(slabs, *self._grid())
            got = self._splits[slabs] = Split(
                params=self, reshard=reshard,
                bands=self._bands(reshard.rows, slabs.devices))
        return got


@dataclasses.dataclass(frozen=True)
class Band:
    """Rows ``[r0, r1)`` of a ``[ny, nx]`` grid held on ``device``, with a
    cross-cell module's static fields cut to them (``fields``)."""

    r0: int
    r1: int
    nx: int
    device: torch.device
    fields: dict

    @functools.cached_property
    def _zeros(self) -> dict:
        return {}

    def zero_row(self, dtype: torch.dtype) -> torch.Tensor:
        """A ``[1, nx]`` zero row in ``dtype`` on the band's device, made
        once: the halo beyond a pole."""
        row = self._zeros.get(dtype)
        if row is None:
            row = self._zeros[dtype] = torch.zeros(
                (1, self.nx), dtype=dtype, device=self.device)
        return row


def halo_rows(parts: list, bands: Sequence[Band], above: bool = True,
              below: bool = True) -> list:
    """Each band's ``[h, nx]`` rows with one row above and one below, as a
    global ``roll`` over the rows would bring them: the neighbour band's
    edge row copied to this band's device (one "halo" exchange a row),
    and a zero row beyond a pole or on a side not asked for.  Longitude
    needs no halo: a band holds whole rows."""
    k = len(parts)
    out = []
    for b, x in enumerate(parts):
        up = down = bands[b].zero_row(x.dtype)
        if above and b > 0:
            collectives["halo"] += 1
            up = _move(parts[b - 1][-1:], x.device)
        if below and b < k - 1:
            collectives["halo"] += 1
            down = _move(parts[b + 1][:1], x.device)
        out.append(torch.cat([up, x, down]))
    return out
