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
Within a rank, ``devices`` is the single-controller launcher's list
(``hydrology_day_sharded``): with one rank and several cards it is
today's ``devices=`` path.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..state import _Tensors
from .launch import host_shard_bounds, process_count, process_index

#: Calls of the exchange in this process, by caller ("routing",
#: "lateral", "spinup", "calibrate", "output").
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


@dataclasses.dataclass(frozen=True)
class Gathered:
    """A cross-cell module's operands over the whole cell axis (``params``:
    the router's or lateral groundwater's), for a rank that holds one
    slab of it.  Each day the module's inputs are gathered from every rank,
    the unchanged global function runs on them, and the rank keeps its
    slab (``step._route``, ``step._lateral``)."""

    params: object
    sharding: CellSharding
