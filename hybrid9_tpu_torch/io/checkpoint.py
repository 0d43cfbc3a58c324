"""Checkpoint/restore of the prognostic state.

Port of ``hybrid9_tpu/io/checkpoint.py`` (the reference has no
checkpointing; the JAX package saves with Orbax).  A checkpoint is one
file ``<path>/year_<year>.pt`` written with ``torch.save``: the simulated
year, the cell slab ``[lo, hi)`` it holds, the number of ranks that wrote
it and the ``ModelState``'s tensors by field name, nested as the
dataclasses nest, on the CPU.  A multi-process run writes one file per
rank, ``year_<year>.rank<i>of<world>.pt``, each with the rank's slab,
and each rank restores its own.  It restores onto any device, with the
JAX package's schema-migration rule; a checkpoint written by another
number of ranks is refused, as the JAX package's raw restore refuses
another topology.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Optional, Tuple

import torch

from ..state import ModelState
from ..utils.logging import get_logger

log = get_logger(__name__)

_NAME = re.compile(r"^year_(-?\d+)(?:\.rank(\d+)of(\d+))?\.pt$")


def _as_dict(state) -> dict:
    """The state's tensors by field name, nested, on the CPU."""
    return {f.name: (_as_dict(v) if dataclasses.is_dataclass(v)
                     else v.detach().to("cpu"))
            for f in dataclasses.fields(state)
            for v in (getattr(state, f.name),)}


def _fill_from_raw(template, raw):
    """Rebuild ``template``'s dataclass from a restored nested dict.

    A field present in ``raw`` is cast to the template field's dtype and
    put on its device; a field absent from ``raw`` (added after the
    checkpoint was written) takes the template's value, so a fresh
    initial state as template restores new fields to their physical
    defaults, not to zero; a field only in ``raw`` is dropped.  Returns
    ``(state, n_missing)``."""
    kw = {}
    n_missing = 0
    for f in dataclasses.fields(template):
        leaf = getattr(template, f.name)
        val = raw.get(f.name) if isinstance(raw, dict) else None
        if dataclasses.is_dataclass(leaf):
            kw[f.name], missing = _fill_from_raw(
                leaf, val if isinstance(val, dict) else {})
            n_missing += missing
        elif isinstance(val, torch.Tensor):
            kw[f.name] = val.to(device=leaf.device, dtype=leaf.dtype)
        else:
            kw[f.name] = leaf
            n_missing += 1
    return type(template)(**kw), n_missing


def _ranks(sharding) -> Tuple[int, int]:
    """``(rank, world)`` of a sharding; ``(0, 1)`` for None."""
    return (0, 1) if sharding is None else (sharding.rank, sharding.world)


class Checkpointer:
    """``torch.save`` checkpoints keyed by simulated year, the newest
    ``max_to_keep`` kept.

    Saving is synchronous: ``save`` copies the state to the host and
    returns when the file is in place (written to a temporary name and
    renamed, so a reader never sees half a file); ``wait`` has nothing to
    wait for and is there for the JAX package's interface.  With
    ``sharding`` (one rank of a multi-process run, whose state is its
    slab) each rank saves and restores its own file.
    """

    def __init__(self, path: str, max_to_keep: int = 3, sharding=None):
        self.path = os.path.abspath(path)
        self.max_to_keep = max_to_keep
        self.sharding = sharding
        os.makedirs(self.path, exist_ok=True)

    def _file(self, year: int, sharding=None) -> str:
        rank, world = _ranks(sharding)
        part = "" if world == 1 else f".rank{rank}of{world}"
        return os.path.join(self.path, f"year_{year}{part}.pt")

    def _written(self) -> list:
        """``(year, rank, world)`` of every checkpoint file on disk."""
        found = (_NAME.match(n) for n in os.listdir(self.path))
        return [(int(m.group(1)), int(m.group(2) or 0), int(m.group(3) or 1))
                for m in found if m]

    def years(self) -> list:
        """The years with a checkpoint, oldest first."""
        return sorted({year for year, _, _ in self._written()})

    def save(self, year: int, state: ModelState) -> None:
        sh = self.sharding
        lo, hi = ((0, state.veg.lai.shape[0]) if sh is None
                  else (sh.lo, sh.hi))
        path = self._file(year, sh)
        tmp = path + ".tmp"
        torch.save({"year": int(year), "lo": lo, "hi": hi,
                    "world": _ranks(sh)[1], "state": _as_dict(state)}, tmp)
        os.replace(tmp, path)
        mine = sorted(y for y, r, w in self._written()
                      if (r, w) == _ranks(sh))
        for old in mine[:-self.max_to_keep]:
            os.remove(self._file(old, sh))
        log.info("checkpoint saved for year %d at %s", year, self.path)

    def latest_year(self) -> Optional[int]:
        years = self.years()
        return years[-1] if years else None

    def restore(self, template: ModelState, year: Optional[int] = None,
                sharding=None) -> Tuple[int, ModelState]:
        """Restore the checkpoint of ``year`` (default: the latest) onto
        the device and dtypes of ``template``.  A field the file lacks
        takes the template's value (pass a fresh initial state);
        ``_fill_from_raw`` has the rule.

        With ``sharding`` (default: the checkpointer's) the restore is
        one rank's: it reads only the file of the rank's slab, and
        ``template`` is that slab.  A checkpoint written by another number
        of ranks raises and names both."""
        sharding = sharding if sharding is not None else self.sharding
        rank, world = _ranks(sharding)
        step = self.latest_year() if year is None else year
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.path}")
        path = self._file(step, sharding)
        if not os.path.exists(path):
            written = sorted({w for y, _, w in self._written()
                              if y == step})
            raise ValueError(
                f"the checkpoint of year {step} under {self.path} was "
                f"written by {' or '.join(map(str, written))} rank(s); "
                f"this run has {world}")
        raw = torch.load(path, weights_only=True,
                         map_location=template.soil.h2osoi_liq.device)
        if world > 1 and (raw.get("lo"), raw.get("hi")) != (
                sharding.lo, sharding.hi):
            raise ValueError(f"{path} holds cells [{raw.get('lo')}, "
                             f"{raw.get('hi')}), this rank "
                             f"[{sharding.lo}, {sharding.hi})")
        state, n_missing = _fill_from_raw(template, raw["state"])
        if world > 1:
            if n_missing:
                log.warning("sharded schema migration: %d field(s) filled "
                            "from the template", n_missing)
            log.info("restored sharded checkpoint for year %d (process %d "
                     "reads only its own slab)", step, rank)
        else:
            if n_missing:
                log.warning("schema migration: %d field(s) filled from "
                            "the template", n_missing)
            log.info("restored checkpoint for year %d", step)
        return int(raw["year"]), state

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for."""

    def close(self) -> None:
        """Nothing is held open."""
