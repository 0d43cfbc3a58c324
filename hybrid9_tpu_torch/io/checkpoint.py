"""Checkpoint/restore of the prognostic state.

Port of ``hybrid9_tpu/io/checkpoint.py`` (the reference has no
checkpointing; the JAX package saves with Orbax).  A checkpoint is one
file ``<path>/year_<year>.pt`` written with ``torch.save``: the simulated
year and the ``ModelState``'s tensors by field name, nested as the
dataclasses nest, on the CPU.  It restores onto any device, with the
JAX package's schema-migration rule.
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

_NAME = re.compile(r"^year_(-?\d+)\.pt$")


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


class Checkpointer:
    """``torch.save`` checkpoints keyed by simulated year, the newest
    ``max_to_keep`` kept.

    Saving is synchronous: ``save`` copies the state to the host and
    returns when the file is in place (written to a temporary name and
    renamed, so a reader never sees half a file); ``wait`` has nothing to
    wait for and is there for the JAX package's interface.
    """

    def __init__(self, path: str, max_to_keep: int = 3):
        self.path = os.path.abspath(path)
        self.max_to_keep = max_to_keep
        os.makedirs(self.path, exist_ok=True)

    def _file(self, year: int) -> str:
        return os.path.join(self.path, f"year_{year}.pt")

    def years(self) -> list:
        """The years with a checkpoint, oldest first."""
        found = (_NAME.match(n) for n in os.listdir(self.path))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, year: int, state: ModelState) -> None:
        path = self._file(year)
        tmp = path + ".tmp"
        torch.save({"year": int(year), "state": _as_dict(state)}, tmp)
        os.replace(tmp, path)
        for old in self.years()[:-self.max_to_keep]:
            os.remove(self._file(old))
        log.info("checkpoint saved for year %d at %s", year, self.path)

    def latest_year(self) -> Optional[int]:
        years = self.years()
        return years[-1] if years else None

    def restore(self, template: ModelState, year: Optional[int] = None,
                sharding=None) -> Tuple[int, ModelState]:
        """Restore the checkpoint of ``year`` (default: the latest) onto
        the device and dtypes of ``template``.  A field the file lacks
        takes the template's value (pass a fresh initial state);
        ``_fill_from_raw`` has the rule.  A sharded restore waits for
        ROADMAP A9."""
        if sharding is not None:
            raise NotImplementedError(
                "a sharded restore is not ported yet: ROADMAP A9 "
                "(multi-device)")
        step = self.latest_year() if year is None else year
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.path}")
        raw = torch.load(self._file(step), weights_only=True,
                         map_location=template.soil.h2osoi_liq.device)
        state, n_missing = _fill_from_raw(template, raw["state"])
        if n_missing:
            log.warning("schema migration: %d field(s) filled from the "
                        "template", n_missing)
        log.info("restored checkpoint for year %d", step)
        return int(raw["year"]), state

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for."""

    def close(self) -> None:
        """Nothing is held open."""
