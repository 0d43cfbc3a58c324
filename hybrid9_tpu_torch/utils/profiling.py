"""Phase timers and torch.profiler integration.

Port of ``hybrid9_tpu/utils/profiling.py``: it replaces the reference's
CPU_TIME bookkeeping (INIT.f90:50; HYBRID9.f90:572-573;
CONTROL.f90:63-66) with named phase timers, and wraps ``torch.profiler``
tracing for kernel-level inspection.

A CUDA launch returns before the device has run it, so a host clock
around launched work measures the enqueue; ``device_sync`` copies a
scalar reduction to the host, which waits for the stream to drain.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch

from .logging import get_logger

log = get_logger(__name__)


def _first_tensor(tree):
    """The first tensor of a tensor, a sequence, a mapping (by sorted key,
    as JAX orders a dict's leaves) or a state dataclass
    (``state._Tensors``, by field), depth first."""
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        children = [tree[k] for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        children = tree
    else:
        children = getattr(tree, "__dict__", {}).values()
    for child in children:
        leaf = _first_tensor(child)
        if leaf is not None:
            return leaf
    return None


def device_sync(tree) -> float:
    """Drain the device queue by copying a scalar reduction of the first
    tensor of ``tree`` to the host."""
    return float(torch.sum(_first_tensor(tree)))


class PhaseTimers:
    """Accumulating named wall-clock timers."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_on is not None:
                device_sync(sync_on)
            dtime = time.perf_counter() - t0
            self.totals[name] += dtime
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get,
                           reverse=True):
            lines.append(f"{name:24s} {self.totals[name]:10.3f}s "
                         f"x{self.counts[name]}")
        return "\n".join(lines)

    def log_report(self) -> None:
        for line in self.report().splitlines():
            log.info("timer: %s", line)


@contextlib.contextmanager
def trace(log_dir: str = "h9torch_trace"):
    """Profile the CPU and the CUDA device inside the block and export a
    Chrome trace (Perfetto, chrome://tracing) into ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)
