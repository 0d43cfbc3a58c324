"""The traced run: the profiler around a fixed number of calls, and the
reduction of its events to what the per-layer readers read.

The profiler records the device's activity and the CUDA calls that
launched it, and no host operations: recording every host operation adds
some 14 % to an ensemble year's host time, and the idle share would then
measure the profiler.  Its first session in a process costs seconds more
(buffers, the tracing library's start), so set-up opens and closes one
before the window.  Only the raw events are read (name, start, duration,
correlation), without building the profiler's per-op tables, so a year of
some 185,000 launches reduces in a second.  A span is a host interval
that the harness brackets with the clock the events use (nanoseconds
since the epoch); a kernel belongs to it if its launch call began inside.
A reader in ``metrics/`` gets a :class:`Trace`.
"""

from __future__ import annotations

import bisect
import contextlib
import gzip
import importlib
import json
import os
import time
from dataclasses import dataclass, field

_TOP = 10


@dataclass
class Trace:
    """What a traced window held: its kernels ``(name, start_ns,
    duration_ns)``, the seconds the device was busy (the union of its
    kernels, copies and fills) and the window's host seconds, the model
    days and member-cell-days its calls finished, the least seconds of
    those days' hydrology (``roofline.least_cell_day``), and per span
    named by a reader its device seconds and instances."""

    kernels: list
    busy_s: float
    window_s: float
    model_days: int
    cell_days: int
    least_s: float
    spans: dict = field(default_factory=dict)


def _ns(e, name):
    f = getattr(e, name + "_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, name + "_us")() * 1000)


def _on_device(e) -> bool:
    return "CUDA" in str(e.device_type())


@contextlib.contextmanager
def spans(readers: dict, brackets: dict):
    """Bracket each call of every function a reader names in ``SPAN =
    (module, function, label)``: the host interval of each call is
    appended to ``brackets[label]``.  For the traced run only; the
    function is put back on exit.  A function the program no longer has
    is left alone, and its reader then finds nothing."""
    undo = []
    for reader in readers.values():
        span = getattr(reader, "SPAN", None)
        if span is None:
            continue
        module_name, fn_name, label = span
        module = importlib.import_module(module_name)
        fn = getattr(module, fn_name, None)
        if fn is None:
            continue
        got = brackets.setdefault(label, [])

        def wrapped(*a, _fn=fn, _got=got, **kw):
            t0 = time.time_ns()
            try:
                return _fn(*a, **kw)
            finally:
                _got.append((t0, time.time_ns()))

        setattr(module, fn_name, wrapped)
        undo.append((module, fn_name, fn))
    try:
        yield
    finally:
        for module, fn_name, fn in undo:
            setattr(module, fn_name, fn)


def _profiler():
    import torch
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])


def start_tracing():
    """Open and close one profiler session, so that the window's is not
    the process's first (part of set-up)."""
    import torch
    with _profiler():
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def profile(call, n_calls: int):
    """Run ``call(k)`` for ``k < n_calls`` under the profiler; returns
    ``(results, raw events, window seconds)``.  Each call's own host copy
    closes it."""
    import torch

    with _profiler() as prof:
        t0 = time.perf_counter()
        results = [call(k) for k in range(n_calls)]
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    return results, list(prof.profiler.kineto_results.events()), window_s


def reduce(events: list, window_s: float, model_days: int, cell_days: int,
           least_cell_day_s: float, brackets=None) -> tuple:
    """``(Trace, breakdown)`` of the raw events: the breakdown's
    ``device_ops`` are the device activities that took the most time, by
    name, and its ``idle_gaps`` the device's idle time between its first
    and last activity, summed by what the host was doing where each gap
    began: the CUDA call in flight, else the span it was in, else
    ``host: between CUDA calls``."""
    brackets = brackets or {}
    kernels, device, calls, launch_at = [], [], [], {}
    for e in events:
        start, dur = _ns(e, "start"), _ns(e, "duration")
        name = e.name()
        if _on_device(e):
            device.append((start, start + dur, name))
            if not name.startswith(("Memcpy", "Memset")):
                kernels.append((name, start, dur, e.correlation_id()))
        else:
            calls.append((start, start + dur, name))
            launch_at[e.correlation_id()] = start
    device.sort()
    merged = []
    for s, t, _ in device:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy_s = sum(t - s for s, t in merged) / 1e9

    by_name = {}
    for s, t, name in device:
        by_name[name] = by_name.get(name, 0.0) + (t - s) / 1e9
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:_TOP]

    # Label each gap where it began: the CUDA calls do not nest, so the
    # one in flight is the last to start before it, if it has not ended.
    calls.sort()
    call_starts = [c[0] for c in calls]
    spans_sorted = sorted((s, t, label) for label, got in brackets.items()
                          for s, t in got)
    span_starts = [s[0] for s in spans_sorted]
    idle = {}
    for i in range(len(merged) - 1):
        at, length = merged[i][1], merged[i + 1][0] - merged[i][1]
        k = bisect.bisect_right(call_starts, at) - 1
        j = bisect.bisect_right(span_starts, at) - 1
        if k >= 0 and calls[k][1] > at:
            label = calls[k][2]
        elif j >= 0 and spans_sorted[j][1] > at:
            label = spans_sorted[j][2]
        else:
            label = "host: between CUDA calls"
        idle[label] = idle.get(label, 0.0) + length / 1e9
    idle_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:_TOP]

    span_s = {}
    for label, got in brackets.items():
        ranges = sorted(got)
        lo = [r[0] for r in ranges]
        total = 0.0
        for _, _, dur, corr in kernels:
            at = launch_at.get(corr)
            if at is None:
                continue
            k = bisect.bisect_right(lo, at) - 1
            if k >= 0 and at <= ranges[k][1]:
                total += dur / 1e9
        span_s[label] = (total, len(ranges))

    trace = Trace(kernels=[k[:3] for k in kernels], busy_s=busy_s,
                  window_s=window_s, model_days=model_days,
                  cell_days=cell_days,
                  least_s=cell_days * least_cell_day_s, spans=span_s)
    breakdown = dict(device_ops=[[n, s] for n, s in device_ops],
                     idle_gaps=[[n, s] for n, s in idle_gaps])
    return trace, breakdown


def write(path: str, trace: Trace, breakdown: dict, limit: int = 20000):
    """A gzipped Chrome trace of the window's first ``limit`` kernels
    and the breakdown beside it, for reading by hand."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    ev = [dict(name=n, ph="X", ts=s / 1e3, dur=d / 1e3, pid=0, tid=0)
          for n, s, d in trace.kernels[:limit]]
    with gzip.open(path, "wt") as f:
        json.dump(dict(traceEvents=ev, breakdown=breakdown,
                       busy_s=trace.busy_s, window_s=trace.window_s), f)
