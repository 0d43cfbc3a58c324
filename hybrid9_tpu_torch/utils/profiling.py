"""Spans of the model's work, and a host sync of a tree of tensors.

Port of ``hybrid9_tpu/utils/profiling.py``, which replaced the
reference's CPU_TIME bookkeeping (INIT.f90:50; HYBRID9.f90:572-573;
CONTROL.f90:63-66).  Here one recorder, off by default, times the
program's parts where they run: a day and each of its modules, an
ensemble's folded day, an assimilation window, its cycles and analyses,
and every collection by Python's garbage collector (``python.gc``).

``record(True)`` switches it on.  Each span then keeps its name, its
parent (the innermost span open on entry, so a call's root span
identifies all of that call's spans), its host start and end in
``time.time_ns()`` (the epoch clock of ``torch.profiler``'s events, so a
span lines up with a device trace) and its attributes; a span opened
with ``device=`` a CUDA tensor also records a pair of CUDA events on the
current stream, and :func:`device_ms` reads the span's share of the
device's timeline once the caller has synchronised: its kernels, and the
time the device waited for the span's launches.  :func:`spanned` makes a
function's whole call a span, :func:`annotate` adds attributes to the
open span.  Spans stay in memory (:func:`spans`); :func:`write_trace`
writes them as a Chrome trace.  Off, :func:`span` returns one shared
no-op object: no clock is read and nothing is allocated.

A CUDA launch returns before the device has run it, so a host clock
around launched work measures the enqueue; ``device_sync`` copies a
scalar reduction to the host, which waits for the stream to drain.
"""

from __future__ import annotations

import functools
import gc
import json
import os
import threading
import time
from typing import List, Optional

import torch


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


class Span:
    """One recorded interval of the program's work: ``name``, ``parent``
    (a Span or None), host ``start_ns`` and ``end_ns`` (epoch
    nanoseconds; ``end_ns`` None while open), ``attrs``, the ``thread``
    it ran on and ``events``, the CUDA event pair of a span on the
    device (else None)."""

    __slots__ = ("name", "parent", "start_ns", "end_ns", "attrs", "thread",
                 "events", "_stream")

    def __init__(self, name: str, parent=None, start_ns: int = 0,
                 end_ns: Optional[int] = None, attrs=None, events=None,
                 thread: int = 0):
        self.name, self.parent = name, parent
        self.start_ns, self.end_ns = start_ns, end_ns
        self.attrs = {} if attrs is None else attrs
        self.events, self.thread, self._stream = events, thread, None

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        stack.append(self)
        _recorder.spans.append(self)
        self.thread = threading.get_ident()
        self.start_ns = time.time_ns()
        if self.events is not None:
            self.events[0].record(self._stream)
        return self

    def __exit__(self, exc_type, exc, tb):
        if self.events is not None:
            self.events[1].record(self._stream)
        self.end_ns = time.time_ns()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        return False


class _NoSpan:
    """What :func:`span` returns while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_NO_SPAN = _NoSpan()


class _Recorder:
    """The recorded spans, each thread's open spans and the garbage
    collection in progress."""

    def __init__(self):
        self.spans: List[Span] = []
        self.open = threading.local()
        self.collecting: Optional[Span] = None


_recorder = _Recorder()
#: The switch (:func:`record`), a module global: :func:`span` reads it
#: once a call.
_on = False


def _stack() -> list:
    stack = getattr(_recorder.open, "stack", None)
    if stack is None:
        stack = _recorder.open.stack = []
    return stack


def _on_gc(phase: str, info: dict) -> None:
    """``gc.callbacks`` hook: each collection becomes a ``python.gc``
    span with its ``generation`` and the objects it ``collected``."""
    if phase == "start":
        stack = _stack()
        _recorder.collecting = Span(
            "python.gc", stack[-1] if stack else None, time.time_ns(),
            attrs={"generation": info["generation"]},
            thread=threading.get_ident())
        return
    got = _recorder.collecting
    if got is None:
        return
    got.end_ns = time.time_ns()
    got.attrs["collected"] = info["collected"]
    _recorder.spans.append(got)
    _recorder.collecting = None


def record(on: bool) -> None:
    """Switch the recorder on or off.  Switching it on from off starts an
    empty list of spans and hooks the garbage collector; switching it off
    removes the hook and keeps the list for reading."""
    global _on
    on = bool(on)
    if on == _on:
        return
    if on:
        _recorder.spans = []
        gc.callbacks.append(_on_gc)
    else:
        gc.callbacks.remove(_on_gc)
        _recorder.collecting = None
    _on = on


def recording() -> bool:
    """Whether the recorder is on: gate work done only for a span's
    attributes behind it."""
    return _on


def span(name: str, device: Optional[torch.Tensor] = None):
    """A context manager that records ``name`` over its block while the
    recorder is on.  With ``device`` a CUDA tensor, the span also records
    a CUDA event pair on that device's current stream (:func:`device_ms`).
    Off, the shared no-op object."""
    if not _on:
        return _NO_SPAN
    s = Span(name)
    if device is not None and device.is_cuda:
        s._stream = torch.cuda.current_stream(device.device)
        s.events = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
    return s


def spanned(name: str, device=None):
    """Decorate a function so that each call is the span ``name``.  Off,
    the wrapper calls the function straight away; on, ``device``, where
    given, picks the tensor of the span's device pair from the call's
    arguments (it takes the function's arguments)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            on = None if device is None else device(*args, **kwargs)
            with span(name, device=on):
                return fn(*args, **kwargs)
        return call
    return wrap


def annotate(**attrs) -> None:
    """Add ``attrs`` to this thread's innermost open span.  Nothing while
    the recorder is off or no span is open."""
    stack = _stack() if _on else None
    if stack:
        stack[-1].attrs.update(attrs)


def spans() -> List[Span]:
    """The spans recorded since the recorder was last switched on: each
    span as it opened, each ``python.gc`` as it ended."""
    return _recorder.spans


def device_ms(s: Span) -> Optional[float]:
    """Milliseconds of the device's timeline between a span's CUDA events
    (None for a span without them).  The caller synchronises first."""
    if s.events is None:
        return None
    return s.events[0].elapsed_time(s.events[1])


def write_trace(path: str) -> int:
    """Write the closed spans of :func:`spans` as a Chrome trace
    (Perfetto, chrome://tracing): complete events (``ph: "X"``) in
    microseconds of the epoch clock, one track a thread, each with its
    attributes, its ``id``, its parent's ``parent_id`` and, for a span on
    the device, ``device_ms`` in ``args``.  Waits for each span's end
    event.  Returns the number of spans written."""
    closed = [s for s in spans() if s.end_ns is not None]
    ids = {id(s): i for i, s in enumerate(closed)}
    pid = os.getpid()
    events = []
    for i, s in enumerate(closed):
        args = dict(s.attrs, id=i)
        if s.parent is not None and id(s.parent) in ids:
            args["parent_id"] = ids[id(s.parent)]
        if s.events is not None:
            s.events[1].synchronize()
            args["device_ms"] = device_ms(s)
        events.append(dict(name=s.name, ph="X", ts=s.start_ns / 1e3,
                           dur=(s.end_ns - s.start_ns) / 1e3, pid=pid,
                           tid=s.thread, args=args))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(dict(traceEvents=events, displayTimeUnit="ms"), f)
    return len(events)
