"""Device idle milliseconds a model day that the day loop's own issue
causes: of the gaps between the window's kernels, those that began
while the host's innermost open span lay inside an ``ensemble.day`` or
an ``assimilate.cycle`` and was not ``python.gc``, summed, over the
model days.  A graph of the day can remove at most this much.  The
kernels' times and the spans share the epoch clock.  Loading this
reader switches the program's span recorder on; nothing is read where
the program has no recorder or no such span ran."""

from h9bench.recorder import reader

LOOPS = ("ensemble.day", "assimilate.cycle")


def _in_loop(span) -> bool:
    while span is not None:
        if span.name in LOOPS:
            return True
        span = span.parent
    return False


def value(trace, spans):
    closed = [s for s in spans
              if s.end_ns is not None and s.end_ns > s.start_ns]
    if not trace.model_days or not any(s.name in LOOPS for s in closed):
        return None
    # Opens and closes in time order, a close before an open at one
    # instant: a span is open over [start, end).
    marks = sorted([(s.start_ns, 1, i) for i, s in enumerate(closed)]
                   + [(s.end_ns, 0, i) for i, s in enumerate(closed)])
    kernels = sorted((start, start + dur) for _, start, dur in trace.kernels)
    open_now, k, idle_ns, busy_until = [], 0, 0, None
    for start, end in kernels:
        if busy_until is not None and start > busy_until:
            # The device went idle at busy_until: whose issue held it?
            while k < len(marks) and marks[k][0] <= busy_until:
                _, opens, i = marks[k]
                if opens:
                    open_now.append(closed[i])
                else:
                    open_now.remove(closed[i])
                k += 1
            inner = max(open_now, key=lambda s: s.start_ns, default=None)
            if (inner is not None and inner.name != "python.gc"
                    and _in_loop(inner)):
                idle_ns += start - busy_until
        busy_until = end if busy_until is None else max(busy_until, end)
    return idle_ns / 1e6 / trace.model_days


read = reader(value)
