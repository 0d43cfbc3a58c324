"""Host milliseconds a model day in Python's garbage collector: the
program's ``python.gc`` spans (one a collection, every generation) that
began inside the traced window, from its first kernel's start to its
last kernel's end (the spans and the kernels share the epoch clock), over
the window's model days.  Collections outside it, such as those of
reading the profiler's events, are left out.  Loading this reader
switches the program's span recorder on, which hooks the collector;
nothing is read where the program has no recorder or no kernel ran."""

from h9bench.recorder import reader


def value(trace, spans):
    if not trace.model_days or not trace.kernels:
        return None
    lo = min(start for _, start, _ in trace.kernels)
    hi = max(start + dur for _, start, dur in trace.kernels)
    ns = sum(s.end_ns - s.start_ns for s in spans
             if s.name == "python.gc" and s.end_ns is not None
             and lo <= s.start_ns <= hi)
    return ns / 1e6 / trace.model_days


read = reader(value)
