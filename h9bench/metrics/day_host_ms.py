"""Host milliseconds a model day spends issuing the day step: the host
time inside the program's ``day`` spans (``step.day_step``,
``step.slab_day_step``) over the window's model days.  Compare with the
device's milliseconds a day (``busy_s`` over the model days).  Loading
this reader switches the program's span recorder on; nothing is read
where the program has no recorder."""

from h9bench.recorder import reader


def value(trace, spans):
    ns = sum(s.end_ns - s.start_ns for s in spans
             if s.name == "day" and s.end_ns is not None)
    if not trace.model_days or ns <= 0:
        return None
    return ns / 1e6 / trace.model_days


read = reader(value)
