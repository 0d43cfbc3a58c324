"""The fixed-layer-count build of the day kernel (``day_kernel``) against
its roofline: the least time of the window's hydrology days
(``roofline.least_cell_day``: operations over the float32 peak, bytes
over the memory peak, the larger) over the device time of the kernels of
that name.  Nothing is read where no such kernel ran."""

import re

PATTERN = re.compile(r"\bday_kernel\b")


def read(trace):
    seconds = sum(d for name, _, d in trace.kernels
                  if PATTERN.search(name)) / 1e9
    if seconds <= 0.0:
        return None
    return 100.0 * trace.least_s / seconds
