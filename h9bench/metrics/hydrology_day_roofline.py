"""The hydrology day against its roofline, whatever build carries it:
the least time of the window's hydrology days
(``roofline.least_cell_day``) over the device time of the program's
``day.hydrology`` spans (the CUDA event pair around each day's
hydrology: its kernel, and the time the device waited for the host to
launch it).  Loading this reader
switches the program's span recorder on; nothing is read where the
program has no recorder or no such span ran on the device."""

from h9bench.recorder import profiling, reader


def value(trace, spans):
    seconds = sum(profiling.device_ms(s) or 0.0 for s in spans
                  if s.name == "day.hydrology") / 1e3
    if seconds <= 0.0:
        return None
    return 100.0 * trace.least_s / seconds


read = reader(value)
