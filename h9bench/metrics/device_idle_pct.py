"""The device's idle share of the traced window: 100 x (1 - the union of
its kernels, copies and fills over the window's host seconds)."""


def read(trace):
    if trace.window_s <= 0.0 or trace.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
