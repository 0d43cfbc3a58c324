"""The whole day's share of the card's peak: the least time of the
window's hydrology days (``roofline.least_cell_day``) over the traced
window's host seconds.  It counts the same work whatever implements it,
so it still bounds a gain when a kernel leaves the path."""


def read(trace):
    if trace.window_s <= 0.0 or trace.least_s <= 0.0:
        return None
    return 100.0 * trace.least_s / trace.window_s
