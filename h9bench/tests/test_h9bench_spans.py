"""The readers of the program's spans, on a hand-built window: a
``Trace`` and a span list whose numbers are worked out by hand.  Each
reader is also loaded against a program without the recorder, where it
reads nothing and raises nothing."""

import pytest

from h9bench import harness
from h9bench.trace import Trace
from hybrid9_tpu_torch.utils import profiling

SPAN_READERS = ("hydrology_day_roofline", "day_host_ms", "day_idle_ms",
                "gc_ms_per_day", "da_analysis_device_ms")


class _Event:
    """A CUDA event's stand-in: ``elapsed_time`` in milliseconds."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, end):
        return end.ms - self.ms


def _span(name, start, end, parent=None, device_ms=None):
    events = None if device_ms is None else (_Event(0.0), _Event(device_ms))
    return profiling.Span(name, parent, start, end, events=events)


def _trace(kernels=(), model_days=2, least_s=1e-3):
    return Trace(kernels=list(kernels), busy_s=1.0, window_s=2.0,
                 model_days=model_days, cell_days=10, least_s=least_s)


@pytest.fixture
def readers():
    """The readers, loaded; the recorder left as it was."""
    was = profiling.recording()
    got = {name: harness.load_reader(name) for name in SPAN_READERS}
    yield got
    profiling.record(was)


def test_device_readers(readers):
    day = _span("day", 0, 10)
    spans = [day, _span("day.hydrology", 1, 2, day, 2.0),
             _span("day.hydrology", 3, 4, day, 3.0),
             _span("day.grow", 5, 6, day, 7.0)]
    # 1 ms of least time over 5 ms of the hydrology days' device time.
    got = readers["hydrology_day_roofline"].value(_trace(), spans)
    assert got == pytest.approx(20.0)
    assert readers["hydrology_day_roofline"].value(_trace(), [day]) is None
    cycle = _span("assimilate.cycle", 0, 10)
    spans = [_span("assimilate.analysis", 1, 2, cycle, ms)
             for ms in (0.5, 0.7, 0.9)]
    got = readers["da_analysis_device_ms"].value(_trace(), spans)
    assert got == pytest.approx(0.7)
    assert readers["da_analysis_device_ms"].value(_trace(), [cycle]) is None


def test_host_readers(readers):
    outer = _span("ensemble.day", 0, 10_000_000)
    spans = [outer, _span("day", 0, 2_000_000, outer),
             _span("day", 3_000_000, 7_000_000, outer),
             _span("python.gc", 4_000_000, 5_000_000),
             _span("python.gc", 8_000_000, 8_500_000),
             _span("day", 9_000_000, None, outer)]      # still open
    # 2 + 4 ms of day spans over 2 days.
    assert readers["day_host_ms"].value(_trace(), spans) == pytest.approx(
        3.0)
    assert readers["day_host_ms"].value(_trace(), [outer]) is None
    # The window runs from the first kernel's start to the last one's
    # end: 1.5 ms of collection inside it over 3 days; the collection
    # after it is left out.
    window = [("a", 1_000_000, 500_000), ("b", 6_000_000, 2_000_000)]
    late = _span("python.gc", 8_500_001, 9_500_000)
    got = readers["gc_ms_per_day"].value(_trace(window, model_days=3),
                                         spans + [late])
    assert got == pytest.approx(0.5)
    assert readers["gc_ms_per_day"].value(_trace(window), [outer]) == 0.0
    assert readers["gc_ms_per_day"].value(_trace(), spans) is None


def test_day_idle(readers):
    run = _span("ensemble.run", 0, 1000)
    day1 = _span("ensemble.day", 100, 500, run)
    step = _span("day", 150, 450, day1)
    spans = [run, day1, step, _span("python.gc", 300, 350, step),
             _span("ensemble.day", 500, 900, run)]
    kernels = [("a", 0, 50),      # gap 50-120: in ensemble.run only
               ("b", 120, 80),    # gap 200-320: in a day step, counted
               ("c", 320, 10),    # gap 330-400: in a collection
               ("d", 400, 200), ("e", 450, 30),   # overlap, busy to 600
               ("f", 950, 10)]    # gap 600-950: in ensemble.day, counted
    got = readers["day_idle_ms"].value(_trace(kernels), spans)
    assert got == pytest.approx((120 + 350) / 1e6 / 2)
    no_loop = [run, _span("day", 150, 450, run)]
    assert readers["day_idle_ms"].value(_trace(kernels), no_loop) is None


def test_a_program_without_the_recorder(monkeypatch):
    """The readers laid over a program that has no recorder: they load,
    and read nothing."""
    monkeypatch.delattr(profiling, "record")
    for name in SPAN_READERS:
        assert harness.load_reader(name).read(_trace()) is None
