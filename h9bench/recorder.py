"""What the readers of the program's span recorder
(``hybrid9_tpu_torch.utils.profiling``) share.  A reader defines
``value(trace, spans)`` and takes ``read = reader(value)``: that switches
the recorder on as the reader loads, and ``read(trace)`` gives ``value``
over the recorded spans.  A program older than the recorder has no
``profiling.record``: nothing is switched on and nothing is read."""

from hybrid9_tpu_torch.utils import profiling


def _has_recorder() -> bool:
    return hasattr(profiling, "record")


def reader(value):
    """Switch the recorder on, and return the ``read(trace)`` of
    ``value``: None where the program has no recorder."""
    if _has_recorder():
        profiling.record(True)

    def read(trace):
        if not _has_recorder():
            return None
        return value(trace, profiling.spans())

    return read
