"""Device milliseconds of one EnSRF analysis, from inside the program:
the CUDA event pairs of the ``assimilate.analysis`` spans
(``assimilate.enkf_update_scalar_obs``), summed, over their count.
Loading this reader switches the program's span recorder on; nothing is
read where the program has no recorder or no analysis ran on the
device."""

from h9bench.recorder import profiling, reader


def value(trace, spans):
    ms = [profiling.device_ms(s) for s in spans
          if s.name == "assimilate.analysis"]
    ms = [x for x in ms if x is not None]
    if not ms:
        return None
    return sum(ms) / len(ms)


read = reader(value)
