"""Device milliseconds of one EnSRF analysis: the kernels launched within
the host interval of each call of ``assimilate.enkf_update_scalar_obs``,
which the traced run brackets, over the number of calls."""

SPAN = ("hybrid9_tpu_torch.assimilate", "enkf_update_scalar_obs",
        "h9bench.enkf_update")


def read(trace):
    seconds, count = trace.spans.get(SPAN[2], (0.0, 0))
    if not count or seconds <= 0.0:
        return None
    return 1e3 * seconds / count
