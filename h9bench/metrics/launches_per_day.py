"""Kernel launches a model day: every CUDA kernel of the traced window
over the model days its calls finished.  The day step issues them one by
one from the host, so fewer launches is less host time a day."""


def read(trace):
    if not trace.model_days or not trace.kernels:
        return None
    return len(trace.kernels) / trace.model_days
