"""A tensor against a constant bound, with the JAX package's gradient.

``jnp.maximum``, ``jnp.minimum`` and ``jnp.clip`` split the gradient
evenly between the two operands where they are equal, as
``torch.maximum`` and ``torch.minimum`` do; ``torch.clamp`` passes all of
it to the tensor.  The values are the same, the adjoint is not, at states
that sit on a bound day after day: an aquifer on its 5,000 mm cap, a
saturated layer whose ``theta / theta_s`` is 1, a water table on its clip,
a LAI on its floor.  So the modules that calibration differentiates write
each of the JAX package's bounds with these functions.  Where a gradient
is taken they use ``torch.maximum``/``torch.minimum`` against the constant
held as a 0-d tensor of the operand's dtype and device, made once and
kept; elsewhere they are the one ``torch.clamp`` launch with a Python
scalar, the same values at the least host cost (the plain day and
``day_step`` run host-bound, a launch at a time).
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def _constant(value: float, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    # One per bound in the source, dtype and device: a few dozen.  Made
    # outside inference mode, so that a constant first needed under
    # torch.inference_mode() can still be saved for a backward pass.
    with torch.inference_mode(False):
        return torch.tensor(value, dtype=dtype, device=device)


def _tracked(x: torch.Tensor) -> bool:
    return x.requires_grad and torch.is_grad_enabled()


def maximum(x: torch.Tensor, lo: float) -> torch.Tensor:
    """``jnp.maximum(x, lo)``: the gradient at ``x == lo`` is half."""
    if _tracked(x):
        return torch.maximum(x, _constant(float(lo), x.dtype, x.device))
    return torch.clamp(x, min=lo)


def minimum(x: torch.Tensor, hi: float) -> torch.Tensor:
    """``jnp.minimum(x, hi)``: the gradient at ``x == hi`` is half."""
    if _tracked(x):
        return torch.minimum(x, _constant(float(hi), x.dtype, x.device))
    return torch.clamp(x, max=hi)


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)``, which is ``minimum(maximum(x, lo), hi)``."""
    if _tracked(x):
        return minimum(maximum(x, lo), hi)
    return torch.clamp(x, lo, hi)
