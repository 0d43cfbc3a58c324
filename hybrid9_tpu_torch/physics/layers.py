"""Layer-list helpers: struct-of-arrays over the (tiny) layer axis.

Port of ``hybrid9_tpu/physics/layers.py``.  Per-layer fields travel as
Python lists of ``[n]`` tensors, so every per-layer update is an
elementwise op over cells and the plain day loop and the CUDA day kernel
share one value-level substep (``hydrology.substep_values``).
"""

from __future__ import annotations

from typing import List, Sequence

import torch


def unstack(x: torch.Tensor) -> List[torch.Tensor]:
    """[n, L] -> list of L [n] tensors (one column view per layer)."""
    return [x[:, i] for i in range(x.shape[1])]


def stack(cols: Sequence[torch.Tensor]) -> torch.Tensor:
    """List of L [n] tensors -> [n, L]."""
    return torch.stack(list(cols), dim=1)


def select_layer(cols: Sequence[torch.Tensor], idx: torch.Tensor,
                 fill=0.0) -> torch.Tensor:
    """cols[idx[c]][c] for each cell c, as an elementwise select chain.

    Cells whose idx is out of [0, L) get ``fill``.
    """
    out = torch.full_like(cols[0], fill)
    for i, col in enumerate(cols):
        out = torch.where(idx == i, col, out)
    return out
