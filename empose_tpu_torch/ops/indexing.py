"""Gathers whose gradient is the same on every run.

``index_select``'s gradient adds the rows of repeated indices with atomics
on CUDA, in an order that changes from run to run, so a step that
differentiates through such a gather (the FK chain, the virtual sensors'
vertex and face gathers in the LGD loop) is not reproducible bit for bit.
Advanced indexing gives the same forward, and its gradient accumulates after
a stable sort of the indices, in one order on every run.
"""

from __future__ import annotations

import torch


def take(x: torch.Tensor, dim: int, index: torch.Tensor) -> torch.Tensor:
    """``x.index_select(dim, index)`` (``dim`` >= 0) with a gradient that
    sums repeated indices in a fixed order."""
    return x[(slice(None),) * dim + (index,)]
