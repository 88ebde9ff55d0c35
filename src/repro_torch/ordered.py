"""Reductions in a fixed left-to-right order.

``torch.sum`` picks its association by size, dtype and device, so two
devices can round a float32 sum differently.  The episode step's float
sums go through :func:`seqsum` instead — ``((x0 + x1) + x2) + ...`` —
which is the order the CUDA kernel uses, so the kernel and its plain
version round every partial sum alike.
"""
from __future__ import annotations

import torch


def seqsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over ``dim`` strictly left to right (float32 stays float32)."""
    x = x.movedim(dim, 0)
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return acc
