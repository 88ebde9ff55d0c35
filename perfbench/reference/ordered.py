"""Reductions in a fixed left-to-right order.

``torch.sum`` picks its association by size, dtype and device, so two
devices can round a float32 sum differently.  The episode step's float
sums go through :func:`seqsum` instead — ``((x0 + x1) + x2) + ...`` —
which is the order the CUDA kernel uses, so the kernel and its plain
version round every partial sum alike.  :func:`xla_sum` is the order of
the reference's ``jnp.sum`` over a minor axis on the CPU, and
:func:`lane_sum` the order of a row reduction XLA's CPU build vectorizes.
:func:`true_div` divides by a number with one rounding on the card too.
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


# XLA's CPU tree-reduction rewrite splits a longer row reduction into
# windows of this many elements
_XLA_WINDOW = 32


def xla_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the order XLA's CPU compiler gives a long
    row reduction: the row, padded with zeros equally on both sides to a
    multiple of the window, is summed window by window left to right, and
    the window sums are reduced the same way until one window is left."""
    n = x.shape[-1]
    if n <= _XLA_WINDOW:
        return seqsum(x, -1)
    pad = -n % _XLA_WINDOW
    x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
    return xla_sum(seqsum(x.reshape(*x.shape[:-1], -1, _XLA_WINDOW), -1))


def lane_sum(x: torch.Tensor, lanes: int) -> torch.Tensor:
    """Sum over the last axis as a vectorized CPU loop adds it: element
    ``i`` goes into running partial ``i % lanes`` in order, then the
    partials are halved pairwise (``p[j] + p[j + h]``, ``h = lanes / 2,
    lanes / 4, ...``) until one is left.  ``lanes`` is a power of two
    dividing the row length; ``lanes = 1`` is :func:`seqsum`."""
    if lanes == 1:
        return seqsum(x, -1)
    n = x.shape[-1]
    if n % lanes:
        raise ValueError(f"row of {n} is not a multiple of {lanes} lanes")
    acc = x[..., :lanes]
    for i in range(lanes, n, lanes):
        acc = acc + x[..., i:i + lanes]
    while acc.shape[-1] > 1:
        h = acc.shape[-1] // 2
        acc = acc[..., :h] + acc[..., h:]
    return acc[..., 0]


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded once, on every device.  CUDA divides a tensor by
    a Python number through the number's reciprocal (``x * (1 / d)``,
    which can be one ULP off); a divisor tensor on ``x``'s device keeps
    the division."""
    return x / torch.full_like(x, d)
