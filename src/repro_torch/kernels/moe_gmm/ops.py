"""Public entry point of the grouped expert-matmul kernel.

:func:`moe_gmm` dispatches by where the tensors lie: CUDA tensors launch
the hand-written kernel (:mod:`.kernel`), CPU tensors take the plain
version (:func:`~repro_torch.kernels.moe_gmm.ref.gmm_ref`).  There is no
fallback between them: a CUDA call that cannot build or launch raises.
:data:`launches` counts the kernel's launches, so a run can show that it
went through the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.moe_gmm import kernel as _kernel
from repro_torch.kernels.moe_gmm.ref import gmm_ref

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def moe_gmm(x: torch.Tensor, w: torch.Tensor,
            group_sizes: torch.Tensor) -> torch.Tensor:
    """x: (E, C, D) or (B, E, C, D); w: (E, D, F); group_sizes: (E,) or
    (B, E) int32.  Returns ``x[..., e, :, :] @ w[e]`` per group with rows
    >= the group's size zero, in x's type (float32 sums)."""
    global launches
    if x.device.type != "cuda":
        return gmm_ref(x, w, group_sizes)
    out = _kernel.moe_gmm(x, w, group_sizes)
    launches += 1
    return out
