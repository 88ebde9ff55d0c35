"""Public entry point of the grouped expert-matmul kernels.

:func:`moe_gmm` dispatches by where the tensors lie: CUDA tensors launch
the hand-written kernels (:mod:`.kernel`, whose :func:`~.kernel.plan`
names the body), CPU tensors take the plain version
(:func:`~repro_torch.kernels.moe_gmm.ref.gmm_ref`).  There is no fallback
between them: a CUDA call that cannot build or launch raises.
:data:`launches` counts the kernels' launches and :data:`body_launches`
the same per body, so a run can show that it went through the kernels,
and through which.  On a tensor that needs a gradient the kernel's
backward is autodiff of the plain version
(:func:`~repro_torch.kernels.autograd.with_ref_grad`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.autograd import with_ref_grad
from repro_torch.kernels.moe_gmm import kernel as _kernel
from repro_torch.kernels.moe_gmm.ref import gmm_ref

launches = 0
body_launches = dict.fromkeys(_kernel.BODIES, 0)


def reset_launches() -> None:
    global launches
    launches = 0
    for body in body_launches:
        body_launches[body] = 0


def _launch(x, w, group_sizes):
    global launches
    out, plan = _kernel.launch(x, w, group_sizes)
    launches += 1
    body_launches[plan.body] += 1
    return out


def moe_gmm(x: torch.Tensor, w: torch.Tensor,
            group_sizes: torch.Tensor) -> torch.Tensor:
    """x: (E, C, D) or (B, E, C, D); w: (E, D, F); group_sizes: (E,) or
    (B, E) int32.  Returns ``x[..., e, :, :] @ w[e]`` per group with rows
    >= the group's size zero, in x's type (float32 sums)."""
    if x.device.type != "cuda":
        return gmm_ref(x, w, group_sizes)
    return with_ref_grad(_launch, gmm_ref, x, w, group_sizes)
