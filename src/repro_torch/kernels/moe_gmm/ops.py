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

The kernel is one registered operator, ``repro_torch::moe_gmm``: its
CUDA implementation launches the kernel (and alone counts), its CPU
implementation is the plain version, its fake implementation gives the
output's shape and type only, and its FLOP formula counts two
operations per element of every group's full capacity: a formula sees
shapes, not the group sizes, so it counts the (B, E, C) buffer the
reference's dense einsum computes, not the kept rows the kernel reads.
"""
from __future__ import annotations

import math

import torch
from torch.utils.flop_counter import register_flop_formula

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


@torch.library.custom_op("repro_torch::moe_gmm", mutates_args=(),
                         device_types="cuda")
def _op(x: torch.Tensor, w: torch.Tensor,
        group_sizes: torch.Tensor) -> torch.Tensor:
    global launches
    out, plan = _kernel.launch(x, w, group_sizes)
    launches += 1
    body_launches[plan.body] += 1
    return out


@_op.register_kernel("cpu")
def _(x, w, group_sizes):
    # laid out row-major, as the kernel's and the fake output are
    out = gmm_ref(x, w, group_sizes)
    return torch.empty(out.shape, dtype=out.dtype).copy_(out)


@_op.register_fake
def _(x, w, group_sizes):
    return x.new_empty(x.shape[:-1] + w.shape[-1:])


@register_flop_formula(torch.ops.repro_torch.moe_gmm)
def _flops(x_shape, w_shape, sizes_shape, out_shape=None, **kw) -> int:
    """Two operations per row of the full (..., E, C) buffer and weight
    element."""
    return 2 * math.prod(x_shape[:-1]) * w_shape[-2] * w_shape[-1]


def moe_gmm(x: torch.Tensor, w: torch.Tensor,
            group_sizes: torch.Tensor) -> torch.Tensor:
    """x: (E, C, D) or (B, E, C, D); w: (E, D, F); group_sizes: (E,) or
    (B, E) int32.  Returns ``x[..., e, :, :] @ w[e]`` per group with rows
    >= the group's size zero, in x's type (float32 sums)."""
    return with_ref_grad(_op, gmm_ref, x, w, group_sizes)
