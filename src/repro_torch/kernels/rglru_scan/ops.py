"""Public entry point of the RG-LRU scan kernel.

:func:`rglru_scan` folds an initial state into the first step as
``repro.kernels.rglru_scan.ops`` does, casts to float32, and dispatches by
where the tensors lie: CUDA tensors launch the hand-written kernel
(:mod:`.kernel`), CPU tensors take the plain step-by-step version
(:func:`~repro_torch.kernels.rglru_scan.ref.rglru_ref`).  There is no
fallback between them: a CUDA call that cannot build or launch raises.
:data:`launches` counts the kernel's launches, so a run can show that it
went through the kernel.  On a tensor that needs a gradient the kernel's
backward is autodiff of the plain version
(:func:`~repro_torch.kernels.autograd.with_ref_grad`).  On DTensors (a
train step under a mesh) it runs on each rank's batch rows and
channels.

The kernel is one registered operator, ``repro_torch::rglru_scan``: its
CUDA implementation launches the kernel (and alone counts), its CPU
implementation is the plain version, its fake implementation gives the
outputs' shapes and types only, and its FLOP formula counts an
exponential, a multiply and an add per element.
"""
from __future__ import annotations

import math

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.distributed import sharding as shd
from repro_torch.kernels.autograd import with_ref_grad
from repro_torch.kernels.rglru_scan import kernel as _kernel
from repro_torch.kernels.rglru_scan.ref import rglru_ref

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def rglru_scan(log_a: torch.Tensor, b: torch.Tensor,
               h0: torch.Tensor | None = None):
    """log_a/b: (B, T, W); h0: (B, W) or None (zeros), folded into the
    first step: ``b[:, 0] += exp(log_a[:, 0]) * h0``.  Returns (h (B, T, W),
    h_final (B, W)), float32."""
    if shd.is_dtensor(log_a):
        return _on_shards(log_a, b, h0)
    if h0 is not None:
        b = b.clone()
        b[:, 0] = b[:, 0] + torch.exp(log_a[:, 0]) * h0
    log_a, b = log_a.to(torch.float32), b.to(torch.float32)
    return with_ref_grad(_op, _plain, log_a, b)


@torch.library.custom_op("repro_torch::rglru_scan", mutates_args=(),
                         device_types="cuda")
def _op(log_a: torch.Tensor,
        b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    global launches
    out = _kernel.rglru_scan(log_a, b)
    launches += 1
    return out


@_op.register_kernel("cpu")
def _(log_a, b):
    # laid out as the kernel's and the fake outputs are
    h, h_fin = _plain(log_a, b)
    return torch.empty_like(log_a.contiguous()).copy_(h), h_fin


@_op.register_fake
def _(log_a, b):
    return (torch.empty_like(log_a.contiguous()),
            b.new_empty((b.shape[0], b.shape[2]), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.rglru_scan)
def _flops(a_shape, b_shape, out_shape=None, **kw) -> int:
    """An exponential, a multiply and an add per element."""
    return 3 * math.prod(a_shape)


def _plain(log_a, b):
    zeros = torch.zeros((b.shape[0], b.shape[2]), dtype=torch.float32,
                        device=b.device)
    return rglru_ref(log_a, b, zeros)


def _on_shards(log_a, b, h0):
    """DTensor operands: the batch over (pod, data), the channels over
    model where they divide evenly; ``h0`` (B, W) split as its rows and
    channels are."""
    mesh = log_a.device_mesh
    p = shd.kernel_placements(mesh, log_a.shape, batch_dim=0, head_dim=2)
    hp = shd.sharded_like(p, {0: 0, 2: 1})
    args, pls = ([log_a, b], [p, p]) if h0 is None else (
        [log_a, b, h0], [p, p, hp])
    return shd.local_call(rglru_scan, args, pls, (p, hp), mesh)
