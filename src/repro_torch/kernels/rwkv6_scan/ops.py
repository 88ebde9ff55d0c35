"""Public entry point of the RWKV-6 scan kernel.

:func:`rwkv6_scan` takes the models' (B, H, T, K) layout, clamps the log
decay at :data:`LOGW_MIN` as ``repro.kernels.rwkv6_scan.ops`` does, and
dispatches by where the tensors lie: CUDA tensors launch the hand-written
kernel (:mod:`.kernel`), CPU tensors take the plain step-by-step version
(:func:`~repro_torch.kernels.rwkv6_scan.ref.wkv_ref`).  There is no
fallback between them: a CUDA call that cannot build or launch raises.
:data:`launches` counts the kernel's launches, so a run can show that it
went through the kernel.  On a tensor that needs a gradient the kernel's
backward is autodiff of the plain version
(:func:`~repro_torch.kernels.autograd.with_ref_grad`).  On DTensors (a
train step under a mesh) it runs on each rank's batch rows and heads.

The kernel is one registered operator, ``repro_torch::rwkv6_scan``: its
CUDA implementation launches the kernel (and alone counts), its CPU
implementation is the plain version, its fake implementation gives the
outputs' shapes and types only, and its FLOP formula
(:func:`scan_flops`) counts the chunked form's float64 operations, the
work behind the kernel's bound.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.distributed import sharding as shd
from repro_torch.kernels.autograd import with_ref_grad
from repro_torch.kernels.rwkv6_scan import kernel as _kernel
from repro_torch.kernels.rwkv6_scan.ref import wkv_ref

LOGW_MIN = -4.0

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


@torch.library.custom_op("repro_torch::rwkv6_scan", mutates_args=(),
                         device_types="cuda")
def _op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        logw: torch.Tensor, u: torch.Tensor,
        s0: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    global launches
    out = _kernel.rwkv6_scan(r, k, v, logw, u, s0)
    launches += 1
    return out


def _kernel_layout(y: torch.Tensor) -> torch.Tensor:
    """``y`` (B, H, T, K) as the kernel lays it out: a view of a (B, T, H,
    K) tensor (the ops after the scan then copy alike wherever it ran)."""
    b, h, t, kd = y.shape
    return torch.empty((b, t, h, kd), dtype=y.dtype).transpose(1, 2).copy_(y)


@_op.register_kernel("cpu")
def _(r, k, v, logw, u, s0):
    y, s = _plain(r, k, v, logw, u, s0)
    return _kernel_layout(y), s


@_op.register_fake
def _(r, k, v, logw, u, s0):
    b, h, t, kd = r.shape
    y = r.new_empty((b, t, h, kd), dtype=torch.float32).transpose(1, 2)
    return y, r.new_empty((b, h, kd, kd), dtype=torch.float32)


def scan_flops(b: int, h: int, t: int, kd: int) -> int:
    """The chunked form's operations per chunk of 16 steps and head: the
    cumsum, the exponentials and their products (8 per element of the
    K-wide rows), the 120 strictly causal entries of A and their
    products with v, the bonus, q_t S and the state update."""
    c = _kernel.CHUNK
    pairs = c * (c - 1) // 2
    per_chunk = (8 * c * kd + pairs * 2 * kd + c * 3 * kd
                 + (pairs + c) * 2 * kd + c * 2 * kd * kd + c * kd
                 + kd * kd * (2 * c + 2))
    return b * h * (t // c) * per_chunk


@register_flop_formula(torch.ops.repro_torch.rwkv6_scan)
def _flops(r_shape, *args, out_shape=None, **kw) -> int:
    return scan_flops(*r_shape)


def _plain(r, k, v, logw, u, s0):
    if s0 is None:
        b, h, _, kd = r.shape
        s0 = torch.zeros((b, h, kd, kd), dtype=torch.float32,
                         device=r.device)
    return wkv_ref(r, k, v, logw, u, s0)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               logw: torch.Tensor, u: torch.Tensor,
               s0: torch.Tensor | None = None):
    """r/k/v/logw: (B, H, T, K) with T a multiple of 16; u: (H, K); s0:
    (B, H, K, K) or None (zeros).  Returns (y (B, H, T, K), s_final
    (B, H, K, K)), float32."""
    if shd.is_dtensor(r):
        return on_shards(rwkv6_scan, r, k, v, logw, u, s0)
    logw = torch.clamp(logw.to(torch.float32), min=LOGW_MIN)
    f32 = lambda x: None if x is None else x.to(torch.float32)
    return with_ref_grad(_op, _plain, f32(r), f32(k), f32(v), logw,
                         f32(u), f32(s0))


def on_shards(fn, r, k, v, logw, u, s0):
    """``fn(r, k, v, logw, u, s0)`` (this scan or another form of the
    recurrence) on DTensor operands, each rank on its shards: the batch
    over (pod, data), the heads over model where they divide evenly;
    ``u`` (H, K) split with the heads."""
    mesh = r.device_mesh
    p = shd.kernel_placements(mesh, r.shape, batch_dim=0, head_dim=1)
    up = shd.sharded_like(p, {1: 0})
    args, pls = [r, k, v, logw, u], [p, p, p, p, up]
    if s0 is not None:
        args.append(s0)
        pls.append(p)
    return shd.local_call(fn, args, pls, (p, p), mesh)
