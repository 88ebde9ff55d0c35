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
"""
from __future__ import annotations

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.kernels.autograd import with_ref_grad
from repro_torch.kernels.rwkv6_scan import kernel as _kernel
from repro_torch.kernels.rwkv6_scan.ref import wkv_ref

LOGW_MIN = -4.0

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _launch(r, k, v, logw, u, s0):
    global launches
    out = _kernel.rwkv6_scan(r, k, v, logw, u, s0)
    launches += 1
    return out


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
        return _on_shards(r, k, v, logw, u, s0)
    logw = torch.clamp(logw.to(torch.float32), min=LOGW_MIN)
    if r.device.type != "cuda":
        return _plain(r, k, v, logw, u, s0)
    f32 = lambda x: None if x is None else x.to(torch.float32)
    return with_ref_grad(_launch, _plain, f32(r), f32(k), f32(v), logw,
                         f32(u), f32(s0))


def _on_shards(r, k, v, logw, u, s0):
    """DTensor operands: the batch over (pod, data), the heads over model
    where they divide evenly; ``u`` (H, K) split with the heads."""
    mesh = r.device_mesh
    p = shd.kernel_placements(mesh, r.shape, batch_dim=0, head_dim=1)
    up = shd.sharded_like(p, {1: 0})
    args, pls = [r, k, v, logw, u], [p, p, p, p, up]
    if s0 is not None:
        args.append(s0)
        pls.append(p)
    return shd.local_call(rwkv6_scan, args, pls, (p, p),
                          mesh)
