"""Public entry point of the flash-attention kernels.

:func:`flash_attention` takes the models' (B, S, H, hd) layout and
dispatches by where the tensors lie: CUDA tensors launch the hand-written
kernels (:mod:`.kernel`, whose :func:`~.kernel.plan` names the body),
CPU tensors take the plain PyTorch version
(:func:`~repro_torch.kernels.flash_attention.ref.attention_ref`).  There
is no fallback between them: a CUDA call that cannot launch raises.
:data:`launches` counts the wrapper's launches (a split decode's two
kernels are one) and :data:`body_launches` the same per body, so a run can
show that it went through the kernels, and through which.  On a tensor
that needs a gradient the kernel's backward is autodiff of the plain
version (:func:`~repro_torch.kernels.autograd.with_ref_grad`); a forward
run again under activation checkpointing launches the kernel again, and
counts.  On DTensors (a train step under a mesh) the wrapper runs on
each rank's shard (:func:`_on_shards`): the kernel, or its plain
version, only ever sees a rank's local tensors.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.kernels.autograd import with_ref_grad
from repro_torch.kernels.flash_attention import kernel as _kernel
from repro_torch.kernels.flash_attention.ref import attention_ref

launches = 0
body_launches = dict.fromkeys(_kernel.BODIES, 0)
# calls that ran on each rank's shard (DTensor operands, through local_map)
shard_calls = 0


def reset_launches() -> None:
    global launches, shard_calls
    launches = shard_calls = 0
    for body in body_launches:
        body_launches[body] = 0


def _plain(q, k, v, **feat):
    out = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), **feat)
    return out.transpose(1, 2)


def _launch(q, k, v, **feat):
    global launches
    out, plan = _kernel.launch(q, k, v, **feat)
    launches += 1
    body_launches[plan.body] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Skv, Hkv, hd) -> (B, Sq, H, hd)."""
    feat = dict(causal=causal, window=window, softcap=softcap)
    if shd.is_dtensor(q):
        return _on_shards(q, k, v, feat)
    if q.device.type != "cuda":
        return _plain(q, k, v, **feat)
    return with_ref_grad(lambda *t: _launch(*t, **feat),
                         lambda *t: _plain(*t, **feat), q, k, v)


def _kv_heads(kv: torch.Tensor, first: int, n: int, group: int):
    """The K/V heads (B, S, ., hd) that query heads ``first .. first + n
    - 1`` read (query head ``h`` reads K/V head ``h // group``), in a
    layout the kernel's grouping takes: a whole block of groups, one
    shared head, or, where a rank's query heads cut a group unevenly,
    each query head's own copy."""
    if n % group == 0 and first % group == 0:
        return kv[:, :, first // group:(first + n) // group]
    if group % n == 0:
        return kv[:, :, first // group:first // group + 1]
    return kv.repeat_interleave(group, 2)[:, :, first:first + n]


def _on_shards(q, k, v, feat):
    """DTensor q/k/v: the batch split over (pod, data) and the query
    heads over model where they divide evenly; K/V heads split with them
    where the K/V heads divide too, else replicated, each rank taking the
    K/V heads its query heads read (:func:`_kv_heads`)."""
    from torch.distributed.tensor import Replicate
    mesh = q.device_mesh
    qp = shd.kernel_placements(mesh, q.shape, batch_dim=0, head_dim=2)
    h, hkv = q.shape[2], k.shape[2]
    kvp = tuple(p if not p.is_shard(2) or hkv % mesh.size(i) == 0
                else Replicate() for i, p in enumerate(qp))
    cut = [i for i, (a, b) in enumerate(zip(qp, kvp)) if a != b]
    rank = mesh.get_local_rank(cut[0]) if cut else 0

    def local(ql, kl, vl):
        global shard_calls
        shard_calls += 1
        if cut:
            n = ql.shape[2]
            kl = _kv_heads(kl, rank * n, n, h // hkv)
            vl = _kv_heads(vl, rank * n, n, h // hkv)
        return flash_attention(ql, kl, vl, **feat)

    return shd.local_call(local, (q, k, v), (qp, kvp, kvp), (qp,), mesh)
