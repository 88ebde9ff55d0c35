"""Gradient compression with error feedback (``repro.optim.compress``).

Each gradient leaf plus its residual is quantized to int8 in blocks of
:data:`BLOCK` with a float32 scale per block, dequantized, and the
quantization error kept as the next step's residual (Seide et al.,
Karimireddy et al.).  A leaf of the reference's tree stacks every
superblock's tensor (:mod:`repro_torch.optim`): its tensors are
flattened in superblock order, one after another, and padded at the end
before the blocks are cut, so a block straddles two layers wherever a
layer's size is not a multiple of 256.  The block scale's ``/ 127`` is a
product with the float32 reciprocal, as the reference's jitted train
step computes it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.xla_math import f32

BLOCK = 256
_INV_127 = f32(1.0 / 127.0)


class EFState(NamedTuple):
    residual: dict   # float32, per parameter


def init_ef(params: dict) -> EFState:
    return EFState(residual={
        k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for k, p in params.items()})


def quantize_int8(x: torch.Tensor):
    """Block-wise symmetric int8 quantization of ``x`` flattened and padded
    with zeros to a multiple of :data:`BLOCK`.  Returns (q (N, BLOCK)
    int8, scale (N, 1) float32)."""
    flat = x.to(torch.float32).reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) * _INV_127
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    shape) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape)


def compress_leaf(gs: list, rs: list):
    """EF-compress one leaf, the tensors ``gs`` stacked (their residuals
    ``rs``).  Returns (compressed gradients, new residuals), per tensor.
    DTensors (a step under a mesh) are gathered whole, a leaf at a time,
    and each rank keeps its shards of the results: a block of 256 runs
    across the flattened stack, across the shards."""
    from repro_torch.distributed import sharding as shd
    if gs and shd.is_dtensor(gs[0]):
        whole = lambda ts: [t.full_tensor() for t in ts]
        out, res = compress_leaf(whole(gs), whole(rs))
        back = lambda ts, like: [_like(t, x) for t, x in zip(ts, like)]
        return back(out, gs), back(res, rs)
    g32 = torch.cat([(g.to(torch.float32) + r).reshape(-1)
                     for g, r in zip(gs, rs)])
    q, scale = quantize_int8(g32)
    deq = dequantize_int8(q, scale, g32.shape)
    out, res, at = [], [], 0
    for g in gs:
        d = deq[at:at + g.numel()].reshape(g.shape)
        res.append(g32[at:at + g.numel()].reshape(g.shape) - d)
        out.append(d.to(g.dtype))
        at += g.numel()
    return out, res


def _like(t: torch.Tensor, x):
    """``t``, the whole value every rank computed, placed as ``x`` is."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, x.device_mesh, x.placements,
                             src_data_rank=None)


def compress_grads(grads: dict, ef: EFState, leaves=None):
    """Apply EF int8 compression to every leaf; returns (compressed
    gradients, new EFState)."""
    new_g, new_r = {}, {}
    for names in leaves or [[k] for k in sorted(grads)]:
        out, res = compress_leaf([grads[k] for k in names],
                                 [ef.residual[k] for k in names])
        new_g.update(zip(names, out))
        new_r.update(zip(names, res))
    return new_g, EFState(residual=new_r)
