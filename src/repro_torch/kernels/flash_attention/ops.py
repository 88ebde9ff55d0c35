"""Public entry point of the flash-attention kernels.

:func:`flash_attention` takes the models' (B, S, H, hd) layout and
dispatches by where the tensors lie: CUDA tensors launch the hand-written
kernels (:mod:`.kernel`, whose :func:`~.kernel.plan` names the body),
CPU tensors take the plain PyTorch version
(:func:`~repro_torch.kernels.flash_attention.ref.attention_ref`).  There
is no fallback between them: a CUDA call that cannot launch raises.
:data:`launches` counts the wrapper's launches (a split decode's two
kernels are one) and :data:`body_launches` the same per body, so a run can
show that it went through the kernels, and through which.

The kernel is one registered operator, ``repro_torch::flash_attention``:
its CUDA implementation launches the kernel (and alone counts), its CPU
implementation is the plain version, its fake implementation gives the
output's shape and type only (a dry-run's fake tensors build and launch
nothing), and its FLOP formula (:func:`attention_flops`) counts the
(query, key) pairs the mask keeps, so a counter
(:mod:`repro_torch.launch.roofline`) reads one op with the same work on
the CPU, under fake tensors and on the card.  On a tensor
that needs a gradient the kernel's backward is autodiff of the plain
version (:func:`~repro_torch.kernels.autograd.with_ref_grad`); a forward
run again under activation checkpointing launches the kernel again, and
counts.  On DTensors (a train step under a mesh) the wrapper runs on
each rank's shard (:func:`_on_shards`): the kernel, or its plain
version, only ever sees a rank's local tensors.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

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


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cuda")
def _op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
        window: int, softcap: float) -> torch.Tensor:
    global launches
    out, plan = _kernel.launch(q, k, v, causal=causal, window=window,
                               softcap=softcap)
    launches += 1
    body_launches[plan.body] += 1
    return out


@_op.register_kernel("cpu")
def _(q, k, v, causal, window, softcap):
    # laid out as the kernel's and the fake output are (row-major, size-1
    # dimensions too): the ops after it then copy alike wherever it runs
    out = _plain(q, k, v, causal=causal, window=window, softcap=softcap)
    return torch.empty(out.shape, dtype=out.dtype).copy_(out)


@_op.register_fake
def _(q, k, v, causal, window, softcap):
    return q.new_empty(q.shape)


def key_pairs(sq: int, skv: int, causal: bool = True,
              window: int = 0) -> int:
    """The (query, key) pairs the mask keeps: query row ``i`` sits at key
    position ``p = i + skv - sq`` and sees ``p + 1`` keys when causal
    (``skv`` otherwise), at most ``window`` of them where ``window`` > 0."""
    if not causal:
        if window <= 0:
            return sq * skv
        # row i sees the keys after p - window
        return sum(skv - max(0, i + skv - sq - window + 1)
                   for i in range(sq))
    first = skv - sq + 1                   # keys row 0 sees
    if window <= 0 or window >= skv:
        return sq * first + sq * (sq - 1) // 2
    # rows below the window grow by one key a row, then stay at window
    grow = max(0, min(sq, window - first + 1))
    grown = grow * first + grow * (grow - 1) // 2
    return grown + (sq - grow) * window


def attention_flops(b: int, h: int, sq: int, skv: int, hd: int, *,
                    causal: bool = True, window: int = 0) -> int:
    """A multiply and an add per element of QK^T and of PV over the kept
    pairs: ``4 hd`` operations a pair, a query head."""
    return 4 * hd * b * h * key_pairs(sq, skv, causal, window)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flops(q_shape, k_shape, v_shape, causal=True, window=0, softcap=0.0,
           out_shape=None, **kw) -> int:
    b, sq, h, hd = q_shape
    return attention_flops(b, h, sq, k_shape[1], hd, causal=causal,
                           window=window)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Skv, Hkv, hd) -> (B, Sq, H, hd)."""
    feat = dict(causal=causal, window=window, softcap=softcap)
    if shd.is_dtensor(q):
        return _on_shards(q, k, v, feat)
    return with_ref_grad(
        lambda *t: _op(*t, bool(causal), int(window), float(softcap)),
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
