"""Pipeline parallelism: the GPipe microbatch schedule on a ``"pipe"``
mesh axis (``repro.distributed.pipeline``).

Stage parameters are stacked on a leading ``n_stages`` axis; each rank of
the pipe axis holds one stage.  The schedule runs M + S - 1 ticks: stage
0 injects a fresh microbatch each tick, every stage applies its layers,
and activations hop one stage a tick by point-to-point sends
(``batch_isend_irecv``, the reference's ``ppermute``).  The last stage
collects the finished microbatches, and a sum over the pipe axis hands
its outputs to every stage (the reference's ``psum`` of the last stage's
outputs).  The schedule is the forward pass: no gradient flows back
through the sends.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist


def _local(x):
    from torch.distributed.tensor import DTensor
    return x.to_local() if isinstance(x, DTensor) else x


def _stage_of(leaf, idx: int):
    """This stage's slice of a stacked leaf: row ``idx`` of a full
    tensor, or the one local row of a DTensor split over the pipe axis."""
    from torch.distributed.tensor import DTensor
    if isinstance(leaf, DTensor):
        return leaf.to_local()[0]
    return leaf[idx]


def pipeline_apply(stage_fn: Callable, stage_params, microbatches, mesh,
                   axis_name: str = "pipe"):
    """Run the GPipe schedule; returns the (M, mb, ...) outputs of the
    last stage on every stage.  ``stage_fn(stage_params, x) -> y`` keeps
    ``x``'s shape; ``stage_params`` is a tensor or a dict / list / tuple
    of them, each ``(n_stages, ...)`` (full, or a DTensor split over the
    pipe axis); ``microbatches`` (M, mb, ...) is held whole by every
    stage."""
    names = list(mesh.mesh_dim_names)
    axis = names.index(axis_name)
    n_stages = mesh.size(axis)
    mbs = _local(microbatches)
    m = mbs.shape[0]
    assert m >= n_stages, (m, n_stages)
    idx = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    params = _map(lambda leaf: _stage_of(leaf, idx), stage_params)
    is_first, is_last = idx == 0, idx == n_stages - 1
    peer = lambda i: dist.get_global_rank(group, i)

    carry = torch.zeros_like(mbs[0])
    outputs = torch.zeros_like(mbs)
    for t in range(m + n_stages - 1):
        x_in = mbs[min(t, m - 1)] if is_first else carry
        y = stage_fn(params, x_in)
        if is_last and t >= n_stages - 1:
            outputs[t - (n_stages - 1)] = y
        ops = []
        if not is_last:
            ops.append(dist.P2POp(dist.isend, y.contiguous(), peer(idx + 1),
                                  group))
        if not is_first:
            carry = torch.empty_like(y)
            ops.append(dist.P2POp(dist.irecv, carry, peer(idx - 1), group))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
    if not is_last:
        outputs.zero_()
    if n_stages > 1:
        dist.all_reduce(outputs, group=group)
    return outputs


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def make_pipe_mesh(n_stages: int):
    """A 1-D ``("pipe",)`` mesh over the first ``n_stages`` ranks of the
    default process group (every rank of the group calls it); on the
    card where the group is NCCL's, else on the CPU."""
    from repro_torch.launch.mesh import make_mesh
    dev = ("cuda" if torch.cuda.is_available()
           and dist.get_backend() == "nccl" else "cpu")
    return make_mesh(range(n_stages), (n_stages,), ("pipe",), dev)
