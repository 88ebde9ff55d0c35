"""Gradients through the hand-written kernels.

A kernel launched through ``ctypes`` writes its output into memory
PyTorch knows nothing of, so its output carries no autograd graph.
:func:`with_ref_grad` wraps a launch in a ``torch.autograd.Function``:
its forward is the kernel, as in serving; its backward recomputes the
kernel's plain version (``ref.py``) from the saved inputs under
autograd and returns that function's gradients.  That is the gradient the
reference takes: ``jax.value_and_grad`` of the same plain math (no
kernel of the reference has a VJP of its own).  No backward kernel is
written; the backward's memory and time are the plain version's.

Under ``torch.utils.checkpoint`` the forward runs again in the backward
pass, and with it the kernel, which its wrapper counts as a launch.
"""
from __future__ import annotations

import torch


class _RefGrad(torch.autograd.Function):

    @staticmethod
    def forward(ctx, launch, ref, *inputs):
        ctx.ref = ref
        ctx.save_for_backward(*inputs)
        out = launch(*inputs)
        ctx.tuple_out = isinstance(out, tuple)
        return out

    @staticmethod
    def backward(ctx, *grads):
        inputs = ctx.saved_tensors
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(n) if n else x
                      for x, n in zip(inputs, need)]
            out = ctx.ref(*leaves)
            outs = out if ctx.tuple_out else (out,)
            pairs = [(o, g) for o, g in zip(outs, grads)
                     if g is not None and o.requires_grad]
            wrt = [x for x, n in zip(leaves, need) if n]
            got = iter(torch.autograd.grad(
                [o for o, _ in pairs], wrt, [g for _, g in pairs],
                allow_unused=True))
        return (None, None) + tuple(next(got) if n else None for n in need)


def with_ref_grad(launch, ref, *inputs):
    """``launch(*inputs)`` (a tensor or a tuple of tensors), differentiable
    as ``ref(*inputs)`` is: the backward pass recomputes ``ref`` under
    autograd.  ``inputs`` are tensors or None; outside autograd (no input
    needs a gradient, or grad mode is off) this is ``launch(*inputs)``."""
    if not (torch.is_grad_enabled()
            and any(x is not None and x.requires_grad for x in inputs)):
        return launch(*inputs)
    return _RefGrad.apply(launch, ref, *inputs)
