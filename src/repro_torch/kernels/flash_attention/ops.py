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
counts.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.autograd import with_ref_grad
from repro_torch.kernels.flash_attention import kernel as _kernel
from repro_torch.kernels.flash_attention.ref import attention_ref

launches = 0
body_launches = dict.fromkeys(_kernel.BODIES, 0)


def reset_launches() -> None:
    global launches
    launches = 0
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
    if q.device.type != "cuda":
        return _plain(q, k, v, **feat)
    return with_ref_grad(lambda *t: _launch(*t, **feat),
                         lambda *t: _plain(*t, **feat), q, k, v)
