"""Public entry point of the flash-attention kernel.

:func:`flash_attention` takes the models' (B, S, H, hd) layout and
dispatches by where the tensors lie: CUDA tensors launch the hand-written
kernel (:mod:`.kernel`), CPU tensors take the plain PyTorch version
(:func:`~repro_torch.kernels.flash_attention.ref.attention_ref`).  There
is no fallback between them: a CUDA call that cannot launch raises.
:data:`launches` counts the kernel's launches, so a run can show that it
went through the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel as _kernel
from repro_torch.kernels.flash_attention.ref import attention_ref

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Skv, Hkv, hd) -> (B, Sq, H, hd)."""
    global launches
    if q.device.type != "cuda":
        out = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, window=window,
                            softcap=softcap)
        return out.transpose(1, 2)
    out = _kernel.flash_attention(q, k, v, causal=causal, window=window,
                                  softcap=softcap)
    launches += 1
    return out
