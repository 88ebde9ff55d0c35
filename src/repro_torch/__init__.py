"""PyTorch/CUDA port of the Cohmeleon reproduction.

Mirrors the layout of the JAX package ``repro`` (``repro_torch.core``,
``repro_torch.soc``, ``repro_torch.kernels.<name>.{ref,kernel,ops}``) and
imports neither JAX nor anything of ``repro``.  Entry points take
``device=None``, which means the CUDA card; without CUDA they raise unless
the caller passes ``device="cpu"`` (the CPU tests do).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise if CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch entry points run on the CUDA card by default and "
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
