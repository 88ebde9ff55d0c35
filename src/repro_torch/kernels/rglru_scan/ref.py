"""Plain PyTorch RG-LRU recurrence, step by step: the scan kernel's oracle
and its CPU path.

    h_t = a_t . h_{t-1} + b_t,   a_t = exp(log_a_t)

The same function as ``repro.kernels.rglru_scan.ref.rglru_ref``, in the
same (B, T, W) layout.
"""
from __future__ import annotations

import torch


def rglru_ref(log_a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """log_a/b: (B, T, W); h0: (B, W).  Returns (h (B, T, W), h_final
    (B, W)), float32."""
    log_a, b = log_a.to(torch.float32), b.to(torch.float32)
    h = h0.to(torch.float32)
    hs = []
    for t in range(log_a.shape[1]):
        h = torch.exp(log_a[:, t]) * h + b[:, t]
        hs.append(h)
    return (torch.stack(hs, dim=1) if hs else torch.zeros_like(b)), h
