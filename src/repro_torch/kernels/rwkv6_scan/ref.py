"""Plain PyTorch RWKV-6 recurrence, step by step: the scan kernel's oracle
and its CPU path.

    S_t = diag(w_t) S_{t-1} + k_t (x) v_t
    y_t = S_{t-1}^T r_t + (r_t . (u . k_t)) v_t

The same function as ``repro.kernels.rwkv6_scan.ref.wkv_ref``, in the
same (B, H, T, K) layout.
"""
from __future__ import annotations

import torch


def wkv_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor):
    """r/k/v/logw: (B, H, T, K); u: (H, K); s0: (B, H, K, V).

    Returns (y (B, H, T, V), s_final (B, H, K, V)); all float32.
    """
    r, k, v, logw, u = (a.to(torch.float32) for a in (r, k, v, logw, u))
    s = s0.to(torch.float32)
    uk = u[None, :, None, :] * k
    ys = []
    for t in range(r.shape[2]):
        r_t, v_t = r[:, :, t], v[:, :, t]
        y = (torch.einsum("bhk,bhkv->bhv", r_t, s)
             + (r_t * uk[:, :, t]).sum(-1, keepdim=True) * v_t)
        s = (torch.exp(logw[:, :, t])[..., None] * s
             + k[:, :, t, :, None] * v_t[:, :, None, :])
        ys.append(y)
    y = (torch.stack(ys, dim=2) if ys
         else torch.zeros_like(v))
    return y, s
