"""Plain PyTorch attention: the flash-attention kernel's oracle and its CPU
path.

The same function as ``repro.kernels.flash_attention.ref.attention_ref``:
causal masking end-aligned to the keys (query row ``i`` sits at key
position ``i + Skv - Sq``), a sliding window, tanh logit soft-capping and
grouped-query attention (the kv heads broadcast), softmax in float32.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  softcap: float = 0.0) -> torch.Tensor:
    """q: (B, H, Sq, hd); k/v: (B, Hkv, Skv, hd), H a multiple of Hkv.

    Returns (B, H, Sq, hd) in q.dtype; softmax in float32.
    """
    b, h, sq, hd = q.shape
    hkv = k.shape[1]
    g = h // hkv
    k = torch.repeat_interleave(k, g, dim=1)
    v = torch.repeat_interleave(v, g, dim=1)

    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * (hd ** -0.5)
    if softcap and softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)

    skv = k.shape[2]
    q_pos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window and window > 0:
        mask &= k_pos > q_pos - window
    logits = logits.masked_fill(~mask[None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v.to(torch.float32))
    return out.to(q.dtype)
