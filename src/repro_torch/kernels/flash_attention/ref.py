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


def visible(sq: int, skv: int, *, causal: bool = True, window: int = 0,
            device=None) -> torch.Tensor:
    """(Sq, Skv) bool: which keys each query row sees (the mask above)."""
    q_pos = torch.arange(sq, device=device)[:, None] + (skv - sq)
    k_pos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window and window > 0:
        mask &= k_pos > q_pos - window
    return mask


def split_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     splits: int, chunk: int, kv_lo: int, kv_hi: int,
                     causal: bool = True, window: int = 0,
                     softcap: float = 0.0) -> torch.Tensor:
    """The ``split_decode`` body's arithmetic in plain PyTorch (used by the
    tests only): split ``s`` of ``splits`` keeps the max, the sum and the
    unnormalised accumulator of its keys ``[kv_lo + s * chunk, min(kv_lo +
    (s + 1) * chunk, kv_hi))``, and the merge rescales them to the largest
    max and adds them in split order.  Same layout as :func:`attention_ref`.
    """
    b, h, sq, hd = q.shape
    g = h // k.shape[1]
    k = torch.repeat_interleave(k, g, dim=1).to(torch.float32)
    v = torch.repeat_interleave(v, g, dim=1).to(torch.float32)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                          k) * (hd ** -0.5)
    if softcap and softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    mask = visible(sq, k.shape[2], causal=causal, window=window,
                   device=q.device)
    logits = logits.masked_fill(~mask[None, None], NEG_INF)
    parts = []
    for s in range(splits):
        lo = kv_lo + s * chunk
        hi = min(lo + chunk, kv_hi)
        x = logits[..., lo:hi]
        m = x.max(dim=-1).values
        p = torch.where(x == NEG_INF, 0.0, torch.exp(x - m[..., None]))
        parts.append((m, p.sum(dim=-1),
                      torch.einsum("bhqk,bhkd->bhqd", p, v[:, :, lo:hi])))
    m_all = torch.stack([m for m, _, _ in parts]).max(dim=0).values
    denom = torch.zeros_like(m_all)
    acc = torch.zeros((b, h, sq, hd), dtype=torch.float32, device=q.device)
    for m, l, a in parts:
        w = torch.exp(m - m_all)
        denom = denom + w * l
        acc = acc + w[..., None] * a
    return (acc / denom.clamp_min(1e-30)[..., None]).to(q.dtype)


def probe_keys(b: int, hkv: int, hd: int, skv: int, sweep: int,
               device=None) -> torch.Tensor:
    """(B, Hkv, hd) int64: the probe key of each (batch row, kv head,
    column) in pass ``sweep`` of a coverage probe (-1: none; passes
    ``0 .. ceil(Skv / (B Hkv hd)) - 1`` probe every key once)."""
    per = b * hkv * hd
    keys = sweep * per + torch.arange(per, device=device).reshape(b, hkv, hd)
    return torch.where(keys < skv, keys, -1)


def probe_inputs(b: int, h: int, hkv: int, sq: int, skv: int, hd: int,
                 keys: torch.Tensor, dtype, device=None, seed: int = 0):
    """q = 0, k random, v one-hot: ``v[bi, keys[bi, g, c], g, c] = 1``.
    Every logit is 0, so ``out[bi, i, h, c]`` is ``1 / n_visible(i)`` if
    row ``i`` sees the probe key of column ``c``, else exactly 0."""
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.zeros((b, sq, h, hd), dtype=dtype, device=device)
    k = torch.randn((b, skv, hkv, hd), generator=gen, device=device
                    ).to(dtype)
    v = torch.zeros((b, skv, hkv, hd), dtype=dtype, device=device)
    bi, g, c = torch.nonzero(keys >= 0, as_tuple=True)
    v[bi, keys[bi, g, c], g, c] = 1
    return q, k, v


def probe_expected(keys: torch.Tensor, sq: int, skv: int, h: int, *,
                   causal: bool = True, window: int = 0) -> torch.Tensor:
    """(B, Sq, H, hd) float32: what a probe's output must be."""
    b, hkv, hd = keys.shape
    vis = visible(sq, skv, causal=causal, window=window, device=keys.device)
    n = vis.sum(dim=1).to(torch.float32)                    # (Sq,)
    seen = vis[:, keys.clamp_min(0)] & (keys >= 0)          # (Sq, B, Hkv, hd)
    out = seen.to(torch.float32) / n[:, None, None, None]
    out = torch.repeat_interleave(out, h // hkv, dim=2)     # (Sq, B, H, hd)
    return out.permute(1, 0, 2, 3)


def probe_faults(got: torch.Tensor, want: torch.Tensor) -> int:
    """Elements of a probe's output that are wrong: > 0 where the probe key
    is hidden or not > 0 where it is seen, or more than 1% from
    ``1 / n_visible`` where it is seen."""
    got = got.to(torch.float32)
    seen = want > 0
    bad = (got > 0) != seen
    bad |= seen & ((got - want).abs() > 0.01 * want)
    return int(bad.sum())
