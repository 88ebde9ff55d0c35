"""Shared model building blocks: norms, positional embeddings, init
helpers.

The same semantics as ``repro.models.common``: RMSNorm in float32 with a
``(1 + w)`` scale, rotary embeddings (and qwen2-vl's M-RoPE) from the same
float32 frequency table, musicgen's sinusoidal positions, tanh
soft-capping, the mean token cross-entropy of training, and the same
init distributions (a truncated normal on [-2, 2] scaled by
fan-in^-1/2, and N(0, 0.02)) drawn from a ``torch.Generator``, so the
numbers differ from ``jax.random``'s.
"""
from __future__ import annotations

import functools
import math
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


class FrozenParams(nn.Module):
    """Parameters named by ``FIELDS``, given in that order; frozen until
    ``transformer.trainable`` turns their gradients on."""

    FIELDS: tuple = ()

    def __init__(self, *args):
        super().__init__()
        for name, t in zip(self.FIELDS, args, strict=True):
            setattr(self, name, nn.Parameter(t.detach(),
                                             requires_grad=False))

    def as_float32(self) -> SimpleNamespace:
        """The fields in float32 (the same tensors where they are float32
        already): the RWKV and RG-LRU blocks compute against float32
        weights, as the reference's float32 activations promote a
        bfloat16 ``param_dtype`` weight."""
        return SimpleNamespace(**{n: getattr(self, n).to(torch.float32)
                                  for n in self.FIELDS})


# ----------------------------------------------------------------- init ----
def dense_init(shape, in_axis: int = -2, *, generator: torch.Generator,
               device=None) -> torch.Tensor:
    """Truncated-normal fan-in init (LeCun-style), float32."""
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(scale)


def embed_init(shape, *, generator: torch.Generator,
               device=None) -> torch.Tensor:
    """GPT-style N(0, 0.02), float32."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return torch.nn.init.normal_(t, 0.0, 0.02, generator=generator)


# ----------------------------------------------------------------- norms ---
def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in float32 with a ``(1 + w)`` scale; the result in ``x``'s
    dtype."""
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    x32 = x32 * torch.rsqrt(var + eps)
    return (x32 * (1.0 + weight.to(torch.float32))).to(x.dtype)


# ------------------------------------------------------------------ rope ---
def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    exponent = np.arange(0, head_dim, 2, dtype=np.float32) / head_dim
    return 1.0 / (theta ** exponent)  # (head_dim // 2,)


@functools.lru_cache(maxsize=32)
def _rope_freqs_on(head_dim: int, theta: float,
                   device: torch.device) -> torch.Tensor:
    """:func:`rope_freqs` on ``device``, copied there once: a copy from
    host memory at every call would stall the host until the device
    drains its queue, once per layer and step."""
    return torch.from_numpy(rope_freqs(head_dim, theta)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = _rope_freqs_on(hd, float(theta), x.device)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, hd/2)
    angles = angles[..., None, :]                            # (..., S, 1, hd/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=32)
def _mrope_sections_on(sections: tuple, device: torch.device) -> torch.Tensor:
    """The position stream (0 = t, 1 = h, 2 = w) of every rotary dim, made
    on the host and copied once (as :func:`_rope_freqs_on`)."""
    streams = np.repeat(np.arange(len(sections)), sections)
    return torch.from_numpy(streams).to(device)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                sections: tuple, theta: float = 10000.0) -> torch.Tensor:
    """Multimodal RoPE (qwen2-vl): the rotary dims split into (temporal,
    height, width) sections, each rotated by its own position stream.

    x: (B, S, H, hd); positions3: (3, B, S); sections sum to hd // 2."""
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"M-RoPE sections {sections} do not sum to {hd // 2}")
    freqs = _rope_freqs_on(hd, float(theta), x.device)
    pos = positions3[_mrope_sections_on(tuple(sections), x.device)]
    angles = pos.movedim(0, -1).to(torch.float32) * freqs   # (B, S, hd/2)
    angles = angles[..., None, :]                           # (B, S, 1, hd/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=8)
def _sinusoidal_freqs_on(dim: int, device: torch.device) -> torch.Tensor:
    """exp(-log(10000) i / half) for i < half, in float32; the division by
    the constant ``half`` is a product with its float32 reciprocal, as XLA
    compiles it (ROADMAP C7; exact where ``half`` is a power of two)."""
    half = dim // 2
    e = (torch.tensor(-math.log(10000.0), dtype=torch.float32)
         * torch.arange(half, dtype=torch.float32)
         * torch.tensor(1.0 / half, dtype=torch.float32))
    return torch.exp(e).to(device)


def sinusoidal_pos_emb(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """Classic transformer sinusoidal embeddings (musicgen): (..., dim)
    float32, the sines then the cosines."""
    freqs = _sinusoidal_freqs_on(dim, positions.device)
    angles = positions[..., None].to(torch.float32) * freqs
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


def activation(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """gemma2 tanh soft-capping; identity when cap == 0."""
    if cap and cap > 0.0:
        return cap * torch.tanh(x / cap)
    return x


def _settled(x):
    """A DTensor's pending reductions done (its ``Partial`` placements
    made ``Replicate``); a plain tensor as it is.  A gather from
    vocab-sharded logits leaves a masked partial sum whose mask keeps the
    gather's rank, which a later ``squeeze`` breaks: it is reduced
    first."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor) or not any(p.is_partial()
                                             for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in x.placements])


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = -1) -> torch.Tensor:
    """Mean token cross-entropy in float32: logits (..., V), labels (...);
    labels equal to ``ignore_index`` are masked out, and the sum is divided
    by ``max(sum(mask), 1)``."""
    logits = logits.to(torch.float32)
    mask = labels != ignore_index
    safe = torch.where(mask, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = _settled(torch.gather(logits, -1, safe[..., None])).squeeze(-1)
    nll = (logz - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1)
