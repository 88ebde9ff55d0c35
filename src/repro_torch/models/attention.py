"""Grouped-query attention: causal masking, sliding-window (local) layers
with their rolling KV ring, tanh logit soft-capping, qwen3's per-head
qk-RMSNorm, qwen2-vl's M-RoPE, and a KV-cache decode path with a
compute-dtype or an int8 cache.

The same semantics as ``repro.models.attention``, with one difference of
route: the reference computes attention with XLA (``attention_scores``)
and validates its Pallas kernel against the same math, while here
:func:`attend` sends both prefill and decode attention through the
flash-attention kernel (:func:`repro_torch.kernels.flash_attention.ops.
flash_attention`: the CUDA kernel on the card, its plain version on the
CPU).  :func:`attention_scores` stays as the reference's plain function,
the tests' oracle (its ``rolling`` option is the reference's ring
decode); no path calls it.

The KV cache is a pair of entries per layer, written in place: ``max_len``
rows for a global layer, a ring of ``min(max_len, window)`` rows for a
local one.  An entry is a compute-dtype tensor, or with
``kv_cache_dtype="int8"`` an ``(int8 values, float32 scales)`` pair
(:func:`quantize_kv`), dequantized on read; the kernel reads the
dequantized compute-dtype rows, as the reference's attention does.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as shd
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import common

NEG_INF = -1e30


class AttnParams(nn.Module):
    """``wq`` (D, H, hd), ``wk``/``wv`` (D, K, hd), ``wo`` (H, hd, D) and
    qwen3's ``q_norm``/``k_norm`` (hd,) (empty without qk-norm)."""

    def __init__(self, wq, wk, wv, wo, q_norm, k_norm):
        super().__init__()
        for name, t in (("wq", wq), ("wk", wk), ("wv", wv), ("wo", wo),
                        ("q_norm", q_norm), ("k_norm", k_norm)):
            setattr(self, name, nn.Parameter(t.detach(),
                                             requires_grad=False))


def init_attn(cfg: ArchConfig, generator: torch.Generator,
              device=None) -> AttnParams:
    hd = cfg.resolved_head_dim
    init = lambda shape: common.dense_init(shape, 0, generator=generator,
                                           device=device)
    qn = torch.zeros((hd,) if cfg.qk_norm else (0,), dtype=torch.float32,
                     device=device)
    return AttnParams(
        wq=init((cfg.d_model, cfg.n_heads, hd)),
        wk=init((cfg.d_model, cfg.n_kv_heads, hd)),
        wv=init((cfg.d_model, cfg.n_kv_heads, hd)),
        wo=init((cfg.n_heads, hd, cfg.d_model)),
        q_norm=qn, k_norm=qn.clone())


# the float32 reciprocal XLA multiplies by where the reference divides by
# 127.0 (ROADMAP C7: measured on its jitted quantize_kv, 4.4% of the
# scales differ from a true division)
_INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)
_MIN_SCALE = torch.tensor(1e-8, dtype=torch.float32)


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int8-quantize (B, S, K, hd) with a float32 per-(B, S, K) scale,
    ``max|x| / 127`` floored at 1e-8; values rounded half to even and
    clipped to +-127."""
    x32 = x.to(torch.float32)
    scale = torch.maximum(x32.abs().amax(-1, keepdim=True) * _INV_127,
                          _MIN_SCALE)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def cache_rows(entry) -> int:
    """The rows a cache entry holds (a ring's size)."""
    return (entry[0] if isinstance(entry, tuple) else entry).shape[1]


def cache_slice(entry, end: int):
    """The entry's first ``end`` rows (a view)."""
    if isinstance(entry, tuple):
        return entry[0][:, :end], entry[1][:, :end]
    return entry[:, :end]


def cache_write(entry, val: torch.Tensor, pos: int) -> None:
    """Write ``val`` (B, S, K, hd) at positions ``pos .. pos + S - 1`` of
    the cache entry, in place; an int8 entry takes ``val`` quantized."""
    end = pos + val.shape[1]
    if isinstance(entry, tuple):
        q, scale = quantize_kv(val)
        entry[0][:, pos:end] = q
        entry[1][:, pos:end] = scale
    else:
        entry[:, pos:end] = val.to(entry.dtype)


def cache_read(entry, dt: torch.dtype) -> torch.Tensor:
    """The entry in ``dt``: an int8 entry dequantized (its values times
    their scale in float32, then cast)."""
    if isinstance(entry, tuple):
        return (entry[0].to(torch.float32) * entry[1]).to(dt)
    return entry.to(dt)


def attention_scores(q, k, v, *, causal_offset: int, window: int = 0,
                     cap: float = 0.0, kv_len_valid=None,
                     rolling: bool = False) -> torch.Tensor:
    """Scaled-dot-product attention with a float32 softmax, GQA-grouped:
    the reference's plain function.

    q: (B, Sq, H, hd); k/v: (B, Skv, K, hd) with H = K * G.
    ``causal_offset`` = absolute position of q[0] minus position of k[0];
    ``window`` > 0 restricts attention to the last ``window`` keys;
    ``kv_len_valid`` is the number of valid cache entries; ``rolling``
    keeps only validity masking (a rolling buffer's slots are all past).
    """
    b, sq, h, hd = q.shape
    kh = k.shape[2]
    g = h // kh
    scale = hd ** -0.5
    qg = q.reshape(b, sq, kh, g, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    logits = common.softcap(logits, cap)

    skv = k.shape[1]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    if rolling:
        mask = (k_pos < kv_len_valid).expand(sq, skv)
    else:
        q_pos = torch.arange(sq, device=q.device)[:, None] + causal_offset
        mask = k_pos <= q_pos
        if window and window > 0:
            mask = mask & (k_pos > q_pos - window)
        if kv_len_valid is not None:
            mask = mask & (k_pos < kv_len_valid)
    logits = logits.masked_fill(~mask[None, None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, sq, h, hd)


def project_qkv(cfg: ArchConfig, p: AttnParams, x: torch.Tensor,
                positions: torch.Tensor, mrope_positions=None):
    """q (B, S, H, hd) and k, v (B, S, K, hd) in the compute dtype, q and
    k qk-normed and rotated: by M-RoPE where the config has sections and
    ``mrope_positions`` (3, B, S) is given, else by ``positions``."""
    dt = common.dtype_of(cfg.compute_dtype)
    hd = cfg.resolved_head_dim
    x = x.to(dt)
    b, s, _ = x.shape
    # under a mesh each projection's heads whole on a rank (no-ops on
    # plain tensors)
    proj = lambda w, n: shd.whole_heads(x @ w.to(dt).flatten(1), n).view(
        b, s, n, hd)
    q = proj(p.wq, cfg.n_heads)
    k = proj(p.wk, cfg.n_kv_heads)
    v = proj(p.wv, cfg.n_kv_heads)
    # under a mesh: the query heads over model, as the reference constrains
    # them (a no-op on plain tensors)
    q = shd.constrain(q, batch_dim=0, head_dim=2)
    if cfg.qk_norm:
        q = common.rms_norm(q, p.q_norm, cfg.norm_eps)
        k = common.rms_norm(k, p.k_norm, cfg.norm_eps)
    if cfg.pos_emb == "rope":
        if cfg.mrope_sections and mrope_positions is not None:
            q = common.apply_mrope(q, mrope_positions, cfg.mrope_sections,
                                   cfg.rope_theta)
            k = common.apply_mrope(k, mrope_positions, cfg.mrope_sections,
                                   cfg.rope_theta)
        else:
            q = common.apply_rope(q, positions, cfg.rope_theta)
            k = common.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def ring_write(entry, val: torch.Tensor, pos: int) -> None:
    """Write ``val`` (B, S, K, hd), the keys or values of positions ``pos ..
    pos + S - 1``, into a local layer's ring of ``size`` rows, in place:
    position ``t`` goes to row ``t % size``, and of more than ``size`` new
    rows only the last ``size`` are kept (the reference's prefill and
    decode writes)."""
    size, s = cache_rows(entry), val.shape[1]
    keep = min(s, size)
    val = val[:, s - keep:]
    start = (pos + s - keep) % size
    first = min(keep, size - start)
    cache_write(entry, val[:, :first], start)
    if first < keep:
        cache_write(entry, val[:, first:], 0)


def attend(cfg: ArchConfig, p: AttnParams, x: torch.Tensor,
           positions: torch.Tensor, *, layer_window: int = 0,
           cache_kv=None, cache_pos: int | None = None,
           mrope_positions=None):
    """The attention sub-layer; returns ``(out, cache_kv)``.

    Without a cache: causal attention over ``x``'s own keys, within
    ``layer_window`` of each query when it is > 0.

    With one, the new keys and values are written in place at
    ``cache_pos``: a global layer's ``cache_kv`` = (k_cache, v_cache), each
    of S_max rows (:func:`cache_write`); a local layer's (``layer_window``
    > 0) a ring of ``size`` = ``min(max_len, window)`` rows
    (:func:`ring_write`).  A prompt (from ``cache_pos`` 0) attends to the
    keys it computed, within the window on a local layer, as the
    reference's prefill does (with an int8 cache, unquantized).  Otherwise
    the queries attend to the cache's rows, read back in the compute dtype
    (an int8 cache dequantized): a global layer's first ``cache_pos + S``,
    end-aligned so every written key is visible to the causal mask (the
    reference's masked full-cache attention: masked logits contribute an
    exact 0 after ``exp``); a local layer's decode step (S = 1) the ring's
    first ``min(cache_pos + 1, size)``, all of them in the past and within
    the window, with no mask but that count (the reference's
    ``rolling=True``).
    """
    dt = common.dtype_of(cfg.compute_dtype)
    q, k, v = project_qkv(cfg, p, x, positions, mrope_positions)
    s = x.shape[1]
    window = layer_window
    keys, values = k, v
    if cache_kv is not None:
        k_cache, v_cache = cache_kv
        if layer_window and s > 1 and cache_pos != 0:
            raise NotImplementedError(
                "a local layer takes a prompt only from position 0")
        write = ring_write if layer_window else cache_write
        write(k_cache, k, cache_pos)
        write(v_cache, v, cache_pos)
        if cache_pos:
            if layer_window:
                end, window = min(cache_pos + 1, cache_rows(k_cache)), 0
            else:
                end = cache_pos + s
            keys = cache_read(cache_slice(k_cache, end), dt)
            values = cache_read(cache_slice(v_cache, end), dt)
    out = fa_ops.flash_attention(q, keys, values, causal=True,
                                 window=window, softcap=cfg.attn_softcap)
    b = x.shape[0]
    out = shd.whole_heads(out.reshape(b, s, -1), cfg.n_heads)
    out = out @ p.wo.to(dt).flatten(0, 1)
    return out, cache_kv
