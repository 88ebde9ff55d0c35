"""Grouped-query attention: causal masking, sliding-window (local) layers
with their rolling KV ring, tanh logit soft-capping, qwen3's per-head
qk-RMSNorm, and a KV-cache decode path.

The same semantics as ``repro.models.attention``, with one difference of
route: the reference computes attention with XLA (``attention_scores``)
and validates its Pallas kernel against the same math, while here
:func:`attend` sends both prefill and decode attention through the
flash-attention kernel (:func:`repro_torch.kernels.flash_attention.ops.
flash_attention`: the CUDA kernel on the card, its plain version on the
CPU).  :func:`attention_scores` stays as the reference's plain function,
the tests' oracle (its ``rolling`` option is the reference's ring
decode); no path calls it.

The KV cache is a pair of plain compute-dtype tensors per layer, written
in place: ``max_len`` rows for a global layer, a ring of
``min(max_len, window)`` rows for a local one.  The int8 cache is not
ported.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
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


def _plain(entry) -> torch.Tensor:
    if not isinstance(entry, torch.Tensor):
        raise NotImplementedError(
            "the int8 KV cache is not ported yet (ROADMAP A15)")
    return entry


def cache_write(entry: torch.Tensor, val: torch.Tensor, pos: int) -> None:
    """Write ``val`` (B, S, K, hd) at positions ``pos .. pos + S - 1`` of
    the cache entry, in place."""
    _plain(entry)[:, pos:pos + val.shape[1]] = val.to(entry.dtype)


def cache_read(entry: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    return _plain(entry).to(dt)


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
                positions: torch.Tensor):
    """q (B, S, H, hd) and k, v (B, S, K, hd) in the compute dtype, q and
    k qk-normed and rotated (with
    rotary positions)."""
    dt = common.dtype_of(cfg.compute_dtype)
    hd = cfg.resolved_head_dim
    x = x.to(dt)
    b, s, _ = x.shape
    q = (x @ p.wq.to(dt).flatten(1)).view(b, s, cfg.n_heads, hd)
    k = (x @ p.wk.to(dt).flatten(1)).view(b, s, cfg.n_kv_heads, hd)
    v = (x @ p.wv.to(dt).flatten(1)).view(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = common.rms_norm(q, p.q_norm, cfg.norm_eps)
        k = common.rms_norm(k, p.k_norm, cfg.norm_eps)
    if cfg.pos_emb == "rope":
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def ring_write(entry: torch.Tensor, val: torch.Tensor, pos: int) -> None:
    """Write ``val`` (B, S, K, hd), the keys or values of positions ``pos ..
    pos + S - 1``, into a local layer's ring of ``size`` rows, in place:
    position ``t`` goes to row ``t % size``, and of more than ``size`` new
    rows only the last ``size`` are kept (the reference's prefill and
    decode writes)."""
    size, s = _plain(entry).shape[1], val.shape[1]
    keep = min(s, size)
    val = val[:, s - keep:]
    start = (pos + s - keep) % size
    first = min(keep, size - start)
    cache_write(entry, val[:, :first], start)
    if first < keep:
        cache_write(entry, val[:, first:], 0)


def attend(cfg: ArchConfig, p: AttnParams, x: torch.Tensor,
           positions: torch.Tensor, *, layer_window: int = 0,
           cache_kv=None, cache_pos: int | None = None):
    """The attention sub-layer; returns ``(out, cache_kv)``.

    Without a cache: causal attention over ``x``'s own keys, within
    ``layer_window`` of each query when it is > 0.

    A global layer's ``cache_kv`` = (k_cache, v_cache), each (B, S_max, K,
    hd): the new keys and values are written at ``cache_pos`` (in place)
    and the queries attend to the cache's first ``cache_pos + S`` rows.
    With the queries end-aligned to those keys every written key is
    visible to the causal mask, which is the reference's masked full-cache
    attention (masked logits contribute an exact 0 after ``exp``).

    A local layer's cache (``layer_window`` > 0) is a ring of ``size`` =
    ``min(max_len, window)`` rows (:func:`ring_write`).  A prompt (S > 1,
    from ``cache_pos`` 0) attends to its own keys within the window and is
    then written to the ring.  A decode step (S = 1) writes at ``cache_pos
    % size`` and attends to the ring's first ``min(cache_pos + 1, size)``
    rows, all of them in the past and within the window, with no mask but
    that count (the reference's ``rolling=True``).
    """
    dt = common.dtype_of(cfg.compute_dtype)
    q, k, v = project_qkv(cfg, p, x, positions)
    s = x.shape[1]
    window = layer_window
    if cache_kv is None:
        keys, values = k, v
    elif layer_window:
        k_cache, v_cache = cache_kv
        if s > 1 and cache_pos != 0:
            raise NotImplementedError(
                "a local layer takes a prompt only from position 0")
        ring_write(k_cache, k, cache_pos)
        ring_write(v_cache, v, cache_pos)
        if s > 1:
            keys, values = k, v
        else:
            n = min(cache_pos + 1, _plain(k_cache).shape[1])
            keys = cache_read(k_cache[:, :n], dt)
            values = cache_read(v_cache[:, :n], dt)
            window = 0
    else:
        k_cache, v_cache = cache_kv
        cache_write(k_cache, k, cache_pos)
        cache_write(v_cache, v, cache_pos)
        end = cache_pos + s
        keys = cache_read(k_cache[:, :end], dt)
        values = cache_read(v_cache[:, :end], dt)
    out = fa_ops.flash_attention(q, keys, values, causal=True,
                                 window=window, softcap=cfg.attn_softcap)
    b = x.shape[0]
    out = out.reshape(b, s, -1) @ p.wo.to(dt).flatten(0, 1)
    return out, cache_kv
