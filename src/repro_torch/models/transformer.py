"""Model assembly for the dense attention families: prefill and greedy
decode with a KV cache.

The same semantics as ``repro.models.transformer`` for layers of the
attention kinds.  The reference stacks each superblock's parameters along
a leading axis for ``lax.scan``; here the layers are a ``ModuleList`` of
``n_layers`` in order (superblock ``s``, position ``i`` is layer
``s * len(pattern) + i``, then the tail), and a loop runs them.  The
parameter names follow the reference's tree (``layers.<n>.ln1``,
``.attn.wq``, ``.mlp.w_gate``, ``embed``, ``lm_head``, ``final_norm``);
:mod:`repro_torch.models.convert` carries a reference tree across.

Parameters are float32 and are cast to ``cfg.compute_dtype`` at use, as
in the reference; :func:`compute_copy` makes that cast once for the
matmul weights (the numbers are the same, the cast being deterministic).
The cache holds one ``(k, v)`` pair of ``(B, max_len, K, hd)``
compute-dtype tensors per layer and is updated in place.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): recurrent layers (RWKV-6, RG-LRU), Mixture-of-Experts, M-RoPE,
sinusoidal positions, audio codebooks, the int8 KV cache, local
(sliding-window) layers with their rolling cache, and Gemma-2's
post-norms, embedding scale, tied head and final soft-cap.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention, common, mlp


# --------------------------------------------------------------------------
# Layout and what the port runs
# --------------------------------------------------------------------------
def superblock_layout(cfg: ArchConfig) -> tuple[list[str], int, int]:
    """Returns (pattern, n_super, n_tail_layers): the stack is
    ``pattern * n_super`` plus ``pattern[:n_tail]``."""
    if cfg.family == "ssm":
        pattern = ["rwkv"]
    elif cfg.family == "hybrid":
        n = max(cfg.rg_pattern, 1)
        pattern = ["rg"] * (n - 1) + ["attn_local"]
    elif cfg.global_every and cfg.global_every > 1:
        pattern = ["attn_local"] * (cfg.global_every - 1) + ["attn_global"]
    elif cfg.global_every < 0:
        pattern = ["attn_local"]
    else:
        pattern = ["attn_global"]
    span = len(pattern)
    n_super, tail = divmod(cfg.n_layers, span)
    return pattern, n_super, tail


def layer_kinds(cfg: ArchConfig) -> list[str]:
    """The kind of every layer, in order."""
    pattern, n_super, tail = superblock_layout(cfg)
    return pattern * n_super + pattern[:tail]


def layer_window(cfg: ArchConfig, kind: str) -> int:
    return cfg.sliding_window if kind in ("attn_local",) else 0


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a feature the port lacks."""
    missing = []
    if cfg.family == "ssm":
        missing.append("RWKV-6 layers (ROADMAP B7)")
    if cfg.family == "hybrid":
        missing.append("RG-LRU layers (ROADMAP B8)")
    if cfg.n_experts:
        missing.append("Mixture-of-Experts layers (ROADMAP B6)")
    if cfg.mrope_sections or cfg.family == "vlm":
        missing.append("M-RoPE and the vision frontend (ROADMAP A15)")
    if cfg.pos_emb != "rope":
        missing.append(f"{cfg.pos_emb} positions (ROADMAP A15)")
    if cfg.n_codebooks:
        missing.append("audio codebooks (ROADMAP A15)")
    if cfg.kv_cache_dtype == "int8":
        missing.append("the int8 KV cache (ROADMAP A15)")
    if "attn_local" in superblock_layout(cfg)[0]:
        missing.append("local layers and their rolling cache (ROADMAP A15)")
    gemma = [f for f in ("post_norms", "embed_scale", "tie_embeddings",
                         "final_softcap") if getattr(cfg, f)]
    if gemma:
        missing.append(f"Gemma-2's {', '.join(gemma)} (ROADMAP A15)")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet: {'; '.join(missing)}")


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------
class Layer(nn.Module):
    """One residual attention layer: ``ln1``, ``attn``, ``ln2``, ``mlp``."""

    def __init__(self, ln1, ln2, attn: attention.AttnParams,
                 mlp_params: mlp.MLPParams):
        super().__init__()
        self.ln1 = nn.Parameter(ln1.detach(), requires_grad=False)
        self.ln2 = nn.Parameter(ln2.detach(), requires_grad=False)
        self.attn = attn
        self.mlp = mlp_params


class Transformer(nn.Module):
    """``embed`` (V, D), ``layers``, ``final_norm`` (D,), ``lm_head``
    (D, V)."""

    def __init__(self, layers, embed, lm_head, final_norm):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.embed = nn.Parameter(embed.detach(), requires_grad=False)
        self.lm_head = nn.Parameter(lm_head.detach(), requires_grad=False)
        self.final_norm = nn.Parameter(final_norm.detach(),
                                       requires_grad=False)


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device=None) -> Transformer:
    """Random float32 parameters from ``generator`` on ``device``: the
    reference's distributions, not its numbers."""
    check_supported(cfg)
    d = cfg.d_model
    zeros = lambda: torch.zeros((d,), dtype=torch.float32, device=device)
    layers = [Layer(zeros(), zeros(),
                    attention.init_attn(cfg, generator, device),
                    mlp.init_mlp(cfg, generator, device))
              for _ in layer_kinds(cfg)]
    embed = common.embed_init((cfg.vocab, d), generator=generator,
                              device=device)
    lm_head = common.dense_init((d, cfg.vocab), 0, generator=generator,
                                device=device)
    return Transformer(layers, embed, lm_head, zeros())


def compute_copy(cfg: ArchConfig, params: Transformer) -> Transformer:
    """``params`` with every matmul weight cast once to the compute dtype
    (the norms stay float32 and shared, the embedding table stays as it
    is: it is cast after the gather).  Computes the same numbers as
    ``params``; with a float32 compute dtype it shares every tensor."""
    dt = common.dtype_of(cfg.compute_dtype)
    c = lambda w: w.to(dt)
    layers = [Layer(l.ln1, l.ln2,
                    attention.AttnParams(c(l.attn.wq), c(l.attn.wk),
                                         c(l.attn.wv), c(l.attn.wo),
                                         l.attn.q_norm, l.attn.k_norm),
                    mlp.MLPParams(c(l.mlp.w_gate), c(l.mlp.w_up),
                                  c(l.mlp.w_down)))
              for l in params.layers]
    return Transformer(layers, params.embed, c(params.lm_head),
                       params.final_norm)


# --------------------------------------------------------------------------
# Layers, embedding, head
# --------------------------------------------------------------------------
def apply_layer(cfg: ArchConfig, kind: str, p: Layer, x: torch.Tensor,
                positions: torch.Tensor, *, cache=None,
                cache_pos: int | None = None):
    """One residual layer of an attention kind; returns ``(x, cache)``."""
    h = common.rms_norm(x, p.ln1, cfg.norm_eps)
    out, cache = attention.attend(cfg, p.attn, h, positions,
                                  layer_window=layer_window(cfg, kind),
                                  cache_kv=cache, cache_pos=cache_pos)
    x = x + out
    h2 = common.rms_norm(x, p.ln2, cfg.norm_eps)
    return x + mlp.mlp(cfg, p.mlp, h2), cache


def embed_tokens(cfg: ArchConfig, params: Transformer,
                 tokens: torch.Tensor) -> torch.Tensor:
    dt = common.dtype_of(cfg.compute_dtype)
    return params.embed[tokens.long()].to(dt)


def lm_logits(cfg: ArchConfig, params: Transformer,
              h: torch.Tensor) -> torch.Tensor:
    dt = h.dtype
    h = common.rms_norm(h, params.final_norm, cfg.norm_eps)
    return (h @ params.lm_head.to(dt)).to(torch.float32)


# --------------------------------------------------------------------------
# KV cache, prefill and decode
# --------------------------------------------------------------------------
def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device=None) -> list:
    """One zeroed ``(k, v)`` pair of (B, max_len, K, hd) per layer."""
    check_supported(cfg)
    dt = common.dtype_of(cfg.compute_dtype)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return [(torch.zeros(shape, dtype=dt, device=device),
             torch.zeros(shape, dtype=dt, device=device))
            for _ in layer_kinds(cfg)]


def _run_layers(cfg, params, h, positions, cache, pos):
    for kind, p, c in zip(layer_kinds(cfg), params.layers, cache):
        h, _ = apply_layer(cfg, kind, p, h, positions, cache=c,
                           cache_pos=pos)
    return h


def prefill(cfg: ArchConfig, params: Transformer, batch: dict,
            max_len: int | None = None):
    """Forward over the prompt ``batch["tokens"]`` (B, S); returns
    ``(cache, logits)`` with a cache of capacity ``max(max_len, S)``
    holding the prompt's K/V and the last token's logits (B, 1, V).

    Each layer computes its K/V once, writes them to the cache and
    attends to them there (the reference computes them twice, for the
    cache and for attention; the numbers are the same)."""
    check_supported(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    h = embed_tokens(cfg, params, tokens)
    positions = torch.arange(s, device=h.device)[None, :]
    cache = init_cache(cfg, b, max(max_len or s, s, 1), h.device)
    h = _run_layers(cfg, params, h, positions, cache, 0)
    return cache, lm_logits(cfg, params, h[:, -1:, :])


def decode_step(cfg: ArchConfig, params: Transformer, cache: list,
                batch: dict, pos: int):
    """One-token decode: ``batch["tokens"]`` (B, 1) at absolute position
    ``pos``.  Writes the token's K/V into ``cache`` in place and returns
    ``(cache, logits)`` with logits (B, 1, V)."""
    check_supported(cfg)
    h = embed_tokens(cfg, params, batch["tokens"])
    positions = torch.full((h.shape[0], 1), pos, device=h.device)
    h = _run_layers(cfg, params, h, positions, cache, pos)
    return cache, lm_logits(cfg, params, h)
