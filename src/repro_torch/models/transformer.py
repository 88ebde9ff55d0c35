"""Model assembly for every family of the reference's configs (dense,
Mixture-of-Experts, RWKV-6, the RecurrentGemma hybrid, the vision-language
and audio models): the training forward and loss, prefill and greedy
decode with a KV cache or recurrent states.

The same semantics as ``repro.models.transformer`` for layers of the
attention (global and local), RWKV and RG-LRU kinds, with a gated MLP, an
MoE layer or both (arctic's dense residual beside its MoE), Gemma-2's
post-norms and final soft-cap, the embedding scale, a head of its own or
tied to the embedding, musicgen's audio codebooks (K embeddings summed, K
heads) and sinusoidal positions, and qwen2-vl's M-RoPE with its vision
stub (projected patch embeddings over the first ``vision_tokens``
positions).  The reference stacks each superblock's parameters along a
leading axis for ``lax.scan``; here the layers are a ``ModuleList`` of
``n_layers`` in order (superblock ``s``, position ``i`` is layer ``s *
len(pattern) + i``, then the tail), and a loop runs them.  The parameter
names follow the reference's tree (``layers.<n>.ln1``, ``.attn.wq``,
``.mlp.w_gate``, ``.moe.router``, ``.tm.wr``, ``.cm.wk``, ``.rg.wa``,
``embed``, ``lm_head`` (absent when tied), ``vision_proj`` (a VLM's),
``final_norm``);
:mod:`repro_torch.models.convert` carries a reference tree across.

Parameters are float32 and are cast to ``cfg.compute_dtype`` at use, as
in the reference; :func:`compute_copy` makes that cast once for the
matmul weights, the expert weights (contiguous, for the grouped-matmul
kernel) and the head (a tied head's ``embed.T``) (the numbers are the
same, the cast being deterministic; the MoE router stays float32).
RWKV layers and RG-LRU blocks compute in float32 against their float32
weights, as the reference's do, so the copy leaves them as they are.  The
cache holds one ``(k, v)`` pair of entries per attention layer, updated in
place (``(B, max_len, K, hd)`` for a global layer, a ring of
``min(max_len, window)`` rows for a local one; each entry a
compute-dtype tensor or, with ``kv_cache_dtype="int8"``, an ``(int8,
float32 scale)`` pair: :mod:`repro_torch.models.attention`), one
:class:`~repro_torch.models.rwkv6.RwkvState` per RWKV layer and one
float32 :class:`~repro_torch.models.rglru.RGLRUState` per RG-LRU layer,
replaced by each step's new state.

Training (:func:`forward`, :func:`loss_fn`) runs under autograd on the
float32 (or ``param_dtype``) parameters themselves, after
:func:`trainable` turns their gradients on; every attention, expert
product and scan still goes through its kernel, whose backward is
autodiff of its plain version (:mod:`repro_torch.kernels.autograd`).
``cfg.remat`` checkpoints each superblock's layers as the reference's
``_remat_wrap`` does: ``"full"`` keeps only the superblock's input,
``"dots"`` also the outputs of products without batch dimensions
(``aten.mm`` / ``aten.addmm``, the counterpart of
``checkpoint_dots_with_no_batch_dims``); the tail is not checkpointed.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models import attention, common, mlp, rglru, rwkv6


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
    """Raise ``ValueError`` for a config no model can run: an unknown
    positional embedding or KV-cache type, or M-RoPE sections that do not
    cover the rotary half of the head.  Every feature of the reference's
    configs is ported."""
    if cfg.pos_emb not in ("rope", "sinusoidal", "none"):
        raise ValueError(f"{cfg.name}: unknown pos_emb {cfg.pos_emb!r}")
    if cfg.kv_cache_dtype not in ("", "int8"):
        raise ValueError(f"{cfg.name}: unknown kv_cache_dtype "
                         f"{cfg.kv_cache_dtype!r}")
    if cfg.mrope_sections and (sum(cfg.mrope_sections)
                               != cfg.resolved_head_dim // 2):
        raise ValueError(f"{cfg.name}: M-RoPE sections {cfg.mrope_sections}"
                         f" do not sum to {cfg.resolved_head_dim // 2}")


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------
class _Norms(nn.Module):
    """A residual layer's norms: ``ln1`` and ``ln2`` before its two
    branches and, where the config has ``post_norms`` (Gemma-2),
    ``post_ln1`` and ``post_ln2`` on their outputs (None without)."""

    def __init__(self, ln1, ln2, post_ln1=None, post_ln2=None):
        super().__init__()
        p = lambda w: (None if w is None
                       else nn.Parameter(w.detach(), requires_grad=False))
        self.ln1, self.ln2 = p(ln1), p(ln2)
        self.post_ln1, self.post_ln2 = p(post_ln1), p(post_ln2)

    def norms(self) -> tuple:
        return self.ln1, self.ln2, self.post_ln1, self.post_ln2


class Layer(_Norms):
    """One residual attention layer: the norms, ``attn`` and ``mlp`` (a
    gated MLP) or ``moe`` (an MoE layer), or both where the config has
    ``moe_dense_residual`` (arctic: ``dense`` passed beside the MoE)."""

    def __init__(self, norms, attn: attention.AttnParams,
                 ff: mlp.MLPParams | mlp.MoEParams,
                 dense: mlp.MLPParams | None = None):
        super().__init__(*norms)
        self.attn = attn
        if isinstance(ff, mlp.MoEParams):
            self.moe = ff
            if dense is not None:
                self.mlp = dense
        else:
            self.mlp = ff


class RwkvLayer(_Norms):
    """One residual RWKV-6 layer: the norms, ``tm`` (time mix) and ``cm``
    (channel mix); a ``post_ln1`` follows the time mix, as in the
    reference, which has no post-norm after the channel mix."""

    def __init__(self, norms, tm: rwkv6.TimeMixParams,
                 cm: rwkv6.ChannelMixParams):
        super().__init__(*norms)
        self.tm = tm
        self.cm = cm


class RgLayer(_Norms):
    """One residual RG-LRU layer: the norms, ``rg`` (the Griffin recurrent
    block) and ``mlp`` (a gated MLP)."""

    def __init__(self, norms, rg: rglru.RGLRUParams, ff: mlp.MLPParams):
        super().__init__(*norms)
        self.rg = rg
        self.mlp = ff


class Transformer(nn.Module):
    """``embed`` (V, D), ``layers``, ``final_norm`` (D,), ``lm_head``
    (D, V), None when the head is tied to ``embed``; with K audio
    codebooks ``embed`` (K, V, D) and ``lm_head`` (K, D, V); a VLM's
    ``vision_proj`` (vision_dim, D), else None."""

    def __init__(self, layers, embed, lm_head, final_norm, vision_proj=None):
        super().__init__()
        p = lambda w: (None if w is None
                       else nn.Parameter(w.detach(), requires_grad=False))
        self.layers = nn.ModuleList(layers)
        self.embed = p(embed)
        self.lm_head = p(lm_head)
        self.final_norm = p(final_norm)
        self.vision_proj = p(vision_proj)


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device=None) -> Transformer:
    """Random float32 parameters from ``generator`` on ``device``: the
    reference's distributions, not its numbers."""
    check_supported(cfg)
    d = cfg.d_model
    zeros = lambda: torch.zeros((d,), dtype=torch.float32, device=device)
    norms = lambda: ((zeros(), zeros(), zeros(), zeros()) if cfg.post_norms
                     else (zeros(), zeros()))

    def layer(kind):
        if kind == "rwkv":
            return RwkvLayer(norms(),
                             rwkv6.init_time_mix(cfg, generator, device),
                             rwkv6.init_channel_mix(cfg, generator, device))
        if kind == "rg":
            return RgLayer(norms(),
                           rglru.init_rglru(cfg, generator, device),
                           mlp.init_mlp(cfg, generator, device))
        if not cfg.n_experts:
            return Layer(norms(), attention.init_attn(cfg, generator, device),
                         mlp.init_mlp(cfg, generator, device))
        return Layer(norms(), attention.init_attn(cfg, generator, device),
                     mlp.init_moe(cfg, generator, device),
                     mlp.init_mlp(cfg, generator, device)
                     if cfg.moe_dense_residual else None)

    layers = [layer(kind) for kind in layer_kinds(cfg)]
    dense = lambda shape, axis: common.dense_init(
        shape, axis, generator=generator, device=device)
    if cfg.n_codebooks:
        k = cfg.n_codebooks
        embed = common.embed_init((k, cfg.vocab, d), generator=generator,
                                  device=device)
        lm_head = dense((k, d, cfg.vocab), 1)
    else:
        embed = common.embed_init((cfg.vocab, d), generator=generator,
                                  device=device)
        lm_head = None if cfg.tie_embeddings else dense((d, cfg.vocab), 0)
    vision = (dense((cfg.vision_dim, d), 0) if cfg.family == "vlm"
              else None)
    return Transformer(layers, embed, lm_head, zeros(), vision)


def trainable(params: Transformer, on: bool = True) -> Transformer:
    """Turn the gradients of every floating-point parameter on (or off);
    returns ``params``.  Serving leaves them off."""
    for p in params.parameters():
        if p.is_floating_point():
            p.requires_grad_(on)
    return params


def compute_copy(cfg: ArchConfig, params: Transformer) -> Transformer:
    """``params`` with every attention, MLP and expert matmul weight, the
    head and a VLM's vision projection cast once to the compute dtype (the
    norms, post-norms included, and the MoE router stay float32 and
    shared, the embedding table stays as it is: it is cast after the
    gather; RWKV layers and RG-LRU blocks, which compute in
    float32, are shared as they are).  A tied head's copy is ``embed.T``
    cast, held as the copy's ``lm_head``.  Computes the same numbers as
    ``params``; with a float32 compute dtype it shares every tensor."""
    dt = common.dtype_of(cfg.compute_dtype)
    c = lambda w: w.to(dt)

    def dense(l):
        return mlp.MLPParams(c(l.mlp.w_gate), c(l.mlp.w_up),
                             c(l.mlp.w_down))

    def ff(l):
        if hasattr(l, "moe"):
            m, ce = l.moe, lambda w: c(w).contiguous()
            return mlp.MoEParams(m.router, ce(m.w_gate), ce(m.w_up),
                                 ce(m.w_down))
        return dense(l)

    def layer(l):
        if isinstance(l, RwkvLayer):
            return l
        if isinstance(l, RgLayer):
            return RgLayer(l.norms(), l.rg, ff(l))
        return Layer(l.norms(),
                     attention.AttnParams(c(l.attn.wq), c(l.attn.wk),
                                          c(l.attn.wv), c(l.attn.wo),
                                          l.attn.q_norm, l.attn.k_norm),
                     ff(l),
                     dense(l) if hasattr(l, "moe") and hasattr(l, "mlp")
                     else None)

    layers = [layer(l) for l in params.layers]
    head = params.lm_head if params.lm_head is not None else params.embed.T
    vision = (None if params.vision_proj is None
              else c(params.vision_proj))
    return Transformer(layers, params.embed, head.to(dt), params.final_norm,
                       vision)


# --------------------------------------------------------------------------
# Layers, embedding, head
# --------------------------------------------------------------------------
def apply_layer(cfg: ArchConfig, kind: str, p, x: torch.Tensor,
                positions: torch.Tensor, *, cache=None,
                cache_pos: int | None = None, mrope_positions=None,
                aux: list | None = None):
    """One residual layer; returns ``(x, cache)``: an attention layer's
    cache written in place, an RWKV or RG-LRU layer's new state (None
    without one).  Where the config has ``post_norms`` (Gemma-2), each
    branch's output is normalized before it joins the residual; with
    ``moe_dense_residual`` (arctic) the dense MLP's output is added to the
    MoE's.  An MoE layer appends its load-balancing loss to ``aux`` where
    one is given."""
    post = lambda y, w: (y if w is None
                         else common.rms_norm(y, w, cfg.norm_eps))
    h = common.rms_norm(x, p.ln1, cfg.norm_eps)
    if kind == "rwkv":
        out, state = rwkv6.time_mix(cfg, p.tm, h, cache)
        x = residual(x + post(residual(out), p.post_ln1))
        h2 = common.rms_norm(x, p.ln2, cfg.norm_eps)
        out2, state = rwkv6.channel_mix(cfg, p.cm, h2, state)
        return residual(x + residual(out2)), state
    if kind == "rg":
        out, cache = rglru.recurrent_block(cfg, p.rg, h, cache)
    else:
        out, cache = attention.attend(cfg, p.attn, h, positions,
                                      layer_window=layer_window(cfg, kind),
                                      cache_kv=cache, cache_pos=cache_pos,
                                      mrope_positions=mrope_positions)
    x = residual(x + post(residual(out), p.post_ln1))
    h2 = common.rms_norm(x, p.ln2, cfg.norm_eps)
    if cfg.n_experts:
        out2, moe_aux = mlp.moe(cfg, p.moe, h2)
        if aux is not None:
            aux.append(moe_aux["aux_loss"])
        if cfg.moe_dense_residual:
            out2 = out2 + mlp.mlp(cfg, p.mlp, h2)
    else:
        out2 = mlp.mlp(cfg, p.mlp, h2)
    return residual(x + post(residual(out2), p.post_ln2)), cache


def residual(x: torch.Tensor) -> torch.Tensor:
    """The residual stream, and each branch's output before it joins it,
    as every layer takes it: under a mesh its batch over (pod, data) and
    the rest replicated over model (the tensor-parallel layout: each
    layer's products split over model and their partial sums reduced
    here, and so their gradients in the backward pass); on a plain tensor
    ``x`` itself."""
    return shd.constrain(x, batch_dim=0)


def embed_tokens(cfg: ArchConfig, params: Transformer, tokens: torch.Tensor,
                 *, positions: torch.Tensor | None = None,
                 vision_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """The tokens' embeddings in the compute dtype: (B, S) ids, or (B, K,
    S) with K audio codebooks, whose K float32 embeddings are added one
    after another in codebook order (the reference's prompt takes a Python
    ``sum``, its decode reduces a stack, which XLA adds in the same order:
    tests/test_torch_lm_configs.py); times
    sqrt(d_model) held in that dtype where ``cfg.embed_scale``; a VLM's
    projected ``vision_embeds`` (B, vision_tokens, vision_dim) over the
    first positions; sinusoidal embeddings of ``positions`` (default
    ``0 .. S - 1``) added where ``cfg.pos_emb`` is ``"sinusoidal"``."""
    dt = common.dtype_of(cfg.compute_dtype)
    tokens = tokens.long()
    look = lambda table, ids: (shd.embedding_lookup(table, ids)
                               if shd.is_dtensor(table) else table[ids])
    if cfg.n_codebooks:
        h = look(params.embed[0], tokens[:, 0])
        for k in range(1, cfg.n_codebooks):
            h = h + look(params.embed[k], tokens[:, k])
    else:
        h = look(params.embed, tokens)
    h = h.to(dt)
    if cfg.embed_scale:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=dt)
    if cfg.family == "vlm" and vision_embeds is not None:
        vis = vision_embeds.to(dt) @ params.vision_proj.to(dt)
        h = torch.cat([vis, h[:, vis.shape[1]:]], dim=1)
    if cfg.pos_emb == "sinusoidal":
        if positions is None:
            positions = torch.arange(h.shape[1], device=h.device)[None, :]
        h = h + common.sinusoidal_pos_emb(positions, cfg.d_model).to(dt)
    return residual(h)


def lm_logits(cfg: ArchConfig, params: Transformer,
              h: torch.Tensor) -> torch.Tensor:
    """The head's float32 logits (B, S, V), or (B, K, S, V) with K audio
    codebooks, soft-capped where ``cfg.final_softcap`` (Gemma-2) in
    float32."""
    dt = h.dtype
    h = common.rms_norm(h, params.final_norm, cfg.norm_eps)
    head = params.lm_head if params.lm_head is not None else params.embed.T
    if cfg.n_codebooks and shd.is_dtensor(h):
        # one product a codebook: DTensor's einsum folds the codebooks
        # into a vocab split over model, a placement no product takes
        logits = torch.stack([h @ head[k].to(dt)
                              for k in range(cfg.n_codebooks)], dim=1)
    elif cfg.n_codebooks:
        logits = torch.einsum("bsd,kdv->bksv", h, head.to(dt))
    else:
        logits = h @ head.to(dt)
    return common.softcap(logits.to(torch.float32), cfg.final_softcap)


# --------------------------------------------------------------------------
# Training forward and loss
# --------------------------------------------------------------------------
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the outputs of products without batch dimensions; recompute
    the rest."""
    if op in _DOTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(cfg: ArchConfig, fn):
    """``fn(x)`` checkpointed as ``cfg.remat`` says (non-reentrant)."""
    if cfg.remat == "full":
        return lambda x: ckpt.checkpoint(fn, x, use_reentrant=False)
    if cfg.remat == "dots":
        ctx = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                _dots_policy)
        return lambda x: ckpt.checkpoint(fn, x, use_reentrant=False,
                                         context_fn=ctx)
    if cfg.remat != "none":
        raise ValueError(f"{cfg.name}: unknown remat {cfg.remat!r}")
    return fn


def forward(cfg: ArchConfig, params: Transformer, batch: dict):
    """The training forward without caches: ``batch["tokens"]`` (B, S) (or
    (B, K, S)), with a VLM's ``vision_embeds`` and ``mrope_positions`` and
    optional ``positions`` (default ``0 .. S - 1``).  Returns the final
    hidden states (B, S, D) in the compute dtype and ``{"moe_aux_loss"}``,
    the MoE layers' load-balancing losses summed (a float32 0 without
    experts): each superblock's in layer order, then the superblocks', then
    the tail's, as the reference adds them."""
    check_supported(cfg)
    tokens = batch["tokens"]
    positions = batch.get("positions")
    h = embed_tokens(cfg, params, tokens, positions=positions,
                     vision_embeds=batch.get("vision_embeds"))
    if positions is None:
        positions = torch.arange(tokens.shape[-1], device=h.device)[None, :]
    mrope = batch.get("mrope_positions")
    pattern, n_super, tail = superblock_layout(cfg)
    span = len(pattern)
    zero = lambda: torch.zeros((), dtype=torch.float32, device=h.device)

    def layers(x, ps, kinds):
        aux = []
        for kind, p in zip(kinds, ps):
            x, _ = apply_layer(cfg, kind, p, x, positions,
                               mrope_positions=mrope, aux=aux)
        total = zero()
        for a in aux:
            total = total + a
        return x, total

    total_aux = zero()
    for s in range(n_super):
        block = params.layers[s * span:(s + 1) * span]
        # the block bound now: a checkpoint replays it in the backward pass
        run = _remat_wrap(cfg, lambda x, ps=block: layers(x, ps, pattern))
        h, aux_s = run(h)
        total_aux = total_aux + aux_s
    for i in range(tail):
        aux = []
        h, _ = apply_layer(cfg, pattern[i], params.layers[n_super * span + i],
                           h, positions, mrope_positions=mrope, aux=aux)
        for a in aux:
            total_aux = total_aux + a
    return h, {"moe_aux_loss": total_aux}


def loss_fn(cfg: ArchConfig, params: Transformer, batch: dict):
    """The mean token cross-entropy of :func:`forward`'s logits against
    ``batch["labels"]``, plus ``router_aux_coef * moe_aux_loss /
    n_layers`` with experts.  Returns ``(loss, {"ce", "moe_aux_loss"})``."""
    h, aux = forward(cfg, params, batch)
    logits = lm_logits(cfg, params, h)
    ce = common.cross_entropy_loss(logits, batch["labels"])
    loss = ce
    if cfg.n_experts:
        loss = loss + cfg.router_aux_coef * aux["moe_aux_loss"] / cfg.n_layers
    return loss, {"ce": ce, **aux}


# --------------------------------------------------------------------------
# KV cache, prefill and decode
# --------------------------------------------------------------------------
def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device=None) -> list:
    """Per layer, a zeroed ``(k, v)`` pair of (B, size, K, hd) for an
    attention layer (``size`` = ``max_len``, or ``min(max_len, window)``
    for a local layer's ring; with the int8 cache each entry an int8
    tensor of zeros and its (B, size, K, 1) float32 scales of ones, as the
    reference's), a zeroed
    :class:`~repro_torch.models.rwkv6.RwkvState` for an RWKV layer and
    :class:`~repro_torch.models.rglru.RGLRUState` for an RG-LRU layer
    (``max_len`` unused)."""
    check_supported(cfg)
    dt = common.dtype_of(cfg.compute_dtype)

    def entry(kind):
        if kind == "rwkv":
            return rwkv6.init_state(cfg, batch, dt, device)
        if kind == "rg":
            return rglru.init_state(cfg, batch, device)
        window = layer_window(cfg, kind)
        size = min(max_len, window) if window else max_len
        shape = (batch, size, cfg.n_kv_heads, cfg.resolved_head_dim)
        if cfg.kv_cache_dtype == "int8":
            return tuple((torch.zeros(shape, dtype=torch.int8, device=device),
                          torch.ones(shape[:-1] + (1,), dtype=torch.float32,
                                     device=device)) for _ in range(2))
        return (torch.zeros(shape, dtype=dt, device=device),
                torch.zeros(shape, dtype=dt, device=device))

    return [entry(kind) for kind in layer_kinds(cfg)]


def _run_layers(cfg, params, h, positions, cache, pos, mrope=None):
    """Runs every layer; returns ``(h, cache)`` with each layer's entry
    as :func:`apply_layer` returns it."""
    new_cache = []
    for kind, p, c in zip(layer_kinds(cfg), params.layers, cache):
        h, c = apply_layer(cfg, kind, p, h, positions, cache=c,
                           cache_pos=pos, mrope_positions=mrope)
        new_cache.append(c)
    return h, new_cache


def prefill(cfg: ArchConfig, params: Transformer, batch: dict,
            max_len: int | None = None, cache: list | None = None):
    """Forward over the prompt ``batch["tokens"]`` (B, S) (or (B, K, S)
    with K audio codebooks); returns ``(cache, logits)`` with a cache of
    capacity ``max(max_len, S)`` (a local layer's ring ``min`` of that and
    its window) holding the prompt's K/V (a ring its last rows; an int8
    cache quantized), the recurrent layers' states after the prompt, and
    the last token's logits (B, 1, V) (or (B, K, 1, V)).  A VLM's batch
    also carries ``vision_embeds`` and ``mrope_positions`` (3, B, S), as
    the reference's.  ``cache``, where given, is a fresh
    :func:`init_cache` of that capacity made elsewhere (a mesh's, its
    leaves placed), filled in its place.

    Each layer computes its K/V once, writes them to the cache and
    attends to them as computed (the reference computes them twice, for
    the cache and for attention; the numbers are the same)."""
    check_supported(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape[0], tokens.shape[-1]
    h = embed_tokens(cfg, params, tokens,
                     vision_embeds=batch.get("vision_embeds"))
    positions = torch.arange(s, device=h.device)[None, :]
    if cache is None:
        cache = init_cache(cfg, b, max(max_len or s, s, 1), h.device)
    h, cache = _run_layers(cfg, params, h, positions, cache, 0,
                           batch.get("mrope_positions"))
    return cache, lm_logits(cfg, params, h[:, -1:, :])


def decode_step(cfg: ArchConfig, params: Transformer, cache: list,
                batch: dict, pos: int):
    """One-token decode: ``batch["tokens"]`` (B, 1) (or (B, K, 1)) at
    absolute position ``pos``, with a VLM's ``mrope_positions`` (3, B, 1)
    where the batch has them.  Writes the token's K/V into ``cache`` in
    place and returns ``(cache, logits)`` with logits (B, 1, V) (or (B,
    K, 1, V)) and the recurrent layers' new states in the returned
    cache."""
    check_supported(cfg)
    tokens = batch["tokens"]
    positions = torch.full((tokens.shape[0], 1), pos, device=tokens.device)
    h = embed_tokens(cfg, params, tokens, positions=positions)
    h, cache = _run_layers(cfg, params, h, positions, cache, pos,
                           batch.get("mrope_positions"))
    return cache, lm_logits(cfg, params, h)
