"""Carry the reference's parameter and cache trees across, as numpy.

The reference keeps each superblock's parameters stacked along a leading
``n_super`` axis (``tree["blocks"]["l{i}_{kind}"]``) and the left-over
layers under ``tree["tail"]["t{i}_{kind}"]``; the port keeps one module
per layer in order.  ``attn``, ``mlp``, ``moe``, ``tm``, ``cm`` and
``rg`` nodes (and an RWKV or RG-LRU layer's cache entry) may be named
tuples (as ``jax.tree_util.tree_map(np.asarray, params)`` leaves them) or
dicts; :func:`params_to_numpy` writes dicts.  A tree with a tied head has no
``lm_head``, and passes both ways without one.  An arctic layer carries
its dense ``mlp`` beside its ``moe``, a VLM's tree its ``vision_proj``,
and an audio model's ``embed`` and ``lm_head`` a leading codebook axis.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import (attention, common, mlp, rglru, rwkv6,
                                transformer)

_ATTN = ("wq", "wk", "wv", "wo", "q_norm", "k_norm")
_MLP = ("w_gate", "w_up", "w_down")
_MOE = ("router", "w_gate", "w_up", "w_down")
_STATES = {"rwkv": rwkv6.RwkvState, "rg": rglru.RGLRUState}
# a layer's norms in order; the post-norms where the config has them
_NORMS = ("ln1", "ln2", "post_ln1", "post_ln2")


def _fields(node, names):
    if isinstance(node, dict):
        return [node[n] for n in names]
    return [getattr(node, n) for n in names]


def _layer_nodes(cfg: ArchConfig, tree: dict):
    """``(kind, node, index)`` per layer in order: the layer's kind, the
    reference's layer tree and its index along the stacked axis (None in
    the tail)."""
    pattern, n_super, tail = transformer.superblock_layout(cfg)
    out = [(kind, tree["blocks"][f"l{i}_{kind}"], s)
           for s in range(n_super) for i, kind in enumerate(pattern)]
    out += [(pattern[i], tree["tail"][f"t{i}_{pattern[i]}"], None)
            for i in range(tail)]
    return out


def params_from_numpy(cfg: ArchConfig, tree: dict,
                      device=None) -> transformer.Transformer:
    """The reference's ``init_params`` tree (numpy leaves) as the port's
    :class:`~repro_torch.models.transformer.Transformer` on ``device``."""
    transformer.check_supported(cfg)

    def t(a, s):
        a = np.asarray(a if s is None else a[s])
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    layers = []
    for kind, node, s in _layer_nodes(cfg, tree):
        fields = lambda sub, names: (t(a, s) for a in _fields(node[sub],
                                                              names))
        norms = tuple(t(node[k], s) for k in _NORMS if k in node)
        if kind == "rwkv":
            layers.append(transformer.RwkvLayer(
                norms,
                rwkv6.TimeMixParams(*fields("tm", rwkv6.TIME_MIX_FIELDS)),
                rwkv6.ChannelMixParams(*fields("cm",
                                               rwkv6.CHANNEL_MIX_FIELDS))))
            continue
        if kind == "rg":
            layers.append(transformer.RgLayer(
                norms,
                rglru.RGLRUParams(*fields("rg", rglru.RGLRU_FIELDS)),
                mlp.MLPParams(*fields("mlp", _MLP))))
            continue
        attn = attention.AttnParams(*fields("attn", _ATTN))
        dense = (mlp.MLPParams(*fields("mlp", _MLP)) if "mlp" in node
                 else None)
        if "moe" in node:
            layers.append(transformer.Layer(
                norms, attn, mlp.MoEParams(*fields("moe", _MOE)), dense))
        else:
            layers.append(transformer.Layer(norms, attn, dense))
    opt = lambda name: (None if tree.get(name) is None
                        else t(tree[name], None))
    return transformer.Transformer(layers, t(tree["embed"], None),
                                   opt("lm_head"), t(tree["final_norm"], None),
                                   opt("vision_proj"))


def params_to_numpy(cfg: ArchConfig, params: transformer.Transformer) -> dict:
    """The inverse of :func:`params_from_numpy`: the reference's tree with
    stacked blocks, as float32 numpy arrays."""
    pattern, n_super, tail = transformer.superblock_layout(cfg)
    n = lambda p: p.detach().to("cpu", torch.float32).numpy()

    def layer(p):
        if isinstance(p, transformer.RwkvLayer):
            subs = (("tm", rwkv6.TIME_MIX_FIELDS),
                    ("cm", rwkv6.CHANNEL_MIX_FIELDS))
        elif isinstance(p, transformer.RgLayer):
            subs = (("rg", rglru.RGLRU_FIELDS), ("mlp", _MLP))
        else:
            subs = (("attn", _ATTN),) + ((("moe", _MOE),) if hasattr(p, "moe")
                                         else ()) + (
                (("mlp", _MLP),) if hasattr(p, "mlp") else ())
        out = {k: n(w) for k, w in zip(_NORMS, p.norms())
               if w is not None}
        for sub, names in subs:
            out[sub] = {f: n(getattr(getattr(p, sub), f)) for f in names}
        return out

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return np.stack(trees)

    layers = [layer(p) for p in params.layers]
    span = len(pattern)
    blocks = {f"l{i}_{kind}": stack(layers[i:n_super * span:span])
              for i, kind in enumerate(pattern)}
    tree = {"blocks": blocks, "embed": n(params.embed),
            "final_norm": n(params.final_norm)}
    if params.lm_head is not None:
        tree["lm_head"] = n(params.lm_head)
    if params.vision_proj is not None:
        tree["vision_proj"] = n(params.vision_proj)
    if tail:
        tree["tail"] = {f"t{i}_{pattern[i]}": layers[n_super * span + i]
                        for i in range(tail)}
    return tree


def cache_from_numpy(cfg: ArchConfig, tree: dict, device=None) -> list:
    """The reference's cache tree (numpy leaves; each attention layer a
    ``(k, v)`` pair, a local layer's of its ring's size, each entry an
    array or, in an int8 cache, an ``(int8, scale)`` pair; each RWKV layer
    an ``RwkvState``, each RG-LRU layer an ``RGLRUState``) as the port's
    per-layer list: K/V in the compute dtype (an int8 entry as int8 values
    and float32 scales), recurrent states in float32 (the layers read them
    in float32)."""
    transformer.check_supported(cfg)
    dt = common.dtype_of(cfg.compute_dtype)

    def t(a, s, dtype=dt):
        a = np.asarray(a if s is None else a[s], np.float32)
        return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)

    def entry(kind, node, s):
        if kind in _STATES:
            state = _STATES[kind]
            return state(*(t(a, s, torch.float32)
                           for a in _fields(node, state._fields)))
        if isinstance(node[0], tuple):     # (int8 values, scales)
            raw = lambda a: torch.from_numpy(np.array(
                a if s is None else a[s])).to(device)
            return tuple((raw(e[0]), raw(e[1])) for e in node)
        return (t(node[0], s), t(node[1], s))

    return [entry(*n) for n in _layer_nodes(cfg, tree)]
