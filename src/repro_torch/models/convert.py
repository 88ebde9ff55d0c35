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

A train state (``repro.launch.steps.make_train_state``, with ``"ef"``
under gradient compression) carries the optimizer's moments in trees of
the same leaves: :func:`leaf_groups` names the port's tensors of each
leaf, and :func:`train_state_from_numpy` / :func:`train_state_to_numpy`
carry AdamW's ``mu``/``nu``, Adafactor's ``vr``/``vc`` and the
compressor's residuals across, so both packages start from the same
numbers.
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
# each sub-tree's fields in the reference's NamedTuple order
_SUB_FIELDS = {"attn": _ATTN, "mlp": _MLP, "moe": _MOE,
               "tm": rwkv6.TIME_MIX_FIELDS, "cm": rwkv6.CHANNEL_MIX_FIELDS,
               "rg": rglru.RGLRU_FIELDS}
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


# --------------------------------------------------------------------------
# Train states
# --------------------------------------------------------------------------
def _ref_path(cfg: ArchConfig, name: str):
    """``(order, key, superblock)`` of a port parameter name: its place in
    JAX's leaf order (dict keys sorted, NamedTuple fields in order), the
    reference's leaf path and its index along the stacked axis (None
    outside the blocks)."""
    parts = name.split(".")
    if parts[0] != "layers":
        return (name,), name, None
    pattern, n_super, _ = transformer.superblock_layout(cfg)
    span, n = len(pattern), int(parts[1])
    if n < n_super * span:
        s, i = divmod(n, span)
        top = ("blocks", f"l{i}_{pattern[i]}")
    else:
        s, i = None, n - n_super * span
        top = ("tail", f"t{i}_{pattern[i]}")
    rest = tuple(parts[2:])
    order = top + (rest if len(rest) == 1
                   else (rest[0], _SUB_FIELDS[rest[0]].index(rest[1])))
    return order, ".".join(top + rest), s


def leaf_groups(cfg: ArchConfig, names) -> dict:
    """``{reference leaf path: [port parameter names]}`` in JAX's leaf
    order, each group's names in superblock order: a stacked leaf's
    tensors.  ``names``: the port's parameter names (or a module, or a
    dict keyed by them)."""
    if isinstance(names, torch.nn.Module):
        names = [n for n, _ in names.named_parameters()]
    paths = sorted((_ref_path(cfg, n) + (n,) for n in names),
                   key=lambda t: (t[0], -1 if t[2] is None else t[2]))
    out: dict = {}
    for _, key, _, n in paths:
        out.setdefault(key, []).append(n)
    return out


def flat_tree(node, prefix: str = "") -> dict:
    """A reference tree of dicts and NamedTuples as ``{path: leaf}``."""
    if isinstance(node, dict):
        items = [(str(k), node[k]) for k in sorted(node)]
    elif hasattr(node, "_fields"):
        items = list(zip(node._fields, node))
    else:
        return {prefix: node}
    out = {}
    for k, v in items:
        if v is not None:
            out.update(flat_tree(v, f"{prefix}.{k}" if prefix else k))
    return out


def _nest(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        *head, last = key.split(".")
        node = out
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def named_from_tree(cfg, groups, flat, suffix="", device=None,
                    dtype=torch.float32) -> dict:
    """``{port name: tensor}`` from a flat reference tree: a stacked
    leaf's slice ``s`` for the tensor of superblock ``s`` (an empty
    ``(0,)`` leaf, Adafactor's unfactored ``vc``, for every one)."""
    out = {}
    for key, names in groups.items():
        a = np.asarray(flat[key + suffix])
        for n in names:
            s = _ref_path(cfg, n)[2]
            part = a if s is None or a.shape == (0,) else a[s]
            out[n] = torch.from_numpy(np.array(part, np.float32)).to(
                device=device, dtype=dtype)
    return out


def tree_from_named(groups, named, vc: bool = False) -> dict:
    """A flat reference tree from ``{port name: tensor}``: each block
    leaf's tensors stacked along a leading axis (with ``vc``, Adafactor's
    unfactored ``(0,)`` stays ``(0,)``)."""
    n = lambda t: t.detach().to("cpu", torch.float32).numpy()
    out = {}
    for key, names in groups.items():
        parts = [n(named[k]) for k in names]
        if key.startswith("blocks.") and not (vc and parts[0].shape
                                               == (0,)):
            out[key] = np.stack(parts)
        else:
            out[key] = parts[0]
    return out


def train_state_from_numpy(cfg: ArchConfig, tree: dict, device=None) -> dict:
    """A reference train state (numpy leaves; ``opt`` an ``AdamWState`` or
    ``AdafactorState``, or dicts of their fields; ``ef`` an ``EFState``
    where there is one) as the port's: ``params`` a trainable
    :class:`~repro_torch.models.transformer.Transformer` in
    ``cfg.param_dtype``, ``opt`` the port's state of the config's
    optimizer, ``ef`` an :class:`~repro_torch.optim.compress.EFState`."""
    from repro_torch.optim import adafactor, adamw, compress

    pdt = common.dtype_of(cfg.param_dtype)
    params = params_from_numpy(cfg, tree["params"], device)
    params = transformer.trainable(params.to(pdt))
    groups = leaf_groups(cfg, params)
    get = lambda node, k: node[k] if isinstance(node, dict) else getattr(
        node, k)
    opt = tree["opt"]
    step = torch.tensor(int(np.asarray(get(opt, "step"))), dtype=torch.int32,
                        device=device)
    if cfg.optimizer == "adafactor":
        flat = flat_tree(get(opt, "v"))
        vr = named_from_tree(cfg, groups, flat, ".vr", device)
        vc = named_from_tree(cfg, groups, flat, ".vc", device)
        state = adafactor.AdafactorState(step, {
            k: adafactor.LeafState(vr[k], vc[k]) for k in vr})
    else:
        mu, nu = (flat_tree(get(opt, k)) for k in ("mu", "nu"))
        bf16 = str(np.asarray(next(iter(mu.values()))).dtype) == "bfloat16"
        dt = torch.bfloat16 if bf16 else torch.float32
        state = adamw.AdamWState(
            step, named_from_tree(cfg, groups, mu, "", device, dt),
            named_from_tree(cfg, groups, nu, "", device, dt))
    out = {"params": params, "opt": state}
    if "ef" in tree:
        out["ef"] = compress.EFState(named_from_tree(
            cfg, groups, flat_tree(get(tree["ef"], "residual")), "", device))
    return out


def train_state_to_numpy(cfg: ArchConfig, state: dict) -> dict:
    """The inverse of :func:`train_state_from_numpy`: the reference's train
    state as nested dicts of numpy arrays (float32; ``opt.step`` int32)."""
    params = state["params"]
    groups = leaf_groups(cfg, params)
    opt = state["opt"]
    tree = {"params": params_to_numpy(cfg, params),
            "opt": {"step": np.asarray(int(opt.step), np.int32)}}
    if hasattr(opt, "v"):
        vr = tree_from_named(groups, {k: v.vr for k, v in opt.v.items()})
        vc = tree_from_named(groups, {k: v.vc for k, v in opt.v.items()},
                             vc=True)
        tree["opt"]["v"] = _nest({**{k + ".vr": a for k, a in vr.items()},
                                  **{k + ".vc": a for k, a in vc.items()}})
    else:
        tree["opt"]["mu"] = _nest(tree_from_named(groups, opt.mu))
        tree["opt"]["nu"] = _nest(tree_from_named(groups, opt.nu))
    if "ef" in state:
        tree["ef"] = {"residual": _nest(tree_from_named(groups,
                                               state["ef"].residual))}
    return tree
