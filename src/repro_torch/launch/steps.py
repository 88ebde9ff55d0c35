"""The train state, the step functions, their abstract inputs and their
shardings (``repro.launch.steps``).

A train state is ``{"params": Transformer, "opt": AdamWState or
AdafactorState}`` plus ``"ef"`` (an ``EFState``) under gradient
compression.  The step takes the loss and its gradients under autograd
(every parameter's; one the loss does not reach gets zeros, as
``jax.value_and_grad`` gives), compresses them where asked, reads the
warmup-cosine scale at the optimizer's step *before* its increment, and
updates the parameters and moments in place (the reference donates its
state).  Its optimizer statistics span the reference's stacked leaves
(:func:`repro_torch.models.convert.leaf_groups`).
"""
from __future__ import annotations

import contextlib
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.distributed import sharding as shd
from repro_torch.models import common, convert, transformer
from repro_torch.optim import adafactor, adamw, compress, schedule


def make_train_state(cfg: ArchConfig, seed: int = 0, device=None) -> dict:
    """Random parameters from a generator seeded with ``seed`` on the
    device (the reference's distributions, not its numbers), cast to
    ``cfg.param_dtype``, trainable, and the config's optimizer state."""
    dev = resolve_device(device)
    rng = torch.Generator(device="cpu" if dev.type == "meta" else dev)
    rng.manual_seed(seed)
    params = transformer.init_params(cfg, rng, dev)
    if cfg.param_dtype != "float32":
        params = params.to(common.dtype_of(cfg.param_dtype))
    transformer.trainable(params)
    named = dict(params.named_parameters())
    opt = (adafactor.init(named) if cfg.optimizer == "adafactor"
           else adamw.init(named))
    return {"params": params, "opt": opt}


def state_tree(state: dict) -> dict:
    """The train state as a checkpointable tree: the parameters as a dict
    by name."""
    out = dict(state)
    out["params"] = {k: p.detach()
                     for k, p in state["params"].named_parameters()}
    return out


@torch.no_grad()
def load_state_tree(state: dict, tree: dict) -> dict:
    """``state`` with its parameters overwritten in place from a
    :func:`state_tree`'s and everything else taken from ``tree``."""
    for k, p in state["params"].named_parameters():
        p.copy_(tree["params"][k])
    return {**tree, "params": state["params"]}


def _clock(phases: dict | None, device: torch.device):
    """Record the seconds since the last mark under a phase's name, after
    a synchronize on the card; a no-op without ``phases``."""
    last = [time.perf_counter()]

    def mark(name):
        if phases is None:
            return
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        phases[name] = now - last[0]
        last[0] = now

    return mark


def make_train_step(cfg: ArchConfig, *, grad_compress: bool = False,
                    total_steps: int = 10000):
    """Returns ``train_step(state, batch, phases=None, grads_hook=None) ->
    (state, metrics)``; metrics ``loss``, ``ce``, ``moe_aux_loss`` and,
    with AdamW, ``grad_norm`` (0-d tensors).  ``phases``, a dict, receives
    the seconds of the ``forward``, ``backward`` and ``optimizer`` phases,
    each ended by a synchronize; ``grads_hook`` is called with the
    gradients by name before they are compressed or applied."""
    use_adafactor = cfg.optimizer == "adafactor"
    leaves: list = []

    def train_step(state, batch, phases: dict | None = None,
                   grads_hook=None):
        params = state["params"]
        named = dict(params.named_parameters())
        if not leaves:
            leaves.extend(convert.leaf_groups(cfg, list(named)).values())
        with _on_mesh(mesh_of(named)):
            return step(state, params, named, batch, phases, grads_hook)

    def step(state, params, named, batch, phases, grads_hook):
        mark = _clock(phases, next(iter(named.values())).device)
        mark("start")
        loss, aux = _loss(cfg, params, named, batch)
        mark("forward")
        got = torch.autograd.grad(loss, list(named.values()),
                                  allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(named.items(), got)}
        mark("backward")
        if grads_hook is not None:
            grads_hook(grads)
        new_state = {}
        if grad_compress:
            grads, new_state["ef"] = compress.compress_grads(
                grads, state["ef"], leaves)
        lr_scale = schedule.warmup_cosine(state["opt"].step,
                                          total_steps=total_steps)
        update = adafactor.update if use_adafactor else adamw.update
        _, opt, om = update(grads, state["opt"], named, lr_scale=lr_scale,
                            leaves=leaves)
        del grads, got
        mark("optimizer")
        new_state.update(params=params, opt=opt)
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in aux.items()}, **om}
        return new_state, {k: _whole(v) for k, v in metrics.items()}

    return train_step


def mesh_of(named: dict):
    """The mesh of the first DTensor among ``named``'s values, or None."""
    for t in named.values():
        if shd.is_dtensor(t):
            return t.device_mesh
    return None


@contextlib.contextmanager
def _on_mesh(mesh):
    """Outside a mesh nothing; under one the activation constraints'
    mesh, and plain tensors (constants the model makes: positions, zero
    states) taken as replicated where they meet DTensors."""
    if mesh is None:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    with shd.activation_mesh(mesh), implicit_replication():
        yield


def _whole(x):
    """A DTensor metric as the plain tensor of its full value."""
    return x.full_tensor() if shd.is_dtensor(x) else x


class _Call(torch.nn.Module):
    """``fn(params, *args)`` as a module holding ``params``, so that
    ``functional_call`` can hand ``fn`` other tensors in their place."""

    def __init__(self, fn, params):
        super().__init__()
        self.fn = fn
        self.params = params

    def forward(self, *args):
        return self.fn(self.params, *args)


def gathered(p):
    """A DTensor parameter as the forward uses it: replicated over data
    (and pod), the FSDP all-gather, its model split kept; its gradient
    comes back through the matching reduce-scatter."""
    from torch.distributed.tensor import Replicate
    names = p.device_mesh.mesh_dim_names
    want = tuple(q if name == "model" else Replicate()
                 for q, name in zip(p.placements, names))
    return p if tuple(p.placements) == want else p.redistribute(
        p.device_mesh, want)


def _gathered_call(fn, params, named, *args):
    """``fn(params, *args)``; under a mesh with each parameter
    :func:`gathered` for it (the module's own, sharded, stay the leaves
    gradients are taken for)."""
    if shd.active_mesh() is None:
        return fn(params, *args)
    from torch.func import functional_call
    use = {"params." + k: gathered(p) for k, p in named.items()}
    return functional_call(_Call(fn, params), use, args)


def _loss(cfg, params, named, batch):
    """``loss_fn``, the parameters gathered under a mesh."""
    return _gathered_call(
        lambda p, b: transformer.loss_fn(cfg, p, b), params, named, batch)


# ------------------------------------------------------------------ specs --
def train_state_specs(cfg: ArchConfig, grad_compress: bool = False) -> dict:
    """The train state on the meta device: its structure, shapes and
    dtypes with nothing allocated (the reference's ``eval_shape``)."""
    state = make_train_state(cfg, 0, "meta")
    if grad_compress:
        state["ef"] = compress.init_ef(dict(
            state["params"].named_parameters()))
    return state


def input_specs(cfg: ArchConfig, spec: ShapeSpec) -> dict:
    """Meta tensors standing in for every model input of a cell: a train
    batch's ``tokens`` and ``labels``, a prefill's ``tokens``, a decode
    step's one token; with K audio codebooks ``(B, K, S)``; a VLM's
    ``vision_embeds`` (not at decode) and ``mrope_positions`` ``(3, B,
    S)``."""
    b, s = spec.global_batch, spec.seq_len
    meta = lambda shape, dt=torch.int32: torch.empty(shape, dtype=dt,
                                                     device="meta")
    tok = lambda seq: ((b, cfg.n_codebooks, seq) if cfg.n_codebooks
                       else (b, seq))
    if spec.kind == "train":
        batch = {"tokens": meta(tok(s)), "labels": meta(tok(s))}
    elif spec.kind == "prefill":
        batch = {"tokens": meta(tok(s))}
    else:
        batch = {"tokens": meta(tok(1))}
    if cfg.family == "vlm":
        seq = s if spec.kind != "decode" else 1
        if spec.kind != "decode":
            batch["vision_embeds"] = meta(
                (b, cfg.vision_tokens, cfg.vision_dim), torch.float32)
        batch["mrope_positions"] = meta((3, b, seq))
    return batch


def cache_specs(cfg: ArchConfig, spec: ShapeSpec) -> list:
    """The decode cache of a cell on the meta device."""
    return transformer.init_cache(cfg, spec.global_batch, spec.seq_len,
                                  device="meta")


# ------------------------------------------------------------------ steps --
def make_prefill_step(cfg: ArchConfig, max_len: int | None = None):
    """Returns ``prefill_step(params, batch) -> (cache, logits)``.  On
    DTensor parameters (placed by :func:`serve_shardings`) the cache is
    made on the mesh, each leaf zeroed as its rank's shard
    (:func:`placed_cache`), the parameters are gathered as the training
    forward gathers them, and the returned cache leaves are redistributed
    to their cache shardings (the reference's ``out_shardings``)."""
    def prefill_step(params, batch):
        named = dict(params.named_parameters())
        mesh = mesh_of(named)
        if mesh is None:
            return transformer.prefill(cfg, params, batch, max_len=max_len)
        with _on_mesh(mesh):
            tokens = batch["tokens"]
            s = tokens.shape[-1]
            cache = placed_cache(cfg, mesh, tokens.shape[0],
                                 max(max_len or s, s, 1))
            cache, logits = _gathered_call(
                lambda p, b: transformer.prefill(cfg, p, b, cache=cache),
                params, named, batch)
            return settled_cache(cfg, mesh, cache), logits
    return prefill_step


def make_decode_step(cfg: ArchConfig):
    """Returns ``decode_step(params, cache, batch, pos) -> (cache,
    logits)``; on DTensors as :func:`make_prefill_step`'s, with the cache
    passed in placed by :func:`serve_shardings`."""
    def decode_step(params, cache, batch, pos):
        named = dict(params.named_parameters())
        mesh = mesh_of(named)
        if mesh is None:
            return transformer.decode_step(cfg, params, cache, batch, pos)
        with _on_mesh(mesh):
            cache, logits = _gathered_call(
                lambda p, c, b: transformer.decode_step(cfg, p, c, b, pos),
                params, named, cache, batch)
            return settled_cache(cfg, mesh, cache), logits
    return decode_step


def _cache_placements(cfg: ArchConfig, mesh, cache: list) -> list:
    """Each leaf's placements on ``mesh``, in ``ckpt.flatten`` order."""
    return [shd.placements(sp, mesh)
            for _, sp in shd.cache_shardings(mesh, cfg, cache)]


def placed_cache(cfg: ArchConfig, mesh, batch: int, max_len: int) -> list:
    """:func:`~repro_torch.models.transformer.init_cache`'s cache as
    DTensors placed by the cache rules, each rank making only its shard:
    zeros, and ones for an int8 entry's scales."""
    import re
    from torch.distributed.tensor import ones, zeros
    from repro_torch.checkpoint import ckpt
    meta = transformer.init_cache(cfg, batch, max_len, device="meta")
    leaves = []
    for (path, t), pls in zip(ckpt.flatten(meta),
                              _cache_placements(cfg, mesh, meta)):
        scale = re.search(r"\.[01]\.1$", path) and t.dtype == torch.float32
        make = ones if scale else zeros
        leaves.append(make(t.shape, dtype=t.dtype, device_mesh=mesh,
                           placements=pls))
    return ckpt.rebuild(meta, iter(leaves))


def settled_cache(cfg: ArchConfig, mesh, cache: list) -> list:
    """``cache`` with every DTensor leaf redistributed to its cache
    placements (the attention caches, written in place, are already)."""
    from repro_torch.checkpoint import ckpt
    leaves = [t.redistribute(mesh, pls)
              if shd.is_dtensor(t) and tuple(t.placements) != pls else t
              for (_, t), pls in zip(ckpt.flatten(cache),
                                     _cache_placements(cfg, mesh, cache))]
    return ckpt.rebuild(cache, iter(leaves))


# -------------------------------------------------------------- shardings --
def train_shardings(cfg: ArchConfig, mesh, spec: ShapeSpec,
                    grad_compress: bool = False):
    """``(state shardings, batch shardings)``: trees of
    :class:`~repro_torch.distributed.sharding.NamedSharding` shaped as
    :func:`state_tree`'s and the batch's.  Parameters by the rules; AdamW's
    ``mu``/``nu`` as their parameters; its ``step`` and all of
    Adafactor's state replicated (the reference's
    ``_opt_leaf_sharding``); the compressor's residual as its parameter
    (the reference leaves it to the compiler)."""
    state = train_state_specs(cfg, grad_compress)
    named = dict(state["params"].named_parameters())
    ns = lambda sp: shd.NamedSharding(mesh, sp)
    params = {k: ns(sp) for k, sp in
              shd.param_shardings(mesh, cfg, named).items()}
    opt = state["opt"]
    rep = ns(shd.replicated(mesh))
    if cfg.optimizer == "adafactor":
        opt_sh = adafactor.AdafactorState(rep, {
            k: adafactor.LeafState(rep, rep) for k in opt.v})
    else:
        opt_sh = adamw.AdamWState(rep, dict(params), dict(params))
    out = {"params": params, "opt": opt_sh}
    if grad_compress:
        out["ef"] = compress.EFState(dict(params))
    batch = {k: ns(sp) for k, sp in
             shd.batch_shardings(mesh, input_specs(cfg, spec)).items()}
    return out, batch


def serve_shardings(cfg: ArchConfig, mesh, spec: ShapeSpec):
    """``(parameter, cache, batch)`` shardings of a serving cell: the
    parameter rules, the cache rules (a list of ``(reference path,
    NamedSharding)`` in :func:`~repro_torch.distributed.sharding.
    cache_leaves` order) and the batch's."""
    named = dict(transformer.init_params(
        cfg, torch.Generator().manual_seed(0), "meta").named_parameters())
    ns = lambda sp: shd.NamedSharding(mesh, sp)
    p_sh = {k: ns(sp) for k, sp in
            shd.param_shardings(mesh, cfg, named).items()}
    c_sh = [(path, ns(sp)) for path, sp in
            shd.cache_shardings(mesh, cfg, cache_specs(cfg, spec))]
    b_sh = {k: ns(sp) for k, sp in
            shd.batch_shardings(mesh, input_specs(cfg, spec)).items()}
    return p_sh, c_sh, b_sh


@torch.no_grad()
def place_state(state: dict, shardings: dict) -> dict:
    """``state`` (every rank holding the same full values) placed by
    :func:`train_shardings`' first tree: each parameter of the module
    replaced by a DTensor parameter holding this rank's shard, every
    other tensor with a sharding a DTensor, the 0-d ``step`` counters
    left as the plain tensors every rank holds."""
    for name, p in list(state["params"].named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = state["params"].get_submodule(mod_name)
        placed = shardings["params"][name].place(p.detach())
        setattr(mod, leaf, torch.nn.Parameter(
            placed, requires_grad=p.requires_grad))
    rest = {k: v for k, v in state.items() if k != "params"}
    sh = {k: v for k, v in shardings.items() if k in rest}
    return {"params": state["params"], **shd.place(rest, sh)}
