"""The train state and train step (``repro.launch.steps``:
``make_train_state``, ``make_train_step``; the sharding and spec
functions are not ported yet).

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

import time

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import common, convert, transformer
from repro_torch.optim import adafactor, adamw, compress, schedule


def make_train_state(cfg: ArchConfig, seed: int = 0, device=None) -> dict:
    """Random parameters from a generator seeded with ``seed`` on the
    device (the reference's distributions, not its numbers), cast to
    ``cfg.param_dtype``, trainable, and the config's optimizer state."""
    dev = resolve_device(device)
    rng = torch.Generator(device=dev).manual_seed(seed)
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
        mark = _clock(phases, next(iter(named.values())).device)
        mark("start")
        loss, aux = transformer.loss_fn(cfg, params, batch)
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
        return new_state, metrics

    return train_step
