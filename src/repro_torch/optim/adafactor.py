"""Adafactor (Shazeer & Stern, 2018) with factored second moments
(``repro.optim.adafactor``), over dicts of tensors keyed by parameter name.

A tensor whose last two dimensions are both at least
``min_dim_size_to_factor`` keeps row and column means of its second
moment; any other keeps the full moment (and an empty ``vc``).  The
update is clipped to RMS <= ``clip_threshold`` and scaled by the
parameter's RMS (at least ``eps2``), and both of these statistics span a
whole leaf of the reference's tree: every superblock's tensor of a group
(:mod:`repro_torch.optim`), as the reference's stacked leaf does.
Parameters and moments are updated in place.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class AdafactorConfig(NamedTuple):
    lr: float = 1e-2             # relative step scale
    decay: float = 0.8           # beta2_t = 1 - t^-decay
    eps1: float = 1e-30
    eps2: float = 1e-3
    clip_threshold: float = 1.0
    weight_decay: float = 0.0
    min_dim_size_to_factor: int = 128


class LeafState(NamedTuple):
    vr: torch.Tensor    # row means (or the full v, unfactored)
    vc: torch.Tensor    # column means (or (0,), unfactored)


class AdafactorState(NamedTuple):
    step: torch.Tensor   # () int32
    v: dict              # LeafState per parameter


def factored(shape, cfg: AdafactorConfig = AdafactorConfig()) -> bool:
    return (len(shape) >= 2 and shape[-1] >= cfg.min_dim_size_to_factor
            and shape[-2] >= cfg.min_dim_size_to_factor)


def init(params: dict,
         cfg: AdafactorConfig = AdafactorConfig()) -> AdafactorState:
    def leaf(p):
        z = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                      device=p.device)
        if factored(p.shape, cfg):
            return LeafState(z(p.shape[:-1]), z(p.shape[:-2] + p.shape[-1:]))
        return LeafState(z(p.shape), z((0,)))

    device = next(iter(params.values())).device if params else None
    return AdafactorState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        v={k: leaf(p) for k, p in params.items()})


@torch.no_grad()
def update(grads: dict, state: AdafactorState, params: dict,
           cfg: AdafactorConfig = AdafactorConfig(), lr_scale=1.0,
           leaves=None):
    """One Adafactor step.  Returns ``(params, state, {})``, the
    parameters and moments updated in place."""
    step = state.step + 1
    beta2 = 1.0 - torch.pow(step.to(torch.float32), -cfg.decay)
    lr = cfg.lr * lr_scale
    for names in leaves or [[k] for k in sorted(params)]:
        us = []
        for k in names:
            g32 = grads[k].to(torch.float32)
            g2 = torch.square(g32) + cfg.eps1
            s = state.v[k]
            if factored(g32.shape, cfg):
                vr = beta2 * s.vr + (1 - beta2) * torch.mean(g2, dim=-1)
                vc = beta2 * s.vc + (1 - beta2) * torch.mean(g2, dim=-2)
                denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                    min=cfg.eps1)
                vhat = (vr[..., None] / denom[..., None]) * vc[..., None, :]
                s.vr.copy_(vr)
                s.vc.copy_(vc)
            else:
                vhat = beta2 * s.vr + (1 - beta2) * g2
                s.vr.copy_(vhat)
            us.append(g32 * torch.rsqrt(vhat + cfg.eps1))
        # update clipping and the parameter scale over the whole leaf
        n = sum(u.numel() for u in us)
        sq_u = sum(torch.sum(torch.square(u)) for u in us)
        rms_u = torch.sqrt(sq_u / n + 1e-30)
        p32s = [params[k].to(torch.float32) for k in names]
        sq_p = sum(torch.sum(torch.square(p)) for p in p32s)
        scale = torch.clamp(torch.sqrt(sq_p / n), min=cfg.eps2)
        clip = torch.clamp(rms_u / cfg.clip_threshold, min=1.0)
        for k, u, p32 in zip(names, us, p32s):
            u = u / clip
            params[k].copy_(p32 - lr * scale * u
                            - lr * cfg.weight_decay * p32)
    return params, AdafactorState(step, state.v), {}
