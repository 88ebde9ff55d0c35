"""AdamW with decoupled weight decay and global-norm clipping
(``repro.optim.adamw``), over dicts of tensors keyed by parameter name.

The reference's arithmetic, in its order: the gradients scaled by
``min(1, max_norm / max(norm, 1e-9))``; then per element ``m = b1 m +
(1 - b1) g``, ``v = b2 v + (1 - b2) g^2``, bias corrections ``1 - b^t``
from the int32 step, and ``p - lr (m_hat / (sqrt(v_hat) + eps) + wd
p)``, all in float32.  ``torch.optim.AdamW`` orders these otherwise
(weight decay before the step, eps elsewhere), so it is not used.  The
moments and parameters are updated in place, as the reference's donated
train step does; ``update`` returns them as the reference's does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32
    mu: dict             # first moment, per parameter
    nu: dict             # second moment, per parameter


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"   # bf16 halves the optimizer's memory


def init(params: dict, cfg: AdamWConfig = AdamWConfig()) -> AdamWState:
    dt = _DTYPES[cfg.moment_dtype]
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    device = next(iter(params.values())).device if params else None
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        mu={k: zeros(p) for k, p in params.items()},
        nu={k: zeros(p) for k, p in params.items()})


def global_norm(tree: dict, leaves=None) -> torch.Tensor:
    """sqrt of the sum of squares, leaf by leaf in the reference's order
    (a group's tensors summed as one stacked leaf)."""
    total = 0
    for names in leaves or [[k] for k in sorted(tree)]:
        leaf = 0
        for n in names:
            leaf = leaf + torch.sum(torch.square(tree[n].to(torch.float32)))
        total = total + leaf
    return torch.sqrt(total)


def clip_by_global_norm(grads: dict, max_norm: float, leaves=None):
    """``(grads scaled by min(1, max_norm / max(norm, 1e-9)), norm)``."""
    norm = global_norm(grads, leaves)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: (g.to(torch.float32) * scale).to(g.dtype)
            for k, g in grads.items()}, norm


@torch.no_grad()
def update(grads: dict, state: AdamWState, params: dict,
           cfg: AdamWConfig = AdamWConfig(), lr_scale=1.0, leaves=None):
    """One AdamW step.  Returns ``(params, state, {"grad_norm"})``, the
    parameters and moments updated in place."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, leaves)
    step = state.step + 1
    t = step.to(torch.float32)
    b1c = 1.0 - torch.pow(cfg.b1, t)
    b2c = 1.0 - torch.pow(cfg.b2, t)
    lr = cfg.lr * lr_scale
    for k, p in params.items():
        m, v = state.mu[k], state.nu[k]
        g32 = grads[k].to(torch.float32)
        m_new = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g32
        v_new = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * torch.square(
            g32)
        delta = (m_new / b1c) / (torch.sqrt(v_new / b2c) + cfg.eps)
        p32 = p.to(torch.float32)
        p.copy_(p32 - lr * (delta + cfg.weight_decay * p32))
        m.copy_(m_new)
        v.copy_(v_new)
    return params, AdamWState(step, state.mu, state.nu), {"grad_norm": gnorm}
