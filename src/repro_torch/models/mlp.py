"""Feed-forward layers: the gated MLP (SwiGLU / GeGLU).

The same semantics as ``repro.models.mlp.mlp``.  Its three products are
plain large matrix products outside any TPU kernel, so they go to
``torch.matmul``, as the reference leaves them to XLA.  The
Mixture-of-Experts layer waits for the grouped-matmul kernel.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common


class MLPParams(nn.Module):
    """``w_gate``, ``w_up`` (D, F) and ``w_down`` (F, D)."""

    def __init__(self, w_gate: torch.Tensor, w_up: torch.Tensor,
                 w_down: torch.Tensor):
        super().__init__()
        self.w_gate = nn.Parameter(w_gate.detach(), requires_grad=False)
        self.w_up = nn.Parameter(w_up.detach(), requires_grad=False)
        self.w_down = nn.Parameter(w_down.detach(), requires_grad=False)


def init_mlp(cfg: ArchConfig, generator: torch.Generator,
             device=None) -> MLPParams:
    f = cfg.d_ff
    init = lambda shape: common.dense_init(shape, 0, generator=generator,
                                           device=device)
    return MLPParams(init((cfg.d_model, f)), init((cfg.d_model, f)),
                     init((f, cfg.d_model)))


def mlp(cfg: ArchConfig, p: MLPParams, x: torch.Tensor) -> torch.Tensor:
    dt = common.dtype_of(cfg.compute_dtype)
    act = common.activation(cfg.act)
    x = x.to(dt)
    h = act(x @ p.w_gate.to(dt)) * (x @ p.w_up.to(dt))
    return h @ p.w_down.to(dt)


def moe(cfg: ArchConfig, p, x):
    raise NotImplementedError(
        "the Mixture-of-Experts layer is not ported yet: it waits for the "
        "moe_gmm kernel (ROADMAP B6, A15)")
