"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

The same semantics as ``repro.models.rglru``.  The Real-Gated Linear
Recurrent Unit is a diagonal linear recurrence with input-dependent
gates,

    r_t = sigmoid(W_a x_t + b_a)          (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)          (input gate)
    log a_t = -c * r_t * softplus(Lambda)     (c = 8)
    h_t = a_t . h_{t-1} + sqrt(1 - a_t^2) . (i_t . x_t)

inside Griffin's recurrent block: two branches from the residual stream
(conv1d -> RG-LRU, and a GeLU gate) multiplied and projected back.  Where
the reference's prefill takes ``lax.associative_scan``, the port calls
the scan kernel (``repro_torch.kernels.rglru_scan.ops``), which steps in
order: the float32 sums associate differently, so the two agree to a
rounding, not bitwise.  Decode takes the single step, as the reference
does.  The block computes in float32 against float32 weights, whatever
the compute dtype, and casts its output to the input's dtype, as the
reference does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as shd
from repro_torch.kernels.rglru_scan import ops as scan_ops
from repro_torch.models import common

_C = 8.0

RGLRU_FIELDS = ("w_in", "w_gate", "conv_w", "conv_b", "wa", "ba", "wx", "bx",
                "lam", "w_out")


class RGLRUParams(common.FrozenParams):
    """``w_in``, ``w_gate`` (D, W), ``conv_w`` (K, W) causal conv1d taps,
    ``conv_b`` (W,), ``wa``, ``wx`` (W, W) gate projections, ``ba``,
    ``bx`` (W,), ``lam`` (W,) the decay parameter, ``w_out`` (W, D)."""

    FIELDS = RGLRU_FIELDS


class RGLRUState(NamedTuple):
    """Decode-time per-layer state, float32."""

    conv: torch.Tensor    # (B, K-1, W) last conv inputs
    h: torch.Tensor       # (B, W) recurrence state


def init_rglru(cfg: ArchConfig, generator: torch.Generator,
               device=None) -> RGLRUParams:
    d, w = cfg.d_model, cfg.lru_width or cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    dense = lambda shape, axis=-2: common.dense_init(
        shape, axis, generator=generator, device=device)
    zeros = lambda: torch.zeros((w,), **f32)
    return RGLRUParams(
        dense((d, w)), dense((d, w)), dense((cfg.conv1d_width, w), 0),
        zeros(), dense((w, w)), zeros(), dense((w, w)), zeros(),
        torch.full((w,), -3.0, **f32), dense((w, d)))


def init_state(cfg: ArchConfig, batch: int, device=None) -> RGLRUState:
    """Zeros.  The reference makes ``conv`` in the compute dtype, but its
    prefill returns it in float32 (the conv's input is float32); zeros are
    the same in either type, so the port holds it in float32 throughout."""
    w = cfg.lru_width or cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return RGLRUState(
        conv=torch.zeros((batch, cfg.conv1d_width - 1, w), **f32),
        h=torch.zeros((batch, w), **f32))


def causal_conv1d(u: torch.Tensor, conv_w: torch.Tensor,
                  conv_b: torch.Tensor, prev: torch.Tensor):
    """u: (B, S, W); prev: (B, K-1, W) left context.  Returns (y, the last
    K-1 inputs), the taps summed in order, then the bias."""
    k, s = conv_w.shape[0], u.shape[1]
    ext = torch.cat([prev.to(u.dtype), u], dim=1)     # (B, S+K-1, W)
    y = sum(ext[:, i:i + s] * conv_w[i] for i in range(k))
    return y + conv_b, ext[:, -(k - 1):].clone()


def _gates(p: RGLRUParams, u: torch.Tensor):
    """(log_a, gated input) of (B, S, W) u."""
    # the gates' channels over model under a mesh, as ``u``'s
    split = lambda t: shd.constrain(t, batch_dim=0, head_dim=2)
    r = torch.sigmoid(split(u @ p.wa + p.ba))
    i = torch.sigmoid(split(u @ p.wx + p.bx))
    # jax.nn.softplus's form, logaddexp(lam, 0)
    softplus = torch.logaddexp(p.lam, torch.zeros_like(p.lam))
    log_a = -_C * r * softplus                        # (B, S, W), <= 0
    gated_x = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                     min=1e-12)) * (i * u)
    return log_a, gated_x


def rglru_scan(p: RGLRUParams, u: torch.Tensor, h0: torch.Tensor):
    """The recurrence over a prompt through the scan kernel.  u: (B, S, W)
    float32, h0: (B, W).  Returns (h (B, S, W), h_final)."""
    log_a, b = _gates(p, u)
    return scan_ops.rglru_scan(log_a, b, h0)


def rglru_step(p: RGLRUParams, u: torch.Tensor, h0: torch.Tensor):
    """Single decode step.  u: (B, 1, W)."""
    log_a, b = _gates(p, u)
    h = torch.exp(log_a[:, 0]) * h0 + b[:, 0]
    return h[:, None, :], h


def recurrent_block(cfg: ArchConfig, p: RGLRUParams, x: torch.Tensor,
                    state: RGLRUState | None):
    """Griffin recurrent block.  x: (B, S, D); returns (out in x's dtype,
    the new state or None)."""
    b, s, _ = x.shape
    p = p.as_float32()
    x32 = x.to(torch.float32)
    u = x32 @ p.w_in
    w = u.shape[-1]
    prev = (state.conv if state is not None else
            torch.zeros((b, cfg.conv1d_width - 1, w), dtype=u.dtype,
                        device=x.device))
    u, new_conv = causal_conv1d(u, p.conv_w, p.conv_b, prev)
    # under a mesh the channels over model, and their gradient: DTensor
    # otherwise splits the sequence over model, a split the gates' weight
    # gradients cannot take on a 2 x 16 x 16 mesh (no-ops on plain
    # tensors)
    u = shd.constrain(u, batch_dim=0, head_dim=2)
    h0 = (state.h if state is not None else
          torch.zeros((b, w), dtype=torch.float32, device=x.device))
    step = rglru_step if s == 1 else rglru_scan
    y, h_fin = step(p, u, h0)
    gate = shd.constrain(F.gelu(x32 @ p.w_gate, approximate="tanh"),
                         batch_dim=0, head_dim=2)
    out = (y * gate) @ p.w_out
    new_state = (RGLRUState(conv=new_conv, h=h_fin) if state is not None
                 else None)
    return out.to(x.dtype), new_state
