"""RWKV-6 "Finch" blocks (arXiv:2404.05892): attention-free time mixing
with data-dependent per-channel decay, and squared-ReLU channel mixing.

The same semantics as ``repro.models.rwkv6``.  Per head, with state S
(K x V),

    S_t = diag(w_t) S_{t-1} + k_t (x) v_t
    y_t = S_{t-1}^T r_t + (r_t . (u . k_t)) v_t

with w_t = exp(-exp(ww_t)).  Where the reference takes its chunk-parallel
``wkv_chunked`` (a prompt of a multiple of 16 tokens, more than one), the
port calls the scan kernel (``repro_torch.kernels.rwkv6_scan.ops``), from
whatever state the layer carries; decode and other lengths take
:func:`wkv_sequential`, as the reference does.  Both mixes run their
products in float32 against float32 weights, whatever the compute dtype,
and cast the result back to the input's dtype, as the reference does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as shd
from repro_torch.kernels.rwkv6_scan import ops as scan_ops
from repro_torch.models import common

CHUNK = 16
LOGW_MIN = -4.0
_LORA_RANK = 32
_MIX_STREAMS = 5   # r, k, v, w, g

TIME_MIX_FIELDS = ("mix_base", "mix_lora_a", "mix_lora_b", "wr", "wk", "wv",
                   "wg", "w_base", "w_lora_a", "w_lora_b", "u", "ln_w", "wo")
CHANNEL_MIX_FIELDS = ("mix_k", "mix_r", "wk", "wv", "wr")


class TimeMixParams(common.FrozenParams):
    """``mix_base`` (5, D), ``mix_lora_a`` (5, D, R), ``mix_lora_b``
    (5, R, D), ``wr``/``wk``/``wv``/``wg``/``wo`` (D, D), ``w_base`` (D,),
    ``w_lora_a`` (D, R), ``w_lora_b`` (R, D), ``u`` and ``ln_w`` (D,)."""

    FIELDS = TIME_MIX_FIELDS


class ChannelMixParams(common.FrozenParams):
    """``mix_k``, ``mix_r`` (D,), ``wk`` (D, F), ``wv`` (F, D), ``wr``
    (D, D)."""

    FIELDS = CHANNEL_MIX_FIELDS


class RwkvState(NamedTuple):
    """Decode-time per-layer state."""

    tm_shift: torch.Tensor    # (B, D)  last input to time mix
    cm_shift: torch.Tensor    # (B, D)  last input to channel mix
    wkv: torch.Tensor         # (B, H, K, V) recurrence state, float32


def init_time_mix(cfg: ArchConfig, generator: torch.Generator,
                  device=None) -> TimeMixParams:
    d, r = cfg.d_model, _LORA_RANK
    f32 = dict(dtype=torch.float32, device=device)
    dense = lambda shape: common.dense_init(shape, generator=generator,
                                            device=device)
    small = lambda shape: 0.01 * torch.randn(shape, generator=generator,
                                             **f32)
    zeros = lambda shape: torch.zeros(shape, **f32)
    return TimeMixParams(
        torch.rand((_MIX_STREAMS, d), generator=generator, **f32),
        small((_MIX_STREAMS, d, r)), zeros((_MIX_STREAMS, r, d)),
        dense((d, d)), dense((d, d)), dense((d, d)), dense((d, d)),
        torch.full((d,), -0.7, **f32),      # exp(-exp(-0.7)) ~ 0.6
        small((d, r)), zeros((r, d)), zeros((d,)), zeros((d,)),
        dense((d, d)))


def init_channel_mix(cfg: ArchConfig, generator: torch.Generator,
                     device=None) -> ChannelMixParams:
    d, f = cfg.d_model, cfg.d_ff
    dense = lambda shape: common.dense_init(shape, generator=generator,
                                            device=device)
    half = torch.full((d,), 0.5, dtype=torch.float32, device=device)
    return ChannelMixParams(half, half.clone(), dense((d, f)), dense((f, d)),
                            dense((d, d)))


def init_state(cfg: ArchConfig, batch: int, dtype=torch.float32,
               device=None) -> RwkvState:
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    return RwkvState(
        tm_shift=torch.zeros((batch, d), dtype=dtype, device=device),
        cm_shift=torch.zeros((batch, d), dtype=dtype, device=device),
        wkv=torch.zeros((batch, d // hd, hd, hd), dtype=torch.float32,
                        device=device))


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """(B, S, D) -> the previous-token stream, seeded by ``prev`` (B, D)."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _mix(x: torch.Tensor, x_prev: torch.Tensor, p: TimeMixParams):
    """Data-dependent token-shift mixing of the five streams: (5, B, S, D)."""
    delta = x_prev - x
    base = p.mix_base[:, None, None, :]
    lora = torch.einsum("bsd,mdr->mbsr", torch.tanh(x), p.mix_lora_a)
    lora = torch.einsum("mbsr,mrd->mbsd", lora, p.mix_lora_b)
    return x[None] + delta[None] * (base + lora)


def wkv_sequential(r, k, v, logw, u, s0):
    """The recurrence step by step (decode, and prompts the chunked form
    does not take).  r/k/v/logw: (B, H, T, K); u: (H, K); s0: (B, H, K,
    V).  Returns (y (B, H, T, V), s_final).  On DTensors each rank steps
    its own batch rows and heads, as the scan kernel does (DTensor has no
    sharding of the per-step products for the state's placement)."""
    if shd.is_dtensor(r):
        return scan_ops.on_shards(wkv_sequential, r, k, v, logw, u, s0)
    s = s0
    ys = []
    for t in range(r.shape[2]):
        r_t, k_t, v_t = r[:, :, t], k[:, :, t], v[:, :, t]
        y = (torch.einsum("bhk,bhkv->bhv", r_t, s)
             + (r_t * (u[None] * k_t)).sum(-1, keepdim=True) * v_t)
        s = (torch.exp(logw[:, :, t])[..., None] * s
             + k_t[..., None] * v_t[..., None, :])
        ys.append(y)
    return torch.stack(ys, dim=2), s


def time_mix(cfg: ArchConfig, p: TimeMixParams, x: torch.Tensor,
             state: RwkvState | None):
    """RWKV-6's attention substitute.  x: (B, S, D); returns (out in x's
    dtype, the new state or None)."""
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    h = d // hd
    p = p.as_float32()
    x32 = x.to(torch.float32)
    prev = (state.tm_shift.to(torch.float32) if state is not None
            else torch.zeros((b, d), dtype=torch.float32, device=x.device))
    # under a mesh each stream (and its gradient) split by batch alone:
    # DTensor otherwise splits the LoRA's gradient along the sequence,
    # which the weight gradient's product cannot take
    xr, xk, xv, xw, xg = (shd.constrain(t, batch_dim=0)
                          for t in _mix(x32, _token_shift(x32, prev), p))

    # (B, S, H, hd) seen as (B, H, S, hd): the scan reads them in place
    heads = lambda t: shd.whole_heads(t, h).reshape(b, s, h, hd).transpose(
        1, 2)
    r, k, v = heads(xr @ p.wr), heads(xk @ p.wk), heads(xv @ p.wv)
    g = F.silu(xg @ p.wg)
    ww = p.w_base + torch.tanh(xw @ p.w_lora_a) @ p.w_lora_b
    logw = heads(torch.clamp(-torch.exp(ww), min=LOGW_MIN))
    u = p.u.reshape(h, hd)

    s0 = state.wkv if state is not None else None
    if s % CHUNK == 0 and s > 1:
        y, s_fin = scan_ops.rwkv6_scan(r, k, v, logw, u, s0)
    else:
        if s0 is None:
            s0 = torch.zeros((b, h, hd, hd), dtype=torch.float32,
                             device=x.device)
        y, s_fin = wkv_sequential(r, k, v, logw, u, s0)

    y = y.transpose(1, 2)                                # (B, S, H, hd)
    mean = y.mean(dim=-1, keepdim=True)
    var = y.var(dim=-1, keepdim=True, correction=0)
    y = (y - mean) * torch.rsqrt(var + 64e-5)
    y = shd.whole_heads(y.reshape(b, s, d), h) * (1.0 + p.ln_w)
    out = (y * g) @ p.wo
    new_state = None
    if state is not None:
        new_state = state._replace(tm_shift=x32[:, -1, :], wkv=s_fin)
    return out.to(x.dtype), new_state


def channel_mix(cfg: ArchConfig, p: ChannelMixParams, x: torch.Tensor,
                state: RwkvState | None):
    """Squared-ReLU channel mixing.  x: (B, S, D); returns (out in x's
    dtype, the new state or None)."""
    b, s, d = x.shape
    p = p.as_float32()
    x32 = x.to(torch.float32)
    prev = (state.cm_shift.to(torch.float32) if state is not None
            else torch.zeros((b, d), dtype=torch.float32, device=x.device))
    xp = _token_shift(x32, prev)
    xk = x32 + (xp - x32) * p.mix_k
    xr = x32 + (xp - x32) * p.mix_r
    hidden = torch.square(torch.relu(xk @ p.wk)) @ p.wv
    out = torch.sigmoid(xr @ p.wr) * hidden
    new_state = None
    if state is not None:
        new_state = state._replace(cm_shift=x32[:, -1, :])
    return out.to(x.dtype), new_state
