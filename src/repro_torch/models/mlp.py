"""Feed-forward layers: the gated MLP (SwiGLU / GeGLU) and the
Mixture-of-Experts layer.

The same semantics as ``repro.models.mlp``.  The gated MLP's three
products are plain large matrix products outside any TPU kernel, so they
go to ``torch.matmul``, as the reference leaves them to XLA.  The MoE
layer dispatches per batch row as the reference does: a float32 router,
top-k with renormalised gates, a stable sort of the assignments by
expert, packing into a (B, E, C, D) buffer up to the capacity C (the
rest dropped), the three expert products through the grouped-matmul
kernel (:mod:`repro_torch.kernels.moe_gmm`; the reference runs them as
XLA einsums on the same zero-padded buffer), and a combine that adds
each token's contributions in the reference's order and type.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as shd
from repro_torch.kernels.moe_gmm import ops as gmm_ops
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
    # under a mesh the hidden units over model, and their gradient (a
    # no-op on plain tensors)
    h = shd.constrain(h, batch_dim=0, head_dim=2)
    return h @ p.w_down.to(dt)


class MoEParams(nn.Module):
    """``router`` (D, E), ``w_gate``, ``w_up`` (E, D, F) and ``w_down``
    (E, F, D), E the padded expert count."""

    def __init__(self, router: torch.Tensor, w_gate: torch.Tensor,
                 w_up: torch.Tensor, w_down: torch.Tensor):
        super().__init__()
        self.router = nn.Parameter(router.detach(), requires_grad=False)
        self.w_gate = nn.Parameter(w_gate.detach(), requires_grad=False)
        self.w_up = nn.Parameter(w_up.detach(), requires_grad=False)
        self.w_down = nn.Parameter(w_down.detach(), requires_grad=False)


def init_moe(cfg: ArchConfig, generator: torch.Generator,
             device=None) -> MoEParams:
    e, d, f = cfg.padded_experts, cfg.d_model, cfg.d_ff
    init = lambda shape, axis: common.dense_init(
        shape, axis, generator=generator, device=device)
    return MoEParams(init((d, e), 0), init((e, d, f), 1),
                     init((e, d, f), 1), init((e, f, d), 1))


def moe_capacity(n_tokens: int, n_experts: int, top_k: int,
                 capacity_factor: float = 1.25) -> int:
    """Rows per expert and batch row: ``n_tokens * top_k *
    capacity_factor / n_experts`` rounded up to a multiple of 8, at least
    8 (the reference's rule)."""
    c = int(math.ceil(n_tokens * top_k * capacity_factor / n_experts))
    return max(8, -(-c // 8) * 8)


def combine(contrib: torch.Tensor, sorted_tokens: torch.Tensor,
            n_tokens: int) -> torch.Tensor:
    """The reference's ``out.at[t].add(c)`` per batch row: contrib (B, N,
    D) added into zeros (B, n_tokens, D) at rows ``sorted_tokens`` (B, N),
    one contribution at a time in N's order and in contrib's type (each
    add rounded), where every token appears N / n_tokens times.  In the
    MoE layer N's order is ascending expert id within each token, and in
    bfloat16 a float32 sum rounded once would give other numbers."""
    b, n, d = contrib.shape
    k = n // n_tokens
    at = torch.argsort(sorted_tokens, dim=-1, stable=True).view(
        b, n_tokens, k)
    rows = torch.arange(b, device=contrib.device)[:, None]
    out = torch.zeros((b, n_tokens, d), dtype=contrib.dtype,
                      device=contrib.device)
    for j in range(k):
        out = out + contrib[rows, at[:, :, j]]
    return out


class Routing(NamedTuple):
    """One MoE layer's routing, per batch row: ``probs`` (B, S, E) float32,
    ``expert_ids`` and ``gate_vals`` (B, S, k), the renormalised gates;
    over the (B, S*k) assignments sorted stably by expert: ``order`` (the
    sort), ``sorted_experts``, ``sorted_tokens``, ``pos_in_expert`` and
    ``keep`` (within capacity); ``sizes`` (B, E) int32, the kept rows of
    each group, and ``cap``, the capacity."""
    probs: torch.Tensor
    expert_ids: torch.Tensor
    gate_vals: torch.Tensor
    order: torch.Tensor
    sorted_experts: torch.Tensor
    sorted_tokens: torch.Tensor
    pos_in_expert: torch.Tensor
    keep: torch.Tensor
    sizes: torch.Tensor
    cap: int


def route(cfg: ArchConfig, p: MoEParams, xf: torch.Tensor,
          capacity_factor: float) -> Routing:
    """The router, top-k and the capacity sort of ``xf`` (B, S, D), the
    compute-dtype activations."""
    probs, expert_ids, gate_vals = _router(cfg, p.router, xf)
    return _sort(cfg, probs, expert_ids, gate_vals, capacity_factor)


def _router(cfg: ArchConfig, router: torch.Tensor, xf: torch.Tensor):
    """(probs (B, S, E), expert_ids, gate_vals (B, S, k)): the float32
    router, the padded (dead) experts masked out, top-k and the gates
    renormalised."""
    logits = xf.to(torch.float32) @ router.to(torch.float32)
    if cfg.padded_experts > cfg.n_experts:
        logits[..., cfg.n_experts:] = -1e30
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, cfg.top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return probs, expert_ids, gate_vals


def _sort(cfg: ArchConfig, probs, expert_ids, gate_vals,
          capacity_factor: float) -> Routing:
    """The assignments sorted stably by expert, and the capacity cut."""
    b, s, k = expert_ids.shape
    e = cfg.padded_experts
    dev = expert_ids.device
    flat = expert_ids.reshape(b, s * k)
    order = torch.argsort(flat, dim=-1, stable=True)
    sorted_experts = torch.gather(flat, 1, order)
    experts = torch.arange(e, device=dev).expand(b, e).contiguous()
    group_start = torch.searchsorted(sorted_experts, experts, side="left")
    group_end = torch.searchsorted(sorted_experts, experts, side="right")
    pos_in_expert = (torch.arange(s * k, device=dev)[None, :]
                     - torch.gather(group_start, 1, sorted_experts))
    cap = moe_capacity(s, e, k, capacity_factor)
    sizes = torch.clamp(group_end - group_start, max=cap).to(torch.int32)
    return Routing(probs, expert_ids, gate_vals, order, sorted_experts,
                   order // k, pos_in_expert, pos_in_expert < cap, sizes,
                   cap)


def moe(cfg: ArchConfig, p: MoEParams, x: torch.Tensor,
        capacity_factor: float | None = None):
    """Sort-based grouped MoE with per-batch-row dispatch: x (B, S, D) ->
    ((B, S, D) in the compute dtype, {"aux_loss", "drop_frac"}).  On a
    DTensor (a train step under a mesh) see :func:`_moe_on_mesh`."""
    if capacity_factor is None:
        capacity_factor = cfg.capacity_factor
    if shd.is_dtensor(x):
        return _moe_on_mesh(cfg, p, x, capacity_factor)
    dt = common.dtype_of(cfg.compute_dtype)
    xf = x.to(dt)
    r = route(cfg, p, xf, capacity_factor)
    out = _experts(cfg, r, xf, p.w_gate, p.w_up, p.w_down, 0)
    return out, _aux(cfg, r.probs, _top1(cfg, r.expert_ids),
                     r.keep.to(torch.float32))


def _experts(cfg: ArchConfig, r: Routing, xf: torch.Tensor, w_gate, w_up,
             w_down, first: int) -> torch.Tensor:
    """Dispatch, the expert products of experts ``first .. first + n -
    1`` (the weights' n), and the combine: (B, S, D).  With every expert
    (``first`` 0, n = E) the whole layer's output; with fewer, the share
    of those experts (the others add exact zeros)."""
    dt = common.dtype_of(cfg.compute_dtype)
    act = common.activation(cfg.act)
    b, s, d = xf.shape
    e, k = cfg.padded_experts, cfg.top_k
    n = w_gate.shape[0]
    dev = xf.device
    cap = r.cap

    # the kept assignments into a zeroed (B, E, cap, D) buffer; the
    # dropped ones go to one extra row at the end, sliced away
    rows = torch.arange(b, device=dev)[:, None]
    slot = r.sorted_experts * cap + r.pos_in_expert
    dest = torch.where(r.keep, rows * (e * cap) + slot, b * e * cap)
    buf = torch.zeros((b * e * cap + 1, d), dtype=dt, device=dev)
    buf[dest.reshape(-1)] = xf[rows, r.sorted_tokens].reshape(-1, d)
    grouped = buf[:-1].view(b, e, cap, d)
    sizes = r.sizes
    if n != e:
        grouped = grouped[:, first:first + n].contiguous()
        sizes = sizes[:, first:first + n].contiguous()

    # the expert products, through the grouped-matmul kernel
    w = lambda t: t.to(dt).contiguous()
    h = (act(gmm_ops.moe_gmm(grouped, w(w_gate), sizes))
         * gmm_ops.moe_gmm(grouped, w(w_up), sizes))
    out_g = gmm_ops.moe_gmm(h, w(w_down), sizes)
    if n != e:
        zeros = lambda m: out_g.new_zeros((b, m, cap, d))
        out_g = torch.cat([zeros(first), out_g, zeros(e - first - n)], 1)
    out_g = out_g.view(b, e * cap, d)

    # combine: each kept slot's output times its gate, in token order
    gathered = out_g[rows, torch.clamp(slot, max=e * cap - 1)]
    gathered = torch.where(r.keep[..., None], gathered,
                           torch.zeros((), dtype=dt, device=dev))
    weights = torch.gather(r.gate_vals.reshape(b, s * k), 1, r.order)
    return combine(gathered * weights[..., None].to(dt), r.sorted_tokens, s)


def _top1(cfg: ArchConfig, expert_ids: torch.Tensor) -> torch.Tensor:
    """One-hot (B, S, E) float32 of each token's first expert."""
    return F.one_hot(expert_ids[..., 0], cfg.padded_experts).to(
        torch.float32)


def _aux(cfg: ArchConfig, probs, top1, keep) -> dict:
    """Switch-style load-balancing loss ``E * sum(me * ce)`` (``me`` the
    mean router probability, ``ce`` the share of first choices, both over
    the whole batch) and the dropped share of the assignments."""
    me = probs.mean(dim=(0, 1))
    ce = top1.mean(dim=(0, 1))
    aux_loss = cfg.padded_experts * torch.sum(me * ce)
    drop_frac = 1.0 - keep.mean()
    return {"aux_loss": aux_loss, "drop_frac": drop_frac}


def _moe_on_mesh(cfg: ArchConfig, p: MoEParams, x, capacity_factor: float):
    """The MoE layer on DTensors: each rank routes its batch rows (the
    router replicated) and runs the experts it holds (split over model
    where their count divides, else all of them) through the kernel; the
    experts' shares are summed over model.  The router's top-k, the sort
    and the dispatch's gathers and scatters run on each rank's local rows
    inside ``local_map``, not as DTensor ops.  The load-balancing
    statistics leave it as DTensors, so their means span the whole
    batch."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    dt = common.dtype_of(cfg.compute_dtype)
    xf = x.to(dt)
    rows = shd.kernel_placements(mesh, xf.shape, batch_dim=0)
    rep = (Replicate(),) * mesh.ndim
    e = cfg.padded_experts

    def local_route(xl, router):
        probs, ids, gates = _router(cfg, router, xl)
        r = _sort(cfg, probs, ids, gates, capacity_factor)
        keep = r.keep.to(torch.float32).view(ids.shape)
        return probs, ids, gates, _top1(cfg, ids), keep

    probs, ids, gates, top1, keep = shd.local_call(
        local_route, (xf, p.router), (rows, rep), (rows,) * 5, mesh)

    model = list(mesh.mesh_dim_names).index("model")
    n = mesh.size(model)
    split = n > 1 and e % n == 0
    wp = tuple(Shard(0) if split and i == model else Replicate()
               for i in range(mesh.ndim))
    outp = tuple(Partial() if split and i == model else q
                 for i, q in enumerate(rows))
    first = mesh.get_local_rank(model) * (e // n) if split else 0

    def local_experts(xl, idl, gl, wg, wu, wd):
        r = _sort(cfg, None, idl, gl, capacity_factor)
        return _experts(cfg, r, xl, wg, wu, wd, first)

    out = shd.local_call(local_experts,
                         (xf, ids, gates, p.w_gate, p.w_up, p.w_down),
                         (rows, rows, rows, wp, wp, wp), (outp,), mesh)
    return out, _aux(cfg, probs, top1, keep)
