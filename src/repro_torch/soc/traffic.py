"""Continuous multi-tenant traffic for the serving path — spec + arrivals.

The episodic environment replays a closed schedule of invocations.
Serving (:class:`repro_torch.soc.vecenv.ServeEnv`) opens it: requests
arrive over continuous time, compete for bounded per-accelerator
admission queues and are shed when their deadline cannot be met.  This
module owns the arrival side:

  * :class:`TrafficSpec` holds the offered-traffic contract as float32
    tensors plus its own threefry key (:mod:`repro_torch.random`), so a
    traffic stream draws exactly the variates the reference draws from the
    same key;
  * :func:`sample_arrivals` lowers a spec to one chunk's
    :class:`Arrivals` table in one batched draw (4-way key split: MMPP
    flips, gaps, row picks, tenant gumbels).

Arrival process: a 2-state Markov-modulated Poisson process.  The chain
sits in a calm state (rate ``rate``) or a burst state (``rate *
burst_rate``) and flips with per-arrival probabilities ``p_burst`` / ``p_calm``;
exponential gaps are inverse-CDF transforms of presampled uniforms.
Tenant ``k`` of ``K`` invokes rows from its contiguous slice of the
schedule, with a per-tenant relative deadline (``<= 0`` disables it) and
priority.

The arrival clock is a float32 prefix sum.  The reference computes it
with XLA's CPU cumsum, which is a recursive 16-wide blocked scan, not a
left-to-right sum; :func:`blocked_cumsum` is that scan, so equal gaps
give an equal clock.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import random as prng

# Deadline sentinel: beyond any reachable cycle count, finite so the
# admission compare (start <= deadline) stays ordinary.
NO_DEADLINE = float(np.float32(1e30))
_GAP_SCALE = float(np.float32(1 - 1e-7))
_RATE_FLOOR = float(np.float32(1e-12))
_BLOCK = 16


class TrafficSpec(NamedTuple):
    """One offered-traffic contract (float32 tensors; ``mix``,
    ``deadline`` and ``priority`` are ``(K,)`` per-tenant vectors; ``key``
    a ``(2,)`` port key).  Field meanings follow
    ``repro.soc.traffic.TrafficSpec``."""

    rate: torch.Tensor           # requests / cycle in the calm state
    burst_rate: torch.Tensor     # burst-state rate multiplier
    p_burst: torch.Tensor        # calm -> burst flip probability
    p_calm: torch.Tensor         # burst -> calm flip probability
    mix: torch.Tensor            # (K,) tenant weights
    deadline: torch.Tensor       # (K,) relative deadline cycles (<=0 off)
    priority: torch.Tensor       # (K,) in [0, 1]
    backoff: torch.Tensor        # retry backoff cycles
    overload_frac: torch.Tensor  # watchdog trip level (0 = off)
    pressure_beta: torch.Tensor  # shed-EMA coefficient
    prio_reserve: torch.Tensor   # queue fraction gated by priority
    key: torch.Tensor            # (2,) threefry key

    def to(self, device) -> "TrafficSpec":
        return TrafficSpec(*(v.to(device) for v in self))


def _f32(v, device=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, np.float32), device=device)


def bursty(rate, *, burst_rate=4.0, p_burst=0.05, p_calm=0.25,
           mix=(1.0,), deadline=0.0, priority=1.0, backoff=0.0,
           overload_frac=0.0, pressure_beta=0.05, prio_reserve=0.0,
           key=None, seed: int = 0, device=None) -> TrafficSpec:
    """MMPP-2 bursty multi-tenant traffic; ``mix`` fixes the tenant count
    and scalar ``deadline``/``priority`` broadcast across tenants."""
    mix = _f32(np.atleast_1d(np.asarray(mix, np.float32)), device)
    k = mix.shape[0]
    per_tenant = lambda v: _f32(np.broadcast_to(
        np.asarray(v, np.float32), (k,)).copy(), device)
    return TrafficSpec(
        rate=_f32(rate, device), burst_rate=_f32(burst_rate, device),
        p_burst=_f32(p_burst, device), p_calm=_f32(p_calm, device),
        mix=mix, deadline=per_tenant(deadline),
        priority=per_tenant(priority), backoff=_f32(backoff, device),
        overload_frac=_f32(overload_frac, device),
        pressure_beta=_f32(pressure_beta, device),
        prio_reserve=_f32(prio_reserve, device),
        key=(key if key is not None else prng.PRNGKey(seed)).to(device))


def poisson(rate, *, deadline=0.0, priority=1.0, backoff=0.0,
            overload_frac=0.0, pressure_beta=0.05, prio_reserve=0.0,
            key=None, seed: int = 0, device=None) -> TrafficSpec:
    """Single-tenant Poisson traffic (the degenerate MMPP,
    ``burst_rate=1``)."""
    return bursty(rate, burst_rate=1.0, p_burst=0.0, p_calm=1.0,
                  mix=np.ones(np.shape(deadline) or (1,), np.float32),
                  deadline=deadline, priority=priority, backoff=backoff,
                  overload_frac=overload_frac, pressure_beta=pressure_beta,
                  prio_reserve=prio_reserve, key=key, seed=seed,
                  device=device)


def chunk_key(spec: TrafficSpec, chunk: int) -> TrafficSpec:
    """Chunk ``chunk`` of a long-lived stream: the same contract with the
    chunk folded into the key."""
    return spec._replace(key=prng.fold_in(spec.key, chunk))


class Arrivals(NamedTuple):
    """One chunk's arrival table, ``(n_requests,)`` leaves."""

    t_arr: torch.Tensor     # float32 absolute cycles
    row: torch.Tensor       # int32 schedule row
    tenant: torch.Tensor    # int32
    deadline: torch.Tensor  # float32 absolute latest start
    priority: torch.Tensor  # float32 in [0, 1]
    burst: torch.Tensor     # bool MMPP state


def blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 prefix sum over the last axis in XLA's CPU order:
    left to right inside blocks of 16 (zero-padded), plus each block's
    exclusive offset taken from the same scan of the block totals."""
    n = x.shape[-1]
    if n <= _BLOCK:
        out = x.clone()
        for i in range(1, n):
            out[..., i] = out[..., i - 1] + x[..., i]
        return out
    m = -(-n // _BLOCK)
    pad = torch.zeros((*x.shape[:-1], m * _BLOCK - n), dtype=x.dtype,
                      device=x.device)
    blocks = torch.cat([x, pad], -1).reshape(*x.shape[:-1], m, _BLOCK)
    within = blocks.clone()
    for i in range(1, _BLOCK):
        within[..., i] = within[..., i - 1] + blocks[..., i]
    totals = blocked_cumsum(within[..., -1])
    offsets = torch.cat([torch.zeros_like(totals[..., :1]),
                         totals[..., :-1]], -1)
    out = within + offsets[..., None]
    return out.reshape(*x.shape[:-1], m * _BLOCK)[..., :n]


def _mmpp_states(u: torch.Tensor, p_burst, p_calm) -> torch.Tensor:
    """The MMPP-2 state after each flip (the chain starts calm)."""
    u = u.cpu().numpy()
    pb = np.float32(p_burst.item())
    pc = np.float32(p_calm.item())
    out = np.zeros(u.shape, bool)
    high = False
    for i, ui in enumerate(u):
        high = bool(ui >= pc) if high else bool(ui < pb)
        out[i] = high
    return torch.from_numpy(out)


def sample_arrivals(spec: TrafficSpec, n_requests: int, n_rows: int,
                    t0=0.0) -> Arrivals:
    """Draw ``n_requests`` arrivals over ``n_rows`` schedule rows with the
    clock starting at ``t0`` — the variates
    ``repro.soc.traffic.sample_arrivals`` draws from the same key.  The
    tables land on the key's device."""
    dev = spec.key.device
    f32 = torch.float32
    ks = prng.split(spec.key, 4)
    u_state = prng.uniform(ks[0], (n_requests,))
    u_gap = prng.uniform(ks[1], (n_requests,))
    u_row = prng.uniform(ks[2], (n_requests,))
    g_ten = prng.gumbel(ks[3], (n_requests, spec.mix.shape[0]))

    burst = _mmpp_states(u_state, spec.p_burst, spec.p_calm).to(dev)
    rate_t = spec.rate * torch.where(burst, spec.burst_rate,
                                     torch.ones((), dtype=f32, device=dev))
    gaps = -torch.log1p(-u_gap * _GAP_SCALE)
    gaps = gaps / torch.clamp(rate_t, min=_RATE_FLOOR)
    t_arr = torch.as_tensor(t0, dtype=f32, device=dev) + blocked_cumsum(gaps)

    kk = spec.mix.shape[0]
    logits = torch.log(torch.clamp(spec.mix, min=_RATE_FLOOR))
    scores = logits[None, :] + g_ten
    tenant = torch.zeros((n_requests,), dtype=torch.int64, device=dev)
    best = scores[:, 0]
    for k in range(1, kk):
        better = scores[:, k] > best
        best = torch.where(better, scores[:, k], best)
        tenant = torch.where(better, k, tenant)
    lo = (tenant * n_rows) // kk
    hi = ((tenant + 1) * n_rows) // kk
    span = torch.clamp(hi - lo, min=1)
    row = lo + torch.floor(u_row * span.to(f32)).to(torch.int64)
    row = torch.clamp(row, 0, n_rows - 1)

    dl_rel = spec.deadline[tenant]
    deadline = t_arr + torch.where(dl_rel <= 0.0,
                                   torch.full_like(dl_rel, NO_DEADLINE),
                                   dl_rel)
    priority = torch.clamp(spec.priority[tenant], 0.0, 1.0)
    return Arrivals(t_arr=t_arr, row=row.to(torch.int32),
                    tenant=tenant.to(torch.int32), deadline=deadline,
                    priority=priority, burst=burst)
