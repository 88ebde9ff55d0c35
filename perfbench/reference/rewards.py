"""Cohmeleon reward function (paper §4.2, "Rewards").

For the i-th invocation of accelerator k the paper defines three scaled
measurements::

    exec(k,i) = execution_time / footprint          (scaled execution time)
    comm(k,i) = comm_cycles / total_cycles          (communication ratio)
    mem(k,i)  = offchip_accesses / footprint        (scaled access count)

and three normalized components, each against the per-accelerator
historical extrema::

    R_exec = min_j exec(k,j) / exec(k,i)
    R_comm = min_j comm(k,j) / comm(k,i)
    R_mem  = 1 - (mem(k,i) - min_j mem) / (max_j mem - min_j mem)

The total reward is the tunable convex mix ``x*R_exec + y*R_comm + z*R_mem``.
Every function here takes a leading batch axis on its tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_BIG = float(np.float32(3.4e38))
_EPS = float(np.float32(1e-12))


class RewardWeights(NamedTuple):
    """(x, y, z) weights for (exec, comm, mem); the paper's default
    operating point is 67.5 / 7.5 / 25 percent."""

    x: float = 0.675
    y: float = 0.075
    z: float = 0.25


PAPER_DEFAULT_WEIGHTS = RewardWeights()


def as_weights(w) -> RewardWeights:
    """Coerce an (x, y, z) tuple / RewardWeights into a RewardWeights."""
    if isinstance(w, RewardWeights):
        return w
    x, y, z = w
    return RewardWeights(float(x), float(y), float(z))


def stack_weights(weights, device=None) -> RewardWeights:
    """Stack a sequence of weightings into one RewardWeights with (B,)
    float32 leaves — one agent per weighting in a batched call."""
    ws = [as_weights(w) for w in weights]
    f32 = torch.float32
    return RewardWeights(
        x=torch.tensor([w.x for w in ws], dtype=f32, device=device),
        y=torch.tensor([w.y for w in ws], dtype=f32, device=device),
        z=torch.tensor([w.z for w in ws], dtype=f32, device=device))


class RewardState(NamedTuple):
    """Per-accelerator running extrema, one ``(..., 4, n_accs)`` tensor in
    row order (exec_min, comm_min, mem_min, mem_max)."""

    extrema: torch.Tensor


def init_reward_state(n_accs: int, batch: tuple = (),
                      device=None) -> RewardState:
    ex = torch.full((*batch, 4, n_accs), _BIG, dtype=torch.float32,
                    device=device)
    ex[..., 3, :] = 0.0
    return RewardState(extrema=ex)


class Measurement(NamedTuple):
    """Raw monitor readings for one completed invocation (paper §4.1 (4))."""

    exec_time: torch.Tensor
    comm_cycles: torch.Tensor
    total_cycles: torch.Tensor
    offchip_accesses: torch.Tensor
    footprint: torch.Tensor


def scaled_measurements(m: Measurement):
    fp = torch.clamp(m.footprint, min=1.0)
    exec_s = m.exec_time / fp
    comm_s = m.comm_cycles / torch.clamp(m.total_cycles, min=1.0)
    mem_s = m.offchip_accesses / fp
    return exec_s, comm_s, mem_s


def evaluate(state: RewardState, acc_id: torch.Tensor, m: Measurement,
             weights: RewardWeights = PAPER_DEFAULT_WEIGHTS):
    """Reward and updated extrema for a batch of invocations.

    ``state.extrema`` is ``(B, 4, n_accs)``, ``acc_id`` and every
    measurement and weight leaf ``(B,)``.  Returns ``(reward, new_state,
    (R_exec, R_comm, R_mem))``; the extrema include this invocation, and a
    non-finite measurement leaves them untouched."""
    exec_s, comm_s, mem_s = scaled_measurements(m)
    ex = state.extrema
    idx = acc_id.long()[:, None, None].expand(-1, 4, 1)
    col = torch.gather(ex, 2, idx)[..., 0]                      # (B, 4)
    vals = torch.stack([exec_s, comm_s, mem_s, mem_s], dim=-1)
    is_min = torch.arange(4, device=ex.device) != 3
    new_col = torch.where(is_min, torch.minimum(col, vals),
                          torch.maximum(col, vals))
    new_col = torch.where(torch.isfinite(new_col), new_col, col)

    r_exec = new_col[:, 0] / torch.clamp(exec_s, min=_EPS)
    r_comm = new_col[:, 1] / torch.clamp(comm_s, min=_EPS)
    span = new_col[:, 3] - new_col[:, 2]
    r_mem = torch.where(
        span > _EPS,
        1.0 - (mem_s - new_col[:, 2]) / torch.clamp(span, min=_EPS),
        torch.ones_like(span))
    reward = weights.x * r_exec + weights.y * r_comm + weights.z * r_mem
    new_ex = ex.scatter(2, idx, new_col[..., None])
    return reward, RewardState(extrema=new_ex), (r_exec, r_comm, r_mem)
