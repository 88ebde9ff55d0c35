"""Synthetic episode inputs at any slot count and tile count.

The paths' episodes come from a handful of SoCs (T up to 12, 2 to 4
memory tiles), so they leave most of the episode kernel's shapes
unvisited: slots past one warp (a lane holds two), 16 tiles, a single
slot or tile, rings of every fill.  :func:`coverage_case` makes a batch of
episodes at a given ``(T, n_tiles, S)`` from a seed with numpy: the
accelerator profiles of ``SOC_MOTIV_PAR`` with some coherent modes taken
away, footprints across the Table-3 buckets, random tile masks (never
empty), concurrent sets, fresh and valid flags, a decaying epsilon and
alpha with presampled noise, Q-tables with exact ties, per-episode reward
weights and learned flags, and optional fault rows.  The kernel and
:func:`~repro_torch.kernels.soc_step.ref.episode_ref` must agree on them
bitwise, like on the paths' inputs.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import rewards
from repro_torch.kernels.soc_step.ref import StepInputs
from repro_torch.soc.config import SOC_MOTIV_PAR
from repro_torch.soc.memsys import SoCStatic
from repro_torch.soc.vecenv import VecEnv


class Case(NamedTuple):
    static: SoCStatic
    learned: torch.Tensor     # (B,) bool
    weights: rewards.RewardWeights
    qtable0: torch.Tensor     # (B, 243, 4)
    extrema0: torch.Tensor    # (B, 4, n_accs)
    xs: StepInputs            # (B, S, ...)


def coverage_case(T: int, n_tiles: int, S: int, B: int = 4, *,
                  seed: int = 0, faulted: bool = False,
                  device=None) -> Case:
    """``B`` episodes of ``S`` steps over ``T`` slots and ``n_tiles``
    memory tiles (see the module note); every episode learns except the
    last, which follows its presampled modes."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    env = VecEnv(SOC_MOTIV_PAR, seed=1, device="cpu")
    pmat = env.pmat.numpy()
    n_accs = pmat.shape[0]
    masks = env.masks.numpy() & (rng.random((n_accs, 4)) > 0.15)
    masks[:, 0] = True
    static = env.static._replace(n_mem_tiles=float(n_tiles))
    acc = rng.integers(0, n_accs, (B, S))
    tiles = rng.random((B, S, n_tiles)) < 0.5
    tiles[np.arange(B)[:, None], np.arange(S)[None],
          rng.integers(0, n_tiles, (B, S))] = True
    thread = rng.integers(0, T, (B, S))
    others = rng.random((B, S, T)) < 0.6
    others[np.arange(B)[:, None], np.arange(S)[None], thread] = False
    frac = 1.0 - np.arange(S, dtype=f32) / max(S, 1)
    u = lambda *shape: rng.random(shape).astype(f32)
    gumbel = lambda: (-np.log(-np.log(
        np.clip(u(B, S, 4), 1e-7, 1 - 1e-7)))).astype(f32)
    cols = dict(
        acc_id=acc.astype(np.int32),
        footprint=(10.0 ** rng.uniform(2.5, 7.5, (B, S))).astype(f32),
        tiles=tiles, thread=thread.astype(np.int32),
        fresh=rng.random((B, S)) < 0.3, others=others,
        valid=rng.random((B, S)) < 0.8,
        pre_mode=rng.integers(0, 4, (B, S)).astype(np.int32),
        profile=pmat[acc].astype(f32), avail=masks[acc],
        eps=np.broadcast_to(0.5 * frac, (B, S)).astype(f32),
        alpha=np.broadcast_to(0.05 + 0.45 * frac, (B, S)).astype(f32),
        u_explore=u(B, S), g_pick=gumbel(), g_tie=gumbel())
    if faulted:
        hit = lambda p: rng.random((B, S)) < p
        cols.update(
            f_exec=np.where(hit(0.3), rng.uniform(1.5, 3.0, (B, S)),
                            1.0).astype(f32),
            f_ddr=np.where(hit(0.3), rng.uniform(0.2, 0.9, (B, S)),
                           1.0).astype(f32),
            f_llc=np.where(hit(0.3), rng.uniform(0.0, 64.0, (B, S)),
                           0.0).astype(f32),
            f_retry=np.where(hit(0.2), 5000.0, 0.0).astype(f32))
    xs = StepInputs(**{k: torch.as_tensor(np.ascontiguousarray(v),
                                          device=device)
                       for k, v in cols.items()})
    # Q-tables: the initial constant (exact ties) in the first episode,
    # values on a coarse grid (ties between some actions) in the others
    q = np.ones((B, 243, 4), f32)
    q[1:] = rng.integers(0, 8, (B - 1, 243, 4)).astype(f32) / 8.0
    learned = np.ones(B, bool)
    learned[-1] = B == 1
    w = rng.dirichlet(np.ones(3), B).astype(f32)
    weights = rewards.RewardWeights(*(torch.as_tensor(w[:, i],
                                                      device=device)
                                      for i in range(3)))
    extrema0 = rewards.init_reward_state(n_accs, (B,), device).extrema
    return Case(static=static, learned=torch.as_tensor(learned,
                                                       device=device),
                weights=weights, qtable0=torch.as_tensor(q, device=device),
                extrema0=extrema0, xs=xs)
