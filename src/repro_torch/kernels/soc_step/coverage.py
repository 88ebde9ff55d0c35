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

:func:`serve_edge_case` does the same for the serve kernel: four arrival
streams, each driving one edge of its admission and watchdog (a full
queue under a priority reserve, every retry failing, deadline misses, an
overload that trips the watchdog and releases it), which the kernel and
:func:`~repro_torch.kernels.soc_step.ref.serve_episode_ref` must agree
on bitwise.  :func:`serve_mlp_edge_case` gives the MLP serve kernel (K2m,
K2m-faulted) five streams of networks and placeholders under a watchdog
that trips and releases, one of them with a non-finite TD delta, at each
network of :data:`SERVE_MLP_NETS`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.core import rewards
from repro_torch.kernels.soc_step import kernel
from repro_torch.kernels.soc_step.ref import (ServeCarry, ServeParams,
                                              StepInputs, init_serve_carry)
from repro_torch.soc import nn as socnn
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


class ServeCase(NamedTuple):
    static: SoCStatic
    learned: torch.Tensor     # (B,) bool
    weights: rewards.RewardWeights
    sp: ServeParams           # (B,) leaves
    carry0: ServeCarry
    xs: StepInputs            # (B, S, ...), others n_accs wide
    t_arr: torch.Tensor       # (B, S)
    deadline: torch.Tensor    # (B, S)
    priority: torch.Tensor    # (B, S)


# the four streams of serve_edge_case
SERVE_EDGES = ("full queue under a priority reserve", "every retry failing",
               "deadline misses", "watchdog trip and release")


def serve_edge_case(S: int = 96, *, queue_cap: int = 2, seed: int = 0,
                    faulted: bool = False, device=None) -> ServeCase:
    """Four streams of ``S`` requests on ``SOC_MOTIV_PAR`` (12
    accelerators, 2 tiles), one edge each (:data:`SERVE_EDGES`), rows from
    :func:`coverage_case`:

    0. a burst (a request every half cycle) into rings of ``queue_cap``
       slots, no backoff, low-priority requests under a reserve of 0.5:
       the queue fills and the reserve halves what a request may use;
    1. requests 3e5 cycles apart (service takes 1e6 to 1e8) with a 4e6
       backoff and no deadline: some are admitted at once, some after one,
       two or three retries, some shed after all four tries;
    2. requests 3e6 cycles apart whose every third deadline lies 1e6
       before the arrival, the others 2e7 after it: the missed ones and
       those that would wait past their deadline are shed;
    3. a burst, then a calm stretch (1e9 cycles apart), then another
       burst, with the watchdog at 0.2 and a fast pressure EMA (0.25):
       shedding trips it (forcing NON_COH and rewinding the decay
       counter of the learning agent), calm releases it, the second burst
       trips it again."""
    b = len(SERVE_EDGES)
    rng = np.random.default_rng(seed + 1)
    f32 = np.float32
    base = coverage_case(12, 2, S, b, seed=seed, faulted=faulted,
                         device=device)
    i = np.arange(S, dtype=f32)
    burst = 100.0 + 0.5 * i
    calm = np.where(i < S // 3, burst,
                    np.where(i < 2 * S // 3, 1e9 * (i - S // 3 + 1),
                             1e9 * (S // 3 + 1) + 0.5 * i))
    t_arr = np.stack([burst, 3e5 * i, 3e6 * i, calm]).astype(f32)
    never = np.full(S, 3e38, f32)
    deadline = np.stack([never, never,
                         t_arr[2] + np.where(i % 3 == 0, -1e6, 2e7),
                         never]).astype(f32)
    priority = np.stack([np.where(i % 2 == 0, 0.25, 1.0),
                         np.ones(S), rng.choice([0.25, 1.0], S),
                         np.ones(S)]).astype(f32)
    num = lambda v: torch.as_tensor(np.asarray(v, f32), device=device)
    sp = ServeParams(
        eps0=num([0.5] * b), alpha0=num([0.2] * b),
        decay_steps=num([float(S)] * b), reopen_frac=num([0.5] * b),
        frozen=num([0.0] * b), backoff=num([0.0, 4e6, 0.0, 0.0]),
        overload_frac=num([0.35, 0.35, 0.35, 0.2]),
        pressure_beta=num([0.05, 0.05, 0.05, 0.25]),
        prio_reserve=num([0.5, 0.0, 0.25, 0.0]))
    xs = base.xs._replace(
        others=torch.zeros((b, S, 12), dtype=torch.bool, device=device))
    carry0 = init_serve_carry(base.qtable0, base.extrema0, 12, 2, queue_cap,
                              torch.zeros(b, dtype=torch.int32,
                                          device=device))
    learned = torch.ones(b, dtype=torch.bool, device=device)
    return ServeCase(static=base.static, learned=learned,
                     weights=base.weights, sp=sp, carry0=carry0, xs=xs,
                     t_arr=num(t_arr), deadline=num(deadline),
                     priority=num(priority))


# the five streams of serve_mlp_edge_case
SERVE_MLP_EDGES = ("a learning network", "its frozen copy",
                   "a Q-table beside a placeholder network",
                   "NON_COH beside a placeholder network",
                   "a learning network whose NON_COH value is +inf (a "
                   "non-finite TD delta on every request it decides)")
# the networks of serve_mlp_edge_case: the paths' (14, 16, 16, 4) sense
# network (K2m keeps its columns in registers), a one-hot 243-input network
# and the widest 4-layer sense network the serve kernel's shared memory
# holds (both in shared memory)
SERVE_MLP_NETS = ("sense", "onehot", "widest")


class ServeMlpCase(NamedTuple):
    case: ServeCase
    qfun: torch.Tensor          # (B,) bool
    mlp: socnn.MLPQState        # the B networks (wpack is carry0's)


def widest_serve_hidden(S: int = 96, queue_cap: int = 2) -> int:
    """The largest w for which a (14, w, w, w, 4) sense network fits the
    serve kernel's shared memory at :func:`serve_mlp_edge_case`'s shapes,
    faulted rows included."""
    n_feat = VecEnv(SOC_MOTIV_PAR, seed=1, device="cpu").pmat.shape[1]
    for w in range(kernel.MAX_WIDTH, 0, -1):
        try:
            kernel.serve_plan(2, n_feat, 4, 243, 12, queue_cap, S,
                              faulted=True,
                              mlp_dims=(socnn.N_SENSE_FEATURES, w, w, w, 4))
            return w
        except ValueError:
            pass
    raise ValueError("no sense network fits")


def serve_mlp_edge_case(net: str = "sense", S: int = 96, *,
                        queue_cap: int = 2, seed: int = 0,
                        faulted: bool = False,
                        device=None) -> ServeMlpCase:
    """Five streams of ``S`` requests on ``SOC_MOTIV_PAR``
    (:data:`SERVE_MLP_EDGES`), rows from :func:`coverage_case`, all facing
    :func:`serve_edge_case`'s fourth arrival pattern (a burst, a calm
    stretch, a second burst) with the watchdog at 0.2 and a fast pressure
    EMA: shedding trips it, which gates every network off (NON_COH) and
    rewinds the learning streams' decay, and the calm releases it.
    ``net`` picks the network of :data:`SERVE_MLP_NETS`; the learning ones
    start from ``init_mlp_qstate`` with their output weights perturbed
    (so the Q-rows are not all ties), the placeholders are
    ``frozen_mlp_qstate``'s, and stream 4's NON_COH bias is +inf: its
    Q-row is never finite, so it takes NON_COH and its delta is +inf."""
    if net not in SERVE_MLP_NETS:
        raise ValueError(f"net must be one of {SERVE_MLP_NETS}")
    b = len(SERVE_MLP_EDGES)
    rng = np.random.default_rng(seed + 2)
    f32 = np.float32
    base = coverage_case(12, 2, S, b, seed=seed, faulted=faulted,
                         device=device)
    i = np.arange(S, dtype=f32)
    t_arr = np.where(i < S // 3, 100.0 + 0.5 * i,
                     np.where(i < 2 * S // 3, 1e9 * (i - S // 3 + 1),
                              1e9 * (S // 3 + 1) + 0.5 * i)).astype(f32)
    num = lambda v: torch.as_tensor(np.asarray(v, f32), device=device)
    rows = lambda v: num(np.tile(np.asarray(v, f32), (b, 1)))
    sp = ServeParams(
        eps0=num([0.5] * b), alpha0=num([0.2] * b),
        decay_steps=num([float(S)] * b), reopen_frac=num([0.5] * b),
        frozen=num([0.0, 1.0, 0.0, 0.0, 0.0]), backoff=num([0.0] * b),
        overload_frac=num([0.2] * b), pressure_beta=num([0.25] * b),
        prio_reserve=num([0.0] * b))
    pre_mode = base.xs.pre_mode.clone()
    pre_mode[3] = 0
    xs = base.xs._replace(
        others=torch.zeros((b, S, 12), dtype=torch.bool, device=device),
        pre_mode=pre_mode)
    cfg = (socnn.MLPConfig() if net == "sense"
           else socnn.MLPConfig(features="onehot") if net == "onehot"
           else socnn.MLPConfig(hidden=(widest_serve_hidden(
               S, queue_cap),) * 3))
    dims = socnn.mlp_dims(cfg)
    learner = socnn.init_mlp_qstate(prng.PRNGKey(seed + 11, device=device),
                                    cfg).wpack[0]
    off = sum(d + 1 for d in dims[:-2])   # the output layer's first row
    learner[off:off + dims[-2], :dims[-1]] = torch.as_tensor(rng.normal(
        0.0, 0.3, (dims[-2], dims[-1])).astype(f32), device=device)
    holder = socnn.frozen_mlp_qstate(cfg, device=device).wpack[0]
    stuck = learner.clone()
    stuck[off + dims[-2], 0] = float("inf")
    wpack = torch.stack([learner, learner, holder, holder, stuck])
    qfun = torch.tensor([True, True, False, False, True], device=device)
    mlp = socnn.MLPQState(
        wpack=wpack,
        lr=torch.where(qfun, torch.tensor(cfg.lr, device=device),
                       torch.tensor(0.0, device=device)).to(torch.float32),
        step=torch.zeros(b, dtype=torch.int32, device=device),
        frozen=torch.tensor([False, True, True, True, False],
                            device=device), cfg=cfg)
    carry0 = init_serve_carry(base.qtable0, base.extrema0, 12, 2, queue_cap,
                              torch.zeros(b, dtype=torch.int32,
                                          device=device), wpack)
    learned = torch.tensor([True, True, True, False, True], device=device)
    case = ServeCase(static=base.static, learned=learned,
                     weights=base.weights, sp=sp, carry0=carry0, xs=xs,
                     t_arr=rows(t_arr), deadline=rows(np.full(S, 3e38)),
                     priority=rows(np.ones(S)))
    return ServeMlpCase(case=case, qfun=qfun, mlp=mlp)
