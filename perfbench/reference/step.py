"""Fused SoC episode step — the plain PyTorch version.

One step of the batched Cohmeleon environment
(:mod:`repro_torch.soc.vecenv`): the whole sense -> select -> time ->
reward -> learn cycle as one pass over a packed ``(T, 6 + n_tiles)`` slot
table and ONE Q-table row, for ``B`` independent episodes at once (the
batch axis is where the JAX package ``vmap``s):

  * the Q-row of the sensed state is gathered once and shared between
    epsilon-greedy selection and the blend/write-back update;
  * the (epsilon, alpha) decay and the select noise arrive precomputed in
    the per-step inputs, so the carry is the Q-table, the reward extrema
    and the slot table;
  * each slot row holds (mode, footprint, warmth, dram demand, llc demand,
    footprint per tile, tile mask), written when that slot's thread
    issues an invocation.

:func:`episode_ref` loops :func:`fused_step` over the S steps of an
episode.  It is the CUDA kernel's oracle (``chip_smoke.py`` holds the
kernel against it on the card) and the CPU path of
:func:`repro_torch.kernels.soc_step.ops.fused_episode`.  Every float
operation follows the kernel's order, so the two round alike.

The Q-table and slot table are updated in place on copies made at the
start of :func:`episode_ref` (one gather/scatter of a row per step
instead of a fresh table).  The port's serving step and its network
agents (its MLP instantiations) have no copy here: no cell of the
benchmark runs them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from perfbench.reference import qlearn, rewards, state as cstate
from perfbench.reference.modes import CoherenceMode
from perfbench.reference.state import CacheGeometry
from perfbench.reference.ordered import seqsum
from perfbench.reference.memsys import (SoCStatic, invocation_perf_cached,
                                    static_tensors, warmth_after)

# Packed slot-table column layout; tile columns follow.
TBL_MODE, TBL_FP, TBL_WARM, TBL_DRAM, TBL_LLC, TBL_FPT = range(6)
N_TBL_COLS = 6

# Column order of the packed per-step trace row.
YCOLS = ("mode", "state_idx", "action", "exec_time", "offchip", "reward")



def tbl_width(n_tiles: int) -> int:
    return N_TBL_COLS + n_tiles


def init_slot_table(n_threads: int, n_tiles: int, batch: int = 1,
                    device=None) -> torch.Tensor:
    """Fresh packed slot tables ``(batch, T, 6 + n_tiles)``: mode=-1
    (never used), warmth=1, rest 0."""
    tbl = torch.zeros((batch, n_threads, tbl_width(n_tiles)),
                      dtype=torch.float32, device=device)
    tbl[..., TBL_MODE] = -1.0
    tbl[..., TBL_WARM] = 1.0
    return tbl


def _neutral_row(tbl: torch.Tensor) -> torch.Tensor:
    """What an inactive slot reads as: mode=-1, every contribution 0."""
    col = torch.arange(tbl.shape[-1], device=tbl.device)
    return torch.where(col == TBL_MODE, -1.0, 0.0).to(torch.float32)


class StepInputs(NamedTuple):
    """Per-step inputs of the fused episode, leaves ``(B, S, ...)``.

    A schedule row, the lowered policy's precomputed mode, the pregathered
    per-accelerator rows (``pmat[acc_id]`` / ``masks[acc_id]``), the
    precomputed decay schedule and the presampled select noise."""

    acc_id: torch.Tensor      # int32
    footprint: torch.Tensor   # float32 bytes
    tiles: torch.Tensor       # (.., n_tiles) bool
    thread: torch.Tensor      # int32
    fresh: torch.Tensor       # bool
    others: torch.Tensor      # (.., T) bool
    valid: torch.Tensor       # bool
    pre_mode: torch.Tensor    # int32 — the PolicySpec mode table row
    profile: torch.Tensor     # (.., F) float32 — pmat[acc_id]
    avail: torch.Tensor       # (.., A) bool — masks[acc_id]
    eps: torch.Tensor         # float32 precomputed epsilon
    alpha: torch.Tensor       # float32 precomputed alpha
    u_explore: torch.Tensor   # float32
    g_pick: torch.Tensor      # (.., A) float32 gumbel
    g_tie: torch.Tensor       # (.., A) float32 gumbel


def step_slice(xs: StepInputs, i: int) -> StepInputs:
    """Step ``i`` of a ``(B, S, ...)`` StepInputs (the program's too: its
    fields are read by name)."""
    return StepInputs(*(getattr(xs, f)[:, i] for f in StepInputs._fields))


def unpack_ys(y: torch.Tensor) -> tuple:
    """Split the ``(..., S, 6)`` trace (:data:`YCOLS`) into typed arrays."""
    i32 = torch.int32
    return (y[..., 0].to(i32), y[..., 1].to(i32), y[..., 2].to(i32),
            y[..., 3], y[..., 4], y[..., 5])


def derive_geom(s: SoCStatic):
    """(cache geometry, warmth capacity) from the static scalar bundle."""
    geom = CacheGeometry(l2_bytes=s.l2_bytes,
                         llc_slice_bytes=s.llc_slice_bytes,
                         n_mem_tiles=s.n_mem_tiles)
    warm_cap = s.llc_slice_bytes * s.n_mem_tiles + s.n_cpus * s.l2_bytes
    return geom, warm_cap


def fused_step(s: SoCStatic, geom: CacheGeometry, warm_cap, learned,
               weights, qtable, rs: rewards.RewardState, tbl,
               x: StepInputs, *, ddr_attribution: bool = False,
               gated: bool = False):
    """One fused sense->select->time->reward->learn step for B episodes.

    ``qtable (B, 243, A)`` and ``tbl (B, T, 6 + n_tiles)`` are updated in
    place; returns ``(rs_new, y)`` with ``y (B, 6)`` the :data:`YCOLS`
    row.  ``s``/``warm_cap``/``learned``/``weights`` leaves are ``(B,)``.
    """
    f32 = torch.float32
    b = tbl.shape[0]
    ar = torch.arange(b, device=tbl.device)
    n_tiles = tbl.shape[-1] - N_TBL_COLS

    omask = x.others & (tbl[..., TBL_MODE] >= 0.0)
    # ONE masked read serves sense, timing and DDR attribution: inactive
    # slots read as the neutral row (mode -1, zero contributions).
    otbl = torch.where(omask[..., None], tbl, _neutral_row(tbl))
    omodes = otbl[..., TBL_MODE]
    ofps = otbl[..., TBL_FP]
    odram = otbl[..., TBL_DRAM]
    ollc = otbl[..., TBL_LLC]
    ofpt = otbl[..., TBL_FPT]
    otiles = otbl[..., N_TBL_COLS:]
    state_idx = cstate.observe(
        active_modes=omodes, active_footprints=ofps, needed_tiles=otiles,
        target_tiles=x.tiles, target_footprint=x.footprint, geom=geom,
        active_fp_per_tile=ofpt)

    thread = x.thread.long()
    self_row = tbl[ar, thread]
    warm_t = torch.where(x.fresh, torch.ones_like(x.footprint),
                         self_row[:, TBL_WARM])

    row = qtable[ar, state_idx.long()]
    q_action = qlearn.row_select_presampled(
        row, x.eps, qlearn.SelectNoise(
            u_explore=x.u_explore, g_pick=x.g_pick, g_tie=x.g_tie),
        x.avail)
    action = torch.where(learned, q_action, x.pre_mode.to(torch.int32))

    # Degradation safety: a non-finite footprint forces the always-
    # available non-coherent mode, like an unavailable action.
    ok = (torch.gather(x.avail, 1, action.long()[:, None])[:, 0]
          & torch.isfinite(x.footprint))
    mode = torch.where(ok, action, int(CoherenceMode.NON_COH_DMA)).to(
        torch.int32)
    m, aux = invocation_perf_cached(
        mode, x.profile, x.footprint, x.tiles, omodes, odram, ollc, ofps,
        otiles, warm_t, s)
    off_reward = m.offchip_accesses
    if ddr_attribution:
        # Prorated per-tile DDR attribution (paper §4.1(4)).
        myt = x.tiles.to(f32)
        n_my = torch.clamp(seqsum(myt, -1), min=1.0)
        o_nt = torch.clamp(seqsum(otiles, -1), min=1.0)
        my_fp_t = (x.footprint / n_my)[:, None] * myt
        o_fp_t = seqsum(ofpt[..., None] * otiles, -2)
        share = my_fp_t / torch.clamp(my_fp_t + o_fp_t, min=1e-9)
        my_bpt = (m.offchip_accesses * s.line / n_my)[:, None] * myt
        o_bpt = seqsum(((odram * m.exec_time[:, None]) / o_nt)[..., None]
                       * otiles, -2)
        off_reward = seqsum(share * (my_bpt + o_bpt), -1) / s.line
    meas = rewards.Measurement(
        exec_time=m.exec_time, comm_cycles=m.comm_cycles,
        total_cycles=m.total_cycles, offchip_accesses=off_reward,
        footprint=x.footprint)
    r, rs_new, _ = rewards.evaluate(rs, x.acc_id, meas, weights)

    new_qrow = qlearn.row_update(row, x.alpha, action, r)
    n_t = torch.clamp(x.tiles.to(torch.int32).sum(-1), min=1).to(f32)
    new_slot = torch.cat([
        torch.stack([mode.to(f32), x.footprint,
                     warmth_after(mode, x.footprint, warm_cap),
                     aux["demand_dram"], aux["demand_llc"],
                     x.footprint / n_t], dim=-1),
        x.tiles.to(f32)], dim=-1)
    if gated:
        v = x.valid
        new_qrow = torch.where(v[:, None], new_qrow, row)
        new_slot = torch.where(v[:, None], new_slot, self_row)
        rs_new = rewards.RewardState(extrema=torch.where(
            v[:, None, None], rs_new.extrema, rs.extrema))
    qtable[ar, state_idx.long()] = new_qrow
    tbl[ar, thread] = new_slot

    y = torch.stack([mode.to(f32), state_idx.to(f32), action.to(f32),
                     m.exec_time, m.offchip_accesses, r], dim=-1)
    return rs_new, y


def episode_ref(s: SoCStatic, learned, weights, qtable0, extrema0,
                xs: StepInputs, *, ddr_attribution: bool = False,
                gated: bool = False):
    """Loop :func:`fused_step` over a batch of whole episodes.

    ``xs`` leaves are ``(B, S, ...)``; ``qtable0 (B, 243, A)``,
    ``extrema0 (B, 4, n_accs)``; ``s`` leaves, ``learned`` and the
    weights are numbers or ``(B,)`` tensors.  Returns ``(qtable_final,
    ys)`` with ``ys`` the ``(B, S)`` per-step ``(mode, state_idx, action,
    exec_cycles, offchip, reward)`` arrays.  Fault columns in ``xs``
    perturb the timing of each step."""
    dev = qtable0.device
    b, n_steps = xs.acc_id.shape
    f32 = torch.float32
    st = static_tensors(s, b, dev)
    learned_t = torch.as_tensor(learned, device=dev).to(torch.bool).expand(b)
    w = rewards.RewardWeights(*(
        torch.as_tensor(v, device=dev).to(f32).expand(b) for v in weights))
    geom, warm_cap = derive_geom(st)
    qtable = qtable0.to(f32).clone()
    rs = rewards.RewardState(extrema=extrema0.to(f32).clone())
    tbl = init_slot_table(xs.others.shape[-1], xs.tiles.shape[-1], b, dev)
    ys = []
    for i in range(n_steps):
        rs, y = fused_step(st, geom, warm_cap, learned_t, w, qtable, rs, tbl,
                           step_slice(xs, i),
                           ddr_attribution=ddr_attribution, gated=gated)
        ys.append(y)
    return qtable, unpack_ys(torch.stack(ys, dim=1))
