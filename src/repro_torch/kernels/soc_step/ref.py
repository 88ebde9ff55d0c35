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
instead of a fresh table).

With a packed MLP (:mod:`repro_torch.soc.nn`: ``wpack``, the per-episode
``qfun`` flags, learning-rate scales and the static layer widths) the
step also builds the network's features, runs its forward and, on
``qfun`` episodes, selects from the network's Q-row instead of the table
row and applies the TD update to the weights instead of the table.  It
composes with fault columns, as the reference's step does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import qlearn, rewards, state as cstate
from repro_torch.core.modes import CoherenceMode
from repro_torch.core.state import CacheGeometry
from repro_torch.ordered import seqsum
from repro_torch.soc import nn as socnn
from repro_torch.soc.faults import StepFault
from repro_torch.soc.memsys import (SoCStatic, invocation_perf_cached,
                                    static_tensors, warmth_after)

# Packed slot-table column layout; tile columns follow.
TBL_MODE, TBL_FP, TBL_WARM, TBL_DRAM, TBL_LLC, TBL_FPT = range(6)
N_TBL_COLS = 6

# Column order of the packed per-step trace row.
YCOLS = ("mode", "state_idx", "action", "exec_time", "offchip", "reward")

# Column order of the packed int input row (see pack_inputs).
ICOLS = ("acc_id", "thread", "fresh", "valid", "pre_mode")

N_STATIC = len(SoCStatic._fields)
# consts row layout: the SoCStatic scalars, then learned, then (x, y, z);
# the MLP variant appends (qfun, mlp_lr).
N_CONSTS = N_STATIC + 4


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
    precomputed decay schedule and the presampled select noise.  The
    optional ``f_*`` columns are a faulted episode's presampled
    :class:`~repro_torch.soc.faults.StepFault` rows; None (the default) is
    the healthy program."""

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
    f_exec: torch.Tensor | None = None    # float32 compute-cost multiplier
    f_ddr: torch.Tensor | None = None     # float32 dram_bw multiplier
    f_llc: torch.Tensor | None = None     # float32 extra LLC load
    f_retry: torch.Tensor | None = None   # float32 retry backoff cycles

    @property
    def faulted(self) -> bool:
        return self.f_exec is not None


def step_slice(xs: StepInputs, i: int) -> StepInputs:
    """Step ``i`` of a ``(B, S, ...)`` StepInputs."""
    return StepInputs(*(None if v is None else v[:, i] for v in xs))


def pack_inputs(xs: StepInputs) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack a StepInputs into the kernel's two rows per step.

    ``xf`` is ``(..., 4 + n_tiles + T + F + 3A [+ 4])`` float32 —
    ``[footprint, eps, alpha, u_explore, tiles, others, profile, avail,
    g_pick, g_tie]`` plus, for a faulted episode, the four fault columns
    ``[f_exec, f_ddr, f_llc, f_retry]`` — and ``xi`` is ``(..., 5)``
    int32 (:data:`ICOLS`); boolean masks ride as exact {0, 1} floats.
    The same layout as ``repro.kernels.soc_step.ref.pack_inputs``."""
    f32, i32 = torch.float32, torch.int32
    cols = [
        torch.stack([xs.footprint.to(f32), xs.eps.to(f32),
                     xs.alpha.to(f32), xs.u_explore.to(f32)], dim=-1),
        xs.tiles.to(f32), xs.others.to(f32), xs.profile.to(f32),
        xs.avail.to(f32), xs.g_pick.to(f32), xs.g_tie.to(f32)]
    if xs.faulted:
        cols.append(torch.stack([xs.f_exec.to(f32), xs.f_ddr.to(f32),
                                 xs.f_llc.to(f32), xs.f_retry.to(f32)],
                                dim=-1))
    xf = torch.cat(cols, dim=-1)
    xi = torch.stack([xs.acc_id.to(i32), xs.thread.to(i32),
                      xs.fresh.to(i32), xs.valid.to(i32),
                      xs.pre_mode.to(i32)], dim=-1)
    return xf.contiguous(), xi.contiguous()


def pack_consts(s: SoCStatic, learned, weights, batch: int,
                device=None, qfun=None, mlp_lr=None) -> torch.Tensor:
    """The kernel's ``(B, 25)`` float32 consts rows: the 21 SoCStatic
    scalars, ``learned``, then the reward weights (x, y, z); with
    ``qfun`` (the MLP variant) ``(B, 27)``, ending in ``[qfun, mlp_lr]``."""
    st = static_tensors(s, batch, device)
    extra = () if qfun is None else (qfun, mlp_lr)
    cols = list(st) + [
        torch.as_tensor(v, device=device).to(torch.float32).expand(batch)
        for v in (learned, weights.x, weights.y, weights.z, *extra)]
    return torch.stack(cols, dim=-1).contiguous()


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
               gated: bool = False, wpack=None, qfun=None, mlp_lr=None,
               mlp_dims=None, mlp_feats: str = "sense", slack=0.0,
               reuse=0.0):
    """One fused sense->select->time->reward->learn step for B episodes.

    ``qtable (B, 243, A)`` and ``tbl (B, T, 6 + n_tiles)`` are updated in
    place; returns ``(rs_new, y)`` with ``y (B, 6)`` the :data:`YCOLS`
    row.  ``s``/``warm_cap``/``learned``/``weights`` leaves are ``(B,)``.
    With ``wpack (B, R, C)`` (and ``qfun``/``mlp_lr (B,)``, ``mlp_dims``,
    ``mlp_feats``) returns ``(rs_new, wpack_new, y)``: ``qfun`` episodes
    select from the network's Q-row, train the network and leave their
    table row bitwise untouched.  ``slack``/``reuse`` (numbers or ``(B,)``)
    are the serving step's deadline-slack and reuse-distance features,
    zero in episodes.
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
    row_sel, learned_eff = row, learned
    if wpack is not None:
        # the network's Q-row goes through the same selection, so
        # non-finite weights fall back to NON_COH like a non-finite row
        feats = socnn.step_features(
            mlp_feats, s, state_idx, footprint=x.footprint, tiles=x.tiles,
            omask=omask, omodes=omodes, ofps=ofps, odram=odram,
            warm_t=warm_t, profile=x.profile, slack=slack, reuse=reuse)
        hs = socnn.forward_layers(wpack, feats, mlp_dims)
        row_sel = torch.where(qfun[:, None], hs[-1], row)
        learned_eff = learned | qfun
    q_action = qlearn.row_select_presampled(
        row_sel, x.eps, qlearn.SelectNoise(
            u_explore=x.u_explore, g_pick=x.g_pick, g_tie=x.g_tie),
        x.avail)
    action = torch.where(learned_eff, q_action, x.pre_mode.to(torch.int32))

    # Degradation safety: a non-finite footprint forces the always-
    # available non-coherent mode, like an unavailable action.
    ok = (torch.gather(x.avail, 1, action.long()[:, None])[:, 0]
          & torch.isfinite(x.footprint))
    mode = torch.where(ok, action, int(CoherenceMode.NON_COH_DMA)).to(
        torch.int32)
    fault = (StepFault(exec_scale=x.f_exec, ddr_scale=x.f_ddr,
                       llc_extra=x.f_llc, retry_cycles=x.f_retry)
             if x.faulted else None)
    m, aux = invocation_perf_cached(
        mode, x.profile, x.footprint, x.tiles, omodes, odram, ollc, ofps,
        otiles, warm_t, s, fault=fault)
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
    if wpack is not None:
        # qfun episodes leave the (placeholder) table row untouched: their
        # alpha follows the network's schedule, so the blend is replaced
        new_qrow = torch.where(qfun[:, None], row, new_qrow)
        wpack = socnn.td_update_from(
            wpack, hs, action, r, x.alpha * mlp_lr, mlp_dims,
            (qfun & x.valid) if gated else qfun)
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
    if wpack is not None:
        return rs_new, wpack, y
    return rs_new, y


def episode_ref(s: SoCStatic, learned, weights, qtable0, extrema0,
                xs: StepInputs, *, ddr_attribution: bool = False,
                gated: bool = False, wpack0=None, qfun=None, mlp_lr=None,
                mlp_dims=None, mlp_feats: str = "sense"):
    """Loop :func:`fused_step` over a batch of whole episodes.

    ``xs`` leaves are ``(B, S, ...)``; ``qtable0 (B, 243, A)``,
    ``extrema0 (B, 4, n_accs)``; ``s`` leaves, ``learned`` and the
    weights are numbers or ``(B,)`` tensors.  Returns ``(qtable_final,
    ys)`` with ``ys`` the ``(B, S)`` per-step ``(mode, state_idx, action,
    exec_cycles, offchip, reward)`` arrays.  Fault columns in ``xs``
    perturb the timing of each step.  With packed MLPs (``wpack0 (B, R,
    C)``, ``qfun`` and ``mlp_lr`` numbers or ``(B,)``, the static
    ``mlp_dims`` and ``mlp_feats``) the weights ride the episode beside
    the Q-table and the return is ``(qtable_final, wpack_final, ys)``."""
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
    kw = {}
    if wpack0 is not None:
        kw = dict(wpack=wpack0.to(f32),
                  qfun=torch.as_tensor(qfun, device=dev).to(
                      torch.bool).expand(b),
                  mlp_lr=torch.as_tensor(mlp_lr, device=dev).to(f32).expand(
                      b), mlp_dims=tuple(mlp_dims), mlp_feats=mlp_feats)
    ys = []
    for i in range(n_steps):
        out = fused_step(st, geom, warm_cap, learned_t, w, qtable, rs, tbl,
                         step_slice(xs, i), ddr_attribution=ddr_attribution,
                         gated=gated, **kw)
        if kw:
            rs, kw["wpack"], y = out
        else:
            rs, y = out
        ys.append(y)
    ys = unpack_ys(torch.stack(ys, dim=1))
    if kw:
        return qtable, kw["wpack"], ys
    return qtable, ys


# --------------------------------------------------------------------------
# Serving: the same fused step driven by an arrival stream.  One step is one
# OFFERED request in arrival order; the carry adds per-accelerator admission
# rings of finish times, the shed-pressure EMA and the in-carry decay
# counter (the overload watchdog may rewind it mid-stream).
# --------------------------------------------------------------------------

# Per-request serving trace columns, appended after YCOLS.  ``executed``
# gates the other columns; ``retries`` is the admitted attempt index, or
# SERVE_MAX_RETRIES + 1 when every attempt was shed; ``depth`` the victim
# accelerator's queue depth at arrival.
SERVE_YCOLS = YCOLS + ("executed", "latency", "retries", "depth",
                       "degraded", "start", "finish")

# Retry budget shared with the fault model of the reference.
SERVE_MAX_RETRIES = 3
_SHED_RETRIES = float(SERVE_MAX_RETRIES + 1)


class ServeParams(NamedTuple):
    """Serving scalars of each stream, ``(B,)`` float32 leaves.  The decay
    schedule is evaluated against the carried counter, which the overload
    watchdog can rewind, so its scalars ride here."""

    eps0: torch.Tensor
    alpha0: torch.Tensor
    decay_steps: torch.Tensor
    reopen_frac: torch.Tensor
    frozen: torch.Tensor          # {0, 1}
    backoff: torch.Tensor         # retry backoff cycles
    overload_frac: torch.Tensor   # shed-EMA trip level (0 disables)
    pressure_beta: torch.Tensor   # shed-EMA coefficient
    prio_reserve: torch.Tensor    # queue fraction reserved by priority


N_SERVE_CONSTS = N_CONSTS + len(ServeParams._fields)


class ServeCarry(NamedTuple):
    """The long-lived serving state of ``B`` streams.

    ``fin`` is each accelerator's ring of admitted finish times
    (``queue_cap`` slots; the queue depth at time t is the count of entries
    > t), ``busy`` the finish time of its last admitted request, ``head``
    the ring cursor.  ``pressure`` is the shed-rate EMA, ``tripped`` its
    {0, 1} latch, ``step`` the decay counter."""

    qtable: torch.Tensor    # (B, 243, A) float32
    extrema: torch.Tensor   # (B, 4, n_accs) float32
    tbl: torch.Tensor       # (B, n_accs, 6 + n_tiles) float32
    busy: torch.Tensor      # (B, n_accs) float32
    fin: torch.Tensor       # (B, n_accs, queue_cap) float32
    head: torch.Tensor      # (B, n_accs) int32
    pressure: torch.Tensor  # (B,) float32
    tripped: torch.Tensor   # (B,) float32
    step: torch.Tensor      # (B,) int32
    # (B, R, C) float32 packed MLP weights of streams served by networks;
    # None for table and fixed serving
    wpack: torch.Tensor | None = None

    def map(self, fn) -> "ServeCarry":
        """``fn`` applied to every tensor leaf (``wpack`` may be None)."""
        return ServeCarry(*(None if v is None else fn(v) for v in self))


def init_serve_carry(qtable0, extrema0, n_accs: int, n_tiles: int,
                     queue_cap: int, step0, wpack0=None) -> ServeCarry:
    """Fresh streams: idle devices, empty rings, no pressure.  Serving
    slots are accelerators, so the slot table has ``n_accs`` rows.
    ``wpack0 (B, R, C)`` joins the carry of MLP-served streams."""
    b = qtable0.shape[0]
    dev = qtable0.device
    f32 = torch.float32
    return ServeCarry(
        qtable=qtable0.to(f32).clone(), extrema=extrema0.to(f32).clone(),
        tbl=init_slot_table(n_accs, n_tiles, b, dev),
        busy=torch.zeros((b, n_accs), dtype=f32, device=dev),
        fin=torch.zeros((b, n_accs, queue_cap), dtype=f32, device=dev),
        head=torch.zeros((b, n_accs), dtype=torch.int32, device=dev),
        pressure=torch.zeros((b,), dtype=f32, device=dev),
        tripped=torch.zeros((b,), dtype=f32, device=dev),
        step=torch.as_tensor(step0, device=dev).to(torch.int32)
        .expand(b).clone(),
        wpack=None if wpack0 is None else wpack0.to(f32).clone())


def _backoff_cycles(backoff, retries: int):
    """Bounded exponential backoff (``2**r - 1`` is exact)."""
    return backoff * float(2.0 ** retries - 1.0)


def serve_step(s: SoCStatic, geom: CacheGeometry, warm_cap, learned,
               weights, sp: ServeParams, carry: ServeCarry, x: StepInputs,
               t_arr, deadline, priority, *,
               ddr_attribution: bool = False, qfun=None, mlp_lr=None,
               mlp_dims=None, mlp_feats: str = "sense"):
    """One offered request of ``B`` streams: admit or shed, then the gated
    fused step.  Same semantics, order and association as
    ``repro.kernels.soc_step.ref.serve_step``.

    A request tries ``SERVE_MAX_RETRIES + 1`` candidates (arrival, then
    backed-off retries); a candidate is admissible when the accelerator's
    queue depth at that time is under its priority-weighted capacity and
    the request would start by its deadline.  The first admissible
    candidate is taken; a shed request leaves every carry untouched.
    Sustained shedding raises ``pressure``; crossing ``overload_frac``
    forces NON_COH and, on the rising edge, rewinds the decay counter to
    the epsilon-reopen point.  ``x``'s thread/fresh/others/valid/eps/alpha
    fields are placeholders the step owns.  Carry tensors are updated in
    place (they are the caller's copies); returns ``(carry, y (B, 13))``.

    A carry with ``wpack`` serves networks (``qfun``/``mlp_lr (B,)``,
    ``mlp_dims``, ``mlp_feats``): overload gates the network as it gates
    the table (``qfun & ~degraded``), the deadline slack at arrival and
    the idle gap since the accelerator's last admitted work feed the
    features, and the trained pack rides the carry.
    """
    f32 = torch.float32
    b = carry.busy.shape[0]
    dev = carry.busy.device
    ar = torch.arange(b, device=dev)
    n_accs = carry.busy.shape[1]
    queue_cap = carry.fin.shape[-1]
    acc = x.acc_id.long()
    busy_a = carry.busy[ar, acc]
    frow = carry.fin[ar, acc]
    degraded = carry.tripped != 0.0
    live = sp.frozen == 0.0

    # ---- admission with bounded retry-with-backoff
    qc = float(queue_cap)
    cap_eff = qc - sp.prio_reserve * qc * (1.0 - priority)
    oks, starts = [], []
    for r in range(SERVE_MAX_RETRIES + 1):
        t_r = t_arr + _backoff_cycles(sp.backoff, r)
        depth_r = (frow > t_r[:, None]).to(f32).sum(-1)
        start_r = torch.maximum(t_r, busy_a)
        oks.append((depth_r < cap_eff) & (start_r <= deadline))
        starts.append(start_r)
    ok = torch.stack(oks, -1)
    executed = ok.any(-1)
    attempt = torch.where(executed, ok.to(torch.int64).argmax(-1), 0)
    start = torch.stack(starts, -1)[ar, attempt]
    retries = torch.where(executed, attempt.to(f32), _SHED_RETRIES)
    depth0 = (frow > t_arr[:, None]).to(f32).sum(-1)

    # ---- decay schedule from the carried counter
    frac = torch.clamp(1.0 - carry.step.to(f32) / sp.decay_steps, 0.0, 1.0)
    eps = torch.where(live, sp.eps0 * frac, 0.0)
    alpha = torch.where(live, sp.alpha0 * frac, 0.0)

    # ---- the gated fused step; overload forces NON_COH through pre_mode
    others = ((carry.busy > start[:, None])
              & (torch.arange(n_accs, device=dev)[None, :] != acc[:, None]))
    si = x._replace(
        thread=x.acc_id, fresh=torch.ones_like(executed), others=others,
        valid=executed, eps=eps, alpha=alpha,
        pre_mode=torch.where(degraded, int(CoherenceMode.NON_COH_DMA),
                             x.pre_mode.to(torch.int32)).to(torch.int32))
    mlp_kw = {}
    if carry.wpack is not None:
        mlp_kw = dict(wpack=carry.wpack, qfun=qfun & ~degraded,
                      mlp_lr=mlp_lr, mlp_dims=mlp_dims, mlp_feats=mlp_feats,
                      slack=deadline - t_arr, reuse=t_arr - busy_a)
    out = fused_step(s, geom, warm_cap, learned & ~degraded, weights,
                     carry.qtable, rewards.RewardState(
                         extrema=carry.extrema), carry.tbl, si,
                     ddr_attribution=ddr_attribution, gated=True, **mlp_kw)
    rs, y = out[0], out[-1]

    # ---- queue / ring bookkeeping
    ex_f = executed.to(f32)
    finish = start + y[:, 3]
    head_a = carry.head[ar, acc]
    slot_hot = ((torch.arange(queue_cap, device=dev)[None, :]
                 == head_a[:, None].long()) & executed[:, None])
    carry.fin[ar, acc] = torch.where(slot_hot, finish[:, None], frow)
    nxt = head_a + 1
    carry.head[ar, acc] = torch.where(
        executed, torch.where(nxt >= queue_cap, 0, nxt), head_a).to(
            torch.int32)
    carry.busy[ar, acc] = torch.where(executed, finish, busy_a)

    # ---- overload watchdog
    pressure = ((1.0 - sp.pressure_beta) * carry.pressure
                + sp.pressure_beta * (1.0 - ex_f))
    over = (sp.overload_frac > 0.0) & (pressure > sp.overload_frac)
    rising = over & (carry.tripped == 0.0)
    reopened = torch.minimum(
        carry.step,
        (sp.decay_steps * (1.0 - sp.reopen_frac)).to(torch.int32))
    step = torch.where(rising & live, reopened, carry.step)
    step = step + (executed & live).to(torch.int32)
    tripped = torch.where(
        over, 1.0,
        torch.where(pressure >= 0.5 * sp.overload_frac, carry.tripped, 0.0))

    y_serve = torch.stack([
        torch.where(executed, y[:, 0], -1.0),
        torch.where(executed, y[:, 1], -1.0),
        torch.where(executed, y[:, 2], -1.0),
        y[:, 3] * ex_f, y[:, 4] * ex_f, y[:, 5] * ex_f,
        ex_f,
        (finish - t_arr) * ex_f,
        retries,
        depth0,
        degraded.to(f32),
        start * ex_f,
        finish * ex_f], dim=-1)
    new_carry = carry._replace(extrema=rs.extrema, pressure=pressure,
                               tripped=tripped, step=step.to(torch.int32),
                               wpack=out[1] if mlp_kw else None)
    return new_carry, y_serve


def serve_params_tensors(sp: ServeParams, batch: int,
                         device=None) -> ServeParams:
    """Each leaf as a ``(batch,)`` float32 tensor."""
    def leaf(v):
        t = torch.as_tensor(v, device=device).to(torch.float32)
        return t.expand(batch).contiguous() if t.dim() == 0 else t
    return ServeParams(*(leaf(v) for v in sp))


def serve_episode_ref(s: SoCStatic, learned, weights, sp: ServeParams,
                      carry0: ServeCarry, xs: StepInputs, t_arr, deadline,
                      priority, *, ddr_attribution: bool = False,
                      qfun=None, mlp_lr=None, mlp_dims=None,
                      mlp_feats: str = "sense"):
    """Loop :func:`serve_step` over ``B`` arrival-stream chunks.

    ``xs`` leaves and ``t_arr``/``deadline``/``priority`` are ``(B, S,
    ...)``; ``s``, ``learned``, the weights and ``sp`` leaves numbers or
    ``(B,)`` tensors.  Returns ``(carry_final, ys (B, S, 13))`` (columns
    :data:`SERVE_YCOLS`); the carry continues into the next chunk.  Fault
    columns in ``xs`` perturb the timing of each request.  A carry with a
    weight pack serves networks (``qfun``, ``mlp_lr`` numbers or ``(B,)``,
    the static ``mlp_dims`` and ``mlp_feats``)."""
    dev = carry0.qtable.device
    b, n_steps = xs.acc_id.shape
    f32 = torch.float32
    st = static_tensors(s, b, dev)
    learned_t = torch.as_tensor(learned, device=dev).to(torch.bool).expand(b)
    w = rewards.RewardWeights(*(
        torch.as_tensor(v, device=dev).to(f32).expand(b) for v in weights))
    spt = serve_params_tensors(sp, b, dev)
    geom, warm_cap = derive_geom(st)
    carry = carry0.map(torch.clone)
    mlp_kw = {}
    if carry.wpack is not None:
        mlp_kw = dict(
            qfun=torch.as_tensor(qfun, device=dev).to(torch.bool).expand(b),
            mlp_lr=torch.as_tensor(mlp_lr, device=dev).to(f32).expand(b),
            mlp_dims=tuple(mlp_dims), mlp_feats=mlp_feats)
    ys = []
    for i in range(n_steps):
        carry, y = serve_step(st, geom, warm_cap, learned_t, w, spt, carry,
                              step_slice(xs, i), t_arr[:, i],
                              deadline[:, i], priority[:, i],
                              ddr_attribution=ddr_attribution, **mlp_kw)
        ys.append(y)
    return carry, torch.stack(ys, dim=1)


def pack_serve_consts(s: SoCStatic, learned, weights, sp: ServeParams,
                      batch: int, device=None, qfun=None,
                      mlp_lr=None) -> torch.Tensor:
    """The serve kernel's ``(B, 34)`` consts rows: :func:`pack_consts`
    followed by the nine :class:`ServeParams` scalars; with ``qfun`` (the
    MLP variant) ``(B, 36)``, ending in ``[qfun, mlp_lr]``."""
    spt = serve_params_tensors(sp, batch, device)
    cols = [pack_consts(s, learned, weights, batch, device),
            torch.stack(list(spt), dim=-1)]
    if qfun is not None:
        cols.append(torch.stack([
            torch.as_tensor(v, device=device).to(torch.float32).expand(batch)
            for v in (qfun, mlp_lr)], dim=-1))
    return torch.cat(cols, dim=-1).contiguous()


def pack_serve_rows(t_arr, deadline, priority) -> torch.Tensor:
    """The serve kernel's ``(B, S, 3)`` float32 request rows ``[t_arr,
    deadline, priority]``."""
    return torch.stack([t_arr, deadline, priority], dim=-1).to(
        torch.float32).contiguous()
