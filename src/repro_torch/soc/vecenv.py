"""Batched SoC environment — the scale path, episodic half.

An :class:`~repro_torch.soc.des.Application` is lowered once to a static
invocation :class:`Schedule` (:func:`compile_app`, the reference's numpy
RNG protocol, so a seed gives the reference's rows).  Every policy family
lowers into one :class:`PolicySpec` — a per-step mode table, a
``learned`` flag and a (possibly frozen placeholder) Q agent — and one
fused episode consumes any batch of specs: each step senses the Table-3
state, selects (epsilon-greedy Q, or the spec's precomputed mode), times
the invocation, computes the reward and updates the Q-table.  The step
itself is :func:`repro_torch.kernels.soc_step.ops.fused_episode`: the
CUDA kernel for tensors on the card, its plain PyTorch version on the
CPU.  This module owns the episode-level work around it: noise and
decay-schedule precomputation, the profile/mask pregather, visits/step
replay and the per-phase metrics.

Batching is explicit: a :class:`PolicySpec` or :class:`~repro_torch.core.
qlearn.QState` whose leaves carry a leading axis ``N`` runs ``N``
episodes in one kernel launch, where the JAX package ``vmap``s.  A spec
may carry function-approximation agents (:mod:`repro_torch.soc.nn`,
:func:`mlp_policy_spec`), which ride the episode kernel's MLP
instantiation.

:class:`ServeEnv` keeps the SoC always on: requests arrive from a
:class:`~repro_torch.soc.traffic.TrafficSpec`, are admitted to bounded
per-accelerator queues or shed, and run through the serving step
(:func:`repro_torch.kernels.soc_step.ops.fused_serve_episode`).

Every entry point takes ``faults=``, a :class:`~repro_torch.soc.faults.
FaultSpec` whose presampled rows join the step inputs (``None`` is the
healthy program; a zero spec is bitwise the same episode).  Training and
serving have crash-resumable forms that checkpoint through a
:class:`~repro_torch.checkpoint.manager.CheckpointManager`
(:meth:`VecEnv.train_batched_checkpointed`,
:meth:`ServeEnv.serve_checkpointed`).

Concurrency model (the reference's one deliberate approximation): threads
of a phase advance in lockstep *rounds*; thread ``t`` of round ``r`` senses
threads ``< t`` of its own round and threads ``> t`` of round ``r-1``.
Phase wall time is the max over threads of per-thread busy time.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch import resolve_device, xla_math
from repro_torch.core import qlearn, rewards, state as cstate
from repro_torch.core.modes import CoherenceMode, N_MODES
from repro_torch.core.policies import EXTRA_SMALL_THRESHOLD
from repro_torch.kernels.soc_step import ops as soc_step_ops
from repro_torch.kernels.soc_step import ref as soc_step_ref
from repro_torch.kernels.soc_step.ref import StepInputs
from repro_torch.ordered import seqsum
from repro_torch.soc.accelerators import (AccProfile, profile_matrix,
                                          resolve_profiles)
from repro_torch.soc.config import SoCConfig
from repro_torch.soc.des import Application, stripe_tiles
from repro_torch.soc import faults as fault_mod
from repro_torch.soc import nn as socnn
from repro_torch.soc import traffic as traffic_mod
from repro_torch.soc.memsys import (SoCStatic, dma_demand,
                                    invocation_perf_cached, static_tensors,
                                    warmth_after)

_NC = int(CoherenceMode.NON_COH_DMA)


class Schedule(NamedTuple):
    """Static per-step tensors of a compiled application (leading (S,);
    :func:`stack_schedules` adds an iteration axis).  ``valid`` marks real
    rows (all True from :func:`compile_app`)."""

    acc_id: torch.Tensor      # (S,) int32
    footprint: torch.Tensor   # (S,) float32 bytes
    tiles: torch.Tensor       # (S, n_tiles) bool
    thread: torch.Tensor      # (S,) int32
    phase_id: torch.Tensor    # (S,) int32
    fresh: torch.Tensor       # (S,) bool
    others: torch.Tensor      # (S, T) bool
    valid: torch.Tensor       # (S,) bool

    def to(self, device) -> "Schedule":
        return Schedule(*(v.to(device) for v in self))


class LaneParams(NamedTuple):
    """Per-SoC constants the episode reads."""

    pmat: torch.Tensor        # (n_accs, F) accelerator profile matrix
    masks: torch.Tensor       # (n_accs, N_MODES) action availability
    static: SoCStatic         # scalar leaves


@dataclasses.dataclass(frozen=True)
class CompiledApp:
    """An Application lowered to static tensors plus host-side metadata."""

    name: str
    schedule: Schedule
    n_phases: int
    n_threads: int
    n_steps: int
    phase_names: tuple


def compile_app(app: Application, soc: SoCConfig,
                seed: int = 0) -> CompiledApp:
    """Trace ``app`` into a flattened, round-major invocation schedule (CPU
    tensors; the environment moves them to its device).  A thread's looped
    chain is unrolled; round ``r`` holds each thread's ``r``-th
    invocation."""
    rng = np.random.default_rng(seed)
    n_tiles = soc.n_mem_tiles
    max_threads = max((len(ph.threads) for ph in app.phases), default=1)

    rows: list[tuple] = []
    for ph_i, phase in enumerate(app.phases):
        progs = []
        for th in phase.threads:
            seq = []
            for _ in range(th.loops):
                seq.extend(th.chain)
            progs.append(seq)
        n_rounds = max((len(p) for p in progs), default=0)
        started = [False] * len(progs)
        for r in range(n_rounds):
            for t, prog in enumerate(progs):
                if r >= len(prog):
                    continue
                inv = prog[r]
                tiles = stripe_tiles(rng, n_tiles, inv.footprint)
                others = np.zeros(max_threads, bool)
                for j, pj in enumerate(progs):
                    if j == t:
                        continue
                    if j < t:          # already issued round r
                        others[j] = r < len(pj)
                    else:              # still running round r-1
                        others[j] = r >= 1 and (r - 1) < len(pj)
                rows.append((inv.acc_id, inv.footprint, tiles, t, ph_i,
                             not started[t], others))
                started[t] = True

    if not rows:
        raise ValueError(f"application {app.name!r} has no invocations")
    i32 = torch.int32
    sched = Schedule(
        acc_id=torch.tensor([r[0] for r in rows], dtype=i32),
        footprint=torch.tensor(np.asarray([r[1] for r in rows], np.float32)),
        tiles=torch.from_numpy(np.stack([r[2] for r in rows])),
        thread=torch.tensor([r[3] for r in rows], dtype=i32),
        phase_id=torch.tensor([r[4] for r in rows], dtype=i32),
        fresh=torch.tensor([r[5] for r in rows], dtype=torch.bool),
        others=torch.from_numpy(np.stack([r[6] for r in rows])),
        valid=torch.ones((len(rows),), dtype=torch.bool),
    )
    return CompiledApp(
        name=app.name, schedule=sched, n_phases=len(app.phases),
        n_threads=max_threads, n_steps=len(rows),
        phase_names=tuple(ph.name for ph in app.phases))


def stack_schedules(compiled: Sequence[CompiledApp]) -> Schedule:
    """Stack same-shape compiled apps along a leading axis."""
    return Schedule(*(torch.stack(vs) for vs in
                      zip(*[c.schedule for c in compiled])))


class EpisodeResult(NamedTuple):
    """Per-phase metrics plus per-invocation traces of a batch of episodes
    (leaves ``(N, P)`` / ``(N, S)``; single-episode entry points drop the
    leading axis)."""

    phase_time: torch.Tensor     # (..., P) seconds of wall clock
    phase_offchip: torch.Tensor  # (..., P) off-chip line accesses
    mode: torch.Tensor           # (..., S) int32 chosen coherence mode
    state_idx: torch.Tensor      # (..., S) int32 sensed Table-3 state
    exec_time: torch.Tensor      # (..., S) float32 cycles
    offchip: torch.Tensor        # (..., S) float32 line accesses
    reward: torch.Tensor         # (..., S) float32

    def index(self, i: int) -> "EpisodeResult":
        return EpisodeResult(*(v[i] for v in self))


def normalized_metrics(res: EpisodeResult, base: EpisodeResult,
                       phase_mask=None):
    """Per-phase geomean (time, offchip) of ``res`` normalized to a
    baseline episode — the paper's Fixed-NON_COH normalization.  ``res``
    leaves may carry a batch axis; ``base`` broadcasts against it.
    ``phase_mask`` restricts the geomean to the real phases of a lane
    padded to a common phase count.  The logarithm and exponential are
    XLA's CPU ones (``xla_math``): ``torch.log`` and ``torch.exp`` put 15%
    of the geomeans an ulp from the reference's."""
    lt = xla_math.log(torch.clamp(
        res.phase_time / torch.clamp(base.phase_time, min=1e-30),
        min=1e-12))
    lm = xla_math.log(torch.clamp(
        (res.phase_offchip + 1.0)
        / torch.clamp(base.phase_offchip + 1.0, min=1e-30), min=1e-12))
    if phase_mask is None:
        return xla_math.exp(lt.mean(-1)), xla_math.exp(lm.mean(-1))
    w = phase_mask.to(lt.dtype)
    n = torch.clamp(w.sum(-1), min=1.0)
    return (xla_math.exp((lt * w).sum(-1) / n),
            xla_math.exp((lm * w).sum(-1) / n))


def _manual_select(s: SoCStatic, footprint, active_modes, active_fp, avail):
    """Paper Algorithm 1 (mirrors ``policies.ManualPolicy``)."""
    active = active_modes >= 0
    n_cd = (active & (active_modes == int(CoherenceMode.COH_DMA))).sum(-1)
    n_fc = (active & (active_modes == int(CoherenceMode.FULLY_COH))).sum(-1)
    n_nc = (active & (active_modes == _NC)).sum(-1)
    l2 = s.l2_bytes
    llc = s.llc_slice_bytes * s.n_mem_tiles
    FC, CD = int(CoherenceMode.FULLY_COH), int(CoherenceMode.COH_DMA)
    LC = int(CoherenceMode.LLC_COH_DMA)
    t = lambda v: torch.full_like(n_cd, v)
    mode = torch.where(
        footprint <= EXTRA_SMALL_THRESHOLD, t(FC),
        torch.where(
            footprint <= l2,
            torch.where(n_cd > n_fc, t(FC), t(CD)),
            torch.where(footprint + active_fp > llc, t(_NC),
                        torch.where(n_nc >= 2, t(LC), t(CD)))))
    ok = torch.gather(avail, -1, mode[..., None].long())[..., 0]
    return torch.where(ok, mode, t(_NC))


def precompute_manual_modes(params: LaneParams,
                            sched: Schedule) -> torch.Tensor:
    """Replay paper Algorithm 1 against a schedule, off the hot path: the
    manual selection depends only on the concurrent slots' (mode,
    footprint), a deterministic recursion over the static schedule."""
    masks, s = params.masks, params.static
    T = sched.others.shape[-1]
    dev = sched.acc_id.device
    tbl_mode = torch.full((T,), -1, dtype=torch.int64, device=dev)
    tbl_fp = torch.zeros((T,), dtype=torch.float32, device=dev)
    avail_all = masks[sched.acc_id.long()]
    out = []
    for i in range(sched.acc_id.shape[0]):
        avail = avail_all[i]
        omask = sched.others[i] & (tbl_mode >= 0)
        omodes = torch.where(omask, tbl_mode, -1)
        ofps = torch.where(omask, tbl_fp, 0.0)
        fp = sched.footprint[i]
        action = _manual_select(s, fp, omodes, seqsum(ofps, -1), avail)
        mode = torch.where(avail[action], action, _NC)
        valid = sched.valid[i]
        th = sched.thread[i].long()
        tbl_mode[th] = torch.where(valid, mode, tbl_mode[th])
        tbl_fp[th] = torch.where(valid, fp, tbl_fp[th])
        out.append(mode)
    return torch.stack(out).to(torch.int32)


class PolicySpec(NamedTuple):
    """One lowered policy — the single episode currency.

    ``modes`` is the per-step mode table (``(S,)``, ignored when
    ``learned``); ``learned`` a bool tensor selecting epsilon-greedy Q
    actions; ``qstate`` the agent (a batch of one; non-learned specs carry
    a frozen placeholder, whose update is a no-op).  ``qfun``/``mlp`` are
    the function-approximation branch (:mod:`repro_torch.soc.nn`): None on
    table specs; an MLP spec (:func:`mlp_policy_spec`) carries
    ``qfun=True`` and the network, and its episode selects from the
    network's Q-row and trains the network instead of the table.  Table
    specs batched with MLP specs carry a frozen placeholder network with
    ``qfun=False`` (:func:`attach_placeholder_mlp`), which leaves their
    results bitwise unchanged.  :func:`stack_specs` gives leaves a leading
    policy axis ``N``."""

    modes: torch.Tensor
    learned: torch.Tensor
    qstate: qlearn.QState
    qfun: torch.Tensor | None = None
    mlp: object | None = None      # repro_torch.soc.nn.MLPQState


def stack_specs(specs: Sequence[PolicySpec]) -> PolicySpec:
    """Stack unbatched specs along a new leading policy axis (mixed
    families welcome; MLP specs stack with MLP specs or placeholders)."""
    has_mlp = {s.mlp is not None for s in specs}
    if len(has_mlp) != 1:
        raise ValueError("stack MLP specs only with MLP specs or table "
                         "specs given attach_placeholder_mlp")
    mlp = has_mlp.pop()
    return PolicySpec(
        modes=torch.stack([s.modes for s in specs]),
        learned=torch.stack([s.learned.reshape(()) for s in specs]),
        qstate=qlearn.cat_qstates([s.qstate for s in specs]),
        qfun=(torch.stack([s.qfun.reshape(()) for s in specs])
              if mlp else None),
        mlp=socnn.cat_mlps([s.mlp for s in specs]) if mlp else None)


def spec_from_numpy(modes, learned, qtable, visits, step, frozen,
                    device=None) -> PolicySpec:
    """A port PolicySpec from the table fields of a JAX ``PolicySpec``
    (batched — a leading policy axis on every leaf — or not)."""
    modes = torch.as_tensor(np.array(modes, np.int32), device=device)
    learned = torch.as_tensor(np.array(learned, np.bool_), device=device)
    return PolicySpec(modes=modes, learned=learned,
                      qstate=qlearn.qstate_from_numpy(
                          qtable, visits, step, frozen, device))


def mlp_policy_spec(mlp, sched: Schedule) -> PolicySpec:
    """Lower function-approximation agents (:class:`repro_torch.soc.nn.
    MLPQState`; a batch of B gives a batched spec): ``qfun`` set, the table
    slot a frozen placeholder whose row the episode leaves untouched."""
    dev = mlp.wpack.device
    n = mlp.wpack.shape[0]
    lead = () if n == 1 else (n,)
    qs = qlearn.frozen_qstate(device=dev)
    return PolicySpec(
        modes=torch.zeros((*lead, sched.acc_id.shape[-1]),
                          dtype=torch.int32, device=dev),
        learned=torch.zeros(lead, dtype=torch.bool, device=dev),
        qstate=qlearn.QState(*(v.expand(n, *v.shape[1:]) for v in qs)),
        qfun=torch.ones(lead, dtype=torch.bool, device=dev), mlp=mlp)


def attach_placeholder_mlp(spec: PolicySpec, cfg=None) -> PolicySpec:
    """A table spec with the MLP fields, so it batches with MLP specs: a
    frozen zero-rate placeholder network and ``qfun=False``.  Its episode
    is bitwise the bare spec's (selection takes the table row, the TD gate
    is False and the merged decay schedule is the table's)."""
    dev = spec.qstate.qtable.device
    n = spec.qstate.qtable.shape[0]
    ph = socnn.frozen_mlp_qstate(cfg or socnn.MLPConfig(), device=dev)
    return spec._replace(
        qfun=torch.zeros(spec.learned.shape, dtype=torch.bool, device=dev),
        mlp=socnn.expand_mlp(ph, n))


def expand_spec(spec: PolicySpec, n: int) -> PolicySpec:
    """An unbatched spec (a batch of one) repeated as ``n`` policies."""
    one = lambda v: v.expand(n, *v.shape).contiguous()
    return PolicySpec(
        modes=one(spec.modes), learned=one(spec.learned),
        qstate=qlearn.QState(*(v.expand(n, *v.shape[1:]).contiguous()
                               for v in spec.qstate)),
        qfun=None if spec.qfun is None else one(spec.qfun),
        mlp=None if spec.mlp is None else socnn.expand_mlp(spec.mlp, n))


def _mask_modes(masks, acc_id, action):
    avail = masks[acc_id.long()]
    ok = torch.gather(avail, 1, action[:, None].long())[:, 0]
    return torch.where(ok, action, _NC).to(torch.int32)


def fixed_policy_spec(params: LaneParams, sched: Schedule,
                      fixed_modes) -> PolicySpec:
    """Lower a per-accelerator mode assignment (a scalar broadcasts)."""
    dev = params.masks.device
    n_accs = params.masks.shape[0]
    fm = torch.as_tensor(fixed_modes, dtype=torch.int32,
                         device=dev).expand(n_accs)
    acc = sched.acc_id.long()
    return PolicySpec(modes=_mask_modes(params.masks, sched.acc_id, fm[acc]),
                      learned=torch.zeros((), dtype=torch.bool, device=dev),
                      qstate=qlearn.frozen_qstate(device=dev))


def manual_policy_spec(params: LaneParams, sched: Schedule) -> PolicySpec:
    """Lower paper Algorithm 1 into a precomputed per-step mode table."""
    dev = params.masks.device
    return PolicySpec(modes=precompute_manual_modes(params, sched),
                      learned=torch.zeros((), dtype=torch.bool, device=dev),
                      qstate=qlearn.frozen_qstate(device=dev))


def learned_policy_spec(qstate: qlearn.QState,
                        sched: Schedule) -> PolicySpec:
    """Lower a Q agent (the mode table is dead weight — zeros).  A batched
    ``qstate`` gives a batched spec."""
    dev = qstate.qtable.device
    n = qstate.qtable.shape[0]
    lead = () if n == 1 else (n,)
    return PolicySpec(
        modes=torch.zeros((*lead, sched.acc_id.shape[-1]),
                          dtype=torch.int32, device=dev),
        learned=torch.ones(lead, dtype=torch.bool, device=dev),
        qstate=qstate)


def merged_agent(specs: PolicySpec):
    """``(step0, frozen)`` of the agents that drive a batched spec's decay
    schedule: an MLP spec's network where ``qfun`` holds, else the
    table's (bitwise the table's for placeholder networks)."""
    qs = specs.qstate
    if specs.mlp is None:
        return qs.step, qs.frozen
    qfun = specs.qfun.expand(qs.step.shape[0])
    return (torch.where(qfun, specs.mlp.step, qs.step),
            torch.where(qfun, specs.mlp.frozen, qs.frozen))


def _batched(spec: PolicySpec) -> PolicySpec:
    """A spec with a leading policy axis (single specs gain one)."""
    if spec.learned.dim() == 0:
        return spec._replace(
            modes=spec.modes[None], learned=spec.learned[None],
            qfun=None if spec.qfun is None else spec.qfun[None])
    return spec


def _fault_columns(faults, acc_id, n: int) -> dict:
    """The ``f_*`` StepInputs columns of ``faults`` over an ``(S,)``
    accelerator column, the same rows for each of ``n`` episodes (one
    spec perturbs every policy of a batch alike); empty for ``None``."""
    if faults is None:
        return {}
    fr = fault_mod.sample_fault_arrays(faults, acc_id)
    ex = lambda v: v.expand(n, *v.shape)
    return dict(f_exec=ex(fr.exec_scale), f_ddr=ex(fr.ddr_scale),
                f_llc=ex(fr.llc_extra), f_retry=ex(fr.retry_cycles))


def episode_inputs(params: LaneParams, sched: Schedule, specs: PolicySpec,
                   cfg: qlearn.QConfig, keys, *, gated: bool = False,
                   faults=None):
    """The fused step's per-step inputs for ``N`` episodes of a batched
    spec: ``(StepInputs (N, S, ...), inc (N, S))``, ``inc`` being the
    decay-counter increments the episode applies.  ``faults`` adds the
    spec's presampled fault rows over the schedule's (padded) length.
    An MLP spec's schedule is the merged one: the live agent's (the
    network's where ``qfun``, else the table's) counter and frozen flag
    drive the decay."""
    qs0 = specs.qstate
    pmat, masks = params.pmat, params.masks
    n = qs0.qtable.shape[0]
    n_steps = sched.acc_id.shape[0]
    # Same one-call noise protocol as the reference: identical key
    # consumption, so a key draws the reference's variates.
    noise = qlearn.sample_select_noise(keys, (n_steps,), masks.shape[-1])
    live = (sched.valid if gated
            else torch.ones_like(sched.valid))[None, :]
    step0, frozen = merged_agent(specs)
    inc = (live & ~frozen[:, None]).to(torch.int32)
    eps_t, alpha_t = qlearn.decay_arrays(cfg, step0, frozen, inc)
    acc = sched.acc_id.long()
    ex = lambda v: v.expand(n, *v.shape)
    xs = StepInputs(
        acc_id=ex(sched.acc_id), footprint=ex(sched.footprint),
        tiles=ex(sched.tiles), thread=ex(sched.thread),
        fresh=ex(sched.fresh), others=ex(sched.others),
        valid=ex(sched.valid), pre_mode=specs.modes.expand(n, n_steps),
        profile=ex(pmat[acc]), avail=ex(masks[acc]), eps=eps_t,
        alpha=alpha_t, u_explore=noise.u_explore, g_pick=noise.g_pick,
        g_tie=noise.g_tie, **_fault_columns(faults, sched.acc_id, n))
    return xs, inc


def phase_segments(sched: Schedule, n_phases: int,
                   n_threads: int) -> torch.Tensor:
    """The gather index of an episode's per-phase sums, built on the host
    from the schedule before the launch: ``(P*T + P, L)`` int64 on the
    schedule's device.  Row ``p*T + t`` lists the valid rows of thread
    ``t`` in phase ``p``; row ``P*T + p`` lists those of phase ``p``,
    offset by ``S`` (the off-chip half of :func:`phase_metrics`'s
    ``[secs | offchip | 0]`` rows); each row keeps row order and is padded
    with ``2S``, the zero column."""
    T, P = n_threads, n_phases
    phase = sched.phase_id.cpu().numpy().astype(np.int64)
    real = np.nonzero(sched.valid.cpu().numpy())[0]
    n_steps = phase.shape[0]
    slot = np.concatenate([
        phase[real] * T + sched.thread.cpu().numpy()[real],
        P * T + phase[real]])
    src = np.concatenate([real, n_steps + real])
    order = np.argsort(slot, kind="stable")
    slot, src = slot[order], src[order]
    counts = np.bincount(slot, minlength=P * T + P)
    first = np.cumsum(counts) - counts
    idx = np.full((P * T + P, max(int(counts.max(initial=0)), 1)),
                  2 * n_steps, np.int64)
    idx[slot, np.arange(slot.shape[0]) - first[slot]] = src
    return torch.from_numpy(idx).to(sched.valid.device)


def phase_metrics(exec_c, off, segments, *, n_phases: int, n_threads: int,
                  cycle_time: float):
    """``(phase_time (N, P), phase_offchip (N, P))`` of ``N`` episodes'
    ``(N, S)`` exec and off-chip traces; ``segments`` is a schedule's
    :func:`phase_segments`, or ``(N, P*T + P, L)`` of them for episodes on
    several schedules.

    Per-phase wall clock is the max over threads of per-thread busy time.
    Each sum runs left to right over its rows, as the reference's
    scatter-add does (CUDA's ``index_add_`` adds with atomics in no fixed
    order), on the device: one gather and ``L - 1`` adds, no round trip to
    the host."""
    T, P = n_threads, n_phases
    n = exec_c.shape[0]
    rows = torch.cat([exec_c * cycle_time, off,
                      torch.zeros((n, 1), dtype=off.dtype,
                                  device=off.device)], dim=1)
    g, length = segments.shape[-2:]
    idx = segments.expand(n, g, length).reshape(n, g * length)
    sums = seqsum(rows.gather(1, idx).reshape(n, g, length), dim=-1)
    return sums[:, :P * T].reshape(n, P, T).amax(-1), sums[:, P * T:]


def episode_tail(qs0: qlearn.QState, qtable, ys, inc, phases):
    """The post-kernel half of ``N`` episodes: the visits/step replay and
    the result, with ``phases`` from :func:`phase_metrics`.  Returns
    ``(QState (N), EpisodeResult (N, ...))``."""
    mode, state_idx, action, exec_c, off, rew = ys
    qs_final = qlearn.replay_visits(qs0, qtable, state_idx, action, inc)
    res = EpisodeResult(phase_time=phases[0], phase_offchip=phases[1],
                        mode=mode, state_idx=state_idx, exec_time=exec_c,
                        offchip=off, reward=rew)
    return qs_final, res


def run_episodes(params: LaneParams, sched: Schedule, specs: PolicySpec,
                 cfg: qlearn.QConfig, weights: rewards.RewardWeights, keys,
                 *, n_phases: int, n_threads: int, cycle_time: float,
                 gated: bool = False, ddr_attribution: bool = False,
                 faults=None, debug_finite: bool = False):
    """``N`` fused episodes of a batched spec on one schedule, ONE kernel
    launch.  ``weights`` leaves are ``(N,)`` or numbers, ``keys (N, 2)``;
    ``faults`` perturbs every episode alike.  ``debug_finite`` raises
    ``FloatingPointError`` on a non-finite reward or trained Q-table.
    Returns ``(QState (N), EpisodeResult (N, ...))``; an MLP spec returns
    ``((QState (N), MLPQState (N)), EpisodeResult (N, ...))``, each agent
    family's counter advanced only where it drove the episode."""
    specs = _batched(specs)
    qs0 = specs.qstate
    mlp = specs.mlp
    n = qs0.qtable.shape[0]
    dev = params.pmat.device
    xs, inc = episode_inputs(params, sched, specs, cfg, keys, gated=gated,
                             faults=faults)
    extrema0 = rewards.init_reward_state(params.pmat.shape[0], (n,),
                                         dev).extrema
    segments = phase_segments(sched, n_phases, n_threads)
    out = soc_step_ops.fused_episode(
        params.static, specs.learned.expand(n), weights, qs0.qtable,
        extrema0, xs, ddr_attribution=ddr_attribution, gated=gated,
        qfun=None if mlp is None else specs.qfun.expand(n), mlp=mlp)
    qtable, ys = out[0], out[-1]
    if debug_finite:
        qlearn.debug_finite_check("vecenv.episode", reward=ys[5],
                                  qtable=qtable)
    phases = phase_metrics(ys[3], ys[4], segments, n_phases=n_phases,
                           n_threads=n_threads, cycle_time=cycle_time)
    if mlp is None:
        return episode_tail(qs0, qtable, ys, inc, phases)
    mlp_inc = torch.where(specs.qfun.expand(n)[:, None], inc, 0)
    qs, res = episode_tail(qs0, qtable, ys, inc - mlp_inc, phases)
    return (qs, mlp._replace(wpack=out[1], step=mlp.step + mlp_inc.sum(
        -1, dtype=torch.int32))), res


def _decayed(cfg: qlearn.QConfig, step, frozen):
    """``(eps, alpha)`` ``(N,)`` at the carried counters ``step (N,)``,
    the arithmetic :func:`~repro_torch.core.qlearn.decay_arrays` uses (the
    episode passes ``cfg`` as an argument, so it divides)."""
    zero = torch.zeros((step.shape[0], 1), dtype=torch.int32,
                       device=step.device)
    eps, alpha = qlearn.decay_arrays(cfg, step, frozen, zero)
    return eps[:, 0], alpha[:, 0]


def run_episodes_unfused(params: LaneParams, sched: Schedule,
                         specs: PolicySpec, cfg: qlearn.QConfig, weights,
                         keys, *, n_phases: int, n_threads: int,
                         cycle_time: float, demand_cache: bool = True,
                         presample_noise: bool = True, gated: bool = False,
                         ddr_attribution: bool = False, faults=None,
                         debug_finite: bool = False):
    """``N`` episodes of a batched spec through the unfused step: plain
    PyTorch ops step by step, the reference's pre-kernel scan.  Same
    arguments and results as :func:`run_episodes`, which it equals
    bitwise with ``demand_cache`` and ``presample_noise``.

    The step senses, selects with the epsilon and alpha decayed from the
    carried counter, times, rewards and then updates the Q-table and
    visits (select and update apart, the decay in the loop).
    ``demand_cache=False`` recomputes every concurrent slot's demand from
    its profile row each step instead of caching it in the slot table;
    ``presample_noise=False`` splits each agent's key every step and draws
    the select noise from the split (``select``'s protocol) instead of
    presampling the episode's noise from the key."""
    if ddr_attribution and not demand_cache:
        raise ValueError("ddr_attribution requires the demand_cache step")
    specs = _batched(specs)
    qs0, mlp = specs.qstate, specs.mlp
    if mlp is not None and not (demand_cache and presample_noise):
        raise ValueError(
            "MLP PolicySpecs require the demand_cache + presample_noise "
            "fast path (the sense features read the cached per-slot "
            "demand)")
    pmat, masks = params.pmat, params.masks
    dev = pmat.device
    n = qs0.qtable.shape[0]
    n_steps, T = sched.others.shape
    n_tiles = sched.tiles.shape[-1]
    f32, i32 = torch.float32, torch.int32
    ar = torch.arange(n, device=dev)
    s = static_tensors(params.static, n, dev)
    geom, warm_cap = soc_step_ref.derive_geom(s)
    w = rewards.RewardWeights(*(torch.as_tensor(v, device=dev).to(
        f32).expand(n) for v in weights))
    learned = specs.learned.expand(n)
    keys = keys.to(dev)
    noise = (qlearn.sample_select_noise(keys, (n_steps,), masks.shape[-1])
             if presample_noise else None)
    frows = (None if faults is None
             else fault_mod.sample_fault_arrays(faults, sched.acc_id))
    if mlp is not None:
        dims = socnn.mlp_dims(mlp.cfg)
        qfun = specs.qfun.expand(n)
        frozen_m = torch.where(qfun, mlp.frozen, qs0.frozen)
        mstep = torch.where(qfun, mlp.step, qs0.step)
        wpack = mlp.wpack.to(f32)
        lr = mlp.lr.to(f32).expand(n)

    qtable = qs0.qtable.to(f32).clone()
    visits = qs0.visits.clone()
    step = qs0.step.clone()
    extrema = rewards.init_reward_state(pmat.shape[0], (n,), dev).extrema
    tbl_mode = torch.full((n, T), -1, dtype=i32, device=dev)
    tbl_acc = torch.full((n, T), -1, dtype=i32, device=dev)
    tbl_fp = torch.zeros((n, T), dtype=f32, device=dev)
    tbl_tiles = torch.zeros((n, T, n_tiles), dtype=torch.bool, device=dev)
    tbl_warm = torch.ones((n, T), dtype=f32, device=dev)
    tbl_dram = torch.zeros((n, T), dtype=f32, device=dev)
    tbl_llc = torch.zeros((n, T), dtype=f32, device=dev)
    tbl_fpt = torch.zeros((n, T), dtype=f32, device=dev)
    ys = []
    for i in range(n_steps):
        acc = sched.acc_id[i].long().expand(n)
        fp = sched.footprint[i].expand(n)
        tiles = sched.tiles[i].expand(n, n_tiles)
        thread = sched.thread[i].long()
        valid = sched.valid[i].expand(n)
        profile, avail = pmat[acc], masks[acc]

        # ---- sense: the concurrent slots this thread sees
        omask = sched.others[i][None, :] & (tbl_mode >= 0)
        omodes = torch.where(omask, tbl_mode, -1)
        ofps = torch.where(omask, tbl_fp, 0.0)
        otiles = tbl_tiles & omask[..., None]
        if demand_cache:
            ofpt = torch.where(omask, tbl_fpt, 0.0)
            odram = torch.where(omask, tbl_dram, 0.0)
            ollc = torch.where(omask, tbl_llc, 0.0)
        else:
            ofpt = None
        state_idx = cstate.observe(
            active_modes=omodes, active_footprints=ofps,
            needed_tiles=otiles, target_tiles=tiles, target_footprint=fp,
            geom=geom, active_fp_per_tile=ofpt)
        warm_t = torch.where(sched.fresh[i], torch.ones_like(fp),
                             tbl_warm[:, thread])

        # ---- select: epsilon-greedy Q vs the spec's precomputed mode
        if presample_noise:
            nz = qlearn.SelectNoise(*(v[:, i] for v in noise))
        else:
            ks = prng.split(keys)
            keys, nz = ks[:, 0], qlearn.key_noise(ks[:, 1], masks.shape[-1])
        eps, alpha = _decayed(cfg, step, qs0.frozen)
        row = qtable[ar, state_idx.long()]
        row_sel, learned_eff = row, learned
        if mlp is not None:
            feats = socnn.step_features(
                mlp.cfg.features, s, state_idx, footprint=fp, tiles=tiles,
                omask=omask, omodes=omodes, ofps=ofps, odram=odram,
                warm_t=warm_t, profile=profile, slack=0.0, reuse=0.0)
            hs = socnn.forward_layers(wpack, feats, dims)
            row_sel = torch.where(qfun[:, None], hs[-1], row)
            eps, alpha_m = _decayed(cfg, mstep, frozen_m)
            learned_eff = learned | qfun
        q_action = qlearn.row_select_presampled(row_sel, eps, nz, avail)
        action = torch.where(learned_eff, q_action,
                             specs.modes[:, i].expand(n)).to(i32)

        # ---- time and reward the actuated mode
        ok = (torch.gather(avail, 1, action.long()[:, None])[:, 0]
              & torch.isfinite(fp))
        mode = torch.where(ok, action, _NC).to(i32)
        fault = (None if frows is None else fault_mod.StepFault(
            *(v[i].expand(n) for v in frows)))
        if demand_cache:
            m, aux = invocation_perf_cached(
                mode, profile, fp, tiles, omodes, odram, ollc, ofps, otiles,
                warm_t, s, fault=fault)
        else:
            oprof = torch.where(omask[..., None],
                                pmat[torch.clamp(tbl_acc, min=0).long()],
                                0.0)
            st = SoCStatic(*(v[..., None] if torch.is_tensor(v) else v
                             for v in s))
            od_dram, od_llc = dma_demand(omodes, oprof, ofps, st)
            m, aux = invocation_perf_cached(
                mode, profile, fp, tiles, omodes, od_dram, od_llc, ofps,
                otiles, warm_t, s, fault=fault)
        off_reward = m.offchip_accesses
        if ddr_attribution:
            myt = tiles.to(f32)
            n_my = torch.clamp(seqsum(myt, -1), min=1.0)
            ot = otiles.to(f32)
            o_nt = torch.clamp(seqsum(ot, -1), min=1.0)
            my_fp_t = (fp / n_my)[:, None] * myt
            o_fp_t = seqsum(ofpt[..., None] * ot, -2)
            share = my_fp_t / torch.clamp(my_fp_t + o_fp_t, min=1e-9)
            my_bpt = (m.offchip_accesses * s.line / n_my)[:, None] * myt
            o_bpt = seqsum(((odram * m.exec_time[:, None]) / o_nt)[..., None]
                           * ot, -2)
            off_reward = seqsum(share * (my_bpt + o_bpt), -1) / s.line
        meas = rewards.Measurement(
            exec_time=m.exec_time, comm_cycles=m.comm_cycles,
            total_cycles=m.total_cycles, offchip_accesses=off_reward,
            footprint=fp)
        r, rs_new, _ = rewards.evaluate(rewards.RewardState(extrema), acc,
                                        meas, w)

        # ---- learn: the table row (a no-op for frozen and placeholder
        # agents) and, for qfun specs, the network
        keep = valid if gated else torch.ones_like(valid)
        new_row = qlearn.row_update(row, alpha, action, r)
        if mlp is not None:
            new_row = torch.where(qfun[:, None], row, new_row)
            wpack = socnn.td_update_from(
                wpack, hs, action, r, alpha_m * lr, dims,
                (qfun & valid) if gated else qfun)
            mstep = mstep + (keep & ~frozen_m).to(i32)
        inc = (keep & ~qs0.frozen).to(i32)
        if mlp is not None:
            inc = torch.where(qfun, 0, inc)
        sidx = state_idx.long()
        qtable[ar, sidx] = torch.where(keep[:, None], new_row, row)
        hot = (torch.arange(visits.shape[-1], device=dev)[None, :]
               == action[:, None]).to(i32)
        visits[ar, sidx] = visits[ar, sidx] + hot * inc[:, None]
        step = step + inc
        extrema = torch.where(keep[:, None, None], rs_new.extrema, extrema)

        # ---- bookkeeping: this thread's slot (and its cached demand)
        new = dict(mode=mode, acc=acc.to(i32), fp=fp,
                   warm=warmth_after(mode, fp, warm_cap),
                   dram=aux["demand_dram"], llc=aux["demand_llc"],
                   fpt=fp / torch.clamp(tiles.to(i32).sum(-1),
                                        min=1).to(f32))
        for name, tbl in (("mode", tbl_mode), ("acc", tbl_acc),
                          ("fp", tbl_fp), ("warm", tbl_warm),
                          ("dram", tbl_dram), ("llc", tbl_llc),
                          ("fpt", tbl_fpt)):
            tbl[:, thread] = torch.where(keep, new[name], tbl[:, thread])
        tbl_tiles[:, thread] = torch.where(keep[:, None], tiles,
                                           tbl_tiles[:, thread])
        ys.append((mode, state_idx.to(i32), m.exec_time,
                   m.offchip_accesses, r))

    mode, state_idx, exec_c, off, rew = (torch.stack(v, -1)
                                         for v in zip(*ys))
    qs = qlearn.QState(qtable=qtable, visits=visits, step=step,
                       frozen=qs0.frozen)
    if debug_finite:
        qlearn.debug_finite_check("vecenv.episode", reward=rew,
                                  qtable=qtable)
    segments = phase_segments(sched, n_phases, n_threads)
    phases = phase_metrics(exec_c, off, segments, n_phases=n_phases,
                           n_threads=n_threads, cycle_time=cycle_time)
    res = EpisodeResult(phase_time=phases[0], phase_offchip=phases[1],
                        mode=mode, state_idx=state_idx, exec_time=exec_c,
                        offchip=off, reward=rew)
    if mlp is None:
        return qs, res
    return (qs, mlp._replace(wpack=wpack, step=torch.where(
        qfun, mstep, mlp.step))), res


class TrainCarry(NamedTuple):
    """Cross-iteration training state beyond the Q-state: the main key
    stream (split 3 ways per iteration), the iteration index (folded into
    a fault spec's own key, so each iteration draws fresh drop coins) and
    the running best mean episode reward (reward-collapse watchdog).  It
    crosses checkpoints unchanged."""

    key: torch.Tensor    # (B, 2)
    it: int
    best: torch.Tensor   # (B,) float32


def init_train_carry(keys) -> TrainCarry:
    return TrainCarry(key=keys, it=0,
                      best=torch.full((keys.shape[0],), -float("inf"),
                                      dtype=torch.float32,
                                      device=keys.device))


def iteration_faults(faults, it: int):
    """Training iteration ``it``'s spec: the iteration folded into the
    spec's own key (the main key stream is untouched)."""
    if faults is None:
        return None
    return faults._replace(key=prng.fold_in(faults.key, it))


class VecEnv:
    """Batched SoC environment over one SoC + accelerator set.

    Same profile resolution, action masks and timing constants as
    ``repro.soc.vecenv.VecEnv``.  ``device=None`` means the CUDA card
    (raises without one); ``device="cpu"`` runs the plain PyTorch step.
    ``debug_finite=True`` checks every episode's rewards and trained
    Q-table and raises ``FloatingPointError`` on a non-finite value (it
    synchronizes with the card after each launch).

    ``fused_step`` picks the episode's step: the fused kernel
    (:func:`run_episodes`) or the unfused plain PyTorch step
    (:func:`run_episodes_unfused`), which equals it bitwise.  ``None`` (the
    default) fuses whenever ``demand_cache`` and ``presample_noise`` both
    hold, the fast path the kernel fuses; ``demand_cache=False`` (every
    slot's demand recomputed each step) and ``presample_noise=False``
    (per-step key splitting) are the unfused step's ablations, which the
    throughput benchmark measures.  ``ddr_attribution`` needs the demand
    cache.  Serving always runs the fused serve step.
    """

    def __init__(self, soc: SoCConfig,
                 profiles: Sequence[AccProfile] | None = None,
                 seed: int = 0, flavor: str = "mixed",
                 cycle_time: float = 1e-8, demand_cache: bool = True,
                 presample_noise: bool = True,
                 ddr_attribution: bool = False,
                 fused_step: bool | None = None,
                 debug_finite: bool = False, device=None):
        self.soc = soc
        self.demand_cache = bool(demand_cache)
        self.presample_noise = bool(presample_noise)
        if ddr_attribution and not self.demand_cache:
            raise ValueError("ddr_attribution requires demand_cache=True")
        fast = self.demand_cache and self.presample_noise
        if fused_step and not fast:
            raise ValueError("fused_step requires demand_cache=True and "
                             "presample_noise=True")
        self.fused_step = fast if fused_step is None else bool(fused_step)
        self.device = resolve_device(device)
        rng = np.random.default_rng(seed)
        self.profiles = list(profiles) if profiles is not None else (
            resolve_profiles(soc.accelerators, rng, flavor))
        assert len(self.profiles) == soc.n_accs
        self.pmat = torch.as_tensor(profile_matrix(self.profiles),
                                    device=self.device)
        self.static = SoCStatic.from_config(soc)
        self.geom = soc.geometry
        self.cycle_time = float(cycle_time)
        self.ddr_attribution = bool(ddr_attribution)
        self.debug_finite = bool(debug_finite)
        masks = np.ones((soc.n_accs, N_MODES), bool)
        for i in soc.no_private_cache:
            masks[i, CoherenceMode.FULLY_COH] = False
        self.masks = torch.as_tensor(masks, device=self.device)
        self.params = LaneParams(pmat=self.pmat, masks=self.masks,
                                 static=self.static)

    @classmethod
    def from_simulator(cls, sim, cycle_time: float = 1e-8,
                       demand_cache: bool = True,
                       presample_noise: bool = True,
                       ddr_attribution: bool = False,
                       fused_step: bool | None = None,
                       debug_finite: bool = False) -> "VecEnv":
        """The scale-path twin of a :class:`~repro_torch.soc.des.
        SoCSimulator`: its SoC, profiles and device."""
        return cls(sim.soc, profiles=sim.profiles, cycle_time=cycle_time,
                   demand_cache=demand_cache,
                   presample_noise=presample_noise,
                   ddr_attribution=ddr_attribution, fused_step=fused_step,
                   debug_finite=debug_finite, device=sim.device)

    def _sched(self, compiled: CompiledApp) -> Schedule:
        return compiled.schedule.to(self.device)

    def _run(self, compiled: CompiledApp, sched: Schedule, specs, cfg,
             weights, keys, faults=None):
        kw = dict(n_phases=compiled.n_phases, n_threads=compiled.n_threads,
                  cycle_time=self.cycle_time,
                  ddr_attribution=self.ddr_attribution, faults=faults,
                  debug_finite=self.debug_finite)
        if self.fused_step:
            return run_episodes(self.params, sched, specs, cfg, weights,
                                keys, **kw)
        return run_episodes_unfused(
            self.params, sched, specs, cfg, weights, keys,
            demand_cache=self.demand_cache,
            presample_noise=self.presample_noise, **kw)

    # -------------------------------------------------------- spec lowering
    def lower(self, compiled: CompiledApp, policy: str = "q",
              qstate: qlearn.QState | None = None, fixed_modes=None,
              cfg: qlearn.QConfig | None = None) -> PolicySpec:
        """Lower a policy-kind shorthand onto ``compiled``'s schedule:
        ``"q"`` (``qstate``, else a fresh agent shaped by ``cfg``),
        ``"fixed"`` (``fixed_modes``, default NON_COH) or ``"manual"``."""
        sched = self._sched(compiled)
        if policy == "q":
            if qstate is None:
                qstate = qlearn.init_qstate(cfg or qlearn.QConfig(),
                                            self.device)
            return learned_policy_spec(qstate, sched)
        if policy == "fixed":
            return fixed_policy_spec(
                self.params, sched,
                _NC if fixed_modes is None else fixed_modes)
        if policy == "manual":
            return manual_policy_spec(self.params, sched)
        raise ValueError(f"unknown policy kind {policy!r}")

    # ----------------------------------------------------- public episodes
    def episode_spec(self, compiled: CompiledApp, spec: PolicySpec,
                     cfg: qlearn.QConfig | None = None,
                     weights: rewards.RewardWeights | None = None,
                     key=None, faults=None):
        """One lowered spec's episode: ``(QState (batch of one),
        EpisodeResult (unbatched))``; an MLP spec returns ``((QState,
        MLPQState), EpisodeResult)``, both trained agents."""
        cfg = cfg or qlearn.QConfig()
        weights = weights or rewards.PAPER_DEFAULT_WEIGHTS
        key = (key if key is not None else prng.PRNGKey(0)).to(self.device)
        agents, res = self._run(compiled, self._sched(compiled), spec, cfg,
                                weights, key.reshape(1, 2), faults)
        return agents, res.index(0)

    def episode(self, compiled: CompiledApp, *, policy: str = "q",
                qstate: qlearn.QState | None = None,
                cfg: qlearn.QConfig | None = None, fixed_modes=None,
                weights: rewards.RewardWeights | None = None, key=None,
                faults=None):
        """:meth:`lower` then :meth:`episode_spec`: ``policy="q"`` trains
        ``qstate`` (a fresh agent if None) unless it is frozen."""
        spec = self.lower(compiled, policy, qstate=qstate,
                          fixed_modes=fixed_modes, cfg=cfg)
        return self.episode_spec(compiled, spec, cfg=cfg, weights=weights,
                                 key=key, faults=faults)

    def episodes(self, compiled: CompiledApp, specs: PolicySpec,
                 cfg: qlearn.QConfig | None = None,
                 weights: rewards.RewardWeights | None = None,
                 keys=None, faults=None) -> EpisodeResult:
        """A heterogeneous batch of lowered policies on one app, one
        kernel launch; ``keys`` default to ``PRNGKey(arange(N))`` and
        ``faults`` perturbs every policy alike."""
        cfg = cfg or qlearn.QConfig()
        weights = weights or rewards.PAPER_DEFAULT_WEIGHTS
        n = specs.learned.shape[0]
        keys = (keys if keys is not None
                else prng.PRNGKey(np.arange(n))).to(self.device)
        _, res = self._run(compiled, self._sched(compiled), specs, cfg,
                           weights, keys, faults)
        return res

    def baseline_episode(self, compiled: CompiledApp,
                         faults=None) -> EpisodeResult:
        """Fixed NON_COH_DMA episode — the paper's normalization baseline
        (under ``faults``, so ratios isolate the policy from the storm)."""
        spec = fixed_policy_spec(self.params, self._sched(compiled), _NC)
        _, res = self.episode_spec(compiled, spec, faults=faults)
        return res

    # ------------------------------------------------------------ training
    def _train_setup(self, cfg, weights_batch, keys, eval_app, faults):
        keys = keys.to(self.device)
        b = keys.shape[0]
        wb = rewards.RewardWeights(*(torch.as_tensor(
            v, dtype=torch.float32, device=self.device).expand(b)
            for v in weights_batch))
        ev = None
        if eval_app is not None:
            ev = (eval_app, self._sched(eval_app),
                  self.baseline_episode(eval_app, faults=faults))
        return keys, wb, ev, qlearn.init_qstate_batch(cfg, b, self.device)

    def _train_iters(self, apps, cfg, wb, qs, tc: TrainCarry, ev, faults):
        """Iterations ``tc.it ...`` of training, one launch per training
        and per evaluation episode; returns ``(qs, tc, hist_t, hist_m)``
        with the histories as lists of ``(B,)`` tensors."""
        hist_t, hist_m = [], []
        for app in apps:
            sched = self._sched(app)
            ks = prng.split(tc.key, 3)
            k_train, k_eval = ks[:, 1], ks[:, 2]
            f_i = iteration_faults(faults, tc.it)
            qs, er = self._run(app, sched, learned_policy_spec(qs, sched),
                               cfg, wb, k_train, f_i)
            valid = sched.valid
            ep_r = (torch.where(valid, er.reward, 0.0).sum(-1)
                    / torch.clamp(valid.to(torch.float32).sum(), min=1.0))
            qs, best = qlearn.reward_watchdog(cfg, qs, ep_r, tc.best)
            if ev is not None:
                eval_app, eval_sched, base = ev
                _, er2 = self._run(
                    eval_app, eval_sched,
                    learned_policy_spec(qlearn.freeze(qs), eval_sched),
                    cfg, wb, k_eval, f_i)
                nt, nm = normalized_metrics(er2, base)
                hist_t.append(nt)
                hist_m.append(nm)
            tc = TrainCarry(key=ks[:, 0], it=tc.it + 1, best=best)
        return qs, tc, hist_t, hist_m

    def train_batched(self, train_apps: Sequence[CompiledApp],
                      cfg: qlearn.QConfig,
                      weights_batch: rewards.RewardWeights, keys,
                      eval_app: CompiledApp | None = None, faults=None):
        """Train ``B`` agents, one kernel launch per iteration: agent ``b``
        trains with ``weights_batch[b]`` from ``keys[b]``.  Each iteration
        splits every agent's key 3 ways (next key, training episode,
        evaluation episode), as the reference does; ``faults`` perturbs
        the training and evaluation episodes, iteration ``i`` drawing from
        the spec's key folded with ``i``, and the baseline.  Returns the
        batched QState and, with ``eval_app``, per-iteration ``(norm_time,
        norm_mem)`` histories of shape ``(B, iterations)``."""
        keys, wb, ev, qs = self._train_setup(cfg, weights_batch, keys,
                                             eval_app, faults)
        qs, _, hist_t, hist_m = self._train_iters(
            train_apps, cfg, wb, qs, init_train_carry(keys), ev, faults)
        hist = ((torch.stack(hist_t, -1), torch.stack(hist_m, -1))
                if eval_app is not None else None)
        return qs, hist

    def train(self, train_apps: Sequence[CompiledApp], cfg: qlearn.QConfig,
              weights: rewards.RewardWeights | None = None, key=None,
              eval_app: CompiledApp | None = None, faults=None):
        """Train one agent over the per-iteration schedules (each compiled
        with its own tile seed): :meth:`train_batched` with a batch of
        one, from ``key`` (default ``PRNGKey(0)``).  Returns the QState (a
        batch of one) and, with ``eval_app``, the ``(norm_time,
        norm_mem)`` histories of shape ``(iterations,)``."""
        weights = weights or rewards.PAPER_DEFAULT_WEIGHTS
        key = key if key is not None else prng.PRNGKey(0)
        qs, hist = self.train_batched(
            train_apps, cfg, rewards.stack_weights([weights]),
            key.reshape(1, 2), eval_app=eval_app, faults=faults)
        return qs, (None if hist is None else (hist[0][0], hist[1][0]))

    def train_batched_checkpointed(self, train_apps: Sequence[CompiledApp],
                                   cfg: qlearn.QConfig,
                                   weights_batch: rewards.RewardWeights,
                                   keys, manager, *, ckpt_every: int = 1,
                                   eval_app: CompiledApp | None = None,
                                   faults=None):
        """Crash-resumable :meth:`train_batched`.

        Training runs in chunks of ``ckpt_every`` iterations; after each
        the ``(QState, TrainCarry, histories, iterations done)`` snapshot
        is saved through ``manager`` (a :class:`~repro_torch.checkpoint.
        manager.CheckpointManager`).  On entry the newest restorable
        checkpoint, if any, is loaded and training continues from its
        iteration: the carry crosses chunks unchanged, so an interrupted
        and resumed run returns Q-states and histories bitwise equal to
        an uninterrupted :meth:`train_batched`.  The histories are
        ``(B, iterations)`` tensors from the start (zeros without
        ``eval_app``), so every checkpoint has the same structure."""
        iters = len(train_apps)
        if ckpt_every < 1:
            raise ValueError("ckpt_every must be >= 1")
        keys, wb, ev, qs = self._train_setup(cfg, weights_batch, keys,
                                             eval_app, faults)
        zeros = torch.zeros((keys.shape[0], iters), dtype=torch.float32,
                            device=self.device)
        state = {"qstate": qs, "carry": init_train_carry(keys),
                 "hist_t": zeros, "hist_m": zeros.clone(), "done": 0}
        if manager.latest_step() is not None:
            state = manager.restore(state)
        qs, tc, done = state["qstate"], state["carry"], state["done"]
        hist_t, hist_m = state["hist_t"], state["hist_m"]
        while done < iters:
            n = min(ckpt_every, iters - done)
            qs, tc, ht, hm = self._train_iters(
                train_apps[done:done + n], cfg, wb, qs, tc, ev, faults)
            if ht:
                hist_t[:, done:done + n] = torch.stack(ht, -1)
                hist_m[:, done:done + n] = torch.stack(hm, -1)
            done += n
            manager.save(done, {"qstate": qs, "carry": tc,
                                "hist_t": hist_t, "hist_m": hist_m,
                                "done": done})
        manager.wait()
        return qs, (hist_t, hist_m)

    def evaluate_batched(self, compiled: CompiledApp,
                         qstates: qlearn.QState, cfg: qlearn.QConfig, keys,
                         faults=None):
        """Frozen-greedy evaluation of ``B`` agents on one app in one
        launch (plus the NON_COH baseline's, under the same ``faults``);
        returns ``(norm_time, norm_mem)`` of shape ``(B,)``."""
        base = self.baseline_episode(compiled, faults=faults)
        sched = self._sched(compiled)
        _, er = self._run(compiled, sched,
                          learned_policy_spec(qlearn.freeze(qstates), sched),
                          cfg, rewards.PAPER_DEFAULT_WEIGHTS,
                          keys.to(self.device), faults)
        return normalized_metrics(er, base)


# ===================================================================== serving
class ServeResult(NamedTuple):
    """Per-request traces of serving chunks (``(..., n_requests)`` leaves).

    Shed requests carry ``executed=False``, ``-1`` mode/state/action and
    zeroed timing columns; times are cycles; ``retries`` counts backed-off
    admission attempts (``SERVE_MAX_RETRIES + 1`` marks a shed request)."""

    t_arr: torch.Tensor      # float32 arrival time
    tenant: torch.Tensor     # int32
    mode: torch.Tensor       # int32 (-1 = shed)
    state_idx: torch.Tensor  # int32 (-1 = shed)
    action: torch.Tensor     # int32 (-1 = shed)
    exec_time: torch.Tensor  # float32 cycles
    offchip: torch.Tensor    # float32 line accesses
    reward: torch.Tensor     # float32
    executed: torch.Tensor   # bool: admitted and served
    latency: torch.Tensor    # float32 finish - arrival (0 when shed)
    retries: torch.Tensor    # float32 admission attempts used
    depth: torch.Tensor      # float32 victim queue depth at arrival
    degraded: torch.Tensor   # bool: served under forced NON_COH
    start: torch.Tensor      # float32 admitted start time
    finish: torch.Tensor     # float32 admitted finish time

    @property
    def t_end(self):
        return self.t_arr[..., -1]

    def index(self, i) -> "ServeResult":
        return ServeResult(*(v[i] for v in self))


_SERVE_RESULT_DTYPES = (
    torch.float32, torch.int32, torch.int32, torch.int32, torch.int32,
    torch.float32, torch.float32, torch.float32, torch.bool, torch.float32,
    torch.float32, torch.float32, torch.bool, torch.float32, torch.float32)


def _zero_serve_results(n_chunks: int, n_requests: int,
                        device=None) -> ServeResult:
    """``(n_chunks, n_requests)`` zero leaves of each field's dtype: the
    fixed structure of a checkpointed stream's results."""
    return ServeResult(*(torch.zeros((n_chunks, n_requests), dtype=dt,
                                     device=device)
                         for dt in _SERVE_RESULT_DTYPES))


def serve_params(cfg: qlearn.QConfig, frozen, tspec) -> \
        soc_step_ref.ServeParams:
    """The serving step's scalars for agents with ``frozen (N,)`` flags."""
    f32 = torch.float32
    dev = frozen.device
    num = lambda v: torch.as_tensor(v, device=dev).to(f32)
    return soc_step_ref.ServeParams(
        eps0=num(float(np.float32(cfg.epsilon0))),
        alpha0=num(float(np.float32(cfg.alpha0))),
        decay_steps=num(float(np.float32(cfg.decay_steps))),
        reopen_frac=num(float(np.float32(cfg.reopen_frac))),
        frozen=frozen.to(f32), backoff=tspec.backoff,
        overload_frac=tspec.overload_frac,
        pressure_beta=tspec.pressure_beta, prio_reserve=tspec.prio_reserve)


def serve_inputs(params: LaneParams, sched: Schedule, specs: PolicySpec,
                 arr: traffic_mod.Arrivals, keys, faults=None) -> StepInputs:
    """The serving step's ``(N, n_requests, ...)`` rows for ``N`` lowered
    policies facing one arrival table.  thread/fresh/others/valid/eps/alpha
    are placeholders the step owns (serving slots are accelerators and the
    decay schedule runs on the carried counter).  ``faults`` rows are
    drawn over the requests' accelerator column, so a storm composes with
    admission request by request."""
    n = specs.learned.shape[0]
    n_req = arr.row.shape[0]
    pmat, masks = params.pmat, params.masks
    dev = pmat.device
    row = arr.row.long()
    acc = sched.acc_id[row]
    noise = qlearn.sample_select_noise(keys, (n_req,), masks.shape[-1])
    ex = lambda v: v.expand(n, *v.shape)
    zf = torch.zeros((n, n_req), dtype=torch.float32, device=dev)
    return StepInputs(
        acc_id=ex(acc), footprint=ex(sched.footprint[row]),
        tiles=ex(sched.tiles[row]),
        thread=torch.zeros((n, n_req), dtype=torch.int32, device=dev),
        fresh=torch.ones((n, n_req), dtype=torch.bool, device=dev),
        others=torch.zeros((n, n_req, pmat.shape[0]), dtype=torch.bool,
                           device=dev),
        valid=torch.ones((n, n_req), dtype=torch.bool, device=dev),
        pre_mode=specs.modes[:, row], profile=ex(pmat[acc]),
        avail=ex(masks[acc]), eps=zf, alpha=zf,
        u_explore=noise.u_explore, g_pick=noise.g_pick, g_tie=noise.g_tie,
        **_fault_columns(faults, acc, n))


def serve_results(qs0: qlearn.QState, carry, ys, arr: traffic_mod.Arrivals):
    """``(QState (N), ServeResult (N, n))`` from a serving call's outputs:
    the trained table and watchdog-rewound counter from the carry, visits
    replayed over the executed rows."""
    cols = {name: ys[..., i]
            for i, name in enumerate(soc_step_ref.SERVE_YCOLS)}
    executed = cols["executed"] > 0.0
    inc = (executed & ~qs0.frozen[:, None]).to(torch.int32)
    sidx = torch.clamp(cols["state_idx"].to(torch.int32), min=0)
    act = torch.clamp(cols["action"].to(torch.int32), min=0)
    qs = qlearn.replay_visits(qs0, carry.qtable, sidx, act, inc)._replace(
        step=carry.step)
    n = ys.shape[0]
    i32 = torch.int32
    res = ServeResult(
        t_arr=arr.t_arr.expand(n, -1), tenant=arr.tenant.expand(n, -1),
        mode=cols["mode"].to(i32), state_idx=cols["state_idx"].to(i32),
        action=cols["action"].to(i32), exec_time=cols["exec_time"],
        offchip=cols["offchip"], reward=cols["reward"], executed=executed,
        latency=cols["latency"], retries=cols["retries"],
        depth=cols["depth"], degraded=cols["degraded"] > 0.0,
        start=cols["start"], finish=cols["finish"])
    return qs, res


def run_serve(params: LaneParams, sched: Schedule, specs: PolicySpec,
              cfg: qlearn.QConfig, weights, tspec, carry, keys, t0, *,
              n_requests: int, queue_cap: int, n_real: int | None = None,
              ddr_attribution: bool = False, faults=None,
              debug_finite: bool = False):
    """``N`` serving chunks of a batched spec against one offered stream,
    ONE kernel launch.  Arrivals sample rows over the first ``n_real``
    schedule rows (default all; a padded stacked lane passes its real
    length).  ``carry=None`` starts fresh streams; ``faults`` perturbs
    every stream alike.  Returns ``(ServeCarry (N), QState (N),
    ServeResult (N, n_requests))``.  MLP specs (``specs.mlp``) serve their
    networks: the merged agent drives the decay and freeze, the trained
    weights ride the returned carry's ``wpack`` (rebuild the agent with
    ``mlp._replace(wpack=carry.wpack, step=carry.step)``) and the
    returned placeholder Q-state stays frozen."""
    specs = _batched(specs)
    qs0 = specs.qstate
    n = qs0.qtable.shape[0]
    n_accs = params.pmat.shape[0]
    arr = traffic_mod.sample_arrivals(
        tspec, n_requests, sched.acc_id.shape[0] if n_real is None
        else int(n_real), t0)
    xs = serve_inputs(params, sched, specs, arr, keys, faults)
    step0, frozen = merged_agent(specs)
    if carry is None:
        carry = soc_step_ref.init_serve_carry(
            qs0.qtable, rewards.init_reward_state(
                n_accs, (n,), qs0.qtable.device).extrema,
            n_accs, sched.tiles.shape[-1], queue_cap, step0,
            None if specs.mlp is None else specs.mlp.wpack)
    carry, ys = soc_step_ops.fused_serve_episode(
        params.static, specs.learned.expand(n), weights,
        serve_params(cfg, frozen, tspec), carry, xs,
        arr.t_arr.expand(n, -1), arr.deadline.expand(n, -1),
        arr.priority.expand(n, -1), ddr_attribution=ddr_attribution,
        qfun=None if specs.mlp is None else specs.qfun.expand(n),
        mlp=specs.mlp)
    qs, res = serve_results(qs0, carry, ys, arr)
    if debug_finite:
        qlearn.debug_finite_check("vecenv.serve", reward=res.reward,
                                  qtable=qs.qtable)
    return carry, qs, res


class ServeEnv:
    """Long-lived continuous-traffic serving over a :class:`VecEnv`.

    Requests arrive from a :class:`~repro_torch.soc.traffic.TrafficSpec`,
    are admitted to bounded per-accelerator queues (``queue_cap`` ring
    slots), shed when their deadline cannot be met after bounded
    retry-with-backoff, and, under sustained shedding, served in forced
    NON_COH while the watchdog reopens exploration.  ``traffic=None``
    delegates to :meth:`VecEnv.episode_spec`, the episodic path.  Chunks
    chain: pass the returned carry and the last arrival time back in;
    :meth:`serve_checkpointed` does so through a checkpoint manager.
    MLP specs serve their networks, whose weights ride the carry."""

    def __init__(self, env: VecEnv, *, queue_cap: int = 8,
                 n_requests: int = 1024):
        if queue_cap < 1:
            raise ValueError("queue_cap must be >= 1")
        self.env = env
        self.queue_cap = int(queue_cap)
        self.n_requests = int(n_requests)

    def init_carry(self, qstate: qlearn.QState, mlp=None, qfun=None):
        """Fresh streams (idle devices, the agents' Q-tables).  For an
        MLP-lowered spec pass ``(spec.qstate, spec.mlp, spec.qfun)``: the
        weight pack joins the carry and the decay counter starts at the
        merged agent's step."""
        n_accs = self.env.pmat.shape[0]
        n = qstate.qtable.shape[0]
        step0 = (qstate.step if mlp is None
                 else torch.where(qfun, mlp.step, qstate.step))
        return soc_step_ref.init_serve_carry(
            qstate.qtable, rewards.init_reward_state(
                n_accs, (n,), self.env.device).extrema,
            n_accs, self.env.soc.n_mem_tiles, self.queue_cap, step0,
            None if mlp is None else mlp.wpack)

    def _call(self, compiled, specs, traffic, cfg, weights, keys, carry,
              t0, n_requests, faults):
        cfg = cfg or qlearn.QConfig()
        weights = weights or rewards.PAPER_DEFAULT_WEIGHTS
        return run_serve(
            self.env.params, self.env._sched(compiled), specs, cfg, weights,
            traffic.to(self.env.device), carry, keys, t0,
            n_requests=int(n_requests or self.n_requests),
            queue_cap=self.queue_cap,
            ddr_attribution=self.env.ddr_attribution, faults=faults,
            debug_finite=self.env.debug_finite)

    def serve(self, compiled: CompiledApp, spec: PolicySpec,
              traffic: traffic_mod.TrafficSpec | None = None, *,
              cfg: qlearn.QConfig | None = None,
              weights: rewards.RewardWeights | None = None,
              key=None, carry=None, t0=0.0,
              n_requests: int | None = None, faults=None):
        """Serve one chunk of offered traffic with a lowered policy:
        ``(ServeCarry (batch of one), QState (batch of one), ServeResult
        (unbatched))``.  With ``traffic=None`` this is
        :meth:`VecEnv.episode_spec`, returning its ``(QState,
        EpisodeResult)``."""
        if traffic is None:
            return self.env.episode_spec(compiled, spec, cfg=cfg,
                                         weights=weights, key=key,
                                         faults=faults)
        key = (key if key is not None else prng.PRNGKey(0)).to(
            self.env.device)
        carry, qs, res = self._call(compiled, spec, traffic, cfg, weights,
                                    key.reshape(1, 2), carry, t0,
                                    n_requests, faults)
        return carry, qs, res.index(0)

    def serve_specs(self, compiled: CompiledApp, specs: PolicySpec,
                    traffic: traffic_mod.TrafficSpec, *,
                    cfg: qlearn.QConfig | None = None,
                    weights: rewards.RewardWeights | None = None,
                    keys=None, n_requests: int | None = None, faults=None):
        """A batch of ``N`` lowered policies against one offered stream in
        one kernel launch (keys default to ``PRNGKey(arange(N))``);
        returns ``(ServeCarry, QState, ServeResult)`` with ``(N, ...)``
        leaves."""
        n = specs.learned.shape[0]
        keys = (keys if keys is not None
                else prng.PRNGKey(np.arange(n))).to(self.env.device)
        return self._call(compiled, specs, traffic, cfg, weights, keys,
                          None, 0.0, n_requests, faults)

    def serve_checkpointed(self, compiled: CompiledApp, spec: PolicySpec,
                           traffic: traffic_mod.TrafficSpec, manager, *,
                           n_chunks: int, cfg: qlearn.QConfig | None = None,
                           weights: rewards.RewardWeights | None = None,
                           key=None, n_requests: int | None = None,
                           faults=None):
        """Crash-resumable serving of ``n_chunks`` chunks of one stream.

        Chunk ``i`` draws its arrivals from ``traffic``'s key folded with
        ``i`` (:func:`~repro_torch.soc.traffic.chunk_key`) and its select
        noise from ``key`` folded with ``i``; the carry, the Q-state and
        the arrival clock cross chunks, and after each chunk the snapshot
        is saved through ``manager``.  On entry the newest restorable
        checkpoint, if any, is loaded, so an interrupted and resumed
        stream ends bitwise equal to an uninterrupted one.  Returns
        ``(ServeCarry, QState, ServeResult)`` with the results flattened
        to ``(n_chunks * n_requests,)`` request order."""
        if n_chunks < 1:
            raise ValueError("n_chunks must be >= 1")
        key = (key if key is not None else prng.PRNGKey(0)).to(
            self.env.device)
        n = int(n_requests or self.n_requests)
        state = {"carry": self.init_carry(spec.qstate, spec.mlp,
                                          spec.qfun),
                 "qstate": spec.qstate,
                 "results": _zero_serve_results(n_chunks, n,
                                                self.env.device),
                 "t0": torch.zeros((), dtype=torch.float32,
                                   device=self.env.device),
                 "done": 0}
        if manager.latest_step() is not None:
            state = manager.restore(state)
        carry, qs, results = state["carry"], state["qstate"], state["results"]
        t0, done = state["t0"], state["done"]
        while done < n_chunks:
            carry, qs, res = self.serve(
                compiled, spec._replace(qstate=qs),
                traffic_mod.chunk_key(traffic, done), cfg=cfg,
                weights=weights, key=prng.fold_in(key, done), carry=carry,
                t0=t0, n_requests=n, faults=faults)
            for acc, r in zip(results, res):
                acc[done] = r
            t0 = res.t_arr[-1]
            done += 1
            manager.save(done, {"carry": carry, "qstate": qs,
                                "results": results, "t0": t0,
                                "done": done})
        manager.wait()
        return carry, qs, ServeResult(*(v.reshape(-1) for v in results))
