"""The episode and serving glue of the reference (frozen copy of the
port's ``soc.vecenv`` at the commit that added the benchmark).

Compiles an application to its static schedule (:func:`compile_app`),
resolves a SoC's profile matrix and action masks (:func:`lane_params`),
lowers the fixed, manual and learned policy families, precomputes a
batch of episodes' step inputs from their keys (:func:`episode_inputs`),
and turns per-step traces into per-phase and normalized metrics.  The
step itself is
:mod:`perfbench.reference.step`.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from perfbench.reference import xla_math
from perfbench.reference import qlearn
from perfbench.reference.modes import CoherenceMode, N_MODES
from perfbench.reference import step as soc_step_ref
from perfbench.reference.step import StepInputs
from perfbench.reference.ordered import seqsum
from perfbench.reference.accelerators import profile_matrix, resolve_profiles
from perfbench.reference.config import SoCConfig
from perfbench.reference.appdefs import Application, stripe_tiles
from perfbench.reference.memsys import SoCStatic

_NC = int(CoherenceMode.NON_COH_DMA)
# Algorithm 1's extra-small class (the port's ``core.policies``)
EXTRA_SMALL_THRESHOLD = 4 * 1024


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
    a frozen placeholder, whose update is a no-op).  :func:`stack_specs`
    gives leaves a leading policy axis ``N``."""

    modes: torch.Tensor
    learned: torch.Tensor
    qstate: qlearn.QState


def stack_specs(specs: Sequence[PolicySpec]) -> PolicySpec:
    """Stack unbatched specs along a new leading policy axis (mixed
    families welcome)."""
    return PolicySpec(
        modes=torch.stack([s.modes for s in specs]),
        learned=torch.stack([s.learned.reshape(()) for s in specs]),
        qstate=qlearn.cat_qstates([s.qstate for s in specs]))


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
    schedule."""
    return specs.qstate.step, specs.qstate.frozen


def episode_inputs(params: LaneParams, sched: Schedule, specs: PolicySpec,
                   cfg: qlearn.QConfig, keys, *, gated: bool = False):
    """The fused step's per-step inputs for ``N`` episodes of a batched
    spec: ``(StepInputs (N, S, ...), inc (N, S))``, ``inc`` being the
    decay-counter increments the episode applies."""
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
        g_tie=noise.g_tie)
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


def lane_params(soc: SoCConfig, seed: int, flavor: str,
                device=None) -> LaneParams:
    """A SoC's profile matrix, action masks and timing scalars: profiles
    resolved from ``default_rng(seed)`` and ``flavor``; accelerators
    without a private cache cannot take FULLY_COH."""
    profiles = resolve_profiles(soc.accelerators, np.random.default_rng(seed),
                                flavor)
    masks = np.ones((soc.n_accs, N_MODES), bool)
    for i in soc.no_private_cache:
        masks[i, CoherenceMode.FULLY_COH] = False
    return LaneParams(
        pmat=torch.as_tensor(profile_matrix(profiles), device=device),
        masks=torch.as_tensor(masks, device=device),
        static=SoCStatic.from_config(soc))
