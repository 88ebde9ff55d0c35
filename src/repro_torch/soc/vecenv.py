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
episodes in one kernel launch, where the JAX package ``vmap``s.

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
from repro_torch import resolve_device
from repro_torch.core import qlearn, rewards
from repro_torch.core.modes import CoherenceMode, N_MODES
from repro_torch.core.policies import EXTRA_SMALL_THRESHOLD
from repro_torch.kernels.soc_step import ops as soc_step_ops
from repro_torch.kernels.soc_step.ref import StepInputs
from repro_torch.ordered import seqsum
from repro_torch.soc.accelerators import (AccProfile, profile_matrix,
                                          resolve_profiles)
from repro_torch.soc.config import SoCConfig
from repro_torch.soc.des import Application, stripe_tiles
from repro_torch.soc.memsys import SoCStatic

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


def normalized_metrics(res: EpisodeResult, base: EpisodeResult):
    """Per-phase geomean (time, offchip) of ``res`` normalized to a
    baseline episode — the paper's Fixed-NON_COH normalization.  ``res``
    leaves may carry a batch axis; ``base`` broadcasts against it."""
    lt = torch.log(torch.clamp(
        res.phase_time / torch.clamp(base.phase_time, min=1e-30),
        min=1e-12))
    lm = torch.log(torch.clamp(
        (res.phase_offchip + 1.0)
        / torch.clamp(base.phase_offchip + 1.0, min=1e-30), min=1e-12))
    return torch.exp(lt.mean(-1)), torch.exp(lm.mean(-1))


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


def spec_from_numpy(modes, learned, qtable, visits, step, frozen,
                    device=None) -> PolicySpec:
    """A port PolicySpec from the table fields of a JAX ``PolicySpec``
    (batched — a leading policy axis on every leaf — or not)."""
    modes = torch.as_tensor(np.array(modes, np.int32), device=device)
    learned = torch.as_tensor(np.array(learned, np.bool_), device=device)
    return PolicySpec(modes=modes, learned=learned,
                      qstate=qlearn.qstate_from_numpy(
                          qtable, visits, step, frozen, device))


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


def _batched(spec: PolicySpec) -> PolicySpec:
    """A spec with a leading policy axis (single specs gain one)."""
    if spec.learned.dim() == 0:
        return PolicySpec(spec.modes[None], spec.learned[None],
                          spec.qstate)
    return spec


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
    inc = (live & ~qs0.frozen[:, None]).to(torch.int32)
    eps_t, alpha_t = qlearn.decay_arrays(cfg, qs0.step, qs0.frozen, inc)
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


def run_episodes(params: LaneParams, sched: Schedule, specs: PolicySpec,
                 cfg: qlearn.QConfig, weights: rewards.RewardWeights, keys,
                 *, n_phases: int, n_threads: int, cycle_time: float,
                 gated: bool = False, ddr_attribution: bool = False):
    """``N`` fused episodes of a batched spec on one schedule, ONE kernel
    launch.  ``weights`` leaves are ``(N,)`` or numbers, ``keys (N, 2)``.
    Returns ``(QState (N), EpisodeResult (N, ...))``."""
    specs = _batched(specs)
    qs0 = specs.qstate
    n = qs0.qtable.shape[0]
    dev = params.pmat.device
    xs, inc = episode_inputs(params, sched, specs, cfg, keys, gated=gated)
    extrema0 = rewards.init_reward_state(params.pmat.shape[0], (n,),
                                         dev).extrema
    qtable, ys = soc_step_ops.fused_episode(
        params.static, specs.learned.expand(n), weights, qs0.qtable,
        extrema0, xs, ddr_attribution=ddr_attribution, gated=gated)
    mode, state_idx, action, exec_c, off, rew = ys
    qs_final = qlearn.replay_visits(qs0, qtable, state_idx, action, inc)

    # Per-phase wall clock: max over threads of per-thread busy time.
    T, P = n_threads, n_phases
    secs = torch.where(sched.valid, exec_c, 0.0) * cycle_time
    off_real = torch.where(sched.valid, off, 0.0)
    slot = (sched.phase_id.long() * T + sched.thread.long())
    per_thread = torch.zeros((n, P * T), dtype=secs.dtype, device=dev)
    per_thread.index_add_(1, slot, secs)
    phase_time = per_thread.reshape(n, P, T).amax(-1)
    phase_off = torch.zeros((n, P), dtype=off.dtype, device=dev)
    phase_off.index_add_(1, sched.phase_id.long(), off_real)
    res = EpisodeResult(phase_time=phase_time, phase_offchip=phase_off,
                        mode=mode, state_idx=state_idx, exec_time=exec_c,
                        offchip=off, reward=rew)
    return qs_final, res


class TrainCarry(NamedTuple):
    """Cross-iteration training state beyond the Q-state: the main key
    stream (split 3 ways per iteration), the iteration index and the
    running best mean episode reward (reward-collapse watchdog)."""

    key: torch.Tensor    # (B, 2)
    it: int
    best: torch.Tensor   # (B,) float32


def init_train_carry(keys) -> TrainCarry:
    return TrainCarry(key=keys, it=0,
                      best=torch.full((keys.shape[0],), -float("inf"),
                                      dtype=torch.float32,
                                      device=keys.device))


class VecEnv:
    """Batched SoC environment over one SoC + accelerator set.

    Same profile resolution, action masks and timing constants as
    ``repro.soc.vecenv.VecEnv``.  ``device=None`` means the CUDA card
    (raises without one); ``device="cpu"`` runs the plain PyTorch step.
    """

    def __init__(self, soc: SoCConfig,
                 profiles: Sequence[AccProfile] | None = None,
                 seed: int = 0, flavor: str = "mixed",
                 cycle_time: float = 1e-8, ddr_attribution: bool = False,
                 device=None):
        self.soc = soc
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
        masks = np.ones((soc.n_accs, N_MODES), bool)
        for i in soc.no_private_cache:
            masks[i, CoherenceMode.FULLY_COH] = False
        self.masks = torch.as_tensor(masks, device=self.device)
        self.params = LaneParams(pmat=self.pmat, masks=self.masks,
                                 static=self.static)

    def _sched(self, compiled: CompiledApp) -> Schedule:
        return compiled.schedule.to(self.device)

    def _run(self, compiled: CompiledApp, sched: Schedule, specs, cfg,
             weights, keys):
        return run_episodes(
            self.params, sched, specs, cfg, weights, keys,
            n_phases=compiled.n_phases, n_threads=compiled.n_threads,
            cycle_time=self.cycle_time,
            ddr_attribution=self.ddr_attribution)

    # ----------------------------------------------------- public episodes
    def episode_spec(self, compiled: CompiledApp, spec: PolicySpec,
                     cfg: qlearn.QConfig | None = None,
                     weights: rewards.RewardWeights | None = None,
                     key=None) -> tuple[qlearn.QState, EpisodeResult]:
        """One lowered spec's episode: ``(QState (batch of one),
        EpisodeResult (unbatched))``."""
        cfg = cfg or qlearn.QConfig()
        weights = weights or rewards.PAPER_DEFAULT_WEIGHTS
        key = (key if key is not None else prng.PRNGKey(0)).to(self.device)
        qs, res = self._run(compiled, self._sched(compiled), spec, cfg,
                            weights, key.reshape(1, 2))
        return qs, res.index(0)

    def episodes(self, compiled: CompiledApp, specs: PolicySpec,
                 cfg: qlearn.QConfig | None = None,
                 weights: rewards.RewardWeights | None = None,
                 keys=None) -> EpisodeResult:
        """A heterogeneous batch of lowered policies on one app, one
        kernel launch; ``keys`` default to ``PRNGKey(arange(N))``."""
        cfg = cfg or qlearn.QConfig()
        weights = weights or rewards.PAPER_DEFAULT_WEIGHTS
        n = specs.learned.shape[0]
        keys = (keys if keys is not None
                else prng.PRNGKey(np.arange(n))).to(self.device)
        _, res = self._run(compiled, self._sched(compiled), specs, cfg,
                           weights, keys)
        return res

    def baseline_episode(self, compiled: CompiledApp) -> EpisodeResult:
        """Fixed NON_COH_DMA episode — the paper's normalization baseline."""
        spec = fixed_policy_spec(self.params, self._sched(compiled), _NC)
        _, res = self.episode_spec(compiled, spec)
        return res

    # ------------------------------------------------------------ training
    def train_batched(self, train_apps: Sequence[CompiledApp],
                      cfg: qlearn.QConfig,
                      weights_batch: rewards.RewardWeights, keys,
                      eval_app: CompiledApp | None = None):
        """Train ``B`` agents, one kernel launch per iteration: agent ``b``
        trains with ``weights_batch[b]`` from ``keys[b]``.  Each iteration
        splits every agent's key 3 ways (next key, training episode,
        evaluation episode), as the reference does.  Returns the batched
        QState and, with ``eval_app``, per-iteration ``(norm_time,
        norm_mem)`` histories of shape ``(B, iterations)``."""
        keys = keys.to(self.device)
        b = keys.shape[0]
        wb = rewards.RewardWeights(*(torch.as_tensor(
            v, dtype=torch.float32, device=self.device).expand(b)
            for v in weights_batch))
        eval_sched = base = None
        if eval_app is not None:
            eval_sched = self._sched(eval_app)
            base = self.baseline_episode(eval_app)
        qs = qlearn.init_qstate_batch(cfg, b, self.device)
        tc = init_train_carry(keys)
        hist_t, hist_m = [], []
        for app in train_apps:
            sched = self._sched(app)
            ks = prng.split(tc.key, 3)
            k_train, k_eval = ks[:, 1], ks[:, 2]
            qs, er = self._run(app, sched, learned_policy_spec(qs, sched),
                               cfg, wb, k_train)
            valid = sched.valid
            ep_r = (torch.where(valid, er.reward, 0.0).sum(-1)
                    / torch.clamp(valid.to(torch.float32).sum(), min=1.0))
            qs, best = qlearn.reward_watchdog(cfg, qs, ep_r, tc.best)
            if eval_app is not None:
                _, er2 = self._run(
                    eval_app, eval_sched,
                    learned_policy_spec(qlearn.freeze(qs), eval_sched),
                    cfg, wb, k_eval)
                nt, nm = normalized_metrics(er2, base)
                hist_t.append(nt)
                hist_m.append(nm)
            tc = TrainCarry(key=ks[:, 0], it=tc.it + 1, best=best)
        hist = ((torch.stack(hist_t, -1), torch.stack(hist_m, -1))
                if eval_app is not None else None)
        return qs, hist

    def evaluate_batched(self, compiled: CompiledApp,
                         qstates: qlearn.QState, cfg: qlearn.QConfig, keys):
        """Frozen-greedy evaluation of ``B`` agents on one app in one
        launch (plus the NON_COH baseline's); returns ``(norm_time,
        norm_mem)`` of shape ``(B,)``."""
        base = self.baseline_episode(compiled)
        sched = self._sched(compiled)
        _, er = self._run(compiled, sched,
                          learned_policy_spec(qlearn.freeze(qstates), sched),
                          cfg, rewards.PAPER_DEFAULT_WEIGHTS,
                          keys.to(self.device))
        return normalized_metrics(er, base)
