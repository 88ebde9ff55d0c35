"""K heterogeneous SoCs as one batched environment (paper Fig. 9).

:mod:`repro_torch.soc.vecenv` batches agents over one SoC; this module
pads K SoCs — different accelerator counts, memory-tile counts, thread
widths, schedule lengths and phase counts — to a common shape and runs
every (lane, policy) or (lane, agent) episode in ONE kernel launch: the
lanes and the policies flatten into the kernel's batch axis, where the
JAX package ``vmap``s twice.

  * :func:`compile_apps_stacked` compiles one application per SoC (each
    lane's own tile-striping stream, so a lane's rows are its unstacked
    rows) and pads schedules to ``(S_max, T_max, tiles_max)``; padding
    rows carry ``valid=False`` at the tail of each lane and leave the
    Q-table, reward extrema and slot table untouched (the ``gated``
    step);
  * :class:`StackedVecEnv` stacks per-SoC profile matrices, action masks
    and timing scalars (padded to the largest ``n_accs``; the scalars ride
    the kernel's per-episode consts rows) and exposes :meth:`~StackedVecEnv.
    episodes` over a ``(K, N)`` batch of lowered specs (MLP agents
    through :meth:`~StackedVecEnv.lower_mlps`), :meth:`~StackedVecEnv.
    train_batched` over (K lanes x B agents) and :meth:`~StackedVecEnv.
    serve`;
  * :func:`length_buckets` / :func:`compile_apps_bucketed` split lanes by
    schedule length to cut padded steps, and :func:`reassemble_lanes`
    puts per-bucket results back in lane order.

A lane of a stacked call reproduces the episode its own
:class:`~repro_torch.soc.vecenv.VecEnv` runs: padded slots and tiles are
masked everywhere.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import random as prng
from repro_torch import resolve_device
from repro_torch.core import qlearn, rewards
from repro_torch.core.modes import CoherenceMode
from repro_torch.core.policies import FixedHomogeneous, Policy
from repro_torch.kernels.soc_step import ops as soc_step_ops
from repro_torch.kernels.soc_step import ref as soc_step_ref
from repro_torch.kernels.soc_step.ref import StepInputs
from repro_torch.soc import nn as socnn
from repro_torch.soc import traffic as traffic_mod
from repro_torch.soc import vecenv as vec
from repro_torch.soc.config import SoCConfig
from repro_torch.soc.des import Application
from repro_torch.soc.memsys import SoCStatic


@dataclasses.dataclass(frozen=True)
class StackedApps:
    """K compiled applications padded to a common schedule shape.

    ``schedule`` leaves carry a leading lane axis ``(K, S_max, ...)`` (CPU
    tensors; the environment moves them to its device); ``phase_mask[k,
    p]`` marks lane ``k``'s real phases."""

    schedule: vec.Schedule
    n_phases: int                  # padded P_max
    n_threads: int                 # padded T_max
    n_tiles: int                   # padded memory-tile axis
    n_steps: tuple                 # (K,) real invocations per lane
    phase_mask: torch.Tensor       # (K, P_max) bool
    names: tuple
    phase_names: tuple             # per lane, real phases only
    compiled: tuple                # per-lane unpadded CompiledApp

    @property
    def n_lanes(self) -> int:
        return len(self.compiled)


def _pad_axis(arr: np.ndarray, axis: int, target: int, fill):
    if arr.shape[axis] == target:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, target - arr.shape[axis])
    return np.pad(arr, widths, constant_values=fill)


def pad_compiled(c: vec.CompiledApp, n_steps: int, n_threads: int,
                 n_tiles: int) -> vec.Schedule:
    """Pad one compiled schedule to ``(n_steps, n_threads, n_tiles)``.

    Padding rows are ``valid=False`` no-ops at the tail; padded thread
    slots and memory tiles are never set in any mask, so they contribute
    zeros to every sensed or timed quantity."""
    s = vec.Schedule(*(v.cpu().numpy() for v in c.schedule))
    t = torch.from_numpy
    return vec.Schedule(
        acc_id=t(_pad_axis(s.acc_id, 0, n_steps, 0)),
        footprint=t(_pad_axis(s.footprint, 0, n_steps, 1.0)),
        tiles=t(_pad_axis(_pad_axis(s.tiles, 1, n_tiles, False),
                          0, n_steps, False)),
        thread=t(_pad_axis(s.thread, 0, n_steps, 0)),
        phase_id=t(_pad_axis(s.phase_id, 0, n_steps, 0)),
        fresh=t(_pad_axis(s.fresh, 0, n_steps, True)),
        others=t(_pad_axis(_pad_axis(s.others, 1, n_threads, False),
                           0, n_steps, False)),
        valid=t(_pad_axis(s.valid, 0, n_steps, False)),
    )


def _stack_compiled(compiled: Sequence[vec.CompiledApp],
                    socs: Sequence[SoCConfig]) -> StackedApps:
    """Pad pre-compiled lanes to a common shape and stack them."""
    n_steps = max(c.n_steps for c in compiled)
    n_threads = max(c.n_threads for c in compiled)
    n_tiles = max(soc.n_mem_tiles for soc in socs)
    n_phases = max(c.n_phases for c in compiled)
    padded = [pad_compiled(c, n_steps, n_threads, n_tiles) for c in compiled]
    schedule = vec.Schedule(*(torch.stack(vs) for vs in zip(*padded)))
    phase_mask = torch.from_numpy(np.stack([
        np.arange(n_phases) < c.n_phases for c in compiled]))
    return StackedApps(
        schedule=schedule, n_phases=n_phases, n_threads=n_threads,
        n_tiles=n_tiles, n_steps=tuple(c.n_steps for c in compiled),
        phase_mask=phase_mask, names=tuple(c.name for c in compiled),
        phase_names=tuple(c.phase_names for c in compiled),
        compiled=tuple(compiled))


def _compile_lanes(apps, socs, seed) -> list[vec.CompiledApp]:
    if len(apps) != len(socs):
        raise ValueError(f"{len(apps)} apps vs {len(socs)} socs")
    if np.isscalar(seed):
        seeds = [seed] * len(apps)
    else:
        seeds = list(seed)
        if len(seeds) != len(apps):
            raise ValueError(
                f"{len(seeds)} per-lane seeds vs {len(apps)} apps — "
                "a seed sequence must give exactly one seed per lane")
    return [vec.compile_app(a, soc, seed=s)
            for a, soc, s in zip(apps, socs, seeds)]


def compile_apps_stacked(apps: Sequence[Application],
                         socs: Sequence[SoCConfig],
                         seed: int | Sequence[int] = 0) -> StackedApps:
    """Compile one application per SoC and stack to a common shape; a
    scalar ``seed`` is shared by every lane, a sequence gives one per
    lane."""
    return _stack_compiled(_compile_lanes(apps, socs, seed), list(socs))


def padded_waste(stacked: StackedApps) -> float:
    """Fraction of the stacked steps that are padding no-ops."""
    k, s_max = stacked.schedule.acc_id.shape[:2]
    return 1.0 - sum(stacked.n_steps) / float(k * s_max)


def length_buckets(lengths: Sequence[int], max_buckets: int = 2,
                   min_gain: float = 0.05) -> list[list[int]]:
    """Partition lane indices by schedule length to cut padded steps.

    Cuts go greedily on the sorted-length prefix-waste curve: each round
    takes the single cut that removes the most padded volume and stops
    when the best cut saves less than ``min_gain`` of the single-call
    volume (``k * max(lengths)``).  Returns index groups in ascending
    length order, original index order inside each group."""
    lens = [int(l) for l in lengths]
    k = len(lens)
    single = [list(range(k))]
    if k < 2 or max_buckets < 2:
        return single
    order = sorted(range(k), key=lambda i: lens[i])
    sl = [lens[i] for i in order]
    volume = float(k * sl[-1])

    def seg_waste(a: int, b: int) -> int:
        return sl[b - 1] * (b - a) - sum(sl[a:b])

    cuts = [0, k]
    while len(cuts) - 1 < max_buckets:
        best_gain, best_cut = 0.0, None
        for a, b in zip(cuts, cuts[1:]):
            base = seg_waste(a, b)
            for c in range(a + 1, b):
                gain = (base - seg_waste(a, c) - seg_waste(c, b)) / volume
                if gain > best_gain:
                    best_gain, best_cut = gain, c
        if best_cut is None or best_gain < min_gain:
            break
        cuts = sorted(cuts + [best_cut])
    if len(cuts) == 2:
        return single
    return [sorted(order[a:b]) for a, b in zip(cuts, cuts[1:])]


def compile_apps_bucketed(
    apps: Sequence[Application], socs: Sequence[SoCConfig],
    seed: int | Sequence[int] = 0, max_buckets: int = 2,
    min_gain: float = 0.05,
) -> list[tuple[list[int], StackedApps]]:
    """:func:`compile_apps_stacked` with length bucketing: one
    ``(lane_indices, StackedApps)`` per bucket.  Run each with
    :meth:`StackedVecEnv.sublanes`; :func:`reassemble_lanes` restores lane
    order."""
    compiled = _compile_lanes(apps, socs, seed)
    groups = length_buckets([c.n_steps for c in compiled],
                            max_buckets=max_buckets, min_gain=min_gain)
    return [(g, _stack_compiled([compiled[i] for i in g],
                                [socs[i] for i in g]))
            for g in groups]


def _tree_map(fn, *trees):
    """Map over matching tuples / lists / dicts with array leaves."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (tuple, list)):
        out = [_tree_map(fn, *vs) for vs in zip(*trees)]
        return (type(first)(*out) if hasattr(first, "_fields")
                else type(first)(out))
    return fn(*trees)


def reassemble_lanes(groups: Sequence[Sequence[int]], parts: Sequence):
    """Invert bucketing: scatter per-bucket results back to lane order.

    ``parts`` holds one tree per bucket whose leaves carry that bucket's
    lanes on the leading axis (reduce per-lane metrics first: buckets pad
    to different maxima).  Returns one tree of numpy leaves with leading
    axis ``k`` in original lane order."""
    index = np.concatenate([np.asarray(list(g), int) for g in groups])
    if sorted(index.tolist()) != list(range(len(index))):
        raise ValueError(f"groups {list(map(list, groups))} do not "
                         "partition the lane range")
    inv = np.argsort(index, kind="stable")

    def scatter(*leaves):
        return np.concatenate([
            l.cpu().numpy() if torch.is_tensor(l) else np.asarray(l)
            for l in leaves])[inv]

    return _tree_map(scatter, *parts)


@dataclasses.dataclass(frozen=True)
class _LaneView:
    """One stacked lane behind the environment protocol that
    ``Policy.lower`` uses (``.params`` padded to the stacked shape,
    ``.profiles`` the lane's real ones)."""

    params: vec.LaneParams
    profiles: list
    device: torch.device

    def _sched(self, lane) -> vec.Schedule:
        return lane.schedule


@dataclasses.dataclass(frozen=True)
class _LaneSchedule:
    """A padded lane schedule (on the device) behind ``.schedule``."""

    schedule: vec.Schedule


def _lane_cfg(cfg: qlearn.QConfig, k: int) -> qlearn.QConfig:
    """Lane ``k``'s config: a ``(K,)`` ``decay_steps`` becomes lane k's."""
    if torch.is_tensor(cfg.decay_steps) or isinstance(cfg.decay_steps,
                                                      np.ndarray):
        return cfg._replace(decay_steps=int(cfg.decay_steps[k]))
    return cfg


def _join_specs(specs: Sequence[vec.PolicySpec], join) -> vec.PolicySpec:
    """Specs joined leaf by leaf along the policy axis (``join`` is
    ``torch.cat`` or ``torch.stack``); MLP fields join when present."""
    first = specs[0]
    mlp = None
    if first.mlp is not None:
        if any(sp.mlp.cfg != first.mlp.cfg for sp in specs):
            raise ValueError("cannot batch networks of different "
                             "architectures")
        mlp = socnn.MLPQState(*(join(vs) for vs in zip(
            *(sp.mlp[:4] for sp in specs))), cfg=first.mlp.cfg)
    return vec.PolicySpec(
        modes=join([sp.modes for sp in specs]),
        learned=join([sp.learned for sp in specs]),
        qstate=qlearn.QState(*(join(vs) for vs in zip(
            *(sp.qstate for sp in specs)))),
        qfun=(None if first.qfun is None
              else join([sp.qfun for sp in specs])),
        mlp=mlp)


def _cat_specs(specs: Sequence[vec.PolicySpec]) -> vec.PolicySpec:
    return _join_specs(specs, torch.cat)


def _lane_rows(spec: vec.PolicySpec, k: int) -> vec.PolicySpec:
    """Lane ``k``'s ``(N, ...)`` specs of a ``(K, N, ...)`` batch."""
    mlp = spec.mlp
    return vec.PolicySpec(
        modes=spec.modes[k], learned=spec.learned[k],
        qstate=qlearn.QState(*(v[k] for v in spec.qstate)),
        qfun=None if spec.qfun is None else spec.qfun[k],
        mlp=None if mlp is None else socnn.MLPQState(
            *(v[k] for v in mlp[:4]), cfg=mlp.cfg))


class StackedVecEnv:
    """K SoCs as one batched environment (always the gated,
    demand-cached step with presampled noise).

    Built from configs (profiles resolved from ``seed``/``flavors``, as
    :class:`~repro_torch.soc.vecenv.VecEnv` does) or from per-lane
    environments.  Every public entry point runs all its lanes in one
    kernel launch; :attr:`calls` counts the entry points used.
    ``fused_step=False`` (``None`` fuses) runs the episodes through the
    unfused plain PyTorch step lane by lane instead
    (:func:`~repro_torch.soc.vecenv.run_episodes_unfused`, bitwise the
    same); serving always runs the fused serve step."""

    def __init__(self, socs: Sequence[SoCConfig], seed: int = 0,
                 flavors: Sequence[str] | str = "mixed",
                 envs: Sequence[vec.VecEnv] | None = None,
                 cycle_time: float = 1e-8, device=None,
                 fused_step: bool | None = None):
        if envs is None:
            if isinstance(flavors, str):
                flavors = [flavors] * len(socs)
            device = resolve_device(device)
            envs = [vec.VecEnv(soc, seed=seed, flavor=fl,
                               cycle_time=cycle_time, device=device)
                    for soc, fl in zip(socs, flavors)]
        self.envs = list(envs)
        self.socs = [e.soc for e in self.envs]
        self.device = self.envs[0].device
        self.cycle_time = float(self.envs[0].cycle_time)
        n_accs = max(soc.n_accs for soc in self.socs)
        k = len(self.envs)
        feat = self.envs[0].pmat.shape[1]
        n_modes = self.envs[0].masks.shape[1]
        pmat = torch.zeros((k, n_accs, feat), dtype=torch.float32,
                           device=self.device)
        masks = torch.ones((k, n_accs, n_modes), dtype=torch.bool,
                           device=self.device)
        for i, env in enumerate(self.envs):
            pmat[i, :env.soc.n_accs] = env.pmat
            masks[i, :env.soc.n_accs] = env.masks
        static = SoCStatic(*(
            torch.tensor([float(np.float32(getattr(env.static, f)))
                          for env in self.envs], dtype=torch.float32,
                         device=self.device)
            for f in SoCStatic._fields))
        self.n_accs = n_accs
        self.fused_step = True if fused_step is None else bool(fused_step)
        self.params = vec.LaneParams(pmat=pmat, masks=masks, static=static)
        self.calls = collections.Counter()

    @property
    def n_lanes(self) -> int:
        return len(self.envs)

    def sublanes(self, lanes: Sequence[int]) -> "StackedVecEnv":
        """A stacked environment over a lane subset (sharing the per-lane
        environments) — the execution half of :func:`length_buckets`."""
        return StackedVecEnv([self.socs[i] for i in lanes],
                             envs=[self.envs[i] for i in lanes],
                             cycle_time=self.cycle_time,
                             fused_step=self.fused_step)

    def compile(self, apps: Sequence[Application],
                seed: int | Sequence[int] = 0) -> StackedApps:
        return compile_apps_stacked(apps, self.socs, seed)

    # ------------------------------------------------------------ plumbing
    def _lane_params(self, k: int) -> vec.LaneParams:
        p = self.params
        return vec.LaneParams(pmat=p.pmat[k], masks=p.masks[k],
                              static=SoCStatic(*(v[k] for v in p.static)))

    def _lane_sched(self, stacked: StackedApps, k: int) -> vec.Schedule:
        return vec.Schedule(*(v[k].to(self.device)
                              for v in stacked.schedule))

    def _rows_static(self, counts: Sequence[int]) -> SoCStatic:
        """The per-lane timing scalars repeated for each lane's rows."""
        reps = torch.as_tensor(list(counts), device=self.device)
        return SoCStatic(*(v.repeat_interleave(reps)
                           for v in self.params.static))

    def _default_keys(self, *batch) -> torch.Tensor:
        n = int(np.prod(batch))
        return prng.PRNGKey(np.arange(n), device=self.device).reshape(
            *batch, 2)

    def lane_view(self, lane: int) -> _LaneView:
        """Lane ``lane`` behind the protocol ``Policy.lower`` needs."""
        return _LaneView(params=self._lane_params(lane),
                         profiles=self.envs[lane].profiles,
                         device=self.device)

    def _episodes_lanes(self, scheds, specs, cfgs, weights, keys, *,
                        n_phases: int, n_threads: int, faults=None):
        """Lane ``k``'s ``N_k`` episodes of ``specs[k]`` on ``scheds[k]``
        for every lane, in ONE kernel launch.  ``weights`` leaves and
        ``keys`` cover the concatenated rows; ``faults`` perturbs every
        episode, its drop coins drawn over the padded length.  Returns
        per-lane lists of ``(QState, EpisodeResult)`` (``((QState,
        MLPQState), EpisodeResult)`` for MLP specs)."""
        specs = [vec._batched(spec) for spec in specs]
        if not self.fused_step:
            return self._episodes_lanes_unfused(
                scheds, specs, cfgs, weights, keys, n_phases=n_phases,
                n_threads=n_threads, faults=faults)
        xs_l, inc_l, counts = [], [], []
        row = 0
        for k, (sched, spec, cfg) in enumerate(zip(scheds, specs, cfgs)):
            n = spec.learned.shape[0]
            xs, inc = vec.episode_inputs(self._lane_params(k), sched, spec,
                                         cfg, keys[row:row + n], gated=True,
                                         faults=faults)
            xs_l.append(xs)
            inc_l.append(inc)
            counts.append(n)
            row += n
        xs = StepInputs(*(None if vs[0] is None else torch.cat(vs)
                          for vs in zip(*xs_l)))
        allspec = _cat_specs(specs)
        extrema0 = rewards.init_reward_state(self.n_accs, (row,),
                                             self.device).extrema
        # every lane's phase sums in one gather and one chain of adds: the
        # lanes share the padded S, so each index pads with the same 2S
        segs = [vec.phase_segments(sched, n_phases, n_threads)
                for sched in scheds]
        length, pad = (max(seg.shape[-1] for seg in segs),
                       2 * scheds[0].valid.shape[0])
        segments = torch.cat([
            F.pad(seg, (0, length - seg.shape[-1]), value=pad).expand(
                n, *seg.shape[:-1], length)
            for seg, n in zip(segs, counts)])
        mlp = allspec.mlp
        res = soc_step_ops.fused_episode(
            self._rows_static(counts), allspec.learned, weights,
            allspec.qstate.qtable, extrema0, xs, gated=True,
            qfun=allspec.qfun, mlp=mlp)
        qtable, ys = res[0], res[-1]
        phases = vec.phase_metrics(ys[3], ys[4], segments, n_phases=n_phases,
                                   n_threads=n_threads,
                                   cycle_time=self.cycle_time)
        out, row = [], 0
        for k, (spec, inc) in enumerate(zip(specs, inc_l)):
            sl = slice(row, row + counts[k])
            # each agent family's counter advances where it drove the episode
            mlp_inc = (0 if mlp is None
                       else torch.where(spec.qfun[:, None], inc, 0))
            qs, er = vec.episode_tail(
                spec.qstate, qtable[sl], tuple(y[sl] for y in ys),
                inc - mlp_inc, tuple(v[sl] for v in phases))
            out.append((qs, er) if mlp is None else ((qs, spec.mlp._replace(
                wpack=res[1][sl], step=spec.mlp.step + mlp_inc.sum(
                    -1, dtype=torch.int32))), er))
            row += counts[k]
        return out

    def _episodes_lanes_unfused(self, scheds, specs, cfgs, weights, keys,
                                *, n_phases: int, n_threads: int,
                                faults=None):
        """:meth:`_episodes_lanes` through the unfused step, one lane at a
        time (``specs`` already batched)."""
        out, row = [], 0
        for k, (sched, spec, cfg) in enumerate(zip(scheds, specs, cfgs)):
            n = spec.learned.shape[0]
            w = rewards.RewardWeights(*(
                v[row:row + n] if torch.is_tensor(v) and v.dim() else v
                for v in weights))
            out.append(vec.run_episodes_unfused(
                self._lane_params(k), sched, spec, cfg, w,
                keys[row:row + n], n_phases=n_phases, n_threads=n_threads,
                cycle_time=self.cycle_time, gated=True, faults=faults))
            row += n
        return out

    # ------------------------------------------------------------ lowering
    def lower(self, stacked: StackedApps, policies) -> vec.PolicySpec:
        """Lower policies onto every padded lane: ``(K, N, ...)`` specs.

        ``policies`` is one sequence of N :class:`Policy` shared by all
        lanes, or K sequences (N each) for per-lane assignments."""
        if policies and isinstance(policies[0], Policy):
            policies = [policies] * self.n_lanes
        if len(policies) != self.n_lanes:
            raise ValueError(
                f"{len(policies)} policy rows vs {self.n_lanes} lanes")
        lane_specs = []
        for k, pols in enumerate(policies):
            view = self.lane_view(k)
            lane = _LaneSchedule(schedule=self._lane_sched(stacked, k))
            lane_specs.append(vec.stack_specs(
                [pol.lower(view, lane) for pol in pols]))
        return _join_specs(lane_specs, torch.stack)

    def lower_qstates(self, stacked: StackedApps, qstates: qlearn.QState,
                      freeze: bool = True) -> vec.PolicySpec:
        """Lower a (K, B) batch of trained agents into learned specs
        (``freeze=True`` is the evaluation protocol)."""
        k, b = qstates.qtable.shape[:2]
        if freeze:
            qstates = qstates._replace(frozen=torch.ones(
                (k, b), dtype=torch.bool, device=qstates.qtable.device))
        s = stacked.schedule.acc_id.shape[-1]
        dev = qstates.qtable.device
        return vec.PolicySpec(
            modes=torch.zeros((k, b, s), dtype=torch.int32, device=dev),
            learned=torch.ones((k, b), dtype=torch.bool, device=dev),
            qstate=qstates)

    def lower_mlps(self, stacked: StackedApps, mlps: socnn.MLPQState,
                   freeze: bool = True) -> vec.PolicySpec:
        """Lower a (K, B) batch of function-approximation agents (an
        :class:`~repro_torch.soc.nn.MLPQState` with ``(K, B, ...)`` tensor
        leaves) into ``qfun`` specs with ``(K, B, ...)`` leaves; the table
        slot is a frozen placeholder per (lane, agent)."""
        k, b = mlps.wpack.shape[:2]
        dev = mlps.wpack.device
        if freeze:
            mlps = mlps._replace(frozen=torch.ones((k, b), dtype=torch.bool,
                                                   device=dev))
        s = stacked.schedule.acc_id.shape[-1]
        qs = qlearn.frozen_qstate(device=dev)
        return vec.PolicySpec(
            modes=torch.zeros((k, b, s), dtype=torch.int32, device=dev),
            learned=torch.zeros((k, b), dtype=torch.bool, device=dev),
            qstate=qlearn.QState(*(v.expand(k, b, *v.shape[1:])
                                   for v in qs)),
            qfun=torch.ones((k, b), dtype=torch.bool, device=dev),
            mlp=mlps)

    # ------------------------------------------------------------ episodes
    def episodes(self, stacked: StackedApps, specs: vec.PolicySpec,
                 cfg: qlearn.QConfig | None = None, keys=None,
                 faults=None) -> vec.EpisodeResult:
        """Every (lane, policy) episode of a ``(K, N)`` spec batch —
        heterogeneous families welcome — in ONE kernel launch; the result
        has ``(K, N, ...)`` leaves.  Keys default to ``PRNGKey(arange(K *
        N))``; one ``faults`` spec perturbs every (lane, policy) episode."""
        self.calls["episodes"] += 1
        cfg = cfg or qlearn.QConfig()
        k, n = specs.learned.shape
        keys = (keys if keys is not None
                else self._default_keys(k, n)).to(self.device)
        outs = self._episodes_lanes(
            [self._lane_sched(stacked, i) for i in range(k)],
            [_lane_rows(specs, i) for i in range(k)],
            [_lane_cfg(cfg, i) for i in range(k)],
            rewards.PAPER_DEFAULT_WEIGHTS, keys.reshape(k * n, 2),
            n_phases=stacked.n_phases, n_threads=stacked.n_threads,
            faults=faults)
        return vec.EpisodeResult(*(torch.stack(vs) for vs in zip(
            *[res for _, res in outs])))

    def baseline(self, stacked: StackedApps,
                 faults=None) -> vec.EpisodeResult:
        """Per-lane fixed NON_COH_DMA episode (``(K, ...)`` leaves) — the
        paper's normalization baseline."""
        specs = self.lower(stacked,
                           [FixedHomogeneous(CoherenceMode.NON_COH_DMA)])
        res = self.episodes(stacked, specs, faults=faults)
        return vec.EpisodeResult(*(v[:, 0] for v in res))

    # ------------------------------------------------------------- serving
    def serve(self, stacked: StackedApps, specs: vec.PolicySpec,
              traffic: traffic_mod.TrafficSpec,
              cfg: qlearn.QConfig | None = None, keys=None, faults=None,
              *, queue_cap: int = 8, n_requests: int = 1024):
        """Every (lane, policy) serving chunk of one offered stream in ONE
        kernel launch.  The traffic replicates across lanes and policies
        (identical arrival times and tenants); each lane maps the row
        draws onto its own schedule over its REAL length, so padding rows
        are never invoked; ``faults`` rows follow each lane's request
        accelerators.  Returns ``(ServeCarry, QState, ServeResult)`` with
        ``(K, N, ...)`` leaves.  MLP specs (``(K, N)`` networks) serve as
        :func:`~repro_torch.soc.vecenv.run_serve` serves them, the packs
        in the carry."""
        self.calls["serve"] += 1
        cfg = cfg or qlearn.QConfig()
        k, n = specs.learned.shape
        keys = (keys if keys is not None
                else self._default_keys(k, n)).to(self.device)
        traffic = traffic.to(self.device)
        xs_l, arrs, lane_specs, sps, carries = [], [], [], [], []
        for i in range(k):
            sched = self._lane_sched(stacked, i)
            spec = _lane_rows(specs, i)
            arr = traffic_mod.sample_arrivals(traffic, n_requests,
                                              stacked.n_steps[i])
            xs_l.append(vec.serve_inputs(self._lane_params(i), sched, spec,
                                         arr, keys[i], faults))
            arrs.append(arr)
            lane_specs.append(spec)
            qs0 = spec.qstate
            step0, frozen = vec.merged_agent(spec)
            sps.append(vec.serve_params(_lane_cfg(cfg, i), frozen, traffic))
            carries.append(soc_step_ref.init_serve_carry(
                qs0.qtable, rewards.init_reward_state(
                    self.n_accs, (n,), self.device).extrema,
                self.n_accs, stacked.n_tiles, queue_cap, step0,
                None if spec.mlp is None else spec.mlp.wpack))
        cat = lambda parts: [None if vs[0] is None else torch.cat(vs)
                             for vs in zip(*parts)]
        mlp = specs.mlp
        mlp_kw = {} if mlp is None else dict(
            qfun=specs.qfun.reshape(k * n),
            mlp=socnn.MLPQState(*(v.reshape(k * n, *v.shape[2:])
                                  for v in mlp[:4]), cfg=mlp.cfg))
        sp = soc_step_ref.ServeParams(*cat([
            soc_step_ref.serve_params_tensors(p, n, self.device)
            for p in sps]))
        lane_rows = lambda f: torch.cat([getattr(a, f).expand(n, -1)
                                         for a in arrs])
        carry, ys = soc_step_ops.fused_serve_episode(
            self._rows_static([n] * k), specs.learned.reshape(k * n),
            rewards.PAPER_DEFAULT_WEIGHTS, sp,
            soc_step_ref.ServeCarry(*cat(carries)),
            StepInputs(*(None if vs[0] is None else torch.cat(vs)
                         for vs in zip(*xs_l))),
            lane_rows("t_arr"), lane_rows("deadline"),
            lane_rows("priority"), **mlp_kw)
        outs = []
        for i in range(k):
            sl = slice(i * n, (i + 1) * n)
            c_i = carry.map(lambda v: v[sl])
            outs.append((c_i, *vec.serve_results(lane_specs[i].qstate, c_i,
                                                 ys[sl], arrs[i])))
        stack = lambda cls, j: cls(*(None if vs[0] is None
                                     else torch.stack(vs) for vs in zip(
                                         *[o[j] for o in outs])))
        return (stack(soc_step_ref.ServeCarry, 0), stack(qlearn.QState, 1),
                stack(vec.ServeResult, 2))

    # ------------------------------------------------------------ training
    def train_batched(self, stacked_iters: Sequence[StackedApps],
                      cfg: qlearn.QConfig,
                      weights_batch: rewards.RewardWeights, keys,
                      eval_stacked: StackedApps | None = None,
                      faults=None):
        """Train (K lanes x B agents), one kernel launch per iteration.

        ``stacked_iters`` holds one StackedApps per training iteration (its
        own tile seed); ``weights_batch`` has ``(B,)`` leaves, ``keys`` is
        ``(K, B, 2)``; ``cfg.decay_steps`` may be a ``(K,)`` tensor of
        per-lane horizons.  Each iteration splits every agent's key 3 ways
        (next key, training episode, evaluation episode); ``faults``
        perturbs every lane's training and evaluation episodes, iteration
        ``i`` drawing from the spec's key folded with ``i``.  Returns a
        QState with ``(K, B, ...)`` leaves and, with ``eval_stacked``,
        per-iteration ``(norm_time, norm_mem)`` histories ``(K, B,
        iterations)``."""
        self.calls["train"] += 1
        keys = keys.to(self.device)
        k, b = keys.shape[:2]
        wb = rewards.RewardWeights(*(torch.as_tensor(
            v, dtype=torch.float32, device=self.device).expand(b).repeat(k)
            for v in weights_batch))
        cfgs = [_lane_cfg(cfg, i) for i in range(k)]
        base = None
        if eval_stacked is not None:
            base = self.baseline(eval_stacked, faults=faults)
            eval_scheds = [self._lane_sched(eval_stacked, i)
                           for i in range(k)]
            pmask = eval_stacked.phase_mask.to(self.device)
        qs = [qlearn.init_qstate_batch(qlearn.QConfig(), b, self.device)
              for _ in range(k)]
        key = keys.reshape(k * b, 2)
        best = torch.full((k * b,), -float("inf"), dtype=torch.float32,
                          device=self.device)
        hist_t, hist_m = [], []
        for it, st in enumerate(stacked_iters):
            scheds = [self._lane_sched(st, i) for i in range(k)]
            ks = prng.split(key, 3)
            f_i = vec.iteration_faults(faults, it)
            outs = self._episodes_lanes(
                scheds, [vec.learned_policy_spec(q, s)
                         for q, s in zip(qs, scheds)],
                cfgs, wb, ks[:, 1], n_phases=st.n_phases,
                n_threads=st.n_threads, faults=f_i)
            new_qs, new_best = [], []
            for i, ((q, er), sched) in enumerate(zip(outs, scheds)):
                valid = sched.valid
                ep_r = (torch.where(valid, er.reward, 0.0).sum(-1)
                        / torch.clamp(valid.to(torch.float32).sum(),
                                      min=1.0))
                q, bst = qlearn.reward_watchdog(
                    cfgs[i], q, ep_r, best[i * b:(i + 1) * b])
                new_qs.append(q)
                new_best.append(bst)
            qs, best = new_qs, torch.cat(new_best)
            if eval_stacked is not None:
                evals = self._episodes_lanes(
                    eval_scheds, [vec.learned_policy_spec(qlearn.freeze(q),
                                                          s)
                                  for q, s in zip(qs, eval_scheds)],
                    cfgs, wb, ks[:, 2], n_phases=eval_stacked.n_phases,
                    n_threads=eval_stacked.n_threads, faults=f_i)
                nt, nm = zip(*[vec.normalized_metrics(
                    er, vec.EpisodeResult(*(v[i] for v in base)), pmask[i])
                    for i, (_, er) in enumerate(evals)])
                hist_t.append(torch.stack(nt))
                hist_m.append(torch.stack(nm))
            key = ks[:, 0]
        qs_all = qlearn.QState(*(torch.stack(vs) for vs in zip(*qs)))
        hist = ((torch.stack(hist_t, -1), torch.stack(hist_m, -1))
                if eval_stacked is not None else None)
        return qs_all, hist

    def evaluate_batched(self, stacked: StackedApps, qstates: qlearn.QState,
                         cfg: qlearn.QConfig, keys=None, faults=None):
        """Frozen-greedy evaluation of (K, B) agents against the per-lane
        NON_COH baseline; returns ``(norm_time, norm_mem)``, each
        ``(K, B)``."""
        base = self.baseline(stacked, faults=faults)
        res = self.episodes(stacked, self.lower_qstates(stacked, qstates),
                            cfg, keys=keys, faults=faults)
        pmask = stacked.phase_mask.to(self.device)
        nt, nm = zip(*[vec.normalized_metrics(
            vec.EpisodeResult(*(v[i] for v in res)),
            vec.EpisodeResult(*(v[i, None] for v in base)), pmask[i])
            for i in range(self.n_lanes)])
        return torch.stack(nt), torch.stack(nm)

    # ----------------------------------------------------------- host side
    def lane_phase_metrics(self, stacked: StackedApps,
                           res: vec.EpisodeResult, lane: int):
        """Lane ``lane``'s real-phase (wall time, off-chip accesses) as
        numpy arrays (leading policy axes preserved)."""
        n_ph = stacked.compiled[lane].n_phases
        pt = res.phase_time[lane][..., :n_ph].cpu().numpy()
        po = res.phase_offchip[lane][..., :n_ph].cpu().numpy()
        return pt, po
