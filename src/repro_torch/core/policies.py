"""Baseline coherence-selection policies (paper §4.3 Decide).

  * Random — uniform over available modes.
  * FixedHomogeneous — one mode for every accelerator.
  * FixedHeterogeneous — a per-accelerator design-time assignment.
  * Manual — the paper's expert heuristic (Algorithm 1).
  * QPolicy — the Cohmeleon agent (``core.qlearn``).

Every policy implements ``decide(ctx) -> CoherenceMode`` where ``ctx``
is a :class:`DecisionContext`; the discrete-event simulator
(:mod:`repro_torch.soc.des`) calls it per invocation.  Every policy also
implements ``lower(env, compiled) -> repro_torch.soc.vecenv.PolicySpec``,
the episode currency of the batched environment: fixed and manual lower
into a precomputed per-step mode table, Random and Q into a (frozen)
Q-table behind the spec's ``learned`` flag.  Stacked specs evaluate
heterogeneous policy batches in one call.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.core import qlearn
from repro_torch.core.modes import CoherenceMode, N_MODES

# Paper Alg. 1 threshold: "extra small" invocations always go fully
# coherent (their data lives comfortably in the private cache).
EXTRA_SMALL_THRESHOLD = 4 * 1024


@dataclasses.dataclass
class DecisionContext:
    """Everything a policy may look at when an invocation is about to
    start."""

    acc_id: int
    acc_name: str
    footprint: float
    state_idx: int                       # encoded Table-3 state
    active_modes: Sequence[int]          # modes of currently-active accs
    active_footprint: float              # sum of active accs' footprints
    available: Sequence[bool]            # len-4 action mask
    soc: object                          # the SoCConfig
    rng: np.random.Generator
    # Richer sensing for function-approximation policies
    # (repro_torch.soc.nn); the tabular and fixed families never read it.
    active_footprints: Sequence[float] | None = None  # per-active footprints
    target_tiles: Sequence[bool] | None = None        # this invocation's tiles
    profile: Sequence[float] | None = None            # packed AccProfile row
    warm: float = 1.0                                 # inter-stage warmth
    slack: float = 0.0                                # deadline - arrival
    reuse: float = 0.0                                # arrival - last finish

    def count(self, mode: CoherenceMode) -> int:
        return int(sum(1 for m in self.active_modes if m == mode))


class Policy:
    name = "policy"

    def decide(self, ctx: DecisionContext) -> CoherenceMode:
        raise NotImplementedError

    def observe_reward(self, ctx: DecisionContext, action: int,
                       reward: float) -> None:
        """Hook for learning policies; no-op for baselines."""

    def lower(self, env, compiled):
        """Lower this policy into a :class:`repro_torch.soc.vecenv.
        PolicySpec` on ``compiled``'s schedule (``env`` exposes
        ``.params``, ``.profiles``, ``.device``)."""
        raise NotImplementedError(
            f"policy {self.name!r} has no batched-environment lowering")


class RandomPolicy(Policy):
    name = "random"

    def decide(self, ctx: DecisionContext) -> CoherenceMode:
        opts = [i for i in range(N_MODES) if ctx.available[i]]
        return CoherenceMode(int(ctx.rng.choice(opts)))

    def lower(self, env, compiled):
        # A frozen untrained table is all ties -> uniform over available
        # modes (randomized argmax), i.e. this policy.
        from repro_torch.soc import vecenv as vec
        return vec.learned_policy_spec(
            qlearn.frozen_qstate(device=env.device), env._sched(compiled))


class FixedHomogeneous(Policy):
    def __init__(self, mode: CoherenceMode):
        self.mode = CoherenceMode(mode)
        self.name = f"fixed-{self.mode.name.lower().replace('_', '-')}"

    def decide(self, ctx: DecisionContext) -> CoherenceMode:
        if ctx.available[self.mode]:
            return self.mode
        return CoherenceMode.NON_COH_DMA  # always available fallback

    def lower(self, env, compiled):
        from repro_torch.soc import vecenv as vec
        return vec.fixed_policy_spec(env.params, env._sched(compiled),
                                     int(self.mode))


class FixedHeterogeneous(Policy):
    """Design-time per-accelerator assignment from an offline profile."""

    name = "fixed-heterogeneous"

    def __init__(self, assignment: Mapping[str, CoherenceMode]):
        self.assignment = dict(assignment)

    def decide(self, ctx: DecisionContext) -> CoherenceMode:
        mode = self.assignment.get(ctx.acc_name, CoherenceMode.NON_COH_DMA)
        if ctx.available[mode]:
            return mode
        return CoherenceMode.NON_COH_DMA

    def lower(self, env, compiled):
        from repro_torch.soc import vecenv as vec
        modes = [int(self.assignment.get(p.name, CoherenceMode.NON_COH_DMA))
                 for p in env.profiles]
        # padded stacked lanes carry more accelerator rows than profiles
        modes += [int(CoherenceMode.NON_COH_DMA)] * (
            env.params.masks.shape[0] - len(modes))
        return vec.fixed_policy_spec(env.params, env._sched(compiled),
                                     torch.tensor(modes, dtype=torch.int32))


class ManualPolicy(Policy):
    """Paper Algorithm 1 — the ESP-tuned expert heuristic, verbatim."""

    name = "manual"

    def decide(self, ctx: DecisionContext) -> CoherenceMode:
        footprint = ctx.footprint
        l2 = ctx.soc.l2_bytes
        llc = ctx.soc.llc_total_bytes
        active_coh_dma = ctx.count(CoherenceMode.COH_DMA)
        active_fully_coh = ctx.count(CoherenceMode.FULLY_COH)
        active_non_coh = ctx.count(CoherenceMode.NON_COH_DMA)

        if footprint <= EXTRA_SMALL_THRESHOLD:
            mode = CoherenceMode.FULLY_COH
        elif footprint <= l2:
            if active_coh_dma > active_fully_coh:
                mode = CoherenceMode.FULLY_COH
            else:
                mode = CoherenceMode.COH_DMA
        elif footprint + ctx.active_footprint > llc:
            mode = CoherenceMode.NON_COH_DMA
        else:
            if active_non_coh >= 2:
                mode = CoherenceMode.LLC_COH_DMA
            else:
                mode = CoherenceMode.COH_DMA

        if not ctx.available[mode]:
            return CoherenceMode.NON_COH_DMA
        return mode

    def lower(self, env, compiled):
        from repro_torch.soc import vecenv as vec
        return vec.manual_policy_spec(env.params, env._sched(compiled))


class QPolicy(Policy):
    """Cohmeleon: a (batch-of-one) Q agent behind the Policy interface.
    It decides and learns where its table lives (``device``); ``seed``
    starts the key it splits once per decision."""

    name = "cohmeleon"

    def __init__(self, cfg: qlearn.QConfig | None = None, seed: int = 0,
                 device=None):
        self.cfg = cfg or qlearn.QConfig()
        self.qs = qlearn.init_qstate(self.cfg, device)
        self._key = prng.PRNGKey(seed, device=self.qs.qtable.device)
        self._pending: dict[int, tuple[int, int]] = {}

    def decide(self, ctx: DecisionContext) -> CoherenceMode:
        dev = self.qs.qtable.device
        ks = prng.split(self._key)
        self._key, sub = ks[0], ks[1]
        action = int(qlearn.select(
            self.qs, self.cfg,
            torch.tensor([ctx.state_idx], dtype=torch.int32, device=dev),
            sub[None],
            torch.tensor(list(ctx.available), dtype=torch.bool,
                         device=dev))[0])
        self._pending[ctx.acc_id] = (ctx.state_idx, action)
        return CoherenceMode(action)

    def observe_reward(self, ctx: DecisionContext, action: int,
                       reward: float) -> None:
        state_idx, chosen = self._pending.pop(ctx.acc_id,
                                              (ctx.state_idx, action))
        dev = self.qs.qtable.device
        t = lambda v, dt: torch.tensor([v], dtype=dt, device=dev)
        self.qs = qlearn.update(self.qs, self.cfg, t(state_idx, torch.int32),
                                t(chosen, torch.int32),
                                t(reward, torch.float32))

    def freeze(self) -> None:
        self.qs = qlearn.freeze(self.qs)

    def lower(self, env, compiled):
        """Frozen-greedy lowering (the evaluation protocol)."""
        from repro_torch.soc import vecenv as vec
        qs = qlearn.QState(*(v.to(env.device) for v in self.qs))
        return vec.learned_policy_spec(qlearn.freeze(qs),
                                       env._sched(compiled))


def all_fixed_policies() -> list[Policy]:
    return [FixedHomogeneous(m) for m in CoherenceMode]
