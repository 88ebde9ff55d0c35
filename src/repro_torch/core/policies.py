"""Baseline coherence-selection policies (paper §4.3 Decide).

  * Random — uniform over available modes.
  * FixedHomogeneous — one mode for every accelerator.
  * FixedHeterogeneous — a per-accelerator design-time assignment.
  * Manual — the paper's expert heuristic (Algorithm 1).
  * QPolicy — the Cohmeleon agent (``core.qlearn``).

Every policy implements ``lower(env, compiled) ->
repro_torch.soc.vecenv.PolicySpec``, the episode currency of the batched
environment: fixed and manual lower into a precomputed per-step mode
table, Random and Q into a (frozen) Q-table behind the spec's ``learned``
flag.  Stacked specs evaluate heterogeneous policy batches in one call.
The per-invocation ``decide`` of the discrete-event simulator is not
ported yet.
"""
from __future__ import annotations

from typing import Mapping

import torch

from repro_torch.core import qlearn
from repro_torch.core.modes import CoherenceMode

# Paper Alg. 1 threshold: "extra small" invocations always go fully
# coherent (their data lives comfortably in the private cache).
EXTRA_SMALL_THRESHOLD = 4 * 1024


class Policy:
    name = "policy"

    def lower(self, env, compiled):
        """Lower this policy into a :class:`repro_torch.soc.vecenv.
        PolicySpec` on ``compiled``'s schedule (``env`` exposes
        ``.params``, ``.profiles``, ``.device``)."""
        raise NotImplementedError(
            f"policy {self.name!r} has no batched-environment lowering")


class RandomPolicy(Policy):
    name = "random"

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

    def lower(self, env, compiled):
        from repro_torch.soc import vecenv as vec
        return vec.fixed_policy_spec(env.params, env._sched(compiled),
                                     int(self.mode))


class FixedHeterogeneous(Policy):
    """Design-time per-accelerator assignment from an offline profile."""

    name = "fixed-heterogeneous"

    def __init__(self, assignment: Mapping[str, CoherenceMode]):
        self.assignment = dict(assignment)

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
    """Paper Algorithm 1 — the ESP-tuned expert heuristic."""

    name = "manual"

    def lower(self, env, compiled):
        from repro_torch.soc import vecenv as vec
        return vec.manual_policy_spec(env.params, env._sched(compiled))


class QPolicy(Policy):
    """Cohmeleon: a (batch-of-one) Q agent behind the Policy interface."""

    name = "cohmeleon"

    def __init__(self, cfg: qlearn.QConfig | None = None, device=None):
        self.cfg = cfg or qlearn.QConfig()
        self.qs = qlearn.init_qstate(self.cfg, device)

    def freeze(self) -> None:
        self.qs = qlearn.freeze(self.qs)

    def lower(self, env, compiled):
        """Frozen-greedy lowering (the evaluation protocol)."""
        from repro_torch.soc import vecenv as vec
        qs = qlearn.QState(*(v.to(env.device) for v in self.qs))
        return vec.learned_policy_spec(qlearn.freeze(qs),
                                       env._sched(compiled))
