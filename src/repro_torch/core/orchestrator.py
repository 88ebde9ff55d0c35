"""Experiment drivers on the batched environment (paper §5, §6).

  * :func:`train_cohmeleon_batched` — Cohmeleon online training, every
    (reward weighting x seed) agent in one batched call per iteration,
    per the paper's Experimental Setup;
  * :class:`BatchedTrainResult` — frozen-greedy evaluation of the trained
    agents against the Fixed NON_COH baseline;
  * :func:`compare_policies` — a whole policy suite plus the NON_COH
    baseline replayed as ONE batched episode call, normalized per phase;
  * :func:`profile_fixed_heterogeneous` / :func:`standard_policy_suite` —
    the design-time per-accelerator baseline and the paper's comparison
    set.

The discrete-event backend of the reference waits for the simulator's
port; these drivers take a :class:`~repro_torch.soc.vecenv.VecEnv` (or an
SoC configuration plus profile seed).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch import random as prng
from repro_torch.core import qlearn, rewards
from repro_torch.core.modes import CoherenceMode, N_MODES
from repro_torch.core.policies import (FixedHeterogeneous, FixedHomogeneous,
                                       ManualPolicy, Policy, QPolicy,
                                       RandomPolicy)
from repro_torch.core.rewards import RewardWeights
from repro_torch.soc import vecenv as vec
from repro_torch.soc.apps import make_application
from repro_torch.soc.config import (SoCConfig, WORKLOAD_LARGE,
                                    WORKLOAD_MEDIUM, WORKLOAD_SMALL)
from repro_torch.soc.des import Application, Invocation, Phase, Thread


def _isolated_app(acc_id: int, footprint: float) -> Application:
    return Application(
        name="isolated",
        phases=[Phase(name="only",
                      threads=[Thread(chain=[Invocation(acc_id, footprint)])])])


def profile_fixed_heterogeneous(
    env: vec.VecEnv,
    footprints: Sequence[float] = (WORKLOAD_SMALL, WORKLOAD_MEDIUM,
                                   WORKLOAD_LARGE),
    seed: int = 0,
) -> FixedHeterogeneous:
    """Design-time per-accelerator profiling (paper §4.3 Decide): each
    accelerator alone, over the workload footprints, in every mode; the
    mode with the best mean time normalized to NON_COH wins.

    The four modes of one (accelerator, footprint) probe run as ONE
    batched episode call (fixed policies are deterministic, so this equals
    the reference's one call per mode).  This is the reference's
    ``backend="vecenv"``; the discrete-event backend waits for ROADMAP
    A8."""
    assignment = {}
    for acc_id, prof in enumerate(env.profiles):
        if prof.name in assignment:
            continue
        times = np.zeros((len(footprints), N_MODES))
        for i, fp in enumerate(footprints):
            compiled = vec.compile_app(_isolated_app(acc_id, fp), env.soc,
                                       seed=seed)
            sched = env._sched(compiled)
            specs = vec.stack_specs([vec.fixed_policy_spec(
                env.params, sched, int(m)) for m in CoherenceMode])
            res = env.episodes(compiled, specs)
            times[i] = res.phase_time.sum(-1).cpu().numpy()
        masks = env.masks[acc_id].cpu().numpy()
        scores = np.zeros(N_MODES)
        for mode in CoherenceMode:
            if not masks[mode]:
                scores[mode] = np.inf
                continue
            scores[mode] = float(np.mean([
                float(times[i, mode]) / max(float(times[i, 0]), 1e-30)
                for i in range(len(footprints))]))
        assignment[prof.name] = CoherenceMode(int(np.argmin(scores)))
    return FixedHeterogeneous(assignment)


def standard_policy_suite(env: vec.VecEnv,
                          include_profiled: bool = True) -> list[Policy]:
    """The paper's comparison set: the 4 fixed-homogeneous policies, the
    profiled heterogeneous one, random and manual (Cohmeleon is trained
    separately)."""
    suite: list[Policy] = [FixedHomogeneous(m) for m in CoherenceMode]
    if include_profiled:
        suite.append(profile_fixed_heterogeneous(env))
    suite.append(RandomPolicy())
    suite.append(ManualPolicy())
    return suite


@dataclasses.dataclass
class BatchedTrainResult:
    """Output of one batched training call over B = |weights| x seeds
    agents.  ``qstates`` leaves carry the batch axis; agent ``i`` trained
    with ``weights[i // n_seeds]``."""

    env: vec.VecEnv
    cfg: qlearn.QConfig
    qstates: qlearn.QState
    weights: list[RewardWeights]
    n_seeds: int
    hist_time: np.ndarray | None    # (B, iterations) or None
    hist_mem: np.ndarray | None
    train_app: Application
    test_app: Application

    @property
    def n_agents(self) -> int:
        return len(self.weights) * self.n_seeds

    def qpolicy(self, i: int) -> QPolicy:
        """Agent ``i`` as a frozen QPolicy."""
        pol = QPolicy(self.cfg, device=self.env.device)
        pol.qs = qlearn.freeze(qlearn.index_qstate(self.qstates, i))
        return pol

    def evaluate(self, app: Application | None = None, seed: int = 5,
                 key_seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """Frozen-greedy batched evaluation on ``app`` (default: the
        held-out test instance); returns (norm_time, norm_mem) of shape
        (B,)."""
        compiled = vec.compile_app(app or self.test_app, self.env.soc,
                                   seed=seed)
        keys = prng.PRNGKey(np.arange(self.n_agents) + key_seed)
        nt, nm = self.env.evaluate_batched(compiled, self.qstates, self.cfg,
                                           keys)
        return nt.cpu().numpy(), nm.cpu().numpy()

    def per_weight(self, values: np.ndarray) -> np.ndarray:
        """Reduce a (B,) metric to (|weights|,) by averaging over seeds."""
        return np.asarray(values).reshape(len(self.weights),
                                          self.n_seeds).mean(axis=1)


def train_cohmeleon_batched(
    soc: SoCConfig,
    iterations: int = 10,
    seed: int = 0,
    weights: Sequence | None = None,
    n_seeds: int = 1,
    n_phases: int = 8,
    eval_each_iteration: bool = False,
    env: vec.VecEnv | None = None,
    device=None,
) -> BatchedTrainResult:
    """Train one agent per (reward weighting x seed) on a randomly
    configured instance with per-iteration tile seeds, to be evaluated
    frozen on a different instance — the reference protocol, with every
    agent of an iteration in one kernel launch."""
    env = env or vec.VecEnv(soc, device=device)
    train_app = make_application(soc, seed=seed, n_phases=n_phases)
    test_app = make_application(soc, seed=seed + 1000, n_phases=n_phases)
    train_compiled = [vec.compile_app(train_app, soc, seed=seed + it)
                      for it in range(iterations)]
    test_compiled = vec.compile_app(test_app, soc, seed=77)
    cfg = qlearn.QConfig(
        decay_steps=max(train_compiled[0].n_steps * iterations, 1))

    wlist = [rewards.as_weights(w) for w in
             (weights if weights is not None
              else [rewards.PAPER_DEFAULT_WEIGHTS])]
    grid = [(w, s) for w in wlist for s in range(n_seeds)]
    wb = rewards.stack_weights([w for w, _ in grid])
    keys = prng.PRNGKey(np.asarray([seed + 100003 * s for _, s in grid],
                                   np.uint32))
    qs, hist = env.train_batched(
        train_compiled, cfg, wb, keys,
        eval_app=test_compiled if eval_each_iteration else None)
    ht, hm = ((hist[0].cpu().numpy(), hist[1].cpu().numpy())
              if hist is not None else (None, None))
    return BatchedTrainResult(
        env=env, cfg=cfg, qstates=qs, weights=wlist, n_seeds=n_seeds,
        hist_time=ht, hist_mem=hm, train_app=train_app, test_app=test_app)


@dataclasses.dataclass
class Comparison:
    """Per-policy, per-phase metrics normalized to fixed non-coherent DMA;
    ``raw`` holds each policy's :class:`~repro_torch.soc.vecenv.
    EpisodeResult`, the baseline's included."""

    policies: list[str]
    norm_time: dict[str, list[float]]
    norm_mem: dict[str, list[float]]
    raw: dict[str, vec.EpisodeResult]

    def geomean(self, policy: str) -> tuple[float, float]:
        t = np.exp(np.mean(np.log(np.maximum(self.norm_time[policy], 1e-12))))
        m = np.exp(np.mean(np.log(np.maximum(self.norm_mem[policy], 1e-12))))
        return float(t), float(m)


def compare_policies(env: vec.VecEnv | SoCConfig, app: Application,
                     policies: Sequence[Policy], seed: int = 0,
                     profile_seed: int = 0, device=None) -> Comparison:
    """Run each policy on ``app`` and normalize per phase to NON_COH fixed.

    Every policy lowers (``Policy.lower``) into a PolicySpec; the specs —
    heterogeneous families included — are stacked behind the NON_COH
    baseline and replayed as ONE batched episode call (keys
    ``PRNGKey(arange(N) + seed)``), as the reference's vecenv backend
    does.  ``env`` may be an SoCConfig, built into a VecEnv with
    ``profile_seed`` on ``device``."""
    if isinstance(env, SoCConfig):
        env = vec.VecEnv(env, seed=profile_seed, device=device)
    base_policy = FixedHomogeneous(CoherenceMode.NON_COH_DMA)
    all_pols = [base_policy] + list(policies)
    compiled = vec.compile_app(app, env.soc, seed=seed)
    specs = vec.stack_specs([pol.lower(env, compiled) for pol in all_pols])
    keys = prng.PRNGKey(np.arange(len(all_pols)) + seed)
    res = env.episodes(compiled, specs, keys=keys)
    pt = res.phase_time.cpu().numpy().astype(np.float64)
    po = res.phase_offchip.cpu().numpy().astype(np.float64)

    out = Comparison(policies=[], norm_time={}, norm_mem={}, raw={})
    out.raw[base_policy.name] = res.index(0)
    for i, pol in enumerate(all_pols[1:], start=1):
        out.policies.append(pol.name)
        out.norm_time[pol.name] = [
            p / max(b, 1e-30) for p, b in zip(pt[i], pt[0])]
        out.norm_mem[pol.name] = [
            (p + 1.0) / max(b + 1.0, 1e-30) for p, b in zip(po[i], po[0])]
        out.raw[pol.name] = res.index(i)
    return out
