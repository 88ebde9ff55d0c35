"""Runtime orchestration glue + experiment drivers (paper §4.1, §5, §6).

``sense -> decide -> actuate -> evaluate`` runs inside the simulators'
invocation paths (:mod:`repro_torch.soc.des` is the fidelity path,
:mod:`repro_torch.soc.vecenv` the scale path); this module holds the
experiment-level drivers of the benchmarks and tests:

  * the profiling-based Fixed-Heterogeneous assignment (design-time
    baseline), through either backend;
  * Cohmeleon online training — serial on the event-driven simulator
    (:func:`train_cohmeleon`) and batched over (reward weights x seeds)
    (:func:`train_cohmeleon_batched`), per the paper's Experimental
    Setup;
  * the policy comparison harness: per-phase metrics normalized to Fixed
    non-coherent DMA (the paper's normalization), routable through either
    backend, and the per-size-class mode breakdown (Fig. 7).

A :class:`~repro_torch.soc.des.SoCSimulator` as first argument defaults
to the event-driven backend (``backend="des"``); a
:class:`~repro_torch.soc.vecenv.VecEnv` or an SoC configuration runs the
batched one.
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
from repro_torch.soc.des import (Application, Invocation, InvocationRecord,
                                 Phase, PhaseResult, RunResult, SoCSimulator,
                                 Thread)


def _isolated_app(acc_id: int, footprint: float) -> Application:
    return Application(
        name="isolated",
        phases=[Phase(name="only",
                      threads=[Thread(chain=[Invocation(acc_id, footprint)])])])


def _vecenv_for(sim: SoCSimulator, env: vec.VecEnv | None = None
                ) -> vec.VecEnv:
    """The simulator's memoized scale-path twin (``env`` if given)."""
    if env is not None:
        return env
    env = getattr(sim, "_vecenv", None)
    if env is None:
        env = vec.VecEnv.from_simulator(sim)
        sim._vecenv = env
    return env


def _backend(target, backend: str | None) -> str:
    """``backend`` checked against the first argument: a simulator
    defaults to ``"des"``; a VecEnv or an SoC configuration has only the
    batched backend."""
    if isinstance(target, SoCSimulator):
        backend = backend or "des"
    elif backend in (None, "vecenv"):
        backend = "vecenv"
    else:
        raise ValueError(f"backend {backend!r} needs a SoCSimulator, not "
                         f"{type(target).__name__}")
    if backend not in ("des", "vecenv"):
        raise ValueError(f"unknown backend {backend!r}")
    return backend


def run_isolated(sim: SoCSimulator, acc_id: int, mode: CoherenceMode,
                 footprint: float, seed: int = 0) -> RunResult:
    """One accelerator alone, one invocation (paper Fig. 2 cell)."""
    return sim.run(_isolated_app(acc_id, footprint), FixedHomogeneous(mode),
                   seed=seed, train=False)


def _isolated_times_vecenv(env: vec.VecEnv, acc_id: int, footprints,
                           seed: int) -> np.ndarray:
    """``(len(footprints), N_MODES)`` total times of one accelerator alone,
    the four modes of a footprint in ONE batched episode call (fixed
    policies are deterministic, so this equals one call per mode)."""
    times = np.zeros((len(footprints), N_MODES))
    for i, fp in enumerate(footprints):
        compiled = vec.compile_app(_isolated_app(acc_id, fp), env.soc,
                                   seed=seed)
        sched = env._sched(compiled)
        specs = vec.stack_specs([vec.fixed_policy_spec(
            env.params, sched, int(m)) for m in CoherenceMode])
        res = env.episodes(compiled, specs)
        times[i] = res.phase_time.sum(-1).cpu().numpy()
    return times


def profile_fixed_heterogeneous(
    sim: SoCSimulator | vec.VecEnv,
    footprints: Sequence[float] = (WORKLOAD_SMALL, WORKLOAD_MEDIUM,
                                   WORKLOAD_LARGE),
    seed: int = 0,
    backend: str | None = None,
    env: vec.VecEnv | None = None,
) -> FixedHeterogeneous:
    """Design-time per-accelerator profiling (paper §4.3 Decide): each
    accelerator alone, over the workload footprints, in every mode; the
    mode with the best mean time normalized to NON_COH wins.

    ``backend="des"`` (a simulator's default) runs each probe through the
    event-driven simulator; ``"vecenv"`` times the same one-invocation
    applications through the batched environment (the simulator's twin,
    ``env``, or ``sim`` itself when it is a VecEnv) — identical results,
    single-thread apps being exact across paths."""
    backend = _backend(sim, backend)
    if backend == "vecenv":
        env = sim if isinstance(sim, vec.VecEnv) else _vecenv_for(sim, env)
        times_of = lambda acc_id: _isolated_times_vecenv(env, acc_id,
                                                         footprints, seed)
        profiles, masks = env.profiles, env.masks.cpu().numpy()
    else:
        def times_of(acc_id):
            return np.asarray([[run_isolated(sim, acc_id, mode, fp,
                                             seed=seed).total_time
                                if mode == CoherenceMode.NON_COH_DMA
                                or sim.masks[acc_id][mode] else np.nan
                                for mode in CoherenceMode]
                               for fp in footprints])
        profiles, masks = sim.profiles, sim.masks

    assignment = {}
    for acc_id, prof in enumerate(profiles):
        if prof.name in assignment:
            continue
        times = times_of(acc_id)
        scores = np.zeros(N_MODES)
        for mode in CoherenceMode:
            if not masks[acc_id][mode]:
                scores[mode] = np.inf
                continue
            scores[mode] = float(np.mean([
                float(times[i, mode]) / max(float(times[i, 0]), 1e-30)
                for i in range(len(footprints))]))
        assignment[prof.name] = CoherenceMode(int(np.argmin(scores)))
    return FixedHeterogeneous(assignment)


def standard_policy_suite(sim: SoCSimulator | vec.VecEnv,
                          include_profiled: bool = True,
                          backend: str | None = None) -> list[Policy]:
    """The paper's comparison set: the 4 fixed-homogeneous policies, the
    profiled heterogeneous one, random and manual (Cohmeleon is trained
    separately); ``backend`` selects the profiling sweep's path."""
    suite: list[Policy] = [FixedHomogeneous(m) for m in CoherenceMode]
    if include_profiled:
        suite.append(profile_fixed_heterogeneous(sim, backend=backend))
    suite.append(RandomPolicy())
    suite.append(ManualPolicy())
    return suite


@dataclasses.dataclass
class TrainHistory:
    iteration: list[int]
    exec_time: list[float]
    offchip: list[float]


def train_cohmeleon(
    sim: SoCSimulator,
    iterations: int = 10,
    seed: int = 0,
    weights: RewardWeights | None = None,
    eval_each_iteration: bool = False,
    n_phases: int = 8,
) -> tuple[QPolicy, TrainHistory]:
    """Online training per the paper's Experimental Setup, on the
    event-driven simulator: train on a randomly configured application
    instance (run seed ``seed + it`` in iteration ``it``) with epsilon and
    alpha decaying linearly to zero over the iterations; optionally
    evaluate a frozen copy after every iteration on a *different* instance
    against the NON_COH baseline (the Fig. 8 protocol).  The agent lives
    on the simulator's device."""
    train_app = make_application(sim.soc, seed=seed, n_phases=n_phases)
    test_app = make_application(sim.soc, seed=seed + 1000, n_phases=n_phases)
    invocations_per_iter = sum(
        len(th.chain) * th.loops for ph in train_app.phases
        for th in ph.threads)
    cfg = qlearn.QConfig(decay_steps=max(invocations_per_iter * iterations, 1))
    policy = QPolicy(cfg, seed=seed, device=sim.device)

    hist = TrainHistory(iteration=[], exec_time=[], offchip=[])
    base = None
    for it in range(iterations):
        sim.run(train_app, policy, seed=seed + it, train=True,
                weights=weights)
        if eval_each_iteration:
            if base is None:
                base = sim.run(test_app, FixedHomogeneous(
                    CoherenceMode.NON_COH_DMA), seed=77, train=False)
            frozen = QPolicy(cfg, seed=123, device=sim.device)
            frozen.qs = qlearn.freeze(policy.qs)
            res = sim.run(test_app, frozen, seed=77, train=False)
            hist.iteration.append(it + 1)
            hist.exec_time.append(_geomean_ratio(res, base, "time"))
            hist.offchip.append(_geomean_ratio(res, base, "mem"))
    policy.freeze()
    return policy, hist


def _geomean_ratio(res: RunResult, base: RunResult, what: str) -> float:
    vals = []
    for p, b in zip(res.phases, base.phases):
        if what == "time":
            vals.append(p.wall_time / max(b.wall_time, 1e-30))
        else:
            vals.append((p.offchip_accesses + 1.0)
                        / max(b.offchip_accesses + 1.0, 1e-30))
    return float(np.exp(np.mean(np.log(np.maximum(vals, 1e-12)))))


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
        """Agent ``i`` as a frozen QPolicy (key seed ``i``; it drops into
        the event-driven simulator too)."""
        pol = QPolicy(self.cfg, seed=i, device=self.env.device)
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
    soc: SoCConfig | SoCSimulator,
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
    agent of an iteration in one kernel launch.  ``soc`` may be a
    simulator, whose twin VecEnv (:func:`_vecenv_for`) then runs."""
    if isinstance(soc, SoCSimulator):
        env = _vecenv_for(soc, env)
        soc = soc.soc
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
    ``raw`` holds each policy's :class:`~repro_torch.soc.des.RunResult`,
    the baseline's included."""

    policies: list[str]
    norm_time: dict[str, list[float]]
    norm_mem: dict[str, list[float]]
    raw: dict[str, RunResult]

    def geomean(self, policy: str) -> tuple[float, float]:
        t = np.exp(np.mean(np.log(np.maximum(self.norm_time[policy], 1e-12))))
        m = np.exp(np.mean(np.log(np.maximum(self.norm_mem[policy], 1e-12))))
        return float(t), float(m)


def episode_to_runresult(env: vec.VecEnv, compiled: vec.CompiledApp,
                         res: vec.EpisodeResult, policy_name: str
                         ) -> RunResult:
    """Lift one batched episode's traces into the simulator's RunResult
    shape, so every downstream consumer (``mode_breakdown``, the
    reports) reads both backends alike.  Each thread's invocations run
    back to back from its phase's start; the attributed off-chip count is
    the true one; the decide overhead is 0 (decisions happen inside the
    episode step)."""
    sched = compiled.schedule
    acc_id = sched.acc_id.numpy()
    footprint = sched.footprint.numpy()
    thread = sched.thread.numpy()
    phase_id = sched.phase_id.numpy()
    host = lambda v, dt=None: (v.cpu().numpy() if dt is None
                               else v.cpu().numpy().astype(dt))
    mode, state_idx = host(res.mode), host(res.state_idx)
    exec_c = host(res.exec_time, np.float64)
    off = host(res.offchip, np.float64)
    rew = host(res.reward, np.float64)
    phase_time = host(res.phase_time, np.float64)
    phase_off = host(res.phase_offchip, np.float64)

    cursor = np.zeros((compiled.n_phases, compiled.n_threads))
    phases: list[PhaseResult] = [
        PhaseResult(name=compiled.phase_names[p], wall_time=phase_time[p],
                    offchip_accesses=phase_off[p], invocations=[])
        for p in range(compiled.n_phases)
    ]
    for i in range(len(acc_id)):
        p, t = int(phase_id[i]), int(thread[i])
        start = cursor[p, t]
        end = start + exec_c[i] * env.cycle_time
        cursor[p, t] = end
        phases[p].invocations.append(InvocationRecord(
            acc_id=int(acc_id[i]),
            acc_name=env.profiles[int(acc_id[i])].name,
            footprint=float(footprint[i]), mode=int(mode[i]),
            state_idx=int(state_idx[i]), start=start, end=end,
            exec_time=float(exec_c[i]), offchip_true=float(off[i]),
            offchip_attr=float(off[i]), reward=float(rew[i])))
    return RunResult(policy=policy_name, phases=phases,
                     decide_overhead_s=0.0)


def compare_policies(sim: SoCSimulator | vec.VecEnv | SoCConfig,
                     app: Application, policies: Sequence[Policy],
                     seed: int = 0, backend: str | None = None,
                     env: vec.VecEnv | None = None, profile_seed: int = 0,
                     device=None) -> Comparison:
    """Run each policy on ``app`` and normalize per phase to NON_COH fixed.

    ``backend="des"`` (a simulator's default) replays each policy through
    the event-driven simulator, one run each.  ``backend="vecenv"``
    lowers every policy (``Policy.lower``) into a PolicySpec, stacks the
    specs — heterogeneous families included — behind the NON_COH baseline
    and replays them as ONE batched episode call (keys ``PRNGKey(arange(N)
    + seed)``); it runs on the simulator's twin VecEnv (or ``env``), on
    ``sim`` itself when it is a VecEnv, or on a VecEnv built from an
    SoCConfig with ``profile_seed`` on ``device``.  Same Comparison shape
    either way."""
    backend = _backend(sim, backend)
    base_policy = FixedHomogeneous(CoherenceMode.NON_COH_DMA)
    all_pols = [base_policy] + list(policies)
    if backend == "des":
        runs = [sim.run(app, pol, seed=seed, train=False)
                for pol in all_pols]
    else:
        if isinstance(sim, SoCConfig):
            env = vec.VecEnv(sim, seed=profile_seed, device=device)
        elif isinstance(sim, vec.VecEnv):
            env = sim
        else:
            env = _vecenv_for(sim, env)
        compiled = vec.compile_app(app, env.soc, seed=seed)
        specs = vec.stack_specs([pol.lower(env, compiled)
                                 for pol in all_pols])
        keys = prng.PRNGKey(np.arange(len(all_pols)) + seed)
        res = env.episodes(compiled, specs, keys=keys)
        runs = [episode_to_runresult(env, compiled, res.index(i), pol.name)
                for i, pol in enumerate(all_pols)]

    base = runs[0]
    out = Comparison(policies=[], norm_time={}, norm_mem={}, raw={})
    out.raw[base_policy.name] = base
    for pol, res in zip(policies, runs[1:]):
        nt, nm = [], []
        for p, b in zip(res.phases, base.phases):
            nt.append(p.wall_time / max(b.wall_time, 1e-30))
            nm.append((p.offchip_accesses + 1.0)
                      / max(b.offchip_accesses + 1.0, 1e-30))
        out.policies.append(pol.name)
        out.norm_time[pol.name] = nt
        out.norm_mem[pol.name] = nm
        out.raw[pol.name] = res
    return out


def mode_breakdown(res: RunResult, soc) -> dict[str, np.ndarray]:
    """Fraction of invocations per mode, total and per size class
    (Fig. 7)."""
    def size_class(fp: float) -> str:
        if fp <= soc.l2_bytes:
            return "S"
        if fp <= soc.llc_slice_bytes:
            return "M"
        if fp <= soc.llc_total_bytes:
            return "L"
        return "XL"

    buckets: dict[str, np.ndarray] = {
        k: np.zeros(N_MODES) for k in ("total", "S", "M", "L", "XL")}
    for ph in res.phases:
        for r in ph.invocations:
            buckets["total"][r.mode] += 1
            buckets[size_class(r.footprint)][r.mode] += 1
    for k, v in buckets.items():
        s = v.sum()
        if s > 0:
            buckets[k] = v / s
    return buckets
