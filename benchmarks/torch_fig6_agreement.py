"""The port's full-width Fig. 6 sweep against the JAX reference.

    PYTHONPATH=src python -m benchmarks.torch_fig6_agreement \
        [--chip-log chip_smoke.out] [--trace-weighting 0.2/0.2/0.6] \
        [--no-fma]

Runs the reference (``repro``, on the CPU) at the width ``chip_smoke.py``
drives — 15 weightings x 8 seeds, 10 iterations of the 540-step training
app, evaluation on the seed-900 app with tile seed 5, the 7-policy
comparison — and prints its per-weighting (norm_time, norm_mem) and suite
geomeans.  With ``--chip-log`` (the saved standard output of
``chip_smoke.py``) it prints the port's numbers beside them and the
largest gap.  With ``--trace-weighting`` it trains that weighting's 8
agents in both packages on the CPU, iteration by iteration, and reports
the first (iteration, agent, step) where their mode or state traces part,
and checks how the jitted reference rounds ``a*b + c`` (one rounding, as
a fused multiply-add, or two, as the port's separate operations).
``--no-fma`` compiles the reference for an ISA without fused multiply-add
(``XLA_FLAGS=--xla_cpu_max_isa=AVX``), so it too rounds each operation
(ROADMAP C1).
"""
from __future__ import annotations

import argparse
import re
import sys

from benchmarks.torch_no_fma import use_reference_without_fma

if "--no-fma" in sys.argv:    # before jax is imported below
    use_reference_without_fma()

import jax
import jax.numpy as jnp
import numpy as np
import torch

from benchmarks.fig6_reward_dse import WEIGHTS
from repro.core import qlearn as jq, rewards as jr
from repro.core.modes import CoherenceMode
from repro.core.orchestrator import compare_policies, train_cohmeleon_batched
from repro.core import policies as jpol
from repro.soc import apps as japps, config as jcfg, vecenv as jvec
from repro.soc.des import SoCSimulator
from repro_torch import random as prng
from repro_torch.core import qlearn as tq, rewards as tr
from repro_torch.soc import apps as tapps, config as tcfg, vecenv as tvec

N_SEEDS, ITERS, N_PHASES, SEED = 8, 10, 6, 11


def reference_points():
    soc = jcfg.SOC_MOTIV_PAR
    res = train_cohmeleon_batched(soc, iterations=ITERS, seed=SEED,
                                  weights=WEIGHTS, n_seeds=N_SEEDS,
                                  n_phases=N_PHASES)
    test_app = japps.make_application(soc, seed=900, n_phases=N_PHASES)
    nt, nm = res.evaluate(test_app, seed=5)
    points = {f"{x}/{y}/{z}": (float(t), float(m)) for (x, y, z), t, m in
              zip(WEIGHTS, res.per_weight(nt), res.per_weight(nm))}
    suite = ([jpol.FixedHomogeneous(m) for m in CoherenceMode]
             + [jpol.RandomPolicy(), jpol.ManualPolicy(), res.qpolicy(0)])
    cmp = compare_policies(SoCSimulator(soc), test_app, suite, seed=5,
                           backend="vecenv", env=res.env)
    return points, {n: cmp.geomean(n) for n in cmp.policies}


def chip_points(path):
    text = open(path).read()
    pat = r"{} (\S+): norm_time=(\S+) norm_mem=(\S+)"
    get = lambda tag: {k: (float(t), float(m))
                       for k, t, m in re.findall(pat.format(tag), text)}
    return get("fig6 point"), get("suite")


def trace_weighting(w):
    """First (iteration, agent, step) where the two packages' traces part
    for weighting ``w``'s agents, both trained on the CPU."""
    jsoc, tsoc = jcfg.SOC_MOTIV_PAR, tcfg.SOC_MOTIV_PAR
    japp = japps.make_application(jsoc, seed=SEED, n_phases=N_PHASES)
    tapp = tapps.make_application(tsoc, seed=SEED, n_phases=N_PHASES)
    jenv, tenv = jvec.VecEnv(jsoc), tvec.VecEnv(tsoc, device="cpu")
    jcs = [jvec.compile_app(japp, jsoc, seed=SEED + i) for i in range(ITERS)]
    tcs = [tvec.compile_app(tapp, tsoc, seed=SEED + i) for i in range(ITERS)]
    cfg_j = jq.QConfig(decay_steps=jcs[0].n_steps * ITERS)
    cfg_t = tq.QConfig(decay_steps=tcs[0].n_steps * ITERS)
    seeds = np.asarray([SEED + 100003 * s for s in range(N_SEEDS)],
                       np.uint32)
    jkeys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds))
    tkeys = prng.PRNGKey(seeds)
    ep_fn = jenv._episode_fn(jcs[0].n_phases, jcs[0].n_threads)
    ep = jax.jit(jax.vmap(
        lambda sched, qs, key: ep_fn(sched, jvec.learned_policy_spec(
            qs, sched), cfg_j, jr.RewardWeights(*w), key),
        in_axes=(None, 0, 0)))
    jqs = jq.init_qstate_batch(cfg_j, N_SEEDS)
    tqs = tq.init_qstate_batch(cfg_t, N_SEEDS)
    wt = tr.RewardWeights(*(torch.full((N_SEEDS,), v) for v in w))
    for it in range(ITERS):
        jk = jax.vmap(lambda k: jax.random.split(k, 3))(jkeys)
        tk = prng.split(tkeys, 3)
        jrow, trow = jqs.qtable, tqs.qtable
        jqs, jres = ep(jcs[it].schedule, jqs, jk[:, 1])
        tqs, tres = tenv._run(tcs[it], tcs[it].schedule,
                              tvec.learned_policy_spec(tqs, tcs[it].schedule),
                              cfg_t, wt, tk[:, 1])
        jkeys, tkeys = jk[:, 0], tk[:, 0]
        ulp = {n: int((np.asarray(getattr(jres, n))
                       != getattr(tres, n).numpy()).sum())
               for n in ("exec_time", "offchip", "reward")}
        for name in ("mode", "state_idx"):
            a = np.asarray(getattr(jres, name))
            b = getattr(tres, name).numpy()
            if (a != b).any():
                ag, st = np.argwhere(a != b)[0]
                s_idx = int(np.asarray(jres.state_idx)[ag, st])
                print(f"iteration {it}: {name} parts at agent {ag} step "
                      f"{st}: reference {a[ag, st]} port {b[ag, st]}; "
                      f"state {s_idx}, pre-episode Q-row reference "
                      f"{np.asarray(jrow)[ag, s_idx]} port "
                      f"{trow.numpy()[ag, s_idx]}")
                return
        gap = np.abs(np.asarray(jqs.qtable) - tqs.qtable.numpy()).max()
        print(f"iteration {it}: traces equal; Q-table max abs gap {gap:.3e};"
              f" steps with unequal float outputs {ulp}")
    print("traces equal through every iteration")


def fma_check(n: int = 100_000):
    """Share of jitted ``a*b + c`` results equal to the one-rounding (FMA)
    and to the two-rounding value, on random float32 inputs."""
    rng = np.random.default_rng(0)
    a, b, c = (rng.uniform(0.1, 3.0, n).astype(np.float32) for _ in range(3))
    jit = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    two = (a * b).astype(np.float32) + c
    one = (a.astype(np.float64) * b + c).astype(np.float32)
    print(f"jitted a*b+c on {n} inputs: equals one rounding (FMA) on "
          f"{np.mean(jit == one):.4f}, two roundings on "
          f"{np.mean(jit == two):.4f}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chip-log")
    ap.add_argument("--trace-weighting")
    ap.add_argument("--no-fma", action="store_true")
    args = ap.parse_args()
    points, suite = reference_points()
    chip, chip_suite = (chip_points(args.chip_log) if args.chip_log
                        else ({}, {}))
    gap = 0.0
    for k, v in list(points.items()) + list(suite.items()):
        c = chip.get(k, chip_suite.get(k))
        line = f"{k}: reference norm_time={v[0]:.6f} norm_mem={v[1]:.6f}"
        if c is not None:
            g = max(abs(c[0] - v[0]), abs(c[1] - v[1]))
            gap = max(gap, g)
            line += (f"  port norm_time={c[0]:.6f} norm_mem={c[1]:.6f}"
                     f"  gap={g:.6f}")
        print(line)
    if chip:
        print(f"largest gap: {gap:.6f}")
    if args.trace_weighting:
        fma_check()
        trace_weighting(tuple(float(v)
                              for v in args.trace_weighting.split("/")))


if __name__ == "__main__":
    main()
