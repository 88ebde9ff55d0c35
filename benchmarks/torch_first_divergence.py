"""Where the port's full-width Fig. 9 / Fig. 11 / Fig. 13 runs first part
from the reference's (ROADMAP C1-C3, C5).

    PYTHONPATH=src python -m benchmarks.torch_first_divergence \
        --fig 9|11|13 [--no-fma]

Both packages run on the CPU with the figure's full-width protocol
(``benchmarks/torch_fig9_socs.py`` / ``torch_fig11_serving.py``).

``--fig 9`` trains the eight stacked lanes for 1, 2, ... iterations in
both packages and stops at the first iteration after which a lane's
visits differ or its Q-table differs by more than 1e-5; it then replays
that iteration from the port's previous state in both packages and
prints, per such lane, the first step where each trace column differs
by more than 1e-5.  It also compares the evaluation call's traces and
phase metrics element by element.

``--fig 11`` trains the agent in both packages, serves the four policies
at 1.5x the calibrated capacity in both (each drawing its own arrivals
from the same key) and prints, per column, how many requests differ and
the first one.

``--fig 13`` builds Fig. 13's portfolio in both packages
(``benchmarks/torch_fig13_generalize.py``), prints the gap between the two
initial networks, then runs the first training iteration's episodes
(every pair, every one of the 4 lanes, each package from its own initial
network, then the port from the reference's) and prints, per pair, the
first (lane, step) whose mode, state or action differs and the first
whose reward differs, with both values, and the trained packs' gap.
``--no-fma`` compiles the reference without fused multiply-add.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from benchmarks.torch_no_fma import use_reference_without_fma


def _first(a, b, tol=0.0):
    d = np.argwhere(np.abs(a.astype(np.float64) - b) > tol)
    return len(d), (d[0].tolist(), a[tuple(d[0])], b[tuple(d[0])]) \
        if len(d) else None


def fig9():
    import jax
    import jax.numpy as jnp
    from benchmarks import fig9_socs as F, torch_fig9_socs as T
    from repro.core import qlearn as jq
    from repro.core.modes import CoherenceMode
    from repro.core.orchestrator import profile_fixed_heterogeneous as jprof
    from repro.core import policies as jp
    from repro.core.rewards import (PAPER_DEFAULT_WEIGHTS as JW,
                                    stack_weights as jsw)
    from repro.soc.apps import make_application as jma
    from repro.soc.config import SOCS as JS
    from repro.soc.des import SoCSimulator
    from repro.soc.stacked import StackedVecEnv as JEnv
    from repro_torch import random as prng
    from repro_torch.core import orchestrator as to, policies as tp
    from repro_torch.core import qlearn as tq
    from repro_torch.core.rewards import (PAPER_DEFAULT_WEIGHTS as TW,
                                          stack_weights as tsw)
    from repro_torch.soc import vecenv as tv
    from repro_torch.soc.apps import make_application as tma
    from repro_torch.soc.apps import make_case_study_app as tmc
    from repro_torch.soc.config import SOCS as TS
    from repro_torch.soc.stacked import StackedVecEnv as TEnv

    fl, it_n = T.SOC_FLAVORS, T.ITERS
    sims = [SoCSimulator(JS[n], seed=1, flavor=f) for n, f in fl]
    jenv = JEnv.from_simulators(sims)
    envs = [tv.VecEnv(TS[n], seed=1, flavor=f, device="cpu") for n, f in fl]
    tenv = TEnv([e.soc for e in envs], envs=envs)
    jits = [jenv.compile([jma(s.soc, seed=0, n_phases=8) for s in sims],
                         seed=i) for i in range(it_n)]
    tits = [tenv.compile([tma(e.soc, seed=0, n_phases=8) for e in envs],
                         seed=i) for i in range(it_n)]
    steps = [s * it_n for s in jits[0].n_steps]
    jcfg = jq.QConfig(decay_steps=jnp.asarray(steps, jnp.int32))
    tcfg = tq.QConfig(decay_steps=torch.tensor(steps, dtype=torch.int32))
    jkeys = jax.vmap(jax.random.PRNGKey)(jnp.arange(8)).reshape(8, 1, 2)
    tkeys = prng.PRNGKey(np.arange(8)).reshape(8, 1, 2)
    prev = tq.QState(*(v[:, None] for v in tq.init_qstate_batch(
        tq.QConfig(), 8)))
    for i in range(1, it_n + 1):
        jqs, _ = jenv.train_batched(jits[:i], jcfg, jsw([JW]), jkeys)
        tqs, _ = tenv.train_batched(tits[:i], tcfg, tsw([TW]), tkeys)
        qd = np.abs(np.asarray(jqs.qtable) - tqs.qtable.numpy()).max(
            axis=(1, 2, 3))
        vis = (np.asarray(jqs.visits) == tqs.visits.numpy()).reshape(
            8, -1).all(-1)
        lanes = [k for k in range(8) if not vis[k] or qd[k] > 1e-5]
        print(f"after iteration {i}: Q-table gap per lane "
              f"{[float(f'{v:.3g}') for v in qd]}; lanes parted {lanes}")
        if lanes:
            key = tkeys.reshape(8, 2)
            for _ in range(i - 1):
                key = prng.split(key, 3)[:, 0]
            ktrain = prng.split(key, 3)[:, 1].reshape(8, 1, 2)
            jprev = jq.QState(*(jnp.asarray(v.numpy()) for v in prev))
            jres = jenv.episodes(
                jits[i - 1], jenv.lower_qstates(jits[i - 1], jprev, False),
                jcfg, keys=jnp.asarray(prng.key_to_numpy(ktrain)))
            tres = tenv.episodes(
                tits[i - 1], tenv.lower_qstates(tits[i - 1], prev, False),
                tcfg, keys=ktrain)
            for k in lanes:
                for f in ("mode", "state_idx", "exec_time", "offchip",
                          "reward"):
                    n, first = _first(np.asarray(getattr(jres, f))[k, 0],
                                      getattr(tres, f).numpy()[k, 0], 1e-5)
                    print(f"  lane {k} {fl[k][0]}-{fl[k][1]} iteration {i}: "
                          f"{f}: {n} steps differ; first (step, reference,"
                          f" port) {first}")
            break
        prev = tqs

    jqs, _ = jenv.train_batched(jits, jcfg, jsw([JW]), jkeys)
    tqs, _ = tenv.train_batched(tits, tcfg, tsw([TW]), tkeys)
    jev = jenv.compile([F._eval_app(s, n, 8) for s, (n, _) in zip(sims, fl)],
                       seed=4)
    tev = tenv.compile([tmc(e.soc, seed=50) if n in T.CASE_STUDY
                        else tma(e.soc, seed=50, n_phases=8)
                        for e, (n, _) in zip(envs, fl)], seed=4)
    jpl, tpl = [], []
    for k, (sim, env) in enumerate(zip(sims, envs)):
        ja = jp.QPolicy(jq.QConfig())
        ja.qs = jax.tree_util.tree_map(lambda x: x[k, 0], jqs)
        ta = tp.QPolicy(tq.QConfig())
        ta.qs = tq.QState(*(v[k, :1] for v in tqs))
        jpl.append([jp.FixedHomogeneous(m) for m in CoherenceMode]
                   + [jprof(sim, backend="vecenv", env=jenv.envs[k]),
                      jp.RandomPolicy(), jp.ManualPolicy(), ja])
        tpl.append([tp.FixedHomogeneous(m) for m in range(4)]
                   + [to.profile_fixed_heterogeneous(env),
                      tp.RandomPolicy(), tp.ManualPolicy(), ta])
    jres = jenv.episodes(jev, jenv.lower(jev, jpl), jcfg)
    tres = tenv.episodes(tev, tenv.lower(tev, tpl), tcfg)
    for f in tres._fields:
        n, first = _first(np.asarray(getattr(jres, f)),
                          getattr(tres, f).numpy())
        print(f"evaluation call {f}: {n} elements differ; first "
              f"(index, reference, port) {first}")


def fig11():
    import jax
    import jax.numpy as jnp
    from benchmarks import fig11_serving as F, torch_fig11_serving as T
    from repro.core import qlearn as jq
    from repro.core.modes import CoherenceMode
    from repro.core.rewards import (PAPER_DEFAULT_WEIGHTS as JW,
                                    stack_weights as jsw)
    from repro.soc import vecenv as jv
    from repro.soc.apps import make_application as jma
    from repro.soc.config import SOCS as JS
    from repro.soc.des import SoCSimulator
    from repro_torch import random as prng
    from repro_torch.core import qlearn as tq
    from repro_torch.core.rewards import (PAPER_DEFAULT_WEIGHTS as TW,
                                          stack_weights as tsw)
    from repro_torch.soc import traffic as tt, vecenv as tv
    from repro_torch.soc.apps import make_application as tma
    from repro_torch.soc.config import SOCS as TS

    soc = JS[T.SOC_NAME]
    jenv = jv.VecEnv.from_simulator(SoCSimulator(soc, seed=1, flavor="mixed"))
    tenv = tv.VecEnv(TS[T.SOC_NAME], seed=1, flavor="mixed", device="cpu")
    japp, tapp = (jma(soc, seed=0, n_phases=8),
                  tma(TS[T.SOC_NAME], seed=0, n_phases=8))
    jtr = [jv.compile_app(japp, soc, seed=i) for i in range(T.ITERS)]
    ttr = [tv.compile_app(tapp, TS[T.SOC_NAME], seed=i)
           for i in range(T.ITERS)]
    jev = jv.compile_app(jma(soc, seed=50, n_phases=8), soc, seed=4)
    tev = tv.compile_app(tma(TS[T.SOC_NAME], seed=50, n_phases=8),
                         TS[T.SOC_NAME], seed=4)
    n = jtr[0].n_steps * T.ITERS
    jcfg = jq.QConfig(decay_steps=n, collapse_frac=0.25)
    tcfg = tq.QConfig(decay_steps=n, collapse_frac=0.25)
    jqs, _ = jenv.train_batched(jtr, jcfg, jsw([JW]), jax.vmap(
        jax.random.PRNGKey)(jnp.arange(1)), eval_app=jev)
    tqs, _ = tenv.train_batched(ttr, tcfg, tsw([TW]),
                                prng.PRNGKey(np.arange(1)), eval_app=tev)
    print("trained Q-table gap",
          float(np.abs(np.asarray(jqs.qtable) - tqs.qtable.numpy()).max()))
    agent = jq.freeze(jax.tree_util.tree_map(lambda x: x[0], jqs))
    jspecs = jv.stack_specs([
        jenv.lower(jev, "fixed", fixed_modes=CoherenceMode.NON_COH_DMA),
        jenv.lower(jev, "fixed", fixed_modes=CoherenceMode.FULLY_COH),
        jenv.lower(jev, "manual"),
        jenv.lower(jev, "q", qstate=agent, cfg=jcfg)])
    ts = tenv._sched(tev)
    tspecs = tv.stack_specs([
        tv.fixed_policy_spec(tenv.params, ts, 0),
        tv.fixed_policy_spec(tenv.params, ts, 3),
        tv.manual_policy_spec(tenv.params, ts),
        tv.learned_policy_spec(tq.freeze(tqs), ts)])
    port = T.run_port("cpu")["_capacity"]
    rate = 1.5 * port["capacity_per_mcycle"] * 1e-6
    svc = port["effective_service_cycles"]
    _, _, jr = jv.ServeEnv(jenv, queue_cap=T.QUEUE_CAP).serve_specs(
        jev, jspecs, F._traffic(rate, T.QUEUE_CAP * svc, 0.25 * svc),
        cfg=jcfg)
    _, _, tr = tv.ServeEnv(tenv, queue_cap=T.QUEUE_CAP).serve_specs(
        tev, tspecs, T._traffic(tt, rate, T.QUEUE_CAP * svc, 0.25 * svc),
        cfg=tcfg)
    for f in tr._fields:
        n, first = _first(np.asarray(getattr(jr, f)),
                          getattr(tr, f).numpy())
        print(f"1.5x {f}: {n} requests differ; first ((policy, request), "
              f"reference, port) {first}")


def fig13():
    import jax
    from benchmarks import fig13_generalize as F, torch_fig13_generalize as T
    from repro.core import qlearn as jq
    from repro.soc import dse as jd, nn as jn, vecenv as jv
    from repro_torch import random as prng
    from repro_torch.core import qlearn as tq
    from repro_torch.soc import dse as td, nn as tn, vecenv as tv
    from repro_torch.soc.apps import make_application as tma

    js, ts = jd.sample_socs(0, T.N_TRAIN), td.sample_socs(0, T.N_TRAIN)
    jitems = [(jv.VecEnv(s.config, seed=0),
               [F._compile(s.config, s.seed + d, T.N_PHASES) for d in (0, 1)])
              for s in js]
    titems = [(tv.VecEnv(s.config, seed=0, device="cpu"),
               [T._compile(tv, tma, s.config, s.seed + d, T.N_PHASES)
                for d in (0, 1)]) for s in ts]
    n = sum(c.n_steps for _, cs in jitems for c in cs) // 2 * T.ITERS
    jcfg, tcfg = jq.QConfig(decay_steps=n), tq.QConfig(decay_steps=n)
    jkey, jsub = jax.random.split(jax.random.PRNGKey(1))
    jm = jn.init_mlp_qstate(jsub)
    tks = prng.split(prng.PRNGKey(1))
    tkey, tm = tks[0], tn.init_mlp_qstate(tks[1])
    print("initial networks: max abs gap", float(np.abs(
        np.asarray(jm.wpack) - tm.wpack[0].numpy()).max()))
    carried = tn.mlp_from_numpy(*(np.asarray(v) for v in jm[:4]), tm.cfg)
    for label, tnet in (("own init", tm), ("reference's init", carried)):
        for j, ((jenv, jc), (tenv, tc)) in enumerate(zip(jitems, titems)):
            jspec = jv.mlp_policy_spec(jm, jc[0].schedule)
            tspec = tv.mlp_policy_spec(tnet, tc[0].schedule)
            jks = jax.random.split(jax.random.fold_in(jkey, j), T.BATCH)
            tkk = prng.split(prng.fold_in(tkey, j), T.BATCH)
            first_int = first_r = None
            wgap = 0.0
            for b in range(T.BATCH):
                (_, jmf), jr = jenv.episode_spec(jc[0], jspec, cfg=jcfg,
                                                 key=jks[b])
                (_, tmf), tr = tenv.episode_spec(tc[0], tspec, cfg=tcfg,
                                                 key=tkk[b])
                wgap = max(wgap, float(np.abs(np.asarray(jmf.wpack)
                                              - tmf.wpack[0].numpy()).max()))
                for f in ("mode", "state_idx"):
                    cnt, fst = _first(np.asarray(getattr(jr, f)),
                                      getattr(tr, f).numpy())
                    if cnt and (first_int is None
                                or (b, fst[0][0]) < first_int[:2]):
                        first_int = (b, fst[0][0], f, fst[1], fst[2])
                cnt, fst = _first(np.asarray(jr.reward), tr.reward.numpy())
                if cnt and first_r is None:
                    first_r = (b, fst[0][0], fst[1], fst[2])
            print(f"{label}, iteration 0, pair {j} ({js[j].config.name}): "
                  f"first integer difference (lane, step, column, "
                  f"reference, port) {first_int}; first reward difference "
                  f"(lane, step, reference, port) {first_r}; trained packs' "
                  f"max abs gap {wgap:.3g}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fig", choices=("9", "11", "13"), required=True)
    ap.add_argument("--no-fma", action="store_true")
    args = ap.parse_args()
    if args.no_fma:
        use_reference_without_fma()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    {"9": fig9, "11": fig11, "13": fig13}[args.fig]()


if __name__ == "__main__":
    main()
