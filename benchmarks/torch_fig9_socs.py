"""Paper Fig. 9 through the PyTorch/CUDA port, beside the JAX reference.

    PYTHONPATH=src python -m benchmarks.torch_fig9_socs [--fidelity] \
        [--quick] [--device cuda|cpu] [--out port.json] \
        [--compare port.json] [--reference] [--no-fma]

The port's run mirrors ``benchmarks/fig9_socs.py``'s stacked path at full
width: eight Table-4 SoC lanes (``SOC_FLAVORS``), 8-phase training apps,
10 iterations with every lane's agent trained in one kernel launch per
iteration, the profiled heterogeneous baseline per lane, then EVERY
policy family on every lane evaluated in one launch; it prints per-SoC
``cohmeleon``, ``manual`` and ``fixed_mean`` (normalized time, off-chip)
and the ``_headline`` (mean speedup and off-chip reduction vs the fixed
policies), with the kernel launches and wall times, and writes them to
``--out`` as JSON.  ``--quick`` mirrors the reference's quick run: the
first three lanes, 4-phase apps, 3 iterations, no profiled baseline, and
the cross-check of the lowered-spec episodes against the event-driven
simulator on single-thread chain apps (:func:`des_crosscheck`, reported
as ``_des_crosscheck``).  ``--fidelity`` runs ``fig9_socs._run_des``'s
serial path instead (:func:`run_des`): one event-driven agent per lane,
trained with ``train_cohmeleon`` and compared with the standard suite
through the simulator.  ``--compare`` loads a JSON (from a run on the
card) instead of running the port.  ``--reference`` also runs the
reference on the CPU with the same arguments (``fig9_socs._run_vecenv``
or ``_run_des``, which write no report) and prints both side by side
with the largest difference; ``--no-fma`` compiles the reference for an
ISA without fused multiply-add (ROADMAP C1).  The port side imports no
JAX.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from benchmarks.torch_no_fma import use_reference_without_fma

SOC_FLAVORS = [
    ("SoC0", "streaming"), ("SoC0", "irregular"),
    ("SoC1", "mixed"), ("SoC2", "mixed"), ("SoC3", "mixed"),
    ("SoC4", "mixed"), ("SoC5", "mixed"), ("SoC6", "mixed"),
]
CASE_STUDY = ("SoC4", "SoC5", "SoC6")
ITERS, N_PHASES = 10, 8
FAMILIES = ("cohmeleon", "manual", "fixed_mean")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def headline(results: dict, speedups, mem_reductions) -> None:
    results["_headline"] = {
        "mean_speedup_vs_fixed": float(np.mean(speedups)),
        "mean_mem_reduction_vs_fixed": float(np.mean(mem_reductions)),
        "paper_claim": {"speedup": 0.38, "mem_reduction": 0.66},
    }


def quick_args(quick: bool) -> tuple[list, int, int]:
    """(lanes, iterations, phases) of a run: the reference's quick cut or
    the full figure."""
    return ((SOC_FLAVORS[:3], 3, 4) if quick
            else (SOC_FLAVORS, ITERS, N_PHASES))


def des_crosscheck(env, sims) -> dict:
    """``fig9_socs._des_crosscheck`` on the port: on one single-thread
    S/M/L chain app per lane (``default_rng(100 + lane)``, chains of 3, 2
    loops: where the batched environment's lockstep model is exact), the
    lowered-spec episodes of the four fixed modes and manual on every
    lane in one launch, against serial event-driven replays per phase
    (tile seed 7); ``agree`` when the largest relative phase-time error
    is below 1e-3."""
    from repro_torch.core.modes import CoherenceMode
    from repro_torch.core.policies import FixedHomogeneous, ManualPolicy
    from repro_torch.soc.apps import make_phase
    from repro_torch.soc.des import Application

    apps = []
    for i, sim in enumerate(sims):
        rng = np.random.default_rng(100 + i)
        phases = [make_phase(rng, sim.soc, name=f"p{j}", n_threads=1,
                             size_classes=[c], chain_len=3, loops=2)
                  for j, c in enumerate(("S", "M", "L"))]
        apps.append(Application(name=f"{sim.soc.name}-xcheck",
                                phases=phases))
    stacked = env.compile(apps, seed=7)
    suite = [FixedHomogeneous(m) for m in CoherenceMode] + [ManualPolicy()]
    res = env.episodes(stacked, env.lower(stacked, suite))
    max_rel = 0.0
    for k, (sim, app) in enumerate(zip(sims, apps)):
        pt, _ = env.lane_phase_metrics(stacked, res, k)
        for i, pol in enumerate(suite):
            des = sim.run(app, pol, seed=7, train=False)
            dt = np.array([p.wall_time for p in des.phases])
            max_rel = max(max_rel, float(np.max(
                np.abs(pt[i] - dt) / np.maximum(dt, 1e-30))))
    return {"max_rel_err": max_rel, "agree": bool(max_rel < 1e-3)}


def crosscheck_port(device=None, flavors=SOC_FLAVORS) -> dict:
    """:func:`des_crosscheck` on one simulator per lane (seed 1) and the
    stacked twin of their environments."""
    from repro_torch.soc import vecenv as vec
    from repro_torch.soc.config import SOCS
    from repro_torch.soc.des import SoCSimulator
    from repro_torch.soc.stacked import StackedVecEnv

    sims = [SoCSimulator(SOCS[n], seed=1, flavor=f, device=device)
            for n, f in flavors]
    envs = [vec.VecEnv.from_simulator(s) for s in sims]
    return des_crosscheck(StackedVecEnv([e.soc for e in envs], envs=envs),
                          sims)


def run_des(device=None, flavors=SOC_FLAVORS, iters: int = ITERS,
            quick: bool = False) -> dict:
    """``fig9_socs._run_des`` on the port: per lane one simulator (seed
    1), ``train_cohmeleon`` (seed 0), the evaluation app (tile seed 4),
    4-phase apps under ``quick``, else 8; the standard suite (profiled
    on the simulator unless ``quick``) and the agent compared through
    the simulator; the per-SoC rows and the headline."""
    from repro_torch import resolve_device
    from repro_torch.core.orchestrator import (compare_policies,
                                               standard_policy_suite,
                                               train_cohmeleon)
    from repro_torch.soc.apps import make_application, make_case_study_app
    from repro_torch.soc.config import SOCS
    from repro_torch.soc.des import SoCSimulator

    dev = resolve_device(device)
    n_phases = 4 if quick else 8
    t0 = time.perf_counter()
    results, speedups, mem_reductions, invocations = {}, [], [], 0
    for soc_name, flavor in flavors:
        sim = SoCSimulator(SOCS[soc_name], seed=1, flavor=flavor,
                           device=dev)
        policy, _ = train_cohmeleon(sim, iterations=iters, seed=0,
                                    n_phases=n_phases)
        app = (make_case_study_app(sim.soc, seed=50)
               if soc_name in CASE_STUDY
               else make_application(sim.soc, seed=50, n_phases=n_phases))
        suite = standard_policy_suite(sim, include_profiled=not quick)
        suite.append(policy)
        cmp = compare_policies(sim, app, suite, seed=4)
        fixed = [cmp.geomean(n) for n in cmp.policies
                 if n.startswith("fixed")]
        fixed_t, fixed_m = [t for t, _ in fixed], [m for _, m in fixed]
        ct, cm = cmp.geomean("cohmeleon")
        speedup = (np.mean(fixed_t) - ct) / np.mean(fixed_t)
        mem_red = (np.mean(fixed_m) - cm) / np.mean(fixed_m)
        speedups.append(speedup)
        mem_reductions.append(mem_red)
        results[f"{soc_name}-{flavor}"] = {
            "cohmeleon": (ct, cm), "manual": cmp.geomean("manual"),
            "fixed_mean": (float(np.mean(fixed_t)), float(np.mean(fixed_m))),
            "speedup_vs_fixed": float(speedup),
            "mem_reduction_vs_fixed": float(mem_red),
            "all": {n: cmp.geomean(n) for n in cmp.policies},
        }
        invocations += sim.invocations
    headline(results, speedups, mem_reductions)
    _sync(dev)
    wall = time.perf_counter() - t0
    results["_engine"] = {
        "path": "des", "lanes": len(flavors),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "wall_s": wall, "invocations": invocations,
        "invocations_per_s": invocations / wall}
    return results


def run_port(device=None, flavors=SOC_FLAVORS, iters: int = ITERS,
             n_phases: int = N_PHASES, quick: bool = False) -> dict:
    """Fig. 9 through the port: one training launch per iteration for all
    lanes, the profiling probes (not under ``quick``), one evaluation
    launch for every policy family on every lane; under ``quick`` the
    event-driven cross-check (:func:`des_crosscheck`) after it."""
    from repro_torch import random as prng, resolve_device
    from repro_torch.core import orchestrator as orch, qlearn
    from repro_torch.core.modes import CoherenceMode
    from repro_torch.core.policies import (FixedHomogeneous, ManualPolicy,
                                           QPolicy, RandomPolicy)
    from repro_torch.core.rewards import PAPER_DEFAULT_WEIGHTS, stack_weights
    from repro_torch.kernels.soc_step import ops as soc_ops
    from repro_torch.soc import vecenv as vec
    from repro_torch.soc.apps import make_application, make_case_study_app
    from repro_torch.soc.config import SOCS
    from repro_torch.soc.stacked import StackedVecEnv

    dev = resolve_device(device)
    _sync(dev)
    soc_ops.reset_launches()
    t0 = time.perf_counter()
    envs = [vec.VecEnv(SOCS[n], seed=1, flavor=f, device=dev)
            for n, f in flavors]
    env = StackedVecEnv([e.soc for e in envs], envs=envs)
    k = len(envs)

    train_apps = [make_application(e.soc, seed=0, n_phases=n_phases)
                  for e in envs]
    stacked_iters = [env.compile(train_apps, seed=it) for it in range(iters)]
    cfg = qlearn.QConfig(decay_steps=torch.tensor(
        [s * iters for s in stacked_iters[0].n_steps], dtype=torch.int32))
    keys = prng.PRNGKey(np.arange(k)).reshape(k, 1, 2)
    qs, _ = env.train_batched(stacked_iters, cfg,
                              stack_weights([PAPER_DEFAULT_WEIGHTS]), keys)
    _sync(dev)
    t_train = time.perf_counter()

    launches_before = soc_ops.launches
    hetero = ([] if quick
              else [orch.profile_fixed_heterogeneous(e) for e in envs])
    _sync(dev)
    t_prof = time.perf_counter()
    launches_prof = soc_ops.launches - launches_before

    eval_apps = [make_case_study_app(e.soc, seed=50) if n in CASE_STUDY
                 else make_application(e.soc, seed=50, n_phases=n_phases)
                 for e, (n, _) in zip(envs, flavors)]
    stacked_eval = env.compile(eval_apps, seed=4)
    names = ([FixedHomogeneous(m).name for m in CoherenceMode]
             + ([] if quick else ["fixed-heterogeneous"])
             + ["random", "manual", "cohmeleon"])
    per_lane = []
    for i in range(k):
        agent = QPolicy(qlearn.QConfig(), device=dev)
        agent.qs = qlearn.QState(*(v[i, :1] for v in qs))
        per_lane.append([FixedHomogeneous(m) for m in CoherenceMode]
                        + hetero[i:i + 1]
                        + [RandomPolicy(), ManualPolicy(), agent])
    specs = env.lower(stacked_eval, per_lane)
    res = env.episodes(stacked_eval, specs, cfg)
    _sync(dev)
    t_end = time.perf_counter()

    base_idx = names.index(FixedHomogeneous(CoherenceMode.NON_COH_DMA).name)
    results, speedups, mem_reductions = {}, [], []
    for i, (soc_name, flavor) in enumerate(flavors):
        pt, po = env.lane_phase_metrics(stacked_eval, res, i)
        base = vec.EpisodeResult(*(torch.from_numpy(np.ascontiguousarray(
            a[base_idx])) for a in (pt, po)), *([None] * 5))
        norms = {}
        for j, name in enumerate(names):
            nt, nm = vec.normalized_metrics(vec.EpisodeResult(
                torch.from_numpy(np.ascontiguousarray(pt[j])),
                torch.from_numpy(np.ascontiguousarray(po[j])),
                *([None] * 5)), base)
            norms[name] = (float(nt), float(nm))
        fixed_t = [t for n, (t, _) in norms.items() if n.startswith("fixed")]
        fixed_m = [m for n, (_, m) in norms.items() if n.startswith("fixed")]
        ct, cm = norms["cohmeleon"]
        speedup = (np.mean(fixed_t) - ct) / np.mean(fixed_t)
        mem_red = (np.mean(fixed_m) - cm) / np.mean(fixed_m)
        speedups.append(speedup)
        mem_reductions.append(mem_red)
        results[f"{soc_name}-{flavor}"] = {
            "cohmeleon": norms["cohmeleon"], "manual": norms["manual"],
            "fixed_mean": (float(np.mean(fixed_t)), float(np.mean(fixed_m))),
            "speedup_vs_fixed": float(speedup),
            "mem_reduction_vs_fixed": float(mem_red),
            "all": norms,
        }
        if not quick:
            results[f"{soc_name}-{flavor}"]["heterogeneous"] = {
                n: int(m) for n, m in hetero[i].assignment.items()}
    headline(results, speedups, mem_reductions)
    results["_engine"] = {
        "path": "repro_torch", "lanes": k,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "train_calls": env.calls["train"],
        "eval_calls": env.calls["episodes"],
        "launches": soc_ops.launches,
        "launches_profile": launches_prof,
        "expected_launches": iters + 1 + (0 if quick else 3 * sum(
            len({p.name for p in e.profiles}) for e in envs)),
        "wall_s": t_end - t0, "train_s": t_train - t0,
        "profile_s": t_prof - t_train, "evaluate_s": t_end - t_prof,
        "padded_steps": int(stacked_iters[0].schedule.acc_id.shape[1]),
        "n_steps": list(stacked_iters[0].n_steps),
    }
    if quick:
        results["_des_crosscheck"] = crosscheck_port(dev, flavors)
    return results


def run_reference(flavors=SOC_FLAVORS, iters: int = ITERS,
                  quick: bool = False, fidelity: bool = False) -> dict:
    """The reference's Fig. 9 at the same width (no report): its stacked
    path (with its cross-check under ``quick``) or its serial
    event-driven one."""
    from benchmarks.fig9_socs import _run_des, _run_vecenv
    return (_run_des if fidelity else _run_vecenv)(flavors, iters, quick)


def print_results(tag: str, results: dict) -> None:
    for soc, row in results.items():
        if soc.startswith("_"):
            continue
        print(f"{tag} {soc}: " + " ".join(
            f"{fam}=({row[fam][0]:.6f}, {row[fam][1]:.6f})"
            for fam in FAMILIES))
    h = results["_headline"]
    print(f"{tag} headline: speedup={h['mean_speedup_vs_fixed']:.6f} "
          f"mem_reduction={h['mean_mem_reduction_vs_fixed']:.6f}")


def compare(port: dict, ref: dict) -> float:
    """Print per-SoC, per-family gaps and the headline's; returns the
    largest gap."""
    gap = 0.0
    for soc, row in ref.items():
        if soc.startswith("_"):
            continue
        for fam in list(FAMILIES) + sorted(row["all"]):
            a = port[soc]["all"][fam] if fam in row["all"] else port[soc][fam]
            b = row["all"][fam] if fam in row["all"] else row[fam]
            g = float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
            gap = max(gap, g)
            if g > 0 and fam in FAMILIES:
                print(f"differs {soc} {fam}: port {tuple(a)} reference "
                      f"{tuple(b)}")
    for key in ("mean_speedup_vs_fixed", "mean_mem_reduction_vs_fixed"):
        a, b = port["_headline"][key], ref["_headline"][key]
        gap = max(gap, abs(a - b))
        print(f"headline {key}: port {a:.6f} reference {b:.6f} "
              f"gap {abs(a - b):.6f}")
    if "_des_crosscheck" in ref:
        a, b = port["_des_crosscheck"], ref["_des_crosscheck"]
        gap = max(gap, abs(a["max_rel_err"] - b["max_rel_err"]))
        print(f"des cross-check: port max_rel_err {a['max_rel_err']:.6g} "
              f"agree {a['agree']}, reference {b['max_rel_err']:.6g} "
              f"agree {b['agree']}")
    print(f"largest difference: {gap:.6g}")
    return gap


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fidelity", action="store_true",
                    help="the serial event-driven path (one agent a lane)")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None)
    ap.add_argument("--out")
    ap.add_argument("--compare")
    ap.add_argument("--reference", action="store_true")
    ap.add_argument("--no-fma", action="store_true")
    args = ap.parse_args()
    flavors, iters, n_phases = quick_args(args.quick)
    if args.compare:
        with open(args.compare) as f:
            port = json.load(f)
        args.fidelity = port["_engine"]["path"] == "des"
        args.quick = port["_engine"]["lanes"] < len(SOC_FLAVORS)
        flavors, iters, n_phases = quick_args(args.quick)
    elif args.fidelity:
        port = run_des(args.device, flavors, iters, args.quick)
    else:
        port = run_port(args.device, flavors, iters, n_phases, args.quick)
    if args.out and not args.compare:
        with open(args.out, "w") as f:
            json.dump(port, f, indent=1)
    print_results("port", port)
    e = port["_engine"]
    if e["path"] == "des":
        print(f"port engine: event-driven on {e['device']}, wall "
              f"{e['wall_s']:.3f} s, {e['invocations']} invocations "
              f"({e['invocations_per_s']:.1f} a second)")
    else:
        print(f"port engine: {e['device']} wall {e['wall_s']:.3f} s (train "
              f"{e['train_s']:.3f}, profile {e['profile_s']:.3f}, evaluate "
              f"{e['evaluate_s']:.3f}); launches {e['launches']} (expected "
              f"{e['expected_launches']}, profiling "
              f"{e['launches_profile']})")
    if "_des_crosscheck" in port:
        x = port["_des_crosscheck"]
        print(f"port des cross-check: max_rel_err {x['max_rel_err']:.6g} "
              f"agree {x['agree']}")
    if args.reference or args.compare:
        if args.no_fma:
            use_reference_without_fma()
        ref = run_reference(flavors, iters, args.quick, args.fidelity)
        print_results("reference", ref)
        compare(port, ref)


if __name__ == "__main__":
    main()
