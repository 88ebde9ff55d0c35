"""Fig. 10 (policy robustness under injected faults) through the
PyTorch/CUDA port, beside the JAX reference.

    PYTHONPATH=src python -m benchmarks.torch_fig10_faults \
        [--device cuda|cpu] [--out port.json] [--compare port.json] \
        [--reference] [--no-fma]

The port's run mirrors ``benchmarks/fig10_faults.py``'s ``_run`` at full
width: SoC1, an 8-phase training app compiled with 10 tile seeds, one
agent trained for 10 iterations with per-iteration evaluation and the
reward-collapse watchdog (``collapse_frac=0.25``) inside a fault storm,
then six policies (the four fixed modes, manual, the frozen agent) on the
evaluation app under the same storm in one launch, normalized to the
NON_COH row of that call; at four intensities (healthy, 0.25, 0.5, 1.0;
``faults.storm(eval steps, intensity, PRNGKey(42))``).  The healthy row
runs the healthy kernel, the storms its faulted instantiation.  It prints
per intensity the agent's, manual's and the fixed policies' mean
normalized (time, off-chip), the agent's gain over the fixed mean and the
storm's slowdown of the NON_COH baseline, with launches and wall times,
and writes them to ``--out``.  It then cross-checks the port's
event-driven simulator against its batched environment under the same
storms (timed apart from the run above), as ``fig10_faults.py
--fidelity``'s ``_des_crosscheck`` does:
SoC1 single-thread chain apps (the regime where the batched lockstep
model is exact), the four fixed modes and manual at every intensity,
each phase's time on both paths; the report holds the relative gap per
(intensity, policy, phase), the largest, and ``agree`` (below 1e-3).

``--compare`` loads such a JSON instead of running the port;
``--reference`` runs the reference's ``fig10_faults._run`` on the CPU
(which writes no report) and holds every policy row, family and scalar
at every intensity against it to rtol = atol = 2e-5, printing each
difference and the verdict; ``--no-fma``
compiles the reference for an ISA without fused multiply-add (ROADMAP
C1).  The port side imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from benchmarks.torch_no_fma import use_reference_without_fma

SOC_NAME = "SoC1"
TILE_SEED = 7
INTENSITIES = [("healthy", None), ("mild", 0.25),
               ("moderate", 0.5), ("severe", 1.0)]
ITERS, N_PHASES = 10, 8
FAMILIES = ("cohmeleon", "manual", "fixed_mean")
SCALARS = ("q_delta_vs_fixed", "mem_delta_vs_fixed", "baseline_time",
           "storm_slowdown")
TOL = 2e-5   # rtol = atol, the bound of the reference's own kernel test


def run_port(device=None, iters: int = ITERS,
             n_phases: int = N_PHASES) -> dict:
    from repro_torch import random as prng, resolve_device
    from repro_torch.core import qlearn
    from repro_torch.core.modes import CoherenceMode
    from repro_torch.core.policies import FixedHomogeneous
    from repro_torch.core.rewards import PAPER_DEFAULT_WEIGHTS, stack_weights
    from repro_torch.kernels.soc_step import ops as soc_ops
    from repro_torch.soc import faults, vecenv
    from repro_torch.soc.apps import make_application
    from repro_torch.soc.config import SOCS

    dev = resolve_device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    soc_ops.reset_launches()
    t0 = time.perf_counter()
    soc = SOCS[SOC_NAME]
    env = vecenv.VecEnv(soc, seed=1, flavor="mixed", device=dev)
    train_app = make_application(soc, seed=0, n_phases=n_phases)
    train_apps = [vecenv.compile_app(train_app, soc, seed=it)
                  for it in range(iters)]
    eval_app = vecenv.compile_app(
        make_application(soc, seed=50, n_phases=n_phases), soc, seed=4)
    cfg = qlearn.QConfig(decay_steps=train_apps[0].n_steps * iters,
                         collapse_frac=0.25)
    wb = stack_weights([PAPER_DEFAULT_WEIGHTS])
    keys = prng.PRNGKey(np.arange(1))
    fixed = list(CoherenceMode)
    names = [FixedHomogeneous(m).name for m in fixed] + ["manual",
                                                         "cohmeleon"]
    base_idx = names.index(FixedHomogeneous(CoherenceMode.NON_COH_DMA).name)
    sched = env._sched(eval_app)
    # the mode tables of the non-learned families depend on the schedule
    # alone, not on the storm: lowered once for all intensities
    fixed_specs = [vecenv.fixed_policy_spec(env.params, sched, int(m))
                   for m in fixed]
    manual = vecenv.manual_policy_spec(env.params, sched)

    results: dict = {}
    phases_s: dict = {}
    for label, intensity in INTENSITIES:
        sync()
        t_i = time.perf_counter()
        fs = (None if intensity is None else
              faults.storm(eval_app.n_steps, intensity, prng.PRNGKey(42)))
        qs, _ = env.train_batched(train_apps, cfg, wb, keys,
                                  eval_app=eval_app, faults=fs)
        agent = qlearn.freeze(qs)
        specs = vecenv.stack_specs(
            fixed_specs + [manual, vecenv.learned_policy_spec(agent, sched)])
        res = env.episodes(eval_app, specs, cfg, faults=fs)
        nt, nm = vecenv.normalized_metrics(res, res.index(base_idx))
        all_norms = {name: (float(nt[i]), float(nm[i]))
                     for i, name in enumerate(names)}
        fixed_t = [t for n, (t, _) in all_norms.items()
                   if n.startswith("fixed")]
        fixed_m = [m for n, (_, m) in all_norms.items()
                   if n.startswith("fixed")]
        ct, cm = all_norms["cohmeleon"]
        results[label] = {
            "intensity": intensity,
            "cohmeleon": (ct, cm),
            "manual": all_norms["manual"],
            "fixed_mean": (float(np.mean(fixed_t)), float(np.mean(fixed_m))),
            "q_delta_vs_fixed": float(
                (np.mean(fixed_t) - ct) / np.mean(fixed_t)),
            "mem_delta_vs_fixed": float(
                (np.mean(fixed_m) - cm) / np.mean(fixed_m)),
            "baseline_time": float(res.phase_time[base_idx].sum()),
            "all": all_norms,
        }
        sync()
        phases_s[label] = time.perf_counter() - t_i
    healthy_base = results["healthy"]["baseline_time"]
    for label, _ in INTENSITIES:
        results[label]["storm_slowdown"] = float(
            results[label]["baseline_time"] / healthy_base)
    sync()
    t_end = time.perf_counter()
    per = 2 * iters + 1 + 1   # train + eval per iteration, baseline, suite
    results["_engine"] = {
        "path": "repro_torch", "soc": SOC_NAME,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "episode_launches": soc_ops.launches,
        "fault_episode_launches": soc_ops.fault_launches,
        "expected_episode_launches": per,
        "expected_fault_episode_launches": per * (len(INTENSITIES) - 1),
        "wall_s": t_end - t0, "intensity_s": phases_s,
    }
    return results


def des_crosscheck(device=None) -> dict:
    """The port's event-driven simulator against its batched environment
    under the same fault storms, per phase (``fig10_faults.py``'s
    ``_des_crosscheck`` with ``--fidelity``): one batched episode per
    (intensity, policy), so 5 healthy and 15 faulted launches.  A path of
    its own, apart from :func:`run_port`'s window: its wall time and
    launches are in the result."""
    from repro_torch import random as prng, resolve_device
    from repro_torch.core.modes import CoherenceMode
    from repro_torch.core.policies import FixedHomogeneous, ManualPolicy
    from repro_torch.kernels.soc_step import ops as soc_ops
    from repro_torch.soc import faults, vecenv
    from repro_torch.soc.apps import make_phase
    from repro_torch.soc.config import SOCS
    from repro_torch.soc.des import Application, SoCSimulator

    device = resolve_device(device)
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    sync()
    soc_ops.reset_launches()
    t0 = time.perf_counter()
    soc = SOCS[SOC_NAME]
    sim = SoCSimulator(soc, seed=1, flavor="mixed", device=device)
    env = vecenv.VecEnv.from_simulator(sim)
    rng = np.random.default_rng(100)
    phases = [make_phase(rng, soc, name=f"p{j}", n_threads=1,
                         size_classes=[c], chain_len=3, loops=2)
              for j, c in enumerate(("S", "M", "L"))]
    app = Application(name=f"{soc.name}-fault-xcheck", phases=phases)
    compiled = vecenv.compile_app(app, soc, seed=TILE_SEED)
    suite = [("fixed", m) for m in CoherenceMode] + [("manual", None)]
    per_phase: dict = {}
    max_rel = 0.0
    for label, intensity in INTENSITIES:
        fs = (None if intensity is None else
              faults.storm(compiled.n_steps, intensity, prng.PRNGKey(42),
                           device=sim.device))
        for kind, mode in suite:
            pol = (FixedHomogeneous(mode) if kind == "fixed"
                   else ManualPolicy())
            des = sim.run(app, pol, seed=TILE_SEED, train=False, faults=fs)
            _, res = env.episode(compiled, policy=kind, fixed_modes=mode,
                                 faults=fs)
            dt = np.array([p.wall_time for p in des.phases])
            rel = (np.abs(res.phase_time.cpu().numpy().astype(np.float64)
                          - dt) / np.maximum(dt, 1e-30))
            per_phase.setdefault(label, {})[pol.name] = rel.tolist()
            max_rel = max(max_rel, float(rel.max()))
    sync()
    return {"max_rel_err": max_rel, "agree": bool(max_rel < 1e-3),
            "storms": len(INTENSITIES), "families": len(suite),
            "per_phase": per_phase, "des_invocations": sim.invocations,
            "wall_s": time.perf_counter() - t0,
            "episode_launches": soc_ops.launches,
            "fault_episode_launches": soc_ops.fault_launches,
            "expected_episode_launches": len(suite),
            "expected_fault_episode_launches": len(suite) * (
                len(INTENSITIES) - 1)}


def run_reference() -> dict:
    """The reference's full-width ``_run`` (no report)."""
    from benchmarks.fig10_faults import _run
    return _run(quick=False)


def print_results(tag: str, results: dict) -> None:
    for label, _ in INTENSITIES:
        r = results[label]
        fams = " ".join(f"{f}=({r[f][0]:.6f}, {r[f][1]:.6f})"
                        for f in FAMILIES)
        print(f"{tag} {label}: {fams} q_delta={r['q_delta_vs_fixed']:.6f} "
              f"mem_delta={r['mem_delta_vs_fixed']:.6f} "
              f"storm_slowdown={r['storm_slowdown']:.6f}")


def compare(port: dict, ref: dict) -> bool:
    """Print every differing number and whether every policy row, family
    and scalar at every intensity is within ``|port - ref| <= TOL + TOL *
    |ref|``; returns that verdict.  (``q_delta_vs_fixed`` is a difference
    of two near-equal numbers, so its relative gap is the largest.)"""
    gap = worst = 0.0

    def check(what, a, b):
        nonlocal gap, worst
        g = abs(a - b) / max(abs(b), 1e-30)
        gap = max(gap, g)
        worst = max(worst, abs(a - b) / (TOL + TOL * abs(b)))
        if g > 0:
            print(f"differs {what}: port {a:.9g} reference {b:.9g} "
                  f"abs {abs(a - b):.3g} rel {g:.3g}")

    for label, _ in INTENSITIES:
        p, r = port[label], ref[label]
        for name, (t, m) in r["all"].items():
            check(f"{label} {name} time", p["all"][name][0], t)
            check(f"{label} {name} mem", p["all"][name][1], m)
        for fam in FAMILIES:
            for j, part in enumerate(("time", "mem")):
                check(f"{label} {fam} {part}", p[fam][j], r[fam][j])
        for k in SCALARS:
            check(f"{label} {k}", p[k], r[k])
    print(f"largest relative difference: {gap:.6g}; within rtol = atol = "
          f"{TOL:g}: {worst <= 1.0} (largest share of the bound "
          f"{worst:.4g})")
    return worst <= 1.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--out")
    ap.add_argument("--compare")
    ap.add_argument("--reference", action="store_true")
    ap.add_argument("--no-fma", action="store_true")
    args = ap.parse_args()
    if args.compare:
        with open(args.compare) as f:
            port = json.load(f)
    else:
        port = run_port(args.device)
        port["_des_crosscheck"] = des_crosscheck(args.device)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(port, f, indent=1)
    print_results("port", port)
    e, x = port["_engine"], port["_des_crosscheck"]
    print(f"port engine: {e['device']} wall {e['wall_s']:.3f} s; episode "
          f"launches {e['episode_launches']} (expected "
          f"{e['expected_episode_launches']}), faulted episode launches "
          f"{e['fault_episode_launches']} (expected "
          f"{e['expected_fault_episode_launches']}); DES cross-check "
          f"{x['wall_s']:.3f} s: largest per-phase gap "
          f"{x['max_rel_err']:.3g}, agree {x['agree']}")
    if args.reference or args.compare:
        if args.no_fma:
            use_reference_without_fma()
        ref = run_reference()
        print_results("reference", ref)
        compare(port, ref)


if __name__ == "__main__":
    main()
