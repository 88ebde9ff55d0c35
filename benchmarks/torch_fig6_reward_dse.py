"""Paper Fig. 6 (the reward function's design space) through the port.

    PYTHONPATH=src python -m benchmarks.torch_fig6_reward_dse [--quick] \
        [--fidelity] [--device cuda|cpu] [--out port.json]

Mirrors ``benchmarks/fig6_reward_dse.py``'s ``run``: one agent per (x, y,
z) reward weighting trained on SoC-motiv-par, frozen and scored on the
seed-900 6-phase test app (tile seed 5) as (normalized time, normalized
off-chip accesses), and each weighting classified near-Pareto or degraded
(normalized time at least ``DEGRADED_TIME``).  By default the batched
environment trains |weights| x seeds agents, every iteration in one
kernel launch; ``--fidelity`` trains one agent per weighting on the
event-driven simulator (``train_cohmeleon``, seed 11, 6 phases) and
scores it with ``compare_policies`` (:func:`des_points`); ``--quick``
takes the first 4 weightings and 3 iterations (2 seeds on the batched
path) and, without ``--fidelity``, runs both paths and reports whether
they classify every weighting alike (``classification_agreement``).  It
prints the points, the classification, the agreement and the wall time,
and writes the report to ``--out`` as JSON.  It imports no JAX;
``benchmarks/torch_fig6_agreement.py`` compares the batched path with the
reference's.
"""
from __future__ import annotations

import argparse
import json
import time

WEIGHTS = [
    (0.675, 0.075, 0.25), (0.125, 0.125, 0.75), (1.0, 0.0, 0.0),
    (0.0, 0.0, 1.0), (0.05, 0.05, 0.90), (0.33, 0.33, 0.34),
    (0.5, 0.25, 0.25), (0.25, 0.5, 0.25), (0.8, 0.1, 0.1),
    (0.1, 0.8, 0.1), (0.45, 0.1, 0.45), (0.6, 0.0, 0.4),
    (0.9, 0.05, 0.05), (0.2, 0.2, 0.6), (0.4, 0.4, 0.2),
]
# a weighting is degraded when its frozen policy fails to beat fixed
# non-coherent DMA on execution time (the reference's anchor)
DEGRADED_TIME = 1.0
TRAIN_SEED, TEST_SEED, TILE_SEED, N_PHASES = 11, 900, 5, 6


def classify(points: dict) -> dict:
    return {k: ("degraded" if p["time"] >= DEGRADED_TIME else "near-pareto")
            for k, p in points.items()}


def des_points(weights, iters: int, device=None) -> tuple[dict, object]:
    """The fidelity path: one serial event-driven training per weighting
    on one simulator, each scored on the test app; returns the points and
    the simulator (its ``invocations`` count the run)."""
    from repro_torch.core.orchestrator import (compare_policies,
                                               train_cohmeleon)
    from repro_torch.core.rewards import RewardWeights
    from repro_torch.soc.apps import make_application
    from repro_torch.soc.config import SOC_MOTIV_PAR
    from repro_torch.soc.des import SoCSimulator

    sim = SoCSimulator(SOC_MOTIV_PAR, device=device)
    test_app = make_application(sim.soc, seed=TEST_SEED, n_phases=N_PHASES)
    points = {}
    for (x, y, z) in weights:
        policy, _ = train_cohmeleon(sim, iterations=iters, seed=TRAIN_SEED,
                                    weights=RewardWeights(x, y, z),
                                    n_phases=N_PHASES)
        cmp = compare_policies(sim, test_app, [policy], seed=TILE_SEED)
        t, m = cmp.geomean("cohmeleon")
        points[f"{x}/{y}/{z}"] = {"time": t, "mem": m}
    return points, sim


def batched_points(weights, iters: int, n_seeds: int,
                   device=None) -> tuple[dict, int]:
    """The scale path: the whole sweep in one batched training (a launch
    per iteration), evaluated frozen in one launch."""
    from repro_torch.core.orchestrator import train_cohmeleon_batched
    from repro_torch.soc.apps import make_application
    from repro_torch.soc.config import SOC_MOTIV_PAR

    res = train_cohmeleon_batched(SOC_MOTIV_PAR, iterations=iters,
                                  seed=TRAIN_SEED, weights=weights,
                                  n_seeds=n_seeds, n_phases=N_PHASES,
                                  device=device)
    test_app = make_application(res.env.soc, seed=TEST_SEED,
                                n_phases=N_PHASES)
    nt, nm = res.evaluate(test_app, seed=TILE_SEED)
    t_w, m_w = res.per_weight(nt), res.per_weight(nm)
    points = {f"{x}/{y}/{z}": {"time": float(t), "mem": float(m)}
              for (x, y, z), t, m in zip(weights, t_w, m_w)}
    return points, res.n_agents


def run(quick: bool = False, fidelity: bool = False, device=None) -> dict:
    """The reference's ``run`` on the port: the report's fields, with the
    wall time and the event-driven invocations under ``_engine``."""
    import torch
    from repro_torch import resolve_device

    dev = resolve_device(device)
    weights = WEIGHTS[:4] if quick else WEIGHTS
    iters = 3 if quick else 10
    t0 = time.perf_counter()
    invocations = 0
    if fidelity:
        points, sim = des_points(weights, iters, dev)
        n_agents, path, invocations = len(weights), "des", sim.invocations
    else:
        points, n_agents = batched_points(weights, iters,
                                          2 if quick else 8, dev)
        path = "vecenv"
    classes = classify(points)
    payload = {"path": path, "n_agents": n_agents, "points": points,
               "classification": classes}
    if quick and not fidelity:
        des, sim = des_points(weights, iters, dev)
        invocations = sim.invocations
        des_classes = classify(des)
        payload.update(des_points=des, des_classification=des_classes,
                       classification_agreement=des_classes == classes)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    payload["_engine"] = {
        "path": path, "device": (torch.cuda.get_device_name(dev)
                                 if dev.type == "cuda" else "cpu"),
        "wall_s": wall, "invocations": invocations,
        "invocations_per_s": invocations / wall if invocations else None,
        "us_per_weighting": wall * 1e6 / len(weights)}
    return payload


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--fidelity", action="store_true",
                    help="the event-driven simulator instead of the "
                         "batched environment")
    ap.add_argument("--device", default=None)
    ap.add_argument("--out")
    args = ap.parse_args()
    r = run(args.quick, args.fidelity, args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(r, f, indent=1)
    for k, p in r["points"].items():
        print(f"{k}: time={p['time']:.6f} mem={p['mem']:.6f} "
              f"{r['classification'][k]}")
    times = [p["time"] for p in r["points"].values()]
    e = r["_engine"]
    print(f"fig6 path={r['path']} n_points={len(times)} "
          f"agents={r['n_agents']} degraded="
          f"{sum(c == 'degraded' for c in r['classification'].values())} "
          f"time_spread={max(times) / min(times):.2f}x"
          + (f" des_agreement={r['classification_agreement']}"
             if "classification_agreement" in r else "")
          + f"; {e['device']} wall {e['wall_s']:.3f} s"
          + (f", {e['invocations']} event-driven invocations "
             f"({e['invocations_per_s']:.1f} a second)"
             if e["invocations"] else ""))


if __name__ == "__main__":
    main()
