"""Fig. 13 (held-out generalization of the neural agent) through the
PyTorch/CUDA port, beside the JAX reference.

    PYTHONPATH=src python -m benchmarks.torch_fig13_generalize \
        [--device cuda|cpu] [--out port.json] [--compare port.json] \
        [--reference] [--no-fma]

The port's run is ``benchmarks/fig13_generalize.py``'s ``run(quick=False,
key=0)``: 14 design points from ``dse.sample_socs(0, 14)``, the first 8
training SoCs and the last 6 held out; a portfolio of the 8 training SoCs,
each with two 3-phase training apps (seeds ``seed``, ``seed + 1``, tile
seed 11) rotated per iteration; ONE shared MLP Q-network trained for 12
iterations by federated averaging over 4 episodes per pair
(``soc.nn.train_portfolio``, one MLP kernel launch per pair and
iteration) and, on the same episode stream, ONE shared Q-table (one table
kernel launch per pair and iteration); then both agents frozen and scored
against NON_COH on a held-out app (seed offset 101) of every training SoC
and of every held-out SoC, the three episodes of a (SoC, app) sharing one
key.  It prints and writes (``--out``) every per-SoC (speedup, off-chip
reduction), the reward history, the set means and the headline, with the
kernel launches and wall times.

``--compare`` loads such a JSON instead of running the port;
``--reference`` runs the reference's ``fig13_generalize.run(quick=False,
key=0)`` on the CPU with its report directory pointed at a temporary one
(the committed ``reports/benchmarks/fig13_generalize.json`` is never
written) and holds every per-SoC value of both agents, the reward history
and the headline against it to rtol = atol = 2e-5, printing each
difference and the verdict; ``--no-fma`` compiles the reference for an
ISA without fused multiply-add (ROADMAP C1).  The port side imports no
JAX.
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time

import numpy as np
import torch

from benchmarks.torch_no_fma import use_reference_without_fma

TILE_SEED = 11
APP_HELDOUT_OFFSET = 101
N_TRAIN, N_HELDOUT, N_PHASES, ITERS, BATCH = 8, 6, 3, 12, 4
SETS = ("heldout_apps", "heldout_socs")
AGENTS = ("tabular", "mlp")
TOL = 2e-5   # rtol = atol, the bound of the reference's own kernel test


def _compile(vecenv, make_application, soc, seed, n_phases):
    app = make_application(soc, seed=seed, n_phases=n_phases)
    return vecenv.compile_app(app, soc, seed=TILE_SEED)


def _train_shared_table(items, cfg, iterations, key):
    """The tabular control: ONE Q-table trained over the same (pair x
    iteration) episode stream the network sees, one launch per episode."""
    from repro_torch import random as prng
    from repro_torch.core import qlearn
    qs = qlearn.init_qstate(cfg, items[0][0].device)
    for it in range(iterations):
        for j, (env, comps) in enumerate(items):
            comp = comps[it % len(comps)]
            k = prng.fold_in(key, it * len(items) + j)
            qs, _ = env.episode(comp, policy="q", qstate=qs, cfg=cfg, key=k)
    return qlearn.freeze(qs)


def _eval_agents(env, comp, qs, mlp, seed):
    """(speedup, off-chip reduction) vs NON_COH of the tabular and MLP
    agents on one (SoC, app); the three episodes share one key."""
    from repro_torch import random as prng
    from repro_torch.core.modes import CoherenceMode
    from repro_torch.soc import nn as socnn, vecenv
    key = prng.PRNGKey(seed % (2 ** 31 - 1))
    sched = env._sched(comp)
    base = env.lower(comp, "fixed",
                     fixed_modes=int(CoherenceMode.NON_COH_DMA))
    _, rb = env.episode_spec(comp, base, key=key)
    _, rt = env.episode_spec(comp, vecenv.learned_policy_spec(qs, sched),
                             key=key)
    _, rm = env.episode_spec(
        comp, vecenv.mlp_policy_spec(socnn.freeze(mlp), sched), key=key)
    tb = float(np.sum(rb.phase_time.cpu().numpy()))
    mb = float(np.sum(rb.phase_offchip.cpu().numpy()))
    out = {}
    for name, r in (("tabular", rt), ("mlp", rm)):
        t = float(np.sum(r.phase_time.cpu().numpy()))
        m = float(np.sum(r.phase_offchip.cpu().numpy()))
        out[name] = (1.0 - t / tb, 1.0 - m / max(mb, 1e-9))
    return out


def _set_summary(rows):
    return {"mean_speedup_vs_noncoh": {
                k: float(np.mean([r[k][0] for r in rows])) for k in AGENTS},
            "mean_offchip_reduction_vs_noncoh": {
                k: float(np.mean([r[k][1] for r in rows])) for k in AGENTS},
            "n": len(rows)}


def headline(apps_sum: dict, socs_sum: dict) -> dict:
    sp = lambda s, a: s["mean_speedup_vs_noncoh"][a]
    off = lambda s, a: s["mean_offchip_reduction_vs_noncoh"][a]
    return {
        "heldout_ok": bool(
            sp(apps_sum, "mlp") > 0 and sp(socs_sum, "mlp") > 0
            and off(apps_sum, "mlp") > 0 and off(socs_sum, "mlp") > 0
            and sp(apps_sum, "mlp") > sp(apps_sum, "tabular")
            and sp(socs_sum, "mlp") > sp(socs_sum, "tabular")),
        "mlp_speedup_heldout_apps": sp(apps_sum, "mlp"),
        "mlp_speedup_heldout_socs": sp(socs_sum, "mlp"),
        "mlp_offchip_reduction_heldout_apps": off(apps_sum, "mlp"),
        "mlp_offchip_reduction_heldout_socs": off(socs_sum, "mlp"),
        "tabular_speedup_heldout_apps": sp(apps_sum, "tabular"),
        "tabular_speedup_heldout_socs": sp(socs_sum, "tabular"),
    }


def run_port(device=None, n_train: int = N_TRAIN, n_heldout: int = N_HELDOUT,
             n_phases: int = N_PHASES, iterations: int = ITERS,
             batch: int = BATCH, key: int = 0, keep_agents: bool = False):
    """The port's Fig. 13 as a JSON-ready dict; with ``keep_agents`` also
    ``(frozen Q-table, network)``."""
    from repro_torch import random as prng, resolve_device
    from repro_torch.core import qlearn
    from repro_torch.kernels.soc_step import ops as soc_ops
    from repro_torch.soc import dse, nn as socnn, vecenv
    from repro_torch.soc.apps import make_application

    dev = resolve_device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    comp = lambda soc, seed: _compile(vecenv, make_application, soc,
                                      seed, n_phases)
    sync()
    soc_ops.reset_launches()
    t0 = time.perf_counter()
    samples = dse.sample_socs(key, n_train + n_heldout)
    train_s, held_s = samples[:n_train], samples[n_train:]
    items, envs = [], []
    for s in train_s:
        env = vecenv.VecEnv(s.config, seed=0, device=dev)
        envs.append(env)
        items.append((env, [comp(s.config, s.seed + d) for d in (0, 1)]))
    total_steps = sum(c.n_steps for _, cs in items for c in cs) // 2
    cfg = qlearn.QConfig(decay_steps=total_steps * iterations)
    sync()
    t_setup = time.perf_counter()
    mlp, hist = socnn.train_portfolio(
        items, cfg, iterations=iterations, batch=batch,
        key=prng.PRNGKey(key + 1, device=dev))
    sync()
    t_mlp = time.perf_counter()
    qs = _train_shared_table(items, cfg, iterations,
                             prng.PRNGKey(key + 1, device=dev))
    sync()
    t_train = time.perf_counter()
    launches_train = (soc_ops.launches, soc_ops.mlp_launches)

    rows_apps = [_eval_agents(env, comp(s.config, s.seed + APP_HELDOUT_OFFSET),
                              qs, mlp, s.seed)
                 for s, env in zip(train_s, envs)]
    rows_socs = [_eval_agents(vecenv.VecEnv(s.config, seed=0, device=dev),
                              comp(s.config, s.seed + APP_HELDOUT_OFFSET),
                              qs, mlp, s.seed)
                 for s in held_s]
    sync()
    t_end = time.perf_counter()
    apps_sum, socs_sum = _set_summary(rows_apps), _set_summary(rows_socs)
    n_eval = n_train + n_heldout
    results = {
        "_engine": {
            "path": "repro_torch", "key": key, "n_train_socs": n_train,
            "n_heldout_socs": n_heldout, "n_phases": n_phases,
            "iterations": iterations, "batch": batch,
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
            "mlp": {"features": mlp.cfg.features,
                    "hidden": list(mlp.cfg.hidden), "lr": float(mlp.cfg.lr),
                    "pack_shape": list(mlp.wpack.shape[1:]),
                    "final_step": int(mlp.step[0])},
            "episode_launches": soc_ops.launches,
            "mlp_episode_launches": soc_ops.mlp_launches,
            "train_launches": list(launches_train),
            "expected_episode_launches": iterations * n_train + 2 * n_eval,
            "expected_mlp_episode_launches": iterations * n_train + n_eval,
            "setup_s": t_setup - t0, "train_mlp_s": t_mlp - t_setup,
            "train_table_s": t_train - t_mlp, "train_s": t_train - t0,
            "eval_s": t_end - t_train, "wall_s": t_end - t0,
        },
        "train_reward_history": [float(h) for h in hist.cpu().numpy()],
        "heldout_apps": apps_sum,
        "heldout_socs": socs_sum,
        "_headline": headline(apps_sum, socs_sum),
        "per_soc": {
            "heldout_apps": [{"name": s.config.name,
                              **{a: list(r[a]) for a in AGENTS}}
                             for s, r in zip(train_s, rows_apps)],
            "heldout_socs": [{"name": s.config.name,
                              **{a: list(r[a]) for a in AGENTS}}
                             for s, r in zip(held_s, rows_socs)],
        },
    }
    return (results, (qs, mlp)) if keep_agents else results


def run_reference() -> dict:
    """The reference's full-width ``run(quick=False, key=0)``, its report
    written to a temporary directory and read back."""
    from benchmarks import common, fig13_generalize
    saved = common.REPORT_DIR
    with tempfile.TemporaryDirectory() as tmp:
        common.REPORT_DIR = tmp
        try:
            fig13_generalize.run(quick=False, key=0)
            with open(f"{tmp}/fig13_generalize.json") as f:
                return json.load(f)
        finally:
            common.REPORT_DIR = saved


def print_results(tag: str, results: dict) -> None:
    for st in SETS:
        for row in results["per_soc"][st]:
            print(f"{tag} {st} {row['name']}: " + " ".join(
                f"{a}=({row[a][0]:.6f}, {row[a][1]:.6f})" for a in AGENTS))
    hist = " ".join(f"{h:.6f}" for h in results["train_reward_history"])
    print(f"{tag} reward history: {hist}")
    print(f"{tag} headline: " + " ".join(
        f"{k}={v:.6f}" if isinstance(v, float) else f"{k}={v}"
        for k, v in results["_headline"].items()))


def compare(port: dict, ref: dict) -> bool:
    """Print every differing number and whether every per-SoC value of
    both agents, the reward history and the headline are within ``|port -
    ref| <= TOL + TOL * |ref|``; returns that verdict (``heldout_ok`` is
    reported, not compared)."""
    gap = worst = 0.0

    def check(what, a, b):
        nonlocal gap, worst
        g = abs(a - b) / max(abs(b), 1e-30)
        gap = max(gap, g)
        worst = max(worst, abs(a - b) / (TOL + TOL * abs(b)))
        if g > 0:
            print(f"differs {what}: port {a:.9g} reference {b:.9g} "
                  f"abs {abs(a - b):.3g} rel {g:.3g}")

    for st in SETS:
        for p, r in zip(port["per_soc"][st], ref["per_soc"][st]):
            if p["name"] != r["name"]:
                print(f"SoC names differ: {p['name']} vs {r['name']}")
                return False
            for a in AGENTS:
                for j, part in enumerate(("speedup", "offchip")):
                    check(f"{st} {r['name']} {a} {part}", p[a][j], r[a][j])
    for i, (a, b) in enumerate(zip(port["train_reward_history"],
                                   ref["train_reward_history"])):
        check(f"reward history {i}", a, b)
    for k, v in ref["_headline"].items():
        if k != "heldout_ok":
            check(f"headline {k}", port["_headline"][k], v)
    print(f"heldout_ok: port {port['_headline']['heldout_ok']}, reference "
          f"{ref['_headline']['heldout_ok']}")
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
        if args.out:
            with open(args.out, "w") as f:
                json.dump(port, f, indent=1)
    print_results("port", port)
    e = port["_engine"]
    print(f"port engine: {e['device']} wall {e['wall_s']:.3f} s (train "
          f"{e['train_s']:.3f} s, evaluate {e['eval_s']:.3f} s); table "
          f"launches {e['episode_launches']} (expected "
          f"{e['expected_episode_launches']}), MLP launches "
          f"{e['mlp_episode_launches']} (expected "
          f"{e['expected_mlp_episode_launches']})")
    if args.reference or args.compare:
        if args.no_fma:
            use_reference_without_fma()
        ref = run_reference()
        print_results("reference", ref)
        compare(port, ref)


if __name__ == "__main__":
    main()
