"""Training invocations a second across the port's simulation engines.

    PYTHONPATH=src:. python -m benchmarks.torch_vecenv_throughput \
        [--device cuda|cpu] [--quick] [--out port.json]

``benchmarks/vecenv_throughput.py``'s measurements on the same Fig. 6
workload (SOC_MOTIV_PAR, a 6-phase application), through the port:

  * the serial event-driven simulator (one learning agent, one run);
  * the batched step variants, 128 agents in one ``train_batched`` call:
    ``pr1_step`` (per-step key splitting and every slot's demand
    recomputed each step: the reference's original step), ``demand_
    recompute`` (only the demand recomputed), ``unfused`` (the cached
    demand and presampled noise, step by step in plain PyTorch) and
    ``fast`` (the episode kernel, K1, one launch);
  * the zero-fault tax: ``fast`` with an all-neutral ``FaultSpec`` (the
    faulted kernel, K1f) against ``fast``, interleaved call by call;
  * the stacked Fig. 9 SoC set (8 lanes, 4 agents each, 2 iterations of
    a 4-phase app): one stacked call vs one batched call per SoC in turn
    vs length-bucketed lanes;
  * ``soc.shard``: the default path (the plain call on one device) vs
    the forced split.

Every rate is the median of 5 timed calls after a first one, with its
spread ((max - min) / median).  ``--quick`` takes the first 3 stacked
lanes.  The reference's ``--check-regression`` against its committed
JSON has no counterpart: that JSON holds CPU numbers of another engine.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

N_AGENTS = 128
REPS = 5


def _median_rate(fn, total_inv: int, sync, reps: int = REPS) -> dict:
    """Invocations a second of the median of ``reps`` timed calls (after
    one untimed call), the first call's seconds and the spread."""
    t0 = time.perf_counter()
    fn()
    sync()
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    return {"inv_per_s": total_inv / med, "median_s": med,
            "first_s": first, "spread": (max(times) - min(times)) / med}


def _stacked_rates(dev, sync, quick: bool) -> dict:
    from benchmarks.torch_fig9_socs import SOC_FLAVORS
    from repro_torch import random as prng
    from repro_torch.core import qlearn, rewards
    from repro_torch.soc import stacked as stk, vecenv
    from repro_torch.soc.apps import make_application
    from repro_torch.soc.config import SOCS

    flavors = SOC_FLAVORS[:3] if quick else SOC_FLAVORS
    iters, b, n_phases = 2, 4, 4
    envs = [vecenv.VecEnv(SOCS[n], seed=1, flavor=f, device=dev)
            for n, f in flavors]
    env = stk.StackedVecEnv([e.soc for e in envs], envs=envs)
    apps = [make_application(e.soc, seed=0, n_phases=n_phases)
            for e in envs]
    st_iters = [env.compile(apps, seed=it) for it in range(iters)]
    n_steps = st_iters[0].n_steps
    cfg = qlearn.QConfig(decay_steps=torch.tensor(
        [s * iters for s in n_steps], dtype=torch.int32))
    wb = rewards.stack_weights([rewards.PAPER_DEFAULT_WEIGHTS] * b)
    k = len(envs)
    keys = prng.PRNGKey(np.arange(k * b), device=dev).reshape(k, b, 2)
    total = sum(n_steps) * b * iters

    stacked = _median_rate(
        lambda: env.train_batched(st_iters, cfg, wb, keys), total, sync)

    per_lane = []
    for i, e in enumerate(envs):
        compiled = [vecenv.compile_app(apps[i], e.soc, seed=it)
                    for it in range(iters)]
        per_lane.append((e, compiled, qlearn.QConfig(
            decay_steps=compiled[0].n_steps * iters), keys[i]))

    def sequential():
        for e, compiled, c, ks in per_lane:
            e.train_batched(compiled, c, wb, ks)

    seq = _median_rate(sequential, total, sync)

    groups = stk.length_buckets(n_steps)
    buckets = []
    for g in groups:
        sub = env.sublanes(g)
        sub_iters = [sub.compile([apps[i] for i in g], seed=it)
                     for it in range(iters)]
        buckets.append((sub, sub_iters, qlearn.QConfig(
            decay_steps=torch.tensor([n_steps[i] * iters for i in g],
                                     dtype=torch.int32)), keys[list(g)]))

    def bucketed():
        for sub, sub_iters, c, ks in buckets:
            sub.train_batched(sub_iters, c, wb, ks)

    buck = _median_rate(bucketed, total, sync)
    real = sum(n_steps)
    vol = sum(len(g) * max(n_steps[i] for i in g) for g in groups)
    return {
        "lanes": k, "agents_per_lane": b, "invocations": int(total),
        "stacked": stacked, "sequential": seq, "bucketed": buck,
        "stacking_speedup": stacked["inv_per_s"] / seq["inv_per_s"],
        "length_buckets": [list(map(int, g)) for g in groups],
        "bucketing_speedup": buck["inv_per_s"] / stacked["inv_per_s"],
        "padded_waste_single_call": stk.padded_waste(st_iters[0]),
        "padded_waste_bucketed": 1.0 - real / float(vol),
    }


def run(device=None, quick: bool = False) -> dict:
    from repro_torch import random as prng, resolve_device
    from repro_torch.core import qlearn, rewards
    from repro_torch.core.policies import QPolicy
    from repro_torch.kernels.soc_step import ops as soc_ops
    from repro_torch.soc import faults as fault_mod, shard, vecenv
    from repro_torch.soc.apps import make_application
    from repro_torch.soc.config import SOC_MOTIV_PAR
    from repro_torch.soc.des import SoCSimulator

    dev = resolve_device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    soc = SOC_MOTIV_PAR
    sim = SoCSimulator(soc, device=dev)
    app = make_application(soc, seed=11, n_phases=6)   # Fig. 6 workload
    compiled = vecenv.compile_app(app, soc, seed=11)
    n_inv = compiled.n_steps
    cfg = qlearn.QConfig(decay_steps=n_inv)

    # the serial fidelity path: one learning agent, one run
    policy = QPolicy(cfg, seed=0, device=dev)
    sync()
    t0 = time.perf_counter()
    sim.run(app, policy, seed=11, train=True)
    sync()
    t_des = time.perf_counter() - t0

    wb = rewards.stack_weights([rewards.PAPER_DEFAULT_WEIGHTS] * N_AGENTS)
    keys = prng.PRNGKey(np.arange(N_AGENTS), device=dev)
    variants = {
        "pr1_step": dict(demand_cache=False, presample_noise=False),
        "demand_recompute": dict(demand_cache=False),
        "unfused": dict(fused_step=False),
        "fast": {},
    }
    rates, envs = {}, {}
    for name, kw in variants.items():
        env = vecenv.VecEnv.from_simulator(sim, **kw)
        envs[name] = env
        rates[name] = _median_rate(
            lambda env=env: env.train_batched([compiled], cfg, wb, keys),
            N_AGENTS * n_inv, sync)

    # zero-fault tax, the two calls interleaved
    fast = envs["fast"]
    zero = fault_mod.no_faults(device=dev)
    calls = {"fast": lambda: fast.train_batched([compiled], cfg, wb, keys),
             "zero": lambda: fast.train_batched([compiled], cfg, wb, keys,
                                                faults=zero)}
    calls["zero"]()
    sync()
    times = {"fast": [], "zero": []}
    for _ in range(2 * REPS):
        for k in ("fast", "zero"):
            t0 = time.perf_counter()
            calls[k]()
            sync()
            times[k].append(time.perf_counter() - t0)
    med_zero = float(np.median(times["zero"]))
    fault_zero = {
        "inv_per_s": N_AGENTS * n_inv / med_zero,
        "vs_fast": float(np.median(times["fast"])) / med_zero,
        "spread": (max(times["zero"]) - min(times["zero"])) / med_zero}

    stacked = _stacked_rates(dev, sync, quick)

    devices = shard.lane_devices() if dev.type == "cuda" else [dev]
    soc_ops.reset_launches()
    shard_rates = {
        name: _median_rate(
            lambda force=force: shard.sharded_train_batched(
                fast, [compiled], cfg, wb, keys, devices=devices,
                force=force), N_AGENTS * n_inv, sync)
        for name, force in (("default", False), ("forced", True))}
    fast_rate = rates["fast"]["inv_per_s"]
    return {
        "workload": app.name,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "invocations_per_episode": n_inv,
        "des_episode_s": t_des, "des_inv_per_s": n_inv / t_des,
        "vecenv_agents": N_AGENTS,
        "step_variants": rates,
        "fast_vs_des": fast_rate / (n_inv / t_des),
        "fused_vs_unfused": fast_rate / rates["unfused"]["inv_per_s"],
        "carry_cache_speedup": fast_rate / rates["pr1_step"]["inv_per_s"],
        "carry_cache_isolated_speedup": (
            fast_rate / rates["demand_recompute"]["inv_per_s"]),
        "fault_zero": fault_zero,
        "multi_soc": stacked,
        "sharded": {"device_count": len(devices),
                    "default_path": ("split" if len(devices) > 1
                                     else "plain call"),
                    **shard_rates},
        "timing": {"estimator": "median", "reps": REPS},
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    r = run(args.device, quick=args.quick)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(r, f, indent=1)
    print(f"workload {r['workload']} on {r['device']}: "
          f"{r['invocations_per_episode']} invocations an episode")
    print(f"DES (one learning agent): {r['des_inv_per_s']:.1f} "
          f"invocations a second ({r['des_episode_s']:.3f} s)")
    for name, v in r["step_variants"].items():
        print(f"{name}: {v['inv_per_s']:.1f} invocations a second "
              f"(median {v['median_s']:.4f} s, first {v['first_s']:.3f} "
              f"s, spread {v['spread']:.3f})")
    z = r["fault_zero"]
    print(f"zero-fault spec: {z['inv_per_s']:.1f} a second, "
          f"{z['vs_fast']:.3f}x of fast (spread {z['spread']:.3f})")
    m = r["multi_soc"]
    print(f"stacked {m['lanes']} lanes x {m['agents_per_lane']}: one call "
          f"{m['stacked']['inv_per_s']:.1f}, sequential "
          f"{m['sequential']['inv_per_s']:.1f}, bucketed "
          f"{m['bucketed']['inv_per_s']:.1f} a second (buckets "
          f"{m['length_buckets']}, waste "
          f"{m['padded_waste_single_call']:.4f} -> "
          f"{m['padded_waste_bucketed']:.4f})")
    s = r["sharded"]
    print(f"shard over {s['device_count']} device(s) ({s['default_path']}): "
          f"default {s['default']['inv_per_s']:.1f}, forced "
          f"{s['forced']['inv_per_s']:.1f} a second")
    print(f"fast / DES {r['fast_vs_des']:.1f}x, fused / unfused "
          f"{r['fused_vs_unfused']:.2f}x, fast / pr1_step "
          f"{r['carry_cache_speedup']:.2f}x")


if __name__ == "__main__":
    main()
