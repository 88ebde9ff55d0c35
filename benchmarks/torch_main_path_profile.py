"""Where the port's main path spends its time on the card.

    PYTHONPATH=src python -m benchmarks.torch_main_path_profile

Runs the full-width Fig. 6 slice (the one ``chip_smoke.py`` drives) once
to warm up, then (1) times its host-side pieces one by one with the
device synchronized around each, and (2) runs it again under
``torch.profiler`` and prints the device's busy share of the wall time
and the device time by kernel name.  Needs a CUDA card; prints the card's
name and power limit beside every number.
"""
from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.core import orchestrator as orch
from repro_torch.core import policies as pol
from repro_torch.core import qlearn, rewards
from repro_torch.core.modes import CoherenceMode
from repro_torch.soc import apps, vecenv as vec
from repro_torch.soc.config import SOC_MOTIV_PAR

WEIGHTS = [
    (0.675, 0.075, 0.25), (0.125, 0.125, 0.75), (1.0, 0.0, 0.0),
    (0.0, 0.0, 1.0), (0.05, 0.05, 0.90), (0.33, 0.33, 0.34),
    (0.5, 0.25, 0.25), (0.25, 0.5, 0.25), (0.8, 0.1, 0.1),
    (0.1, 0.8, 0.1), (0.45, 0.1, 0.45), (0.6, 0.0, 0.4),
    (0.9, 0.05, 0.05), (0.2, 0.2, 0.6), (0.4, 0.4, 0.2),
]


def main_path(env):
    res = orch.train_cohmeleon_batched(
        SOC_MOTIV_PAR, iterations=10, seed=11, weights=WEIGHTS, n_seeds=8,
        n_phases=6, env=env)
    test_app = apps.make_application(SOC_MOTIV_PAR, seed=900, n_phases=6)
    res.evaluate(test_app, seed=5)
    suite = ([pol.FixedHomogeneous(m) for m in CoherenceMode]
             + [pol.RandomPolicy(), pol.ManualPolicy(), res.qpolicy(0)])
    orch.compare_policies(env, test_app, suite, seed=5)
    torch.cuda.synchronize()


def timed(fn, reps=3):
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return float(np.median(out)) * 1e3


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    dev = torch.device("cuda")
    env = vec.VecEnv(SOC_MOTIV_PAR, device=dev)
    main_path(env)                                   # warm-up + build
    wall = timed(lambda: main_path(env), reps=3)
    print(f"card: {card}")
    print(f"main path: {wall:.1f} ms wall (median of 3)")

    soc = SOC_MOTIV_PAR
    app = apps.make_application(soc, seed=11, n_phases=6)
    compiled = vec.compile_app(app, soc, seed=11)
    sched = compiled.schedule.to(dev)
    b = len(WEIGHTS) * 8
    cfg = qlearn.QConfig(decay_steps=compiled.n_steps * 10)
    keys = prng.PRNGKey(np.arange(b), device=dev)
    wb = rewards.stack_weights(WEIGHTS * 8, device=dev)
    spec = vec.learned_policy_spec(qlearn.init_qstate_batch(cfg, b, dev),
                                   sched)
    pieces = {
        "make_application + compile_app (1 iteration)": lambda:
            vec.compile_app(apps.make_application(soc, seed=11, n_phases=6),
                            soc, seed=11),
        "manual policy mode table (540-step loop)": lambda:
            vec.manual_policy_spec(env.params, sched),
        "episode inputs (noise, decay, pregather)": lambda:
            vec.episode_inputs(env.params, sched, spec, cfg, keys),
        "one training episode, B=120 (inputs + kernel + metric tail)":
            lambda: env._run(compiled, sched, spec, cfg, wb, keys),
    }
    for name, fn in pieces.items():
        print(f"{name}: {timed(fn):.2f} ms on {card}")

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        main_path(env)
        traced = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
        if dev_us:
            rows.append((dev_us, evt.key, evt.count))
    busy = sum(r[0] for r in rows) / 1e3
    print(f"traced main path: {traced:.1f} ms wall, device busy "
          f"{busy:.1f} ms ({100 * busy / traced:.1f}%), idle "
          f"{100 * (1 - busy / traced):.1f}% on {card}")
    for dev_us, key, count in sorted(rows, reverse=True)[:8]:
        print(f"  device {dev_us / 1e3:9.2f} ms  x{count:<6d} {key[:70]}")


if __name__ == "__main__":
    main()
