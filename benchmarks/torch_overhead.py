"""The decision path's cost per invocation (paper §6, "Cohmeleon
Overhead") through the PyTorch/CUDA port, beside the JAX reference.

    PYTHONPATH=src python -m benchmarks.torch_overhead \
        [--devices cuda,cpu] [--out port.json] [--reference] \
        [--autotune-steps N]

As ``benchmarks/overhead.py`` does, on each device: a Q agent trained
for 2 iterations of a 4-phase SOC_MOTIV_PAR app on the event-driven
simulator (``train_cohmeleon``), frozen, then one run of another 4-phase
app; ``decide_overhead_s`` is the run's mean host seconds per decision,
compared with the simulated execution time (10 ns cycles) of its small
(footprint <= 32 KB) and large (>= 1 MB) invocations.  The paper reports
3-6% for small workloads and < 0.1% for large ones.  ``--devices``
defaults to the card and the machine's CPU; without a card the run
raises, and ``--devices cpu`` measures the CPU alone.  ``--reference`` also runs the reference's ``overhead.run`` on the
CPU, its report written to a temporary directory.

Then the memory-mode autotuner's decide path (``core.autotune``, the
beyond-paper use the reference's ``overhead.py`` names): ``N`` train
steps (default 40) of Qwen3-8B's smoke configuration (B 8, seq 64) under
``MemoryModeOrchestrator`` on each device; ``decide_overhead_s`` is the
mean host seconds of sensing and selecting per step, beside the mean
step.  The port side imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time

import numpy as np
import torch

CYCLE = 1e-8


def run_port(device=None) -> dict:
    from repro_torch import resolve_device
    from repro_torch.core.orchestrator import train_cohmeleon
    from repro_torch.soc.apps import make_application
    from repro_torch.soc.config import (SOC_MOTIV_PAR, WORKLOAD_LARGE,
                                        WORKLOAD_SMALL)
    from repro_torch.soc.des import SoCSimulator

    dev = resolve_device(device)
    sim = SoCSimulator(SOC_MOTIV_PAR, device=dev)
    t0 = time.perf_counter()
    policy, _ = train_cohmeleon(sim, iterations=2, seed=0, n_phases=4)
    t1 = time.perf_counter()
    app = make_application(sim.soc, seed=77, n_phases=4)
    res = sim.run(app, policy, seed=1, train=False)
    t2 = time.perf_counter()
    small, large = [], []
    for ph in res.phases:
        for r in ph.invocations:
            if r.footprint <= WORKLOAD_SMALL * 2:
                small.append(r.exec_time)
            elif r.footprint >= WORKLOAD_LARGE / 4:
                large.append(r.exec_time)
    small_s = float(np.mean(small)) * CYCLE if small else None
    large_s = float(np.mean(large)) * CYCLE if large else None
    d = res.decide_overhead_s
    n_inv = sum(len(ph.invocations) for ph in res.phases)
    return {
        "decide_overhead_us": d * 1e6,
        "small_invocation_s": small_s, "large_invocation_s": large_s,
        "n_small": len(small), "n_large": len(large),
        "frac_small": d / small_s if small_s else None,
        "frac_large": d / large_s if large_s else None,
        "paper": "3-6% small, <0.1% large",
        "_engine": {
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
            "train_s": t1 - t0, "run_s": t2 - t1, "invocations": n_inv,
            "invocations_per_s": n_inv / (t2 - t1)},
    }


def run_autotune(device=None, steps: int = 40) -> dict:
    from repro_torch import resolve_device
    from repro_torch.configs import smoke_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.core.autotune import MemoryModeOrchestrator
    from repro_torch.data.synthetic import DataConfig, host_batch
    from repro_torch.launch import steps as steps_lib

    dev = resolve_device(device)
    cfg = smoke_config("qwen3-8b")
    orch = MemoryModeOrchestrator(cfg, ShapeSpec("overhead", "train", 64, 8),
                                  seed=0, total_steps=steps)
    state = steps_lib.make_train_state(cfg, 0, dev)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in host_batch(
        cfg, DataConfig(64, 8, seed=i), i).items()} for i in range(steps)]
    t0 = time.perf_counter()
    for batch in batches:
        state, _ = orch.step(state, batch)
    wall = time.perf_counter() - t0
    d = orch.decide_overhead_s()
    return {"decide_overhead_us": d * 1e6, "step_s": wall / steps,
            "frac_step": d / (wall / steps), "steps": steps,
            "decisions": orch.decision_counts(),
            "_engine": {"device": (torch.cuda.get_device_name(dev)
                                   if dev.type == "cuda" else "cpu")}}


def run_reference() -> dict:
    from benchmarks import common, overhead
    saved = common.REPORT_DIR
    with tempfile.TemporaryDirectory() as tmp:
        common.REPORT_DIR = tmp
        try:
            print(f"reference: {overhead.run()}")
            with open(f"{tmp}/overhead.json") as f:
                return json.load(f)
        finally:
            common.REPORT_DIR = saved


def _fmt(v, spec):
    return "n/a" if v is None else format(v, spec)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", default="cuda,cpu",
                    help="comma-separated devices (default: cuda,cpu; "
                         "without a card pass --devices cpu)")
    ap.add_argument("--out")
    ap.add_argument("--reference", action="store_true")
    ap.add_argument("--autotune-steps", type=int, default=40)
    args = ap.parse_args()
    devices = args.devices.split(",")
    out = {}
    for d in devices:
        r = run_port(d)
        out[d] = r
        e = r["_engine"]
        print(f"port {d} ({e['device']}): decide "
              f"{r['decide_overhead_us']:.1f} us; small invocation "
              f"{_fmt(r['small_invocation_s'], '.4g')} s -> "
              f"{_fmt(r['frac_small'], '.4f')}; large "
              f"{_fmt(r['large_invocation_s'], '.4g')} s -> "
              f"{_fmt(r['frac_large'], '.5f')}; run {e['run_s']:.3f} s "
              f"({e['invocations_per_s']:.1f} invocations a second)")
        if args.autotune_steps:
            a = run_autotune(d, args.autotune_steps)
            r["autotune"] = a
            print(f"port {d} autotuner ({a['_engine']['device']}): decide "
                  f"{a['decide_overhead_us']:.1f} us a step of "
                  f"{a['step_s'] * 1e3:.2f} ms ({a['frac_step']:.4f}); "
                  f"decisions {a['decisions']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    if args.reference:
        ref = run_reference()
        print(f"reference (CPU): decide {ref['decide_overhead_us']:.1f} us; "
              f"frac_small {_fmt(ref['frac_small'], '.4f')}, frac_large "
              f"{_fmt(ref['frac_large'], '.5f')}")


if __name__ == "__main__":
    main()
