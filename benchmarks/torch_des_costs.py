"""What one invocation of the port's event-driven simulator costs, piece by
piece, on one device.

    PYTHONPATH=src python -m benchmarks.torch_des_costs [--device cuda|cpu]

Times, as the median of 200 calls after 5 warm-up calls (host clock, the
card synchronized after each call), the pieces ``SoCSimulator.run`` calls
for one invocation on SoC-motiv-par with eight accelerators in flight:
the timing model (the CUDA graph on the card, beside its eager ops),
the sensing (``observe_host``), the reward (``rewards.evaluate``), a Q
agent's ``decide`` and ``observe_reward``, a sense MLP agent's
``decide`` and the manual policy's; then whole runs: Fig. 3's 12-thread
app under fixed COH_DMA (72 invocations) and a learning Q agent on a
two-phase app, as invocations a second.  Prints one line a piece and the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import numpy as np
import torch


def _timer(dev):
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def ms(fn, n=200, warm=5):
        for _ in range(warm):
            fn()
        sync()
        out = []
        for _ in range(n):
            t = time.perf_counter()
            fn()
            sync()
            out.append((time.perf_counter() - t) * 1e3)
        return statistics.median(out)
    return ms


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    from repro_torch import random as prng, resolve_device
    from repro_torch.core import qlearn, rewards, state as cstate
    from repro_torch.core.modes import CoherenceMode
    from repro_torch.core.policies import (DecisionContext,
                                           FixedHomogeneous, ManualPolicy,
                                           QPolicy)
    from repro_torch.soc import des, nn as socnn
    from repro_torch.soc.apps import make_application
    from repro_torch.soc.config import SOC_MOTIV_PAR, WORKLOAD_MEDIUM

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    ms = _timer(dev)
    soc = SOC_MOTIV_PAR
    sim = des.SoCSimulator(soc, device=dev)
    rng = np.random.default_rng(0)
    k, nt = 8, soc.n_mem_tiles
    slots = np.zeros((des.MAX_SLOTS, 3 + nt), np.float32)
    slots[:, 0] = -1.0
    slots[:k, 0] = rng.integers(0, 4, k)
    slots[:k, 1] = np.arange(1, k + 1)
    slots[:k, 2] = WORKLOAD_MEDIUM
    slots[:k, 3:] = rng.random((k, nt)) < 0.6
    packed = np.concatenate([np.asarray([2, 0, WORKLOAD_MEDIUM, 1.0],
                                        np.float32),
                             np.ones(nt, np.float32), slots.reshape(-1)])
    modes = [int(m) for m in slots[:k, 0]]
    fps = [float(WORKLOAD_MEDIUM)] * k
    tiles = [slots[i, 3:] > 0.5 for i in range(k)]
    ctx = DecisionContext(
        acc_id=0, acc_name=sim.profiles[0].name, footprint=WORKLOAD_MEDIUM,
        state_idx=17, active_modes=modes, active_footprint=sum(fps),
        available=[True] * 4, soc=soc, rng=np.random.default_rng(1),
        active_footprints=fps, target_tiles=[True] * nt,
        profile=sim.pmat[0])
    agent = QPolicy(qlearn.QConfig(decay_steps=10**6), device=dev)
    mlp = socnn.init_mlp_qstate(prng.PRNGKey(3))
    mlp_pol = socnn.MLPQPolicy(socnn.MLPQState(
        *(v.to(dev) for v in mlp[:4]), cfg=mlp.cfg))
    rs = rewards.init_reward_state(soc.n_accs, (1,), device=dev)
    meas = rewards.Measurement(*torch.tensor(
        [[2e5], [1e5], [1.9e5], [2e3], [2.6e5]], device=dev))
    acc = torch.tensor([0], dtype=torch.int32, device=dev)
    pieces = [
        ("timing model", lambda: sim.perf_fn(packed)),
        ("timing model, eager ops", lambda: sim.perf_fn.eager(
            torch.from_numpy(packed).to(dev)).cpu()),
        ("sensing (observe_host)", lambda: cstate.observe_host(
            active_modes=modes, active_footprints=fps, needed_tiles=tiles,
            target_tiles=[True] * nt, target_footprint=WORKLOAD_MEDIUM,
            geom=sim.geom, device=dev)),
        ("reward (evaluate)", lambda: float(rewards.evaluate(
            rs, acc, meas)[0][0])),
        ("Q agent decide", lambda: agent.decide(ctx)),
        ("Q agent observe_reward", lambda: agent.observe_reward(
            ctx, 1, 0.5)),
        ("MLP agent decide", lambda: mlp_pol.decide(ctx)),
        ("manual decide", lambda: ManualPolicy().decide(ctx)),
    ]
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    for name, fn in pieces:
        print(f"{where}: {name}: {ms(fn):.4f} ms a call")

    app = des.Application(name="par12", phases=[des.Phase(
        name="p", threads=[des.Thread(chain=[des.Invocation(
            i, WORKLOAD_MEDIUM)], loops=6) for i in range(12)])])
    train_app = make_application(soc, seed=0, n_phases=2)
    for name, run in (
            ("Fig. 3's 12 threads, fixed COH_DMA", lambda: sim.run(
                app, FixedHomogeneous(CoherenceMode.COH_DMA), train=False)),
            ("a learning Q agent, 2-phase app", lambda: sim.run(
                train_app, QPolicy(qlearn.QConfig(decay_steps=600),
                                   device=dev), train=True))):
        run()
        n0, t = sim.invocations, time.perf_counter()
        run()
        n, secs = sim.invocations - n0, time.perf_counter() - t
        print(f"{where}: {name}: {n} invocations in {secs:.3f} s, "
              f"{n / secs:.1f} a second")


if __name__ == "__main__":
    main()
