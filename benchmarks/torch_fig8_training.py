"""Paper Fig. 8 (performance against training iterations) through the
port, beside the JAX reference.

    PYTHONPATH=src python -m benchmarks.torch_fig8_training [--fidelity] \
        [--device cuda|cpu] [--out port.json] [--compare port.json] \
        [--reference] [--no-fma]

Mirrors ``benchmarks/fig8_training.py`` at full width on SoC-motiv-par:
10 iterations of an 8-phase app, each followed by a frozen evaluation on
another instance against the NON_COH baseline.  By default the batched
environment runs the curve twice, with true per-invocation off-chip
counts feeding the reward and with the simulator's prorated DDR
attribution (``VecEnv(ddr_attribution=True)``); ``--fidelity`` runs it
on the event-driven simulator (``train_cohmeleon(eval_each_iteration=
True)``).  It prints the first and last normalized time, the wall time
and, on the event-driven path, the invocations a second, and writes the
report to ``--out``; the options are those of
``benchmarks/torch_des_common.py``.
"""
from __future__ import annotations

import time

from benchmarks.torch_des_common import engine, main

NAME = "fig8_training"
ITERS, N_PHASES = 10, 8


def run_port(device=None, fidelity: bool = False) -> dict:
    from repro_torch.core.orchestrator import (train_cohmeleon,
                                               train_cohmeleon_batched)
    from repro_torch.soc import vecenv as vec
    from repro_torch.soc.config import SOC_MOTIV_PAR
    from repro_torch.soc.des import SoCSimulator

    t0 = time.perf_counter()
    sims = []
    if fidelity:
        sims.append(SoCSimulator(SOC_MOTIV_PAR, device=device))
        _, hist = train_cohmeleon(sims[0], iterations=ITERS, seed=2,
                                  eval_each_iteration=True,
                                  n_phases=N_PHASES)
        payload = {"path": "des", "iteration": hist.iteration,
                   "norm_time": hist.exec_time, "norm_mem": hist.offchip}
    else:
        kw = dict(iterations=ITERS, seed=2, n_phases=N_PHASES,
                  eval_each_iteration=True)
        res = train_cohmeleon_batched(SOC_MOTIV_PAR, device=device, **kw)
        nt = [float(v) for v in res.hist_time[0]]
        nm = [float(v) for v in res.hist_mem[0]]
        res_a = train_cohmeleon_batched(
            SOC_MOTIV_PAR, env=vec.VecEnv(SOC_MOTIV_PAR, ddr_attribution=True,
                                          device=device), **kw)
        at = [float(v) for v in res_a.hist_time[0]]
        am = [float(v) for v in res_a.hist_mem[0]]
        payload = {"path": "vecenv", "iteration": list(range(1, ITERS + 1)),
                   "norm_time": nt, "norm_mem": nm,
                   "ddr_attribution": {
                       "norm_time": at, "norm_mem": am,
                       "final_time_delta": at[-1] - nt[-1],
                       "final_mem_delta": am[-1] - nm[-1]}}
    payload["_headline"] = {"iter1_time": payload["norm_time"][0],
                            "last_time": payload["norm_time"][-1]}
    payload["_engine"] = engine(sims, t0, device, payload["path"])
    return payload


def print_results(tag: str, r: dict) -> None:
    print(f"{tag} fig8 ({r['path']}): norm_time " + " ".join(
        f"{v:.6f}" for v in r["norm_time"]) + "; norm_mem " + " ".join(
        f"{v:.6f}" for v in r["norm_mem"]))
    if "ddr_attribution" in r:
        a = r["ddr_attribution"]
        print(f"{tag} fig8 ddr_attribution: final_time_delta="
              f"{a['final_time_delta']:.6f} final_mem_delta="
              f"{a['final_mem_delta']:.6f}")


if __name__ == "__main__":
    main(NAME, NAME, run_port, print_results)
