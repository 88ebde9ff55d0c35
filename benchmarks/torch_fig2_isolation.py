"""Paper Fig. 2 (accelerators in isolation x 4 modes x 3 workload sizes)
through the port's event-driven simulator, beside the JAX reference.

    PYTHONPATH=src python -m benchmarks.torch_fig2_isolation \
        [--device cuda|cpu] [--out port.json] [--compare port.json] \
        [--reference] [--no-fma]

Mirrors ``benchmarks/fig2_isolation.py`` at full width: every accelerator
of SoC-motiv-iso alone, at 16 KB, 256 KB and 4 MB, one NON_COH baseline
and one run per mode each (12 x 3 x 5 one-invocation runs), normalized
execution time and off-chip accesses per (accelerator, size, mode) cell,
and the winning mode per (accelerator, size).  It prints the number of
distinct winning modes, the wall time and the invocations a second, and
writes the report to ``--out``; the options are those of
``benchmarks/torch_des_common.py``.
"""
from __future__ import annotations

import time

from benchmarks.torch_des_common import engine, main

NAME = "fig2_isolation"


def run_port(device=None) -> dict:
    from repro_torch.core.modes import CoherenceMode, MODE_NAMES
    from repro_torch.core.orchestrator import run_isolated
    from repro_torch.soc.config import (SOC_MOTIV_ISO, WORKLOAD_LARGE,
                                        WORKLOAD_MEDIUM, WORKLOAD_SMALL)
    from repro_torch.soc.des import SoCSimulator

    sizes = {"S": WORKLOAD_SMALL, "M": WORKLOAD_MEDIUM, "L": WORKLOAD_LARGE}
    t0 = time.perf_counter()
    sim = SoCSimulator(SOC_MOTIV_ISO, device=device)
    table = {}
    for acc in range(len(sim.profiles)):
        name = sim.profiles[acc].name
        for label, fp in sizes.items():
            base = run_isolated(sim, acc, CoherenceMode.NON_COH_DMA, fp)
            for mode in CoherenceMode:
                res = run_isolated(sim, acc, mode, fp)
                table[f"{name}|{label}|{MODE_NAMES[mode]}"] = {
                    "norm_time": res.total_time / base.total_time,
                    "norm_mem": (res.total_offchip
                                 / max(base.total_offchip, 1e-9)),
                }
    winners = {}
    for key, v in table.items():
        acc, size, mode = key.split("|")
        cur = winners.get((acc, size))
        if cur is None or v["norm_time"] < cur[1]:
            winners[(acc, size)] = (mode, v["norm_time"])
    return {"cells": table,
            "winners": {f"{a}|{s}": w[0] for (a, s), w in winners.items()},
            "_headline": {"distinct_winning_modes": len(
                {w[0] for w in winners.values()})},
            "_engine": engine([sim], t0, device, "des")}


def print_results(tag: str, r: dict) -> None:
    distinct = len(set(r["winners"].values()))
    print(f"{tag} fig2: {len(r['cells'])} cells, distinct winning modes "
          f"{distinct}/4: " + ", ".join(f"{k}={v}" for k, v in
                                         sorted(r["winners"].items())[:6])
          + " ...")


if __name__ == "__main__":
    main(NAME, NAME, lambda device: run_port(device), print_results,
         fidelity_flag=False)
