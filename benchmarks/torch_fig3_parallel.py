"""Paper Fig. 3 (slowdown under concurrent accelerator execution) through
the port's event-driven simulator, beside the JAX reference.

    PYTHONPATH=src python -m benchmarks.torch_fig3_parallel \
        [--device cuda|cpu] [--out port.json] [--compare port.json] \
        [--reference] [--no-fma]

Mirrors ``benchmarks/fig3_parallel.py`` at full width: on SoC-motiv-par,
1, 4, 8 and 12 concurrent threads, each looping one medium-workload
accelerator 6 times, under each fixed mode (4 x 25 x 6 = 600
invocations); the mean execution time's slowdown against the mode's own
one-thread case and the off-chip total per (mode, threads).  It prints
the headline slowdowns ``non_coh@12`` (paper ~2.4x) and ``coh_dma@12``
(paper ~8x, the worst), the wall time and the invocations a second, and
writes the report to ``--out``; the options are those of
``benchmarks/torch_des_common.py``.
"""
from __future__ import annotations

import time

import numpy as np

from benchmarks.torch_des_common import engine, main

NAME = "fig3_parallel"
COUNTS = (1, 4, 8, 12)


def run_port(device=None) -> dict:
    from repro_torch.core.modes import CoherenceMode, MODE_NAMES
    from repro_torch.core.policies import FixedHomogeneous
    from repro_torch.soc.config import SOC_MOTIV_PAR, WORKLOAD_MEDIUM
    from repro_torch.soc.des import (Application, Invocation, Phase,
                                     SoCSimulator, Thread)

    def app(n):
        threads = [Thread(chain=[Invocation(acc_id=i,
                                            footprint=WORKLOAD_MEDIUM)],
                          loops=6) for i in range(n)]
        return Application(name=f"par{n}",
                           phases=[Phase(name="p", threads=threads)])

    t0 = time.perf_counter()
    sim = SoCSimulator(SOC_MOTIV_PAR, device=device)
    out = {}
    for mode in CoherenceMode:
        pol = FixedHomogeneous(mode)
        iso_t = None
        for n in COUNTS:
            res = sim.run(app(n), pol, train=False)
            t = float(np.mean([r.exec_time
                               for r in res.phases[0].invocations]))
            if n == 1:
                iso_t = t
            out[f"{MODE_NAMES[mode]}|{n}"] = {"slowdown": t / iso_t,
                                              "offchip": res.total_offchip}
    out["_headline"] = {"non_coh@12": out["non-coh-dma|12"]["slowdown"],
                        "coh_dma@12": out["coh-dma|12"]["slowdown"]}
    out["_engine"] = engine([sim], t0, device, "des")
    return out


def print_results(tag: str, r: dict) -> None:
    print(f"{tag} fig3: non_coh@12={r['non-coh-dma|12']['slowdown']:.6f}x "
          f"(paper ~2.4) coh_dma@12={r['coh-dma|12']['slowdown']:.6f}x "
          f"(paper ~8, worst); " + ", ".join(
              f"{k}={v['slowdown']:.4f}" for k, v in r.items()
              if not k.startswith("_")))


if __name__ == "__main__":
    main(NAME, NAME, lambda device: run_port(device), print_results,
         fidelity_flag=False)
