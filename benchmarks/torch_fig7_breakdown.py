"""Paper Fig. 7 (coherence decisions by workload-size class) through the
port, beside the JAX reference.

    PYTHONPATH=src python -m benchmarks.torch_fig7_breakdown [--fidelity] \
        [--device cuda|cpu] [--out port.json] [--compare port.json] \
        [--reference] [--no-fma]

Mirrors ``benchmarks/fig7_breakdown.py`` at full width on SoC-motiv-par:
Cohmeleon trained for 10 iterations of an 8-phase app, then manual and
the frozen agent on another 8-phase app, and each run's share of
invocations per mode, in total and per size class (S, M, L, XL).  By
default training and the replay run on the batched environment (its
traces lifted into the simulator's records); ``--fidelity`` runs them on
the event-driven simulator.  It prints Cohmeleon's coh-dma + non-coh-dma
share, the wall time and, on the event-driven path, the invocations a
second, and writes the report to ``--out``; the options are those of
``benchmarks/torch_des_common.py``.
"""
from __future__ import annotations

import time

from benchmarks.torch_des_common import engine, main

NAME = "fig7_breakdown"


def run_port(device=None, fidelity: bool = False) -> dict:
    from repro_torch.core.modes import MODE_NAMES
    from repro_torch.core.orchestrator import (compare_policies,
                                               mode_breakdown,
                                               train_cohmeleon,
                                               train_cohmeleon_batched)
    from repro_torch.core.policies import ManualPolicy
    from repro_torch.soc.apps import make_application
    from repro_torch.soc.config import SOC_MOTIV_PAR
    from repro_torch.soc.des import SoCSimulator

    backend = "des" if fidelity else "vecenv"
    t0 = time.perf_counter()
    sim = SoCSimulator(SOC_MOTIV_PAR, device=device)
    if fidelity:
        policy, _ = train_cohmeleon(sim, iterations=10, seed=0, n_phases=8)
    else:
        policy = train_cohmeleon_batched(sim, iterations=10, seed=0,
                                         n_phases=8).qpolicy(0)
    app = make_application(sim.soc, seed=123, n_phases=8)
    cmp = compare_policies(sim, app, [ManualPolicy(), policy], seed=9,
                           backend=backend)
    out = {"path": backend}
    for pol in ("manual", "cohmeleon"):
        bd = mode_breakdown(cmp.raw[pol], sim.soc)
        out[pol] = {k: dict(zip(MODE_NAMES, v.tolist()))
                    for k, v in bd.items()}
    tot = out["cohmeleon"]["total"]
    out["_headline"] = {"cohmeleon_dma_share":
                        tot["coh-dma"] + tot["non-coh-dma"]}
    out["_engine"] = engine([sim], t0, device, backend)
    return out


def print_results(tag: str, r: dict) -> None:
    for pol in ("manual", "cohmeleon"):
        print(f"{tag} fig7 ({r['path']}) {pol}: " + "; ".join(
            f"{k} " + " ".join(f"{m}={v:.4f}" for m, v in row.items())
            for k, row in r[pol].items()))
    tot = r["cohmeleon"]["total"]
    print(f"{tag} fig7: cohmeleon_dma_share="
          f"{tot['coh-dma'] + tot['non-coh-dma']:.6f}")


if __name__ == "__main__":
    main(NAME, NAME, run_port, print_results)
