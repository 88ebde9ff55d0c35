"""Paper Fig. 5 (per-phase policy comparison) through the port, beside
the JAX reference.

    PYTHONPATH=src python -m benchmarks.torch_fig5_phases [--fidelity] \
        [--device cuda|cpu] [--out port.json] [--compare port.json] \
        [--reference] [--no-fma]

Mirrors ``benchmarks/fig5_phases.py`` at full width on SoC-motiv-par:
Cohmeleon trained for 10 iterations of an 8-phase app, then the paper's
suite (the four fixed modes, the profiled heterogeneous assignment,
random, manual) and the frozen agent on the four Fig. 5 phases,
normalized per phase to fixed NON_COH.  By default the batched
environment trains every iteration in one launch, profiles through it
and replays the suite in one launch; ``--fidelity`` runs all of it on
the event-driven simulator (``train_cohmeleon``, the profiling sweep and
one run per policy).  It prints the geomean (time, off-chip) of
Cohmeleon and manual, the wall time and, on the event-driven path, the
invocations a second, and writes the report to ``--out``; the options
are those of ``benchmarks/torch_des_common.py``.
"""
from __future__ import annotations

import time

from benchmarks.torch_des_common import engine, main

NAME = "fig5_phases"


def run_port(device=None, fidelity: bool = False) -> dict:
    from repro_torch.core.orchestrator import (compare_policies,
                                               standard_policy_suite,
                                               train_cohmeleon,
                                               train_cohmeleon_batched)
    from repro_torch.soc.apps import make_fig5_phases
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
    app = make_fig5_phases(sim.soc, seed=7)
    suite = standard_policy_suite(sim, backend=backend)
    suite.append(policy)
    cmp = compare_policies(sim, app, suite, seed=3, backend=backend)
    return {"path": backend,
            "suite_episode_calls": 1 if backend == "vecenv"
            else len(suite) + 1,
            "phases": [p.name for p in app.phases],
            "norm_time": cmp.norm_time, "norm_mem": cmp.norm_mem,
            "_headline": {"cohmeleon": cmp.geomean("cohmeleon"),
                          "manual": cmp.geomean("manual")},
            "_engine": engine([sim], t0, device, backend)}


def _geomean(values):
    import numpy as np
    return float(np.exp(np.mean(np.log(np.maximum(values, 1e-12)))))


def print_results(tag: str, r: dict) -> None:
    g = {p: (_geomean(r["norm_time"][p]), _geomean(r["norm_mem"][p]))
         for p in ("cohmeleon", "manual")}
    print(f"{tag} fig5 ({r['path']}): cohmeleon_time={g['cohmeleon'][0]:.6f}"
          f" manual_time={g['manual'][0]:.6f} "
          f"cohmeleon_mem={g['cohmeleon'][1]:.6f} "
          f"manual_mem={g['manual'][1]:.6f}")


if __name__ == "__main__":
    main(NAME, NAME, run_port, print_results)
