"""What the port's Fig. 2/3/5/7/8 drivers share: the engine record, the
reference's report read back, the comparison and the command line.

Each driver (``benchmarks/torch_fig{2,3,5,7,8}_*.py``) defines
``run_port(device=None, fidelity=False) -> dict`` (the reference
report's fields plus ``_headline`` and ``_engine``) and calls
:func:`main` with the reference module's name.  Its command line:

    PYTHONPATH=src python -m benchmarks.torch_figN_... [--fidelity] \
        [--device cuda|cpu] [--out port.json] [--compare port.json] \
        [--reference] [--no-fma]

``--compare`` loads a JSON written by ``--out`` (a run on the card)
instead of running the port; ``--reference`` (implied by ``--compare``)
runs the reference's ``run(quick=False, ...)`` on the CPU with its
report written to a temporary directory, so the committed report is not
touched, and prints every number that differs, the largest relative
difference and whether all lie within rtol = atol = 2e-5; ``--no-fma``
compiles the reference for an ISA without fused multiply-add (ROADMAP
C1).  The port side imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time

from benchmarks.torch_no_fma import use_reference_without_fma

TOL = 2e-5   # rtol = atol of the verdict
SKIP = ("_engine", "_headline")


def engine(sims, t0: float, device, path: str) -> dict:
    """Where and how fast a run went: the wall time since ``t0`` and, on
    the event-driven path, the invocations the simulators ``sims`` started
    and their rate."""
    import torch
    from repro_torch import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = sum(s.invocations for s in sims)
    return {"path": path, "device": (torch.cuda.get_device_name(dev)
                                     if dev.type == "cuda" else "cpu"),
            "wall_s": wall, "invocations": n,
            "invocations_per_s": n / wall if n else None}


def reference_report(module: str, name: str, **kw) -> dict:
    """The reference's ``benchmarks.<module>.run(quick=False, **kw)``
    report, written to a temporary directory and read back."""
    import importlib
    from benchmarks import common
    mod = importlib.import_module(f"benchmarks.{module}")
    saved = common.REPORT_DIR
    with tempfile.TemporaryDirectory() as tmp:
        common.REPORT_DIR = tmp
        try:
            print(f"reference: {mod.run(quick=False, **kw)}")
            with open(f"{tmp}/{name}.json") as f:
                return json.load(f)
        finally:
            common.REPORT_DIR = saved


def _leaves(x, path=""):
    if isinstance(x, dict):
        for k in sorted(x):
            if k not in SKIP:
                yield from _leaves(x[k], f"{path}/{k}")
    elif isinstance(x, list):
        for i, v in enumerate(x):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, x


def compare(port: dict, ref: dict) -> bool:
    """Print every reference number the port's differs from and the
    verdict: every number within ``|port - ref| <= TOL + TOL * |ref|``
    and every other field equal."""
    got = dict(_leaves(port))
    gap = worst = 0.0
    bad = 0
    for path, want in _leaves(ref):
        have = got.get(path)
        if isinstance(want, (int, float)) and not isinstance(want, bool) \
                and isinstance(have, (int, float)):
            d = abs(have - want)
            gap = max(gap, d / max(abs(want), 1e-30))
            worst = max(worst, d / (TOL + TOL * abs(want)))
            if d > 0:
                print(f"differs {path}: port {have!r} reference {want!r}")
        elif have != want:
            bad += 1
            print(f"differs {path}: port {have!r} reference {want!r}")
    ok = worst <= 1.0 and not bad
    print(f"largest relative difference: {gap:.6g}; {bad} other fields "
          f"differ; within rtol = atol = {TOL:g}: {ok}")
    return ok


def main(name: str, module: str, run_port, print_results,
         fidelity_flag: bool = True) -> None:
    ap = argparse.ArgumentParser()
    if fidelity_flag:
        ap.add_argument("--fidelity", action="store_true",
                        help="the event-driven simulator instead of the "
                             "batched environment")
    ap.add_argument("--device", default=None)
    ap.add_argument("--out")
    ap.add_argument("--compare")
    ap.add_argument("--reference", action="store_true")
    ap.add_argument("--no-fma", action="store_true")
    args = ap.parse_args()
    kw = {"fidelity": args.fidelity} if fidelity_flag else {}
    if args.compare:
        with open(args.compare) as f:
            port = json.load(f)
        if fidelity_flag:
            kw["fidelity"] = port["_engine"]["path"] == "des"
    else:
        port = run_port(args.device, **kw)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(port, f, indent=1)
    print_results("port", port)
    e = port["_engine"]
    rate = (f", {e['invocations']} invocations, "
            f"{e['invocations_per_s']:.1f} a second"
            if e["invocations"] else "")
    print(f"port engine: {e['path']} on {e['device']}, wall "
          f"{e['wall_s']:.3f} s{rate}")
    if args.reference or args.compare:
        if args.no_fma:
            use_reference_without_fma()
        ref = reference_report(module, name, **kw)
        print_results("reference", ref)
        compare(port, ref)
