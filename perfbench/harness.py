"""The benchmark's run of one cell: set-up, a measured window of whole
units, the check against the reference, and one result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix;
``perfbench/configs/<config>.json`` and ``perfbench/traffic/<traffic>.json``
hold them, and the traffic file names its driver,
``perfbench/drivers/<driver>.py``.  A driver exposes

  * ``setup(run) -> state``: builds the program's objects from the files
    and ``--seed`` and runs one whole unit, so that every shape the
    window uses is built and warm;
  * ``unit(run, state, j) -> work``: unit ``j`` of the window (one call
    into the program's entry), returning the work items it completed;
  * ``check(run, state) -> [(name, value, limit), ...]``: the comparison
    of the last completed unit with the reference, after the window.

The window runs whole units until ``--seconds`` have passed, each ending
in a synchronize; a rate is all the work of the window over all of its
time.  A per-layer metric ``<name>`` is ``perfbench/metrics/<name>.py``,
whose ``read(run)`` returns a number or None (nothing to read).
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# What the process that prints a result may not hold (whole top-level
# module names: ``repro_torch`` begins with ``repro``).
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
# A traced window stops after this many seconds: the profiler's own
# processing grows with the events it holds (about 3.5 s for each second
# of a training window on the card), and a traced run has to end within
# 360 seconds.
TRACE_SECONDS = 15.0


def process_age() -> float:
    """Seconds since this process started (``/proc``)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def load_benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


class Run:
    """One run of one cell: its files, arguments and what it measured."""

    def __init__(self, bench: dict, cell: str, seed: int, seconds: float,
                 trace: bool, device: str = "cuda",
                 overrides: dict | None = None):
        from perfbench import inputs
        cells = {w["name"]: w for w in bench["workloads"]}
        if cell not in cells:
            raise SystemExit(f"unknown workload {cell!r}; known: "
                             f"{sorted(cells)}")
        self.bench = bench
        self.cell = cells[cell]
        self.config = inputs.load_json("configs", self.cell["config"])
        self.traffic = inputs.load_json("traffic", self.cell["traffic"])
        self.traffic.update(overrides or {})
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.facts: dict = {}       # counts and shapes for metric readers
        self.units: list = []       # (wall_s, work) of each window unit
        self.window_s = 0.0
        self.summary = None         # trace.TraceSummary of a traced window
        self.warm = True            # set-up runs one unit before the window
        self._patched: list = []

    def patch(self, owner, name: str, value):
        """Set ``owner.name`` for this run (undone by :meth:`restore`)."""
        self._patched.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def restore(self):
        while self._patched:
            owner, name, value = self._patched.pop()
            setattr(owner, name, value)

    def sync(self):
        if self.device == "cuda":
            import torch
            torch.cuda.synchronize()

    def span(self, name: str):
        """A host span the trace keeps (a no-op when not tracing)."""
        if not self.trace:
            import contextlib
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)


def driver_of(run: Run):
    return importlib.import_module(f"perfbench.drivers.{run.traffic['driver']}")


def run_window(run: Run, drv, state) -> float:
    """Whole units until ``run.seconds`` (a traced window: at most
    :data:`TRACE_SECONDS`) have passed; returns the process age at the
    first unit's start (the set-up time)."""
    from perfbench.trace import UNIT_SPAN, WINDOW_SPAN
    seconds = min(run.seconds, TRACE_SECONDS) if run.trace else run.seconds
    run.sync()
    setup_s = process_age()
    t_start = time.perf_counter()
    j = 0
    with run.span(WINDOW_SPAN):
        while True:
            t0 = time.perf_counter()
            with run.span(UNIT_SPAN):
                work = drv.unit(run, state, j)
                run.sync()
            t1 = time.perf_counter()
            run.units.append((t1 - t0, work))
            j += 1
            if t1 - t_start >= seconds:
                break
    run.window_s = t1 - t_start
    return setup_s


def per_layer_metrics(run: Run) -> dict:
    out = {}
    for m in run.bench["per_layer"]:
        if "workloads" in m and run.cell["name"] not in m["workloads"]:
            continue
        spec = importlib.util.spec_from_file_location(
            f"perfbench_metric_{m['name']}",
            HERE / "metrics" / f"{m['name']}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def end_to_end_metrics(run: Run, setup_s: float) -> dict:
    out = {}
    for m in run.bench["end_to_end"]:
        if "workloads" in m and run.cell["name"] not in m["workloads"]:
            continue
        if m["name"] == "setup_s":
            value = setup_s
        else:
            value = run.facts["end_to_end"][m["name"]]
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return proc.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def execute(run: Run) -> dict:
    """Set-up, window, check; returns the result object."""
    try:
        return _execute(run)
    finally:
        run.restore()


def build_kernels(run: Run) -> float:
    """Build the program's CUDA kernels (a checkout's first run compiles
    them; later runs find them built); returns the seconds it took, a
    part of the set-up that the result names apart."""
    if run.device != "cuda":
        return 0.0
    from repro_torch.kernels.soc_step import kernel
    t0 = time.perf_counter()
    kernel.build()
    return time.perf_counter() - t0


def _execute(run: Run) -> dict:
    import torch
    drv = driver_of(run)
    build_s = build_kernels(run)
    state = drv.setup(run)
    if run.trace:
        from torch.profiler import ProfilerActivity, profile
        from perfbench import trace
        acts = [ProfilerActivity.CPU]
        if run.device == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            setup_s = run_window(run, drv, state)
        run.summary = trace.summarize(prof)
        del prof
    else:
        setup_s = run_window(run, drv, state)
    work = sum(w for _, w in run.units)
    run.facts["work"] = work
    run.facts["units"] = len(run.units)
    if run.device == "cuda":
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": 1,
                  "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    else:
        device = {"platform": "cpu", "kind": "cpu", "count": 1,
                  "memory_peak_bytes": 0}
    drv.finish_window(run, state)
    metrics = (per_layer_metrics(run) if run.trace
               else end_to_end_metrics(run, setup_s))
    t_check = time.perf_counter()
    if run.device == "cuda":
        torch.set_num_threads(4)         # the reference's host-side inputs
    try:
        checks = drv.check(run, state)
        failure = None
    except Exception as exc:  # the check's own failure is a wrong result
        checks, failure = [], f"{type(exc).__name__}: {exc}"
    walls = sorted(w for w, _ in run.units)
    print(f"set-up {setup_s:.2f} s (the kernels' build {build_s:.2f} s), "
          f"window {run.window_s:.2f} s over "
          f"{len(run.units)} units (first {run.units[0][0]:.4f} s, median "
          f"{walls[len(walls) // 2]:.4f} s, last {run.units[-1][0]:.4f} s), "
          f"check {time.perf_counter() - t_check:.2f} s", file=sys.stderr)
    correct = failure is None and all(v <= lim for _, v, lim in checks)
    result = {"correct": bool(correct), "attempted": int(work),
              "failed": 0, "metrics": metrics, "device": device,
              "setup_build_s": build_s}
    if run.trace:
        s = run.summary
        device["busy_s"] = s.busy_us * 1e-6
        device["window_s"] = s.window_us * 1e-6
        result["breakdown"] = {"device_ops": s.device_ops,
                               "idle_gaps": s.idle_gaps}
    for name, what in run.facts.get("worst", {}).items():
        print(f"{name} read most on {what}", file=sys.stderr)
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    if failure is not None:
        result["checks"]["check_ran"] = {"value": 1, "limit": 0}
        print(f"check failed to run: {failure}", file=sys.stderr)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # build and kernel caches stay inside the checkout, at fixed paths
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    import torch
    bench = load_benchmark()
    run = Run(bench, args.workload, args.seed, args.seconds, args.trace)
    chips = int(run.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(1)     # the window: one process, one CPU thread
    card = power_limit()
    result = execute(run)
    result["device"]["card"] = card
    bad = forbidden_modules()
    if bad:
        print(f"the process holds {bad}: the benchmark runs the port alone",
              file=sys.stderr)
        return 4
    print(f"card: {card}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0
