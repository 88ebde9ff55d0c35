"""Reading the profiler's trace of a ``--trace 1`` window.

The events stay in memory (``torch.profiler`` with CPU and CUDA
activities, no stacks, shapes or memory); what leaves this module is a
summary: the device's busy time as the union of its event intervals
inside the window (the arithmetic of the port's
``benchmarks/torch_main_path_profile.py``, taken over intervals so that
overlapping events count once), the kernels by name, and the longest
idle gaps labelled by what the host was running at their midpoint.
"""
from __future__ import annotations

import dataclasses

import numpy as np

WINDOW_SPAN = "pb.window"
UNIT_SPAN = "pb.unit"


@dataclasses.dataclass
class TraceSummary:
    window_us: float
    busy_us: float
    kernels: list          # (name, start_us, dur_us) of each device kernel
    device_ops: list       # [name, seconds] of the 10 largest by time
    idle_gaps: list        # [label, seconds] of the 10 longest gaps

    def kernel_times(self, prefix: str) -> np.ndarray:
        """Device microseconds of every kernel whose name contains
        ``prefix``."""
        return np.array([d for n, _, d in self.kernels if prefix in n],
                        dtype=np.float64)


def is_copy(name: str) -> bool:
    """A copy or fill on the device, not a kernel."""
    return name.startswith("Memcpy") or name.startswith("Memset")


def _raw_events(prof):
    """``(name, is_device, start_us, end_us)`` of every event, read from
    the profiler's raw results (no per-event Python objects are built)."""
    from torch.autograd import DeviceType
    for e in prof.profiler.kineto_results.events():
        if hasattr(e, "start_ns"):
            start, dur = e.start_ns() * 1e-3, e.duration_ns() * 1e-3
        else:
            start, dur = float(e.start_us()), float(e.duration_us())
        yield e.name(), e.device_type() == DeviceType.CUDA, start, start + dur


def summarize(prof) -> TraceSummary:
    """Summarize a finished ``torch.profiler.profile`` whose window ran
    inside a ``record_function(WINDOW_SPAN)``."""
    dev, cpu = [], []
    win = None
    for name, on_device, start, end in _raw_events(prof):
        if on_device and name.startswith("pb."):
            continue          # the spans' own marks on the device timeline
        if on_device:
            dev.append((name, start, end - start))
        elif name == WINDOW_SPAN:
            win = (start, end)
        else:
            cpu.append((name, start, end))
    if win is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span")
    w0, w1 = win
    dev = [(n, s, d) for n, s, d in dev if s >= w0 and s + d <= w1]
    dev.sort(key=lambda r: r[1])

    # union of the device intervals, and the gaps between them
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for _, s, d in dev:
        e = s + d
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            else:
                gaps.append((w0, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
        gaps.append((cur_e, w1))
    else:
        gaps.append((w0, w1))

    by_name: dict[str, float] = {}
    for n, _, d in dev:
        by_name[n] = by_name.get(n, 0.0) + d
    device_ops = [[short_kernel(n), t * 1e-6] for n, t in
                  sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]

    names = [n for n, _, _ in cpu]
    cs = np.array([s for _, s, _ in cpu], dtype=np.float64)
    ce = np.array([e for _, _, e in cpu], dtype=np.float64)
    kstart = np.array([s for _, s, _ in dev], dtype=np.float64)
    idle_gaps = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = 0.5 * (g0 + g1)
        inside = np.nonzero((cs <= mid) & (ce >= mid))[0]
        ops = [i for i in inside if not names[i].startswith("pb.")]
        host = names[max(ops, key=lambda i: cs[i])] if ops else "python"
        nxt = np.searchsorted(kstart, g1 - 1e-3)
        after = dev[nxt][0] if nxt < len(dev) else "window end"
        idle_gaps.append([f"{host} before {short_kernel(after)}",
                          (g1 - g0) * 1e-6])
    return TraceSummary(window_us=w1 - w0, busy_us=busy, kernels=dev,
                        device_ops=device_ops, idle_gaps=idle_gaps)


def short_kernel(name: str) -> str:
    """A kernel name without its return type, namespaces and argument
    list, at most 120 letters."""
    for ns in ("(anonymous namespace)::", "at::native::", "std::"):
        name = name.replace(ns, "")
    return name.removeprefix("void ").split("(")[0][:120]
