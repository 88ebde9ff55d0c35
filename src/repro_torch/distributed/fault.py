"""Fault tolerance around the train loop (``repro.distributed.fault``).

  * HeartbeatMonitor: workers post heartbeats; a worker silent for
    ``timeout`` seconds is declared failed.
  * StragglerDetector: per-step durations over a window; a worker whose
    median is above ``threshold`` times the median of the workers'
    medians is flagged.
  * ElasticRunner: steps, checkpoints, and on a failure restores the
    latest checkpoint resharded onto a mesh of the surviving ranks (the
    checkpoint holds full arrays, so any mesh can take it).

The failure is injected, as in the reference; the recovery is real: a
new mesh and its process groups over the survivors, a resharded restore,
the steps since the checkpoint run again.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np


@dataclasses.dataclass
class HeartbeatMonitor:
    n_workers: int
    timeout: float = 30.0
    _last: dict = dataclasses.field(default_factory=dict)

    def beat(self, worker: int, now: Optional[float] = None) -> None:
        self._last[worker] = time.monotonic() if now is None else now

    def failed_workers(self, now: Optional[float] = None) -> list[int]:
        now = time.monotonic() if now is None else now
        out = []
        for w in range(self.n_workers):
            last = self._last.get(w)
            if last is None or now - last > self.timeout:
                out.append(w)
        return out


@dataclasses.dataclass
class StragglerDetector:
    threshold: float = 1.5       # x median
    window: int = 20
    _durations: dict = dataclasses.field(default_factory=dict)

    def record(self, worker: int, duration: float) -> None:
        self._durations.setdefault(worker, []).append(duration)
        if len(self._durations[worker]) > self.window:
            self._durations[worker].pop(0)

    def stragglers(self) -> list[int]:
        if not self._durations:
            return []
        medians = {w: float(np.median(d))
                   for w, d in self._durations.items() if d}
        overall = float(np.median(list(medians.values())))
        return [w for w, m in medians.items()
                if m > self.threshold * overall]


class ElasticRunner:
    """Step driver with checkpoint/restart and an elastic re-mesh on
    failure.

    ``build(ranks) -> (step_fn, shardings)`` makes the step for a mesh
    over ``ranks`` (ranks of the default process group; the reference's
    devices) and the state's shardings there (a tree of
    :class:`~repro_torch.distributed.sharding.NamedSharding` shaped as the
    state, or None to leave the state as it is).  Every rank of the
    default group runs ``run``: forming a mesh's groups is collective over
    the world, so a rank outside the surviving set takes part in
    ``build(surviving_devices)`` and then leaves, returning ``(None,
    step)``.  ``step_fn(state) -> state``; the state is a checkpointable
    tree (:mod:`repro_torch.checkpoint.ckpt`).
    """

    def __init__(self, build: Callable, manager, ckpt_every: int = 50):
        self.build = build
        self.manager = manager
        self.ckpt_every = ckpt_every
        self.recoveries = 0

    def run(self, state, n_steps: int, devices,
            inject_failure_at: Optional[int] = None,
            surviving_devices=None):
        from repro_torch.distributed import sharding as shd
        step_fn, shardings = self.build(devices)
        state = shd.place(state, shardings)
        step = 0
        while step < n_steps:
            if inject_failure_at is not None and step == inject_failure_at:
                # --- the injected loss of ranks: re-mesh onto survivors --
                self.manager.wait()
                latest = self.manager.latest_step()
                devices = surviving_devices
                step_fn, shardings = self.build(devices)
                if not _member(devices):
                    return None, step
                state = self.manager.restore(state, step=latest,
                                             shardings=shardings)
                step = latest if latest is not None else 0
                self.recoveries += 1
                inject_failure_at = None
                continue
            state = step_fn(state)
            step += 1
            if step % self.ckpt_every == 0 or step == n_steps:
                self.manager.save(step, state)
        self.manager.wait()
        return state, step


def _member(ranks) -> bool:
    """Whether this process is one of ``ranks`` (always, without a
    process group: one process holds every device)."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return True
    return dist.get_rank() in [int(r) for r in ranks]
