"""Heartbeats and straggler detection around the train loop
(``repro.distributed.fault``: ``HeartbeatMonitor`` and
``StragglerDetector``; its ``ElasticRunner`` is not ported yet).

  * HeartbeatMonitor: workers post heartbeats; a worker silent for
    ``timeout`` seconds is declared failed.
  * StragglerDetector: per-step durations over a window; a worker whose
    median is above ``threshold`` times the median of the workers'
    medians is flagged.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

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
