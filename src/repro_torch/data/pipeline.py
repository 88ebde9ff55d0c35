"""Host data pipeline: background prefetch, then the copy to the device
(``repro.data.pipeline``).

A producer thread keeps a small bounded queue of ready host batches
(numpy), overlapping data generation with the train step; the consumer
moves each batch to the device, from pinned host memory with a
non-blocking copy where the device is the card.  With ``sharding`` (the
batch's :class:`~repro_torch.distributed.sharding.NamedSharding` by key)
each rank's iterator yields only its own rows (``host_batch(host,
n_hosts)``) and ``next`` returns them as the pieces of the global batch's
DTensors.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch


class PrefetchIterator:
    """Wrap a host-batch iterator (dicts of numpy arrays) with a daemon
    prefetch thread; ``next`` returns the batch as tensors on
    ``device`` (None: leave them on the host as tensors)."""

    def __init__(self, it: Iterator[dict], depth: int = 2, device=None,
                 sharding: dict | None = None):
        self._it = it
        self._sharding = sharding
        if sharding:
            from repro_torch.launch.mesh import mesh_device
            device = mesh_device(next(iter(sharding.values())).mesh)
        self._device = None if device is None else torch.device(device)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: BaseException | None = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for batch in self._it:
                self._q.put(batch)
        except Exception as e:  # surfaced on next()
            self._err = e
        self._q.put(None)

    def __iter__(self):
        return self

    def _to_device(self, a) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self._device is None or self._device.type == "cpu":
            return t
        return t.pin_memory().to(self._device, non_blocking=True)

    def __next__(self) -> dict:
        item = self._q.get()
        if item is None:
            self._q.put(None)
            raise (self._err or StopIteration)
        out = {k: self._to_device(v) for k, v in item.items()}
        if self._sharding:
            from torch.distributed.tensor import DTensor
            out = {k: DTensor.from_local(v, self._sharding[k].mesh,
                                         self._sharding[k].placements(),
                                         run_check=False)
                   for k, v in out.items()}
        return out
