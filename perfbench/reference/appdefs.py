"""Applications as data (frozen copy of the port's ``soc.des`` records).

An application is phases of threads, each thread a chain of accelerator
invocations run ``loops`` times; :func:`stripe_tiles` draws an
invocation's memory-tile mask.  The benchmark builds its applications
from these records and hands the same ones to the program (converted to
the program's own record types) and to the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

# Allocation interleaving across memory tiles: 256KB page-set striping.
_STRIPE_BYTES = 256 << 10


def stripe_tiles(rng: np.random.Generator, n_tiles: int,
                 footprint: float) -> np.ndarray:
    """Memory-tile mask for one invocation: contiguous 256KB-page-set
    striping from a random start tile (one ``rng.integers`` draw)."""
    span = int(min(n_tiles, max(1, int(np.ceil(footprint / _STRIPE_BYTES)))))
    start = int(rng.integers(0, n_tiles))
    mask = np.zeros(n_tiles, bool)
    for k in range(span):
        mask[(start + k) % n_tiles] = True
    return mask


@dataclasses.dataclass(frozen=True)
class Invocation:
    acc_id: int
    footprint: float


@dataclasses.dataclass(frozen=True)
class Thread:
    chain: Sequence[Invocation]
    loops: int = 1


@dataclasses.dataclass(frozen=True)
class Phase:
    name: str
    threads: Sequence[Thread]


@dataclasses.dataclass(frozen=True)
class Application:
    name: str
    phases: Sequence[Phase]
