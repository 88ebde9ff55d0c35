"""Application types of the discrete-event simulator.

An *application* is a list of phases; a *phase* is a set of software
threads; a *thread* is a chain of accelerator invocations over one
dataset (output of one feeds the next), optionally looped (paper §5).
The batched environment (:mod:`repro_torch.soc.vecenv`) lowers them to
static schedules.  The event-driven simulator itself is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

# Allocation interleaving across memory tiles: ESP partitions the address
# space per memory tile and accelerator data spreads across partitions
# (the paper's ddr(k,m) attribution sums footprint(acc, m) over tiles m,
# and its L workload class "smaller than the AGGREGATE LLC" presumes
# multi-partition residency).  256KB page-set striping reproduces that.
_STRIPE_BYTES = 256 << 10


def stripe_tiles(rng: np.random.Generator, n_tiles: int,
                 footprint: float) -> np.ndarray:
    """Memory-tile mask for one invocation: contiguous 256KB-page-set
    striping from a random start tile.  One ``rng.integers`` draw per
    invocation, so a seed gives the reference's masks."""
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
