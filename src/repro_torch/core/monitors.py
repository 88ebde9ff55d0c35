"""Hardware-monitor model (paper §4.1(4) / §4.3 Evaluate).

The real system exposes memory-mapped counters per tile: accelerator active
cycles, accelerator communication cycles, and per-memory-tile DRAM access
counts.  Software reads the DRAM counters before/after each invocation and
— because per-accelerator DRAM attribution would need extra hardware —
approximates each accelerator's share proportionally to its active
footprint (the paper's ``ddr(k, m)`` equation):

    ddr(k,m) = ddr_total(m) * footprint(k,m) / sum_acc footprint(acc,m)

Cohmeleon consumes the *attributed* value, not ground truth; both are
modelled so tests can quantify the approximation error.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.ordered import seqsum


def attribute_ddr(ddr_total, footprints) -> torch.Tensor:
    """The paper's proportional attribution in float32: ``ddr_total
    (n_tiles,)`` observed access deltas per memory tile, ``footprints
    (n_accs, n_tiles)`` bytes of each accelerator's data per tile.
    Returns ``(n_accs, n_tiles)``; the per-tile footprint sums run over
    the accelerators in order."""
    ddr_total = torch.as_tensor(ddr_total, dtype=torch.float32)
    footprints = torch.as_tensor(footprints, dtype=torch.float32,
                                 device=ddr_total.device)
    total_fp = torch.clamp(seqsum(footprints, 0), min=float(
        np.float32(1e-9)))[None, :]
    return ddr_total[None, :] * footprints / total_fp


class MonitorBank:
    """Host-side counter bank: cumulative, wrap-free counters (overflow
    handling is a driver detail) that software samples around each
    invocation and diffs."""

    def __init__(self, n_accs: int, n_tiles: int):
        self.n_accs = n_accs
        self.n_tiles = n_tiles
        self.ddr_accesses = np.zeros(n_tiles, np.float64)     # per mem tile
        self.acc_cycles = np.zeros(n_accs, np.float64)        # active cycles
        self.comm_cycles = np.zeros(n_accs, np.float64)       # comm cycles

    def snapshot_ddr(self) -> np.ndarray:
        return self.ddr_accesses.copy()

    def record_invocation(self, acc_id: int, total_cycles: float,
                          comm_cycles: float,
                          offchip_per_tile: np.ndarray) -> None:
        self.acc_cycles[acc_id] += total_cycles
        self.comm_cycles[acc_id] += comm_cycles
        self.ddr_accesses += offchip_per_tile

    def attributed_accesses(self, before: np.ndarray, after: np.ndarray,
                            acc_id: int, footprints: np.ndarray) -> float:
        """Software-visible off-chip count for ``acc_id`` over a window;
        ``footprints (n_accs, n_tiles)`` is the active footprint map."""
        delta = np.maximum(after - before, 0.0)
        shares = attribute_ddr(delta, footprints).numpy()
        return float(shares[acc_id].sum())
