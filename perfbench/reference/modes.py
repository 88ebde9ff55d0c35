"""Accelerator cache-coherence modes (paper §2).

The four modes are defined independently of the specific coherence protocol.
Each mode differs in (a) where accelerator memory requests are routed and
(b) which software flushes the device driver must issue before launch.

These integer codes index the action dimension of the Q-table and every
per-mode lookup table in the SoC timing model, so their values are part of
the on-disk checkpoint format — do not reorder.
"""
from __future__ import annotations

import enum


class CoherenceMode(enum.IntEnum):
    """Paper §2 coherence modes, in the paper's presentation order."""

    NON_COH_DMA = 0   # bypass caches, DMA straight to DRAM; full flush first
    LLC_COH_DMA = 1   # DMA to the LLC; private (L2) caches flushed first
    COH_DMA = 2       # DMA to the LLC; LLC recalls/invalidates L2 lines
    FULLY_COH = 3     # private cache on the accelerator, full MESI coherence


N_MODES = len(CoherenceMode)


