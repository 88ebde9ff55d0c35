"""SoC configurations (paper Table 4) and memory-system timing constants.

The seven evaluation SoCs vary accelerator count, NoC size, CPU count, DRAM
controllers, LLC partitioning and L2 size — we reproduce the table exactly.
Timing constants approximate the ESP FPGA prototypes (LEON3 @ soft-core
clock, 32-bit NoC planes, one memory link of 32 bits/cycle per memory tile,
paper §4.3/§5); absolute values only set the scale, every paper figure is
normalized to the Fixed non-coherent-DMA policy.  The area/bandwidth
budget model at the end bounds the SoCs that ``soc.dse`` generates.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from perfbench.reference.state import CacheGeometry

KB = 1024
MB = 1024 * KB


@dataclasses.dataclass(frozen=True)
class MemTimings:
    """Cycle-level constants of the memory system model (memsys.py)."""

    line_bytes: int = 64            # coherence / DMA-beat granularity
    dram_lat: float = 120.0         # DRAM access latency (cycles)
    dram_bw: float = 4.0            # bytes/cycle per controller (32 bits/cy)
    llc_hit_lat: float = 24.0       # NoC + LLC pipeline (cycles)
    llc_bw: float = 8.0             # bytes/cycle LLC slice service rate
    l2_hit_lat: float = 4.0         # accelerator-private L2 hit (cycles)
    l2_bw: float = 16.0             # bytes/cycle private-cache fill path
    noc_hop_lat: float = 1.0        # per-router latency (cycles)
    noc_bw: float = 4.0             # bytes/cycle per NoC plane link
    driver_base: float = 5000.0     # device-driver invocation overhead
    tlb_per_page: float = 12.0      # TLB preload per 2 MB page (paper §5)
    page_bytes: int = 2 * MB
    flush_base: float = 2000.0      # fixed flush-instruction overhead
    flush_bw: float = 8.0           # bytes/cycle writeback drain
    dir_lookup: float = 8.0         # directory action per line (coh modes)
    recall_lat: float = 40.0        # LLC->L2 recall round trip per line
    mshr_per_tile: int = 4          # outstanding line transactions per bridge
                                    # (ESP's DMA-to-cache bridge splits bursts
                                    # into line requests with few MSHRs, the
                                    # key reason long-burst NON_COH DMA wins
                                    # for big streaming workloads, paper §3)


@dataclasses.dataclass(frozen=True)
class SoCConfig:
    """One row of paper Table 4.

    Construction validates the structural invariants every consumer
    assumes, so a bad configuration fails here with its name."""

    name: str
    n_accs: int
    noc_rows: int
    noc_cols: int
    n_cpus: int
    n_mem_tiles: int                # DDR controllers == LLC partitions
    llc_slice_bytes: int
    l2_bytes: int
    accelerators: Sequence[str]     # profile names, len == n_accs
    # SoC3: five accelerators lack a private cache (FPGA resource limits),
    # so FULLY_COH is unavailable for them (action masking).
    no_private_cache: Sequence[int] = ()
    timings: MemTimings = MemTimings()

    def __post_init__(self):
        problems = []
        if self.n_accs < 1:
            problems.append(f"n_accs={self.n_accs} < 1")
        if self.n_cpus < 1:
            problems.append(f"n_cpus={self.n_cpus} < 1")
        if self.n_mem_tiles < 1:
            problems.append(f"n_mem_tiles={self.n_mem_tiles} < 1")
        if len(self.accelerators) != self.n_accs:
            problems.append(f"{len(self.accelerators)} accelerator names "
                            f"vs n_accs={self.n_accs}")
        bad = [i for i in self.no_private_cache
               if not 0 <= int(i) < self.n_accs]
        if bad:
            problems.append(f"no_private_cache indices {bad} outside "
                            f"[0, {self.n_accs})")
        tiles = self.noc_rows * self.noc_cols
        need = self.n_accs + self.n_cpus + self.n_mem_tiles
        if tiles < need:
            problems.append(f"{self.noc_rows}x{self.noc_cols} NoC has "
                            f"{tiles} tiles < {need} occupants "
                            f"(accs+cpus+mem)")
        if self.llc_slice_bytes <= 0:
            problems.append(f"llc_slice_bytes={self.llc_slice_bytes} <= 0")
        if self.l2_bytes <= 0:
            problems.append(f"l2_bytes={self.l2_bytes} <= 0")
        if problems:
            raise ValueError(
                f"invalid SoCConfig {self.name!r}: " + "; ".join(problems))

    @property
    def llc_total_bytes(self) -> int:
        return self.llc_slice_bytes * self.n_mem_tiles

    @property
    def geometry(self) -> CacheGeometry:
        return CacheGeometry(
            l2_bytes=self.l2_bytes,
            llc_slice_bytes=self.llc_slice_bytes,
            n_mem_tiles=self.n_mem_tiles,
        )


