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

from repro_torch.core.state import CacheGeometry

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


def _repeat(names: Sequence[str], copies: int) -> tuple[str, ...]:
    return tuple(n for n in names for _ in range(copies))


# The 11 ESP accelerators (+ NVDLA) of paper Table 2 / §3.
ALL_ACCS = (
    "autoencoder", "cholesky", "conv2d", "fft", "gemm", "mlp",
    "mriq", "nvdla", "nightvision", "sort", "spmv", "viterbi",
)

SOC0 = SoCConfig(  # traffic-generator SoC (Table 4: "SoCs w/ Traffic Gen")
    name="SoC0", n_accs=12, noc_rows=5, noc_cols=5, n_cpus=4, n_mem_tiles=4,
    llc_slice_bytes=512 * KB, l2_bytes=64 * KB,
    accelerators=tuple(f"traffic{i}" for i in range(12)),
)
SOC1 = SoCConfig(
    name="SoC1", n_accs=7, noc_rows=4, noc_cols=4, n_cpus=2, n_mem_tiles=4,
    llc_slice_bytes=256 * KB, l2_bytes=32 * KB,
    accelerators=("traffic0", "traffic1", "traffic2", "traffic3",
                  "traffic4", "traffic5", "traffic6"),
)
SOC2 = SoCConfig(
    name="SoC2", n_accs=9, noc_rows=4, noc_cols=4, n_cpus=4, n_mem_tiles=2,
    llc_slice_bytes=512 * KB, l2_bytes=32 * KB,
    accelerators=tuple(f"traffic{i}" for i in range(9)),
)
SOC3 = SoCConfig(
    name="SoC3", n_accs=16, noc_rows=5, noc_cols=5, n_cpus=4, n_mem_tiles=4,
    llc_slice_bytes=256 * KB, l2_bytes=64 * KB,
    accelerators=tuple(f"traffic{i}" for i in range(16)),
    no_private_cache=(3, 6, 9, 12, 15),
)
SOC4 = SoCConfig(  # case study: one of each accelerator
    name="SoC4", n_accs=11, noc_rows=5, noc_cols=4, n_cpus=2, n_mem_tiles=4,
    llc_slice_bytes=256 * KB, l2_bytes=32 * KB,
    accelerators=tuple(a for a in ALL_ACCS if a != "nvdla"),
)
SOC5 = SoCConfig(  # collaborative autonomous vehicles
    name="SoC5", n_accs=8, noc_rows=4, noc_cols=4, n_cpus=1, n_mem_tiles=4,
    llc_slice_bytes=256 * KB, l2_bytes=32 * KB,
    accelerators=_repeat(("fft", "viterbi", "conv2d", "gemm"), 2),
)
SOC6 = SoCConfig(  # computer vision: 3x image-classification pipeline
    name="SoC6", n_accs=9, noc_rows=4, noc_cols=4, n_cpus=1, n_mem_tiles=2,
    llc_slice_bytes=256 * KB, l2_bytes=32 * KB,
    accelerators=_repeat(("nightvision", "autoencoder", "mlp"), 3),
)

# §3 motivation SoCs: "Each processor and accelerator has its own 32KB
# private cache. The 1MB LLC is split in two units" — used for Fig. 2
# (one accelerator of each type, isolation) and Fig. 3 (12 accelerators:
# 3x FFT, night-vision, sort, SPMV, concurrent).
SOC_MOTIV_ISO = SoCConfig(
    name="SoC-motiv-iso", n_accs=12, noc_rows=4, noc_cols=5, n_cpus=2,
    n_mem_tiles=2, llc_slice_bytes=512 * KB, l2_bytes=32 * KB,
    accelerators=ALL_ACCS,
)
SOC_MOTIV_PAR = SoCConfig(
    name="SoC-motiv-par", n_accs=12, noc_rows=4, noc_cols=5, n_cpus=2,
    n_mem_tiles=2, llc_slice_bytes=512 * KB, l2_bytes=32 * KB,
    accelerators=_repeat(("fft", "nightvision", "sort", "spmv"), 3),
)

SOCS = {s.name: s for s in (SOC0, SOC1, SOC2, SOC3, SOC4, SOC5, SOC6,
                            SOC_MOTIV_ISO, SOC_MOTIV_PAR)}

# Paper §3 / Fig. 2 workload buckets, and §5's S/M/L/XL characterization.
WORKLOAD_SMALL = 16 * KB
WORKLOAD_MEDIUM = 256 * KB
WORKLOAD_LARGE = 4 * MB


# --------------------------------------------------------------- budget model
@dataclasses.dataclass(frozen=True)
class SoCBudget:
    """Area / off-chip-bandwidth envelope for generated SoCs (soc.dse).

    A lumos-style abstract budget: every tile occupant costs area in the
    same arbitrary unit (one accelerator datapath == 1.0), SRAM costs
    area per MB, and the off-chip bandwidth budget caps how many DDR
    controllers a design may instantiate (each contributes
    ``timings.dram_bw`` bytes/cycle).  The defaults envelope paper
    Table 4: every hand-written SoC fits (pinned in tests), so the
    generated design space is "SoCs buildable on the paper's FPGA".
    Accelerators listed in ``no_private_cache`` pay no L2 area — the
    same resource trade the paper's SoC3 makes."""

    max_area: float = 48.0          # abstract tile-area units
    max_offchip_bw: float = 16.0    # bytes/cycle aggregate DDR
    cpu_area: float = 2.0           # CPU tile (core + its private cache)
    acc_area: float = 1.0           # accelerator datapath tile
    mem_tile_area: float = 1.5      # DDR controller + LLC slice control
    router_area: float = 0.25       # per NoC router
    cache_area_per_mb: float = 4.0  # SRAM (private L2s + LLC slices)


DEFAULT_BUDGET = SoCBudget()


def soc_cache_bytes(soc: SoCConfig) -> int:
    """Total on-chip SRAM: one private L2 per CPU and per accelerator that
    has one, plus the LLC slices."""
    n_l2 = soc.n_cpus + soc.n_accs - len(soc.no_private_cache)
    return n_l2 * soc.l2_bytes + soc.n_mem_tiles * soc.llc_slice_bytes


def soc_area(soc: SoCConfig, budget: SoCBudget = DEFAULT_BUDGET) -> float:
    """Area of ``soc`` under ``budget``'s cost model (budget-relative
    only through the per-component cost constants)."""
    return (soc.n_cpus * budget.cpu_area
            + soc.n_accs * budget.acc_area
            + soc.n_mem_tiles * budget.mem_tile_area
            + soc.noc_rows * soc.noc_cols * budget.router_area
            + soc_cache_bytes(soc) / MB * budget.cache_area_per_mb)


def soc_offchip_bw(soc: SoCConfig) -> float:
    """Aggregate off-chip bandwidth (bytes/cycle across DDR channels)."""
    return soc.n_mem_tiles * soc.timings.dram_bw


def budget_report(soc: SoCConfig,
                  budget: SoCBudget = DEFAULT_BUDGET) -> dict:
    """Area/bandwidth numbers and whether ``soc`` fits ``budget``."""
    area = soc_area(soc, budget)
    bw = soc_offchip_bw(soc)
    return {
        "area": area,
        "area_frac": area / budget.max_area,
        "offchip_bw": bw,
        "bw_frac": bw / budget.max_offchip_bw,
        "within_budget": bool(area <= budget.max_area
                              and bw <= budget.max_offchip_bw),
    }
