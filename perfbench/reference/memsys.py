"""Memory-system timing model for the ESP-like SoC, batched over a leading
axis ``B``.

Models one accelerator invocation under each of the four coherence modes
(paper §2) in the presence of a concurrent set of other active
accelerators, producing the four monitor metrics of paper §4.1(4): total
execution time, off-chip bytes, active cycles, communication cycles.  The
model is analytical (service rates + proportional sharing of bandwidth).

Every float operation follows ``repro.soc.memsys`` in order and
association as XLA compiles it: XLA rewrites a quotient divided again,
``a / b / c``, into ``a / (b * c)``, so the two controller bandwidths are
written that way here (and in the CUDA kernel).  The float sums over
concurrent slots run left to right (:func:`repro_torch.ordered.seqsum`),
which is what the CUDA episode kernel does too.  The port's fault model
(its faulted instantiations) has no copy here: no cell of the benchmark
runs it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from perfbench.reference.modes import CoherenceMode
from perfbench.reference.rewards import Measurement
from perfbench.reference.ordered import lane_sum, seqsum
from perfbench.reference.accelerators import IRREGULAR, PF
from perfbench.reference.config import SoCConfig

_NC = int(CoherenceMode.NON_COH_DMA)
_LC = int(CoherenceMode.LLC_COH_DMA)
_CD = int(CoherenceMode.COH_DMA)


class SoCStatic(NamedTuple):
    """Scalar bundle of SoC + timing constants.  Leaves are numbers
    (:meth:`from_config`) or float32 tensors (:func:`static_tensors`)."""

    n_cpus: float
    n_mem_tiles: float
    l2_bytes: float
    llc_slice_bytes: float
    line: float
    dram_lat: float
    dram_bw: float
    llc_hit_lat: float
    llc_bw: float
    l2_hit_lat: float
    l2_bw: float
    noc_hop_lat: float
    noc_bw: float
    driver_base: float
    tlb_per_page: float
    page_bytes: float
    flush_base: float
    flush_bw: float
    dir_lookup: float
    recall_lat: float
    mshr: float

    @classmethod
    def from_config(cls, soc: SoCConfig) -> "SoCStatic":
        t = soc.timings
        return cls(
            n_cpus=float(soc.n_cpus),
            n_mem_tiles=float(soc.n_mem_tiles),
            l2_bytes=float(soc.l2_bytes),
            llc_slice_bytes=float(soc.llc_slice_bytes),
            line=float(t.line_bytes),
            dram_lat=t.dram_lat,
            dram_bw=t.dram_bw,
            llc_hit_lat=t.llc_hit_lat,
            llc_bw=t.llc_bw,
            l2_hit_lat=t.l2_hit_lat,
            l2_bw=t.l2_bw,
            noc_hop_lat=t.noc_hop_lat,
            noc_bw=t.noc_bw,
            driver_base=t.driver_base,
            tlb_per_page=t.tlb_per_page,
            page_bytes=float(t.page_bytes),
            flush_base=t.flush_base,
            flush_bw=t.flush_bw,
            dir_lookup=t.dir_lookup,
            recall_lat=t.recall_lat,
            mshr=float(t.mshr_per_tile),
        )


def static_tensors(s: SoCStatic, batch: int, device=None) -> SoCStatic:
    """Each leaf as a ``(batch,)`` float32 tensor (numbers broadcast;
    tensors are cast)."""
    def leaf(v):
        t = torch.as_tensor(v, dtype=torch.float32, device=device)
        return t.expand(batch).contiguous() if t.dim() == 0 else t
    return SoCStatic(*(leaf(v) for v in s))


_WORD = 8.0             # DMA word granularity (bytes) for irregular accesses
_SERIAL_FRAC = 0.10     # non-overlappable compute/communication fraction
_DMA_OUTSTANDING = 4.0  # outstanding DMA bursts an ESP accelerator keeps
_CPU_LLC_RESERVE = 0.15  # LLC fraction consumed by CPU background traffic
_THRASH_HIT = 0.25      # LRU second-pass hit credit over capacity


def _where(c, a, b):
    return torch.where(c, a, b)


def warmth_after(mode, footprint, cache_capacity_bytes):
    """How warm a producer leaves its output for the next pipeline stage:
    NON_COH lands data off-chip (cold); cached modes leave up to the
    hierarchy's capacity resident."""
    warm = torch.clamp(cache_capacity_bytes
                       / torch.clamp(footprint, min=1.0), max=1.0)
    return torch.where(mode == _NC, torch.zeros_like(warm), warm)


def _burst_bw(burst_bytes, lat, peak_bw, outstanding):
    """Effective bandwidth of latency-bound bursts with overlap."""
    t = lat + burst_bytes / peak_bw
    return torch.minimum(torch.as_tensor(peak_bw), outstanding * burst_bytes
                         / t)


def dma_demand(mode, profile, footprint, s: SoCStatic):
    """Unconstrained (dram, llc) bytes/cycle an invocation asks for."""
    pattern = profile[..., PF.PATTERN]
    burst = _where(pattern == IRREGULAR, torch.full_like(pattern, _WORD),
                   profile[..., PF.BURST])
    dma_bw = _burst_bw(burst, s.dram_lat, s.dram_bw, _DMA_OUTSTANDING)
    line_bw = _burst_bw(s.line, s.dram_lat + s.llc_hit_lat, s.dram_bw,
                        s.mshr)
    cpb = profile[..., PF.COMPUTE] / profile[..., PF.ENGINES]
    compute_bw = 1.0 / torch.clamp(cpb, min=1e-3)
    is_nc = mode == _NC
    miss = torch.clamp(footprint / s.llc_slice_bytes, 0.05, 1.0)
    dirty = 1.0 - profile[..., PF.READ_FRAC]
    dram = _where(is_nc, torch.minimum(dma_bw, compute_bw),
                  torch.minimum(line_bw, compute_bw) * miss * (1.0 + dirty))
    llc = _where(is_nc, torch.zeros_like(dram),
                 torch.minimum(torch.as_tensor(s.llc_bw), compute_bw))
    active = mode >= 0
    return (_where(active, dram, torch.zeros_like(dram)),
            _where(active, llc, torch.zeros_like(llc)))


# The reference's event-driven simulator jits the self-contained model
# over its 32 slots, and XLA's CPU build vectorizes two of the slot
# reductions: the DDR load over 16 lanes (two 8-wide
# accumulators), the LLC load over 8, while the cached footprint and the
# user count stay in order.
_DES_DRAM_LANES, _DES_LLC_LANES = 16, 8


def invocation_perf_cached(mode, profile, footprint, my_tiles, other_modes,
                           other_dram_demand, other_llc_demand,
                           other_footprints, other_tiles, warm_frac,
                           s: SoCStatic, dram_lanes: int = 1,
                           llc_lanes: int = 1):
    """Timing + monitor metrics of a batch of invocations.

    Shapes: ``mode (B,)`` int, ``profile (B, F)``, ``footprint (B,)``,
    ``my_tiles (B, n_tiles)``, ``other_* (B, T)`` (the concurrent slots'
    modes, cached (dram, llc) demand and footprints; mode < 0 = inactive),
    ``other_tiles (B, T, n_tiles)``, ``warm_frac (B,)``; ``s`` leaves are
    ``(B,)`` tensors or numbers.  Returns ``(Measurement, aux)`` with
    ``aux['demand_dram']``/``aux['demand_llc']`` this invocation's own
    demand, which the caller caches for its slot.

    The DDR and LLC loads sum the slots
    in ``dram_lanes`` and ``llc_lanes`` running partials
    (:func:`~repro_torch.ordered.lane_sum`; 1, the default, is left to
    right); the other slot sums run left to right."""
    f32 = torch.float32
    footprint = torch.clamp(footprint.to(f32), min=1.0)
    n_my_tiles = torch.clamp(seqsum(my_tiles.to(f32), -1), min=1.0)

    pattern = profile[..., PF.PATTERN]
    reuse = torch.clamp(profile[..., PF.REUSE], min=1.0)
    read_frac = profile[..., PF.READ_FRAC]
    one = torch.ones_like(footprint)
    zero = torch.zeros_like(footprint)
    afrac = _where(pattern == IRREGULAR, profile[..., PF.ACCESS_FRAC], one)
    in_place = profile[..., PF.IN_PLACE]
    compute_per_byte = (profile[..., PF.COMPUTE]
                        / torch.clamp(profile[..., PF.ENGINES], min=1.0))

    read_bytes = footprint * read_frac * reuse
    write_bytes = footprint * (1.0 - read_frac)
    dma_read_bytes = footprint * afrac * read_frac * reuse

    # Contention from the concurrent set (proportional sharing per tile).
    other_active = other_modes >= 0
    ot = other_tiles.to(f32)
    overlap = (seqsum(ot * my_tiles[..., None, :].to(f32), -1)
               / torch.clamp(seqsum(ot, -1), min=1.0))

    my_dram, my_llc = dma_demand(mode, profile, footprint, s)
    dram_cap = s.dram_bw * n_my_tiles
    llc_cap = s.llc_bw * n_my_tiles

    dram_load = lane_sum(_where(other_active, other_dram_demand * overlap,
                                torch.zeros_like(overlap)), dram_lanes)
    llc_load = lane_sum(_where(other_active, other_llc_demand * overlap,
                               torch.zeros_like(overlap)), llc_lanes)
    dram_slow = torch.clamp((dram_load + my_dram) / dram_cap, min=1.0)
    llc_slow = torch.clamp((llc_load + my_llc) / llc_cap, min=1.0)

    other_cached = other_active & (other_modes != _NC)
    cached_fp = seqsum(_where(other_cached, other_footprints * overlap,
                              torch.zeros_like(overlap)), -1)
    llc_capacity = (s.llc_slice_bytes * n_my_tiles
                    * (1.0 - _CPU_LLC_RESERVE))
    my_llc_cap = (llc_capacity * footprint
                  / torch.clamp(footprint + cached_fp, min=1.0))
    n_llc_users = seqsum(_where(other_cached, overlap,
                                torch.zeros_like(overlap)), -1)

    # Shared path bandwidths.
    burst = _where(pattern == IRREGULAR, torch.full_like(pattern, _WORD),
                   profile[..., PF.BURST])
    dma_bw = _burst_bw(burst, s.dram_lat + 2 * s.noc_hop_lat, s.dram_bw,
                       _DMA_OUTSTANDING) / dram_slow
    line_fill_bw = _burst_bw(
        s.line, s.dram_lat + s.llc_hit_lat + 2 * s.noc_hop_lat,
        s.dram_bw, s.mshr) / dram_slow
    llc_hit_bw = torch.minimum(torch.as_tensor(s.llc_bw),
                               s.noc_bw * n_my_tiles) / llc_slow

    # Cache hit models.
    warm_llc_bytes = warm_frac * torch.minimum(footprint, my_llc_cap)
    fits_llc = footprint <= my_llc_cap
    cold_hit = warm_llc_bytes / footprint
    reuse_hit = _where(fits_llc, one, _THRASH_HIT * my_llc_cap / footprint)
    n_pass = torch.clamp(reuse, min=1.0)
    llc_hit_frac = (cold_hit + (n_pass - 1.0) * reuse_hit) / n_pass
    fits_l2 = footprint <= s.l2_bytes
    l2_reuse_hit = _where(fits_l2, one, _THRASH_HIT * s.l2_bytes / footprint)
    l2_hit_frac = ((n_pass - 1.0) * l2_reuse_hit) / n_pass

    # Overheads (driver, TLB preload, flushes) — paper §4.3 Actuate.
    tlb = s.tlb_per_page * torch.ceil(footprint / s.page_bytes)
    hierarchy = s.llc_slice_bytes * s.n_mem_tiles + s.n_cpus * s.l2_bytes
    full_flush_bytes = warm_frac * torch.minimum(
        footprint, torch.as_tensor(hierarchy))
    priv_flush_bytes = warm_frac * torch.minimum(
        footprint, torch.as_tensor(s.n_cpus * s.l2_bytes))
    ovh_base = s.driver_base + tlb
    ovh = _where(mode == _NC,
                 ovh_base + s.flush_base + full_flush_bytes / s.flush_bw,
                 _where(mode == _LC,
                        ovh_base + s.flush_base
                        + priv_flush_bytes / s.flush_bw,
                        ovh_base))

    # Per-mode communication cycles and off-chip bytes.
    nc_offchip = dma_read_bytes + write_bytes + full_flush_bytes
    nc_comm = ((dma_read_bytes + write_bytes)
               / torch.clamp(dma_bw, min=1e-3))

    llc_miss_bytes = read_bytes * (1.0 - llc_hit_frac)
    llc_hit_bytes = read_bytes * llc_hit_frac
    dirty_frac = torch.clamp((1.0 - read_frac) + 0.25 * in_place, 0.0, 1.0)
    evict_bytes = _where(fits_llc, zero, llc_miss_bytes * dirty_frac)
    llc_write_off = _where(fits_llc, zero, write_bytes)

    def llc_path(dir_cost_per_line, extra_lat, fill_bw_scale):
        per_line = s.line / s.llc_bw + dir_cost_per_line
        ctl_bw = s.line / (per_line * llc_slow)
        hit_bw = torch.minimum(llc_hit_bw, ctl_bw)
        fill = torch.clamp(line_fill_bw * fill_bw_scale, min=1e-3)
        comm = (llc_hit_bytes / torch.clamp(hit_bw, min=1e-3)
                + llc_miss_bytes / fill
                + write_bytes / torch.clamp(ctl_bw, min=1e-3)
                + evict_bytes / torch.clamp(fill, min=1e-3)
                + extra_lat)
        off = llc_miss_bytes + evict_bytes + llc_write_off
        return comm, off

    lc_comm, lc_off = llc_path(0.0, 0.0, 1.0)

    pressure = torch.clamp((cached_fp + footprint)
                           / torch.clamp(llc_capacity, min=1.0), 0.0, 1.0)
    dir_cost = (s.dir_lookup * (1.0 + n_llc_users * pressure)
                + s.recall_lat * torch.clamp(0.15 * n_llc_users * pressure,
                                             max=1.0))
    recall_bytes = warm_frac * torch.minimum(
        footprint, torch.as_tensor(s.n_cpus * s.l2_bytes))
    recall_cycles = ((recall_bytes / s.line) * s.recall_lat
                     / _DMA_OUTSTANDING)
    cd_comm, cd_off = llc_path(dir_cost, recall_cycles, 1.0)

    l2_hit_bytes = read_bytes * l2_hit_frac
    l2_miss_bytes = read_bytes * (1.0 - l2_hit_frac)
    fc_llc_hit = l2_miss_bytes * llc_hit_frac
    fc_llc_miss = l2_miss_bytes * (1.0 - llc_hit_frac)
    fc_dirty = _where(fits_l2, zero, l2_miss_bytes * dirty_frac * 0.5)
    per_line_fc = (s.line / s.llc_bw
                   + s.dir_lookup * (1.0 + 0.5 * n_llc_users * pressure))
    fc_ctl_bw = s.line / (per_line_fc * llc_slow)
    fc_evict = _where(fits_llc, zero, fc_llc_miss * dirty_frac)
    fc_write_off = _where(fits_llc, zero, _where(fits_l2, zero, write_bytes))
    fc_comm = (
        l2_hit_bytes / s.l2_bw
        + fc_llc_hit / torch.clamp(torch.minimum(llc_hit_bw, fc_ctl_bw),
                                   min=1e-3)
        + fc_llc_miss / torch.clamp(line_fill_bw, min=1e-3)
        + (fc_dirty + fc_evict) / torch.clamp(line_fill_bw, min=1e-3)
        + _where(fits_l2, write_bytes / s.l2_bw,
                 write_bytes / torch.clamp(fc_ctl_bw, min=1e-3)))
    fc_off = fc_llc_miss + fc_evict + fc_write_off

    comm_cycles = _where(mode == _NC, nc_comm,
                         _where(mode == _LC, lc_comm,
                                _where(mode == _CD, cd_comm, fc_comm)))
    offchip_bytes = _where(mode == _NC, nc_offchip,
                           _where(mode == _LC, lc_off,
                                  _where(mode == _CD, cd_off, fc_off)))

    compute_cycles = compute_per_byte * footprint * reuse
    hi = torch.maximum(compute_cycles, comm_cycles)
    lo = torch.minimum(compute_cycles, comm_cycles)
    active_cycles = hi + _SERIAL_FRAC * lo
    exec_time = ovh + active_cycles

    m = Measurement(exec_time=exec_time, comm_cycles=comm_cycles,
                    total_cycles=active_cycles,
                    offchip_accesses=offchip_bytes / s.line,
                    footprint=footprint)
    aux = {
        "overhead": ovh,
        "compute_cycles": compute_cycles,
        "dram_slowdown": dram_slow,
        "llc_slowdown": llc_slow,
        "llc_hit_frac": llc_hit_frac,
        "offchip_bytes": offchip_bytes,
        "demand_dram": my_dram,
        "demand_llc": my_llc,
    }
    return m, aux
