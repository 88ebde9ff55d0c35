"""Cohmeleon state space (paper Table 3).

A state is a 5-tuple of discretized attributes, each taking one of three
values, so |S| = 3^5 = 243:

  0. fully_coh_acc      — number of active fully-coherent accelerators
                          {0, 1, 2+}
  1. non_coh_per_tile   — avg number of non-coherent accelerators per memory
                          partition needed by this invocation {0, 1, 2+}
  2. to_llc_per_tile    — avg number of accelerators per LLC partition needed
                          by this invocation {0, 1, 2+}
  3. tile_footprint     — avg utilization of each needed cache-hierarchy
                          partition {<=L2, <=LLC slice, >LLC slice}
  4. acc_footprint      — memory footprint of this invocation
                          {<=L2, <=LLC slice, >LLC slice}

:func:`observe` works on tensors with any leading batch dimensions and
returns the encoded int32 state index; :func:`observe_host` senses one
invocation from host lists, as the discrete-event simulator holds them.
"""
from __future__ import annotations

import dataclasses

import torch


from perfbench.reference.modes import CoherenceMode
from perfbench.reference.ordered import seqsum

N_ATTRS = 5
N_LEVELS = 3
N_STATES = N_LEVELS**N_ATTRS  # 243


@dataclasses.dataclass(frozen=True)
class CacheGeometry:
    """Capacities needed to discretize footprints (bytes).  Fields are
    numbers, or float32 tensors broadcastable against the batch."""

    l2_bytes: object
    llc_slice_bytes: object
    n_mem_tiles: object


def _bucket_count(x: torch.Tensor) -> torch.Tensor:
    """{0, 1, 2+} bucket for a count."""
    return torch.clamp(x.to(torch.int32), 0, 2)


def _bucket_footprint(b: torch.Tensor, geom: CacheGeometry) -> torch.Tensor:
    """{<=L2, <=LLC slice, >LLC slice} bucket for a byte footprint."""
    one = torch.ones_like(b, dtype=torch.int32)
    return torch.where(b <= geom.l2_bytes, 0 * one,
                       torch.where(b <= geom.llc_slice_bytes, one, 2 * one))


def encode_attrs(attrs: torch.Tensor) -> torch.Tensor:
    """Pack a (..., 5) attribute tensor (each in [0,3)) into a state index."""
    attrs = attrs.to(torch.int32)
    out = attrs[..., 0]
    for i in range(1, N_ATTRS):
        out = out + attrs[..., i] * (N_LEVELS**i)
    return out


def observe(*, active_modes, active_footprints, needed_tiles, target_tiles,
            target_footprint, geom: CacheGeometry,
            active_fp_per_tile=None) -> torch.Tensor:
    """Sense the SoC and return the encoded state index (paper §4.1 Sense).

    Shapes (with any leading batch dims ``...``): ``active_modes (..., T)``
    (-1 = inactive), ``active_footprints (..., T)``, ``needed_tiles (...,
    T, n_tiles)`` ({0, 1} float or bool), ``target_tiles (..., n_tiles)``
    bool, ``target_footprint (...)``.  ``active_fp_per_tile (..., T)``
    optionally supplies each slot's cached ``footprint / |needed tiles|``
    (zero on inactive slots), exactly as the episode step caches it.
    """
    i32, f32 = torch.int32, torch.float32
    active = active_modes >= 0
    fc = active & (active_modes == int(CoherenceMode.FULLY_COH))
    fully_coh = fc.to(i32).sum(-1)

    tgt = target_tiles.bool()
    n_target = torch.clamp(tgt.to(i32).sum(-1), min=1)
    tiles_i = needed_tiles.to(i32)

    non_coh = active & (active_modes == int(CoherenceMode.NON_COH_DMA))
    per_tile_nc = (tiles_i * non_coh.to(i32)[..., None]).sum(-2)
    avg_nc = (torch.where(tgt, per_tile_nc, 0).sum(-1).to(f32)
              / n_target.to(f32))

    llc = active & (active_modes != int(CoherenceMode.NON_COH_DMA))
    per_tile_llc = (tiles_i * llc.to(i32)[..., None]).sum(-2)
    avg_llc = (torch.where(tgt, per_tile_llc, 0).sum(-1).to(f32)
               / n_target.to(f32))

    tiles_f = needed_tiles.to(f32)
    if active_fp_per_tile is None:
        active_fp_per_tile = (
            torch.where(active, active_footprints, 0.0)
            / torch.clamp(tiles_f.sum(-1), min=1.0))
    per_tile_bytes = seqsum(tiles_f * active_fp_per_tile[..., None], -2)
    avg_tile_bytes = (seqsum(torch.where(tgt, per_tile_bytes, 0.0), -1)
                      / n_target.to(f32))

    attrs = torch.stack([
        _bucket_count(fully_coh),
        _bucket_count(torch.round(avg_nc)),
        _bucket_count(torch.round(avg_llc)),
        _bucket_footprint(avg_tile_bytes, geom),
        _bucket_footprint(target_footprint.to(f32), geom),
    ], dim=-1)
    return encode_attrs(attrs)
