"""Generative SoC design space, sampler half: budgeted design points.

:func:`sample_socs` draws design points (accelerator counts and access-
pattern mixes, cache sizes, DDR channels, CPU counts, NoC dims,
``no_private_cache`` masks) under a lumos-style area/bandwidth
:class:`~repro_torch.soc.config.SoCBudget`, the reference's
``repro.soc.dse`` sampler copied as it is (numpy only): over-budget
draws are repaired deterministically (shrink LLC, shrink L2, drop
accelerators, ...) so every :class:`SoCConfig` validates and fits, and
each point carries its own seed, so sample ``i`` of a key is the same
configuration and seed as the reference's.  The co-search half
(``run_sweep``, ``rank_axes``) is not ported yet (ROADMAP A13/A14).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.soc.accelerators import PATTERN_NAMES, PROFILES
from repro_torch.soc.config import (DEFAULT_BUDGET, KB, MemTimings, SoCBudget,
                                    SoCConfig, budget_report, soc_offchip_bw)

# Accelerators grouped by access pattern (streaming / strided /
# irregular) — the sampler draws a pattern mix first so the mix axes
# vary widely instead of concentrating at the suite's 8/3/1 split.
_BY_PATTERN = tuple(
    tuple(n for n, p in PROFILES.items() if p.pattern == pat)
    for pat in range(len(PATTERN_NAMES)))

L2_CHOICES = (16 * KB, 32 * KB, 64 * KB, 128 * KB)
LLC_CHOICES = (128 * KB, 256 * KB, 512 * KB, 1024 * KB)

@dataclasses.dataclass(frozen=True)
class SampledSoC:
    """One generated design point: validated config + deterministic seed
    + the raw sampler-axis values (the regression features)."""

    config: SoCConfig
    seed: int            # per-config seed (apps, tile striping, keys)
    axes: dict


def config_seed(key: int, i: int) -> int:
    """Deterministic per-config seed — depends only on (key, i), never on
    the sample count or bucket layout."""
    return int(np.random.SeedSequence([key, i]).generate_state(1)[0]
               % np.uint32(2 ** 31 - 1))


def _noc_dims(occupants: int) -> tuple[int, int]:
    """Smallest near-square grid with at least ``occupants`` tiles."""
    rows = int(math.ceil(math.sqrt(occupants)))
    cols = int(math.ceil(occupants / rows))
    return rows, cols


def _build(name: str, d: dict) -> SoCConfig:
    rows, cols = _noc_dims(d["n_accs"] + d["n_cpus"] + d["n_mem_tiles"])
    return SoCConfig(
        name=name, n_accs=d["n_accs"], noc_rows=rows, noc_cols=cols,
        n_cpus=d["n_cpus"], n_mem_tiles=d["n_mem_tiles"],
        llc_slice_bytes=d["llc_slice"], l2_bytes=d["l2"],
        accelerators=tuple(d["accs"][:d["n_accs"]]),
        no_private_cache=tuple(i for i in d["no_l2"] if i < d["n_accs"]))


def _sample_one(rng: np.random.Generator, name: str, budget: SoCBudget,
                min_accs: int, max_accs: int) -> tuple[SoCConfig, dict]:
    """Draw one design point, then repair it deterministically until it
    fits the budget (shrink LLC -> shrink L2 -> drop accelerators ->
    drop DDR channels -> drop CPUs, cheapest-first)."""
    n_accs = int(rng.integers(min_accs, max_accs + 1))
    mix = rng.dirichlet(np.ones(len(PATTERN_NAMES)))
    patterns = rng.choice(len(PATTERN_NAMES), size=n_accs, p=mix)
    accs = [str(rng.choice(_BY_PATTERN[p])) for p in patterns]
    no_l2_frac = float(rng.uniform(0.0, 0.4))
    d = {
        "n_accs": n_accs,
        "accs": accs,
        "n_cpus": int(rng.choice([1, 2, 4])),
        "n_mem_tiles": int(rng.choice([1, 2, 4])),
        "l2": int(rng.choice(L2_CHOICES)),
        "llc_slice": int(rng.choice(LLC_CHOICES)),
        "no_l2": sorted(int(i) for i in np.nonzero(
            rng.random(n_accs) < no_l2_frac)[0]),
    }
    # Bandwidth budget first: each DDR channel costs dram_bw bytes/cycle.
    dram_bw = MemTimings().dram_bw
    while (d["n_mem_tiles"] > 1
           and d["n_mem_tiles"] * dram_bw > budget.max_offchip_bw):
        d["n_mem_tiles"] //= 2
    # Area budget: shrink until the report says it fits.
    while True:
        cfg = _build(name, d)
        rep = budget_report(cfg, budget)
        if rep["within_budget"]:
            break
        if d["llc_slice"] > LLC_CHOICES[0]:
            d["llc_slice"] //= 2
        elif d["l2"] > L2_CHOICES[0]:
            d["l2"] //= 2
        elif d["n_accs"] > max(2, min(min_accs, 2)):
            d["n_accs"] -= 1
        elif d["n_mem_tiles"] > 1:
            d["n_mem_tiles"] -= 1
        elif d["n_cpus"] > 1:
            d["n_cpus"] -= 1
        else:
            raise ValueError(f"budget {budget} too tight for any design")

    profs = [PROFILES[n] for n in cfg.accelerators]
    pat = np.asarray([p.pattern for p in profs])
    axes = {
        "n_accs": cfg.n_accs,
        "n_cpus": cfg.n_cpus,
        "n_mem_tiles": cfg.n_mem_tiles,
        "noc_tiles": cfg.noc_rows * cfg.noc_cols,
        "l2_kb": cfg.l2_bytes // KB,
        "llc_slice_kb": cfg.llc_slice_bytes // KB,
        "no_l2_frac": len(cfg.no_private_cache) / cfg.n_accs,
        "frac_streaming": float(np.mean(pat == 0)),
        "frac_strided": float(np.mean(pat == 1)),
        "frac_irregular": float(np.mean(pat == 2)),
        "mean_compute_per_byte": float(np.mean(
            [p.compute_per_byte for p in profs])),
        "mean_reuse": float(np.mean([p.reuse for p in profs])),
        "mean_burst": float(np.mean([p.burst_bytes for p in profs])),
        "area": rep["area"],
        "area_frac": rep["area_frac"],
        "offchip_bw": rep["offchip_bw"],
        "bw_per_acc": soc_offchip_bw(cfg) / cfg.n_accs,
    }
    return cfg, axes


def sample_socs(key: int, n: int, budget: SoCBudget | None = None, *,
                min_accs: int = 4, max_accs: int = 16
                ) -> list[SampledSoC]:
    """Draw ``n`` validated, budget-fitting design points.

    Each point is sampled from its own ``SeedSequence([key, i])`` stream
    and carries :func:`config_seed`'s deterministic per-config seed —
    sample ``i`` is identical no matter how many points are drawn."""
    budget = budget or DEFAULT_BUDGET
    out = []
    for i in range(n):
        rng = np.random.default_rng(np.random.SeedSequence([key, i]))
        cfg, axes = _sample_one(rng, f"dse{key}-{i}", budget,
                                min_accs, max_accs)
        out.append(SampledSoC(config=cfg, seed=config_seed(key, i),
                              axes=axes))
    return out
