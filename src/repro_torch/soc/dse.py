"""Generative SoC design space: budgeted sampling and bucketed co-search.

Two halves:

  * :func:`sample_socs` draws design points (accelerator counts and
    access-pattern mixes, cache sizes, DDR channels, CPU counts, NoC
    dims, ``no_private_cache`` masks) under a lumos-style area/bandwidth
    :class:`~repro_torch.soc.config.SoCBudget`, the reference's
    ``repro.soc.dse`` sampler copied as it is (numpy only): over-budget
    draws are repaired deterministically (shrink LLC, shrink L2, drop
    accelerators, ...) so every :class:`SoCConfig` validates and fits,
    and each point carries its own seed, so sample ``i`` of a key is the
    same configuration and seed as the reference's.
  * :func:`run_sweep` splits hundreds of sampled SoCs into at most
    ``max_buckets`` length buckets (:func:`~repro_torch.soc.stacked.
    length_buckets`), trains one Cohmeleon agent per SoC with ONE
    :meth:`~repro_torch.soc.stacked.StackedVecEnv.train_batched` call per
    bucket (one episode-kernel launch a training iteration), evaluates
    the whole policy suite (fixed modes, random, manual Algorithm 1, the
    trained agents) with ONE :meth:`~repro_torch.soc.stacked.
    StackedVecEnv.episodes` call per bucket (one launch), reassembles
    per-lane metrics in sample order and regresses the learned-policy
    margins on the sampler axes (:func:`rank_axes`).

Every per-SoC input (apps, tile striping, keys) derives from the
sample's own seed, so deterministic-family metrics do not depend on the
bucketing; the keyed families (random, the agents) draw their noise at
the bucket's padded length, as the reference's do.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch import random as prng, resolve_device, xla_math
from repro_torch.core import qlearn
from repro_torch.core.modes import CoherenceMode
from repro_torch.core.policies import (FixedHomogeneous, ManualPolicy,
                                       RandomPolicy)
from repro_torch.core.rewards import PAPER_DEFAULT_WEIGHTS, stack_weights
from repro_torch.ordered import seqsum
from repro_torch.soc.accelerators import PATTERN_NAMES, PROFILES
from repro_torch.soc.config import (DEFAULT_BUDGET, KB, MemTimings, SoCBudget,
                                    SoCConfig, budget_report, soc_offchip_bw)
from repro_torch.soc.stacked import (StackedVecEnv, _compile_lanes,
                                     _join_specs, _stack_compiled,
                                     length_buckets, reassemble_lanes)

# Accelerators grouped by access pattern (streaming / strided /
# irregular) — the sampler draws a pattern mix first so the mix axes
# vary widely instead of concentrating at the suite's 8/3/1 split.
_BY_PATTERN = tuple(
    tuple(n for n, p in PROFILES.items() if p.pattern == pat)
    for pat in range(len(PATTERN_NAMES)))

L2_CHOICES = (16 * KB, 32 * KB, 64 * KB, 128 * KB)
LLC_CHOICES = (128 * KB, 256 * KB, 512 * KB, 1024 * KB)

# Sampler axes regressed against the learned-policy margin.  NoC dims
# are excluded: the grid is the smallest that fits the occupants, so
# its size is collinear with the count axes (and only costs area).
FEATURE_AXES = (
    "n_accs", "n_cpus", "n_mem_tiles", "l2_kb", "llc_slice_kb",
    "no_l2_frac", "frac_streaming", "frac_strided", "frac_irregular",
    "mean_compute_per_byte", "mean_reuse", "mean_burst",
    "area_frac", "bw_per_acc",
)

EVAL_FAMILIES = tuple(FixedHomogeneous(m).name for m in CoherenceMode) + (
    "random", "manual", "cohmeleon")
_BASE_IDX = 0            # NON_COH_DMA row == the normalization baseline
_N_FIXED = len(CoherenceMode)

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


# ------------------------------------------------------------------ sweep
def _eval_keys(seeds: np.ndarray, n_policies: int, device=None
               ) -> torch.Tensor:
    """``(K, N, 2)`` evaluation keys derived from per-config seeds —
    bucket- and sample-count-invariant, so deterministic-family metrics
    from bucketed runs reassemble bitwise against a single stacked
    call."""
    flat = (seeds[:, None].astype(np.int64) * 131 + np.arange(n_policies)
            ) % (2 ** 31 - 1)
    return prng.PRNGKey(flat.ravel(), device=device).reshape(
        len(seeds), n_policies, 2)


def _normalized(res, base, phase_mask):
    """Per-phase geomean (time, offchip) of ``res (K, N, P)`` against
    ``base (K, P)`` over each lane's real phases, ``(K, N)`` each: the
    reference's eager per-lane ``normalized_metrics``, its logarithm and
    exponential as XLA's CPU backend computes them."""
    lt = xla_math.log(torch.clamp(
        res.phase_time / torch.clamp(base.phase_time[:, None], min=1e-30),
        min=1e-12))
    lm = xla_math.log(torch.clamp(
        (res.phase_offchip + 1.0)
        / torch.clamp(base.phase_offchip[:, None] + 1.0, min=1e-30),
        min=1e-12))
    w = phase_mask.to(lt.dtype)[:, None, :]
    n = torch.clamp(seqsum(w, -1), min=1.0)
    return (xla_math.exp(seqsum(lt * w, -1) / n),
            xla_math.exp(seqsum(lm * w, -1) / n))


def _bucket_norms(sub: StackedVecEnv, st_iters, st_eval,
                  seeds_g: np.ndarray, iters: int, sharded: bool = False,
                  phases: dict | None = None
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Train one agent per lane, then evaluate the whole suite in one
    episodes call; returns ``(norm_time, norm_mem)``, each ``(K_g, N)``.

    ``sharded`` routes the training call through
    :func:`repro_torch.soc.shard.sharded_train_batched_stacked`, splitting
    the agent axis across every visible device; on one device it makes
    the plain call.  ``phases`` accumulates the training, lowering and
    evaluation seconds (host clock, the device synchronized)."""
    dev = sub.device
    sync = (torch.cuda.synchronize if dev.type == "cuda"
            else (lambda: None))
    t0 = time.perf_counter()
    cfg = qlearn.QConfig(decay_steps=torch.tensor(
        [s * iters for s in st_iters[0].n_steps], dtype=torch.int32))
    tkeys = prng.PRNGKey(seeds_g, device=dev).reshape(len(seeds_g), 1, 2)
    weights = stack_weights([PAPER_DEFAULT_WEIGHTS])
    if sharded:
        from repro_torch.soc import shard
        qs, _ = shard.sharded_train_batched_stacked(sub, st_iters, cfg,
                                                    weights, tkeys)
    else:
        qs, _ = sub.train_batched(st_iters, cfg, weights, tkeys)
    sync()
    t1 = time.perf_counter()

    suite = [FixedHomogeneous(m) for m in CoherenceMode]
    suite += [RandomPolicy(), ManualPolicy()]
    det = sub.lower(st_eval, suite)
    learned = sub.lower_qstates(st_eval, qs)
    specs = _join_specs([det, learned], lambda vs: torch.cat(vs, 1))
    sync()
    t2 = time.perf_counter()
    keys = _eval_keys(seeds_g, len(EVAL_FAMILIES), dev)
    res = sub.episodes(st_eval, specs, cfg, keys=keys)
    base = type(res)(*(v[:, _BASE_IDX] for v in res))
    nt, nm = _normalized(res, base, st_eval.phase_mask.to(dev))
    out = nt.cpu().numpy(), nm.cpu().numpy()
    t3 = time.perf_counter()
    if phases is not None:
        for k, v in (("train_s", t1 - t0), ("lower_s", t2 - t1),
                     ("eval_s", t3 - t2)):
            phases[k] = phases.get(k, 0.0) + v
    return out


def rank_axes(samples: Sequence[SampledSoC],
              targets: dict[str, np.ndarray]) -> dict:
    """Standardized least-squares regression of each target (e.g. the
    learned speedup margin) on :data:`FEATURE_AXES`; axes ranked by
    coefficient magnitude.  Constant axes get coefficient 0."""
    X = np.asarray([[s.axes[a] for a in FEATURE_AXES] for s in samples],
                   np.float64)
    mu, sd = X.mean(axis=0), X.std(axis=0)
    keep = sd > 1e-12
    Z = np.zeros_like(X)
    Z[:, keep] = (X[:, keep] - mu[keep]) / sd[keep]
    A = np.concatenate([np.ones((len(X), 1)), Z], axis=1)
    out = {}
    for name, y in targets.items():
        y = np.asarray(y, np.float64)
        coef, *_ = np.linalg.lstsq(A, y, rcond=None)
        pred = A @ coef
        ss_res = float(np.sum((y - pred) ** 2))
        ss_tot = float(np.sum((y - y.mean()) ** 2))
        ranked = sorted(zip(FEATURE_AXES, coef[1:].tolist()),
                        key=lambda kv: -abs(kv[1]))
        out[name] = {
            "ranked_coefficients": [[a, c] for a, c in ranked],
            "r2": 1.0 - ss_res / max(ss_tot, 1e-30),
        }
    return out


def run_sweep(samples: Sequence[SampledSoC], *, iters: int = 3,
              n_phases: int = 3, max_buckets: int = 4,
              min_gain: float = 0.02, sharded: bool = False,
              device=None) -> dict:
    """Train and evaluate every sampled SoC in at most ``max_buckets``
    batched (train, eval) call pairs and reduce to per-architecture win
    margins.

    Per bucket: ONE :meth:`StackedVecEnv.train_batched` call (one agent
    per lane, per-lane decay horizons) and ONE
    :meth:`StackedVecEnv.episodes` call evaluating the full suite —
    fixed modes, random, manual and the freshly trained agents — with the
    NON_COH row of the same call as the normalization baseline.
    ``sharded=True`` splits each bucket's training call across every
    visible device (:mod:`repro_torch.soc.shard`); with one device it is
    the plain call.  ``timing`` holds the reference's ``compile_s`` and
    ``train_eval_s`` and their split: ``train_s``, ``lower_s`` (the
    policy suite's mode tables) and ``eval_s``."""
    from repro_torch.soc.apps import make_application

    dev = resolve_device(device)
    socs = [s.config for s in samples]
    seeds = np.asarray([s.seed for s in samples], np.int64)
    env = StackedVecEnv(socs, device=dev)

    t0 = time.perf_counter()
    train_apps = [make_application(c, seed=s.seed, n_phases=n_phases)
                  for c, s in zip(socs, samples)]
    eval_apps = [make_application(c, seed=s.seed + 1, n_phases=n_phases)
                 for c, s in zip(socs, samples)]
    compiled_iters = [
        _compile_lanes(train_apps, socs, [int(s) + it for s in seeds])
        for it in range(iters)]
    compiled_eval = _compile_lanes(eval_apps, socs,
                                   [int(s) + 7919 for s in seeds])
    lengths = [c.n_steps for c in compiled_iters[0]]
    groups = length_buckets(lengths, max_buckets=max_buckets,
                            min_gain=min_gain)
    t_compile = time.perf_counter() - t0

    def volume(lens, gs):
        return sum(len(g) * max(lens[i] for i in g) for g in gs)

    eval_lengths = [c.n_steps for c in compiled_eval]
    vol_single = (iters * volume(lengths, [list(range(len(socs)))])
                  + volume(eval_lengths, [list(range(len(socs)))]))
    vol_bucketed = (iters * volume(lengths, groups)
                    + volume(eval_lengths, groups))
    real = iters * sum(lengths) + sum(eval_lengths)

    parts, subs, phases = [], [], {}
    t0 = time.perf_counter()
    for g in groups:
        sub = env.sublanes(g)
        subs.append(sub)
        socs_g = [socs[i] for i in g]
        st_iters = [_stack_compiled([compiled_iters[it][i] for i in g],
                                    socs_g) for it in range(iters)]
        st_eval = _stack_compiled([compiled_eval[i] for i in g], socs_g)
        parts.append(_bucket_norms(sub, st_iters, st_eval,
                                   seeds[list(g)], iters, sharded, phases))
    nt = reassemble_lanes(groups, [p[0] for p in parts])
    nm = reassemble_lanes(groups, [p[1] for p in parts])
    t_run = time.perf_counter() - t0

    fixed_t, fixed_m = nt[:, :_N_FIXED], nm[:, :_N_FIXED]
    coh_t, coh_m = nt[:, -1], nm[:, -1]
    margins = {
        "speedup_vs_noncoh": 1.0 - coh_t,
        "offchip_reduction_vs_noncoh": 1.0 - coh_m,
        "speedup_vs_fixed_mean":
            (fixed_t.mean(axis=1) - coh_t) / fixed_t.mean(axis=1),
        "offchip_reduction_vs_fixed_mean":
            (fixed_m.mean(axis=1) - coh_m) / fixed_m.mean(axis=1),
        "speedup_vs_best_fixed":
            (fixed_t.min(axis=1) - coh_t) / fixed_t.min(axis=1),
    }
    train_calls = sum(s.calls["train"] for s in subs)
    eval_calls = sum(s.calls["episodes"] for s in subs)
    return {
        "n_socs": len(samples),
        "families": list(EVAL_FAMILIES),
        "norm_time": nt,
        "norm_mem": nm,
        "margins": margins,
        "groups": [list(g) for g in groups],
        "calls": {"train": int(train_calls), "eval": int(eval_calls),
                  "n_buckets": len(groups), "max_buckets": max_buckets},
        "waste": {
            "padded_volume_single_call": int(vol_single),
            "padded_volume_bucketed": int(vol_bucketed),
            "real_invocations": int(real),
            "padded_waste_single_call": 1.0 - real / vol_single,
            "padded_waste_bucketed": 1.0 - real / vol_bucketed,
            "waste_reduction": (vol_single - vol_bucketed) / vol_single,
        },
        "timing": {
            "compile_s": t_compile,
            "train_eval_s": t_run,
            "padded_steps_per_s": vol_bucketed / max(t_run, 1e-9),
            "real_invocations_per_s": real / max(t_run, 1e-9),
            **phases,
        },
        "axis_ranking": rank_axes(samples, {
            "speedup_vs_noncoh": margins["speedup_vs_noncoh"],
            "offchip_reduction_vs_noncoh":
                margins["offchip_reduction_vs_noncoh"],
        }),
    }
