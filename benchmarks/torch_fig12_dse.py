"""Fig. 12 (generative SoC design-space co-search) through the
PyTorch/CUDA port, beside the JAX reference.

    PYTHONPATH=src python -m benchmarks.torch_fig12_dse [--quick] \
        [--device cuda|cpu] [--out port.json] [--compare port.json] \
        [--reference] [--no-fma]

The port's run mirrors ``benchmarks/fig12_dse.py`` at full width: 256
SoCs sampled under the default area/bandwidth budget (``key = 0``), one
Cohmeleon agent trained per SoC for 3 iterations of a 3-phase app and the
whole policy suite evaluated, in at most 4 length buckets — one
``train_batched`` call (3 episode-kernel launches) and one ``episodes``
call (1 launch) per bucket — then the per-SoC margins against NON_COH,
the fixed modes' mean and the best fixed mode, and the sampler axes
ranked by a least-squares fit.  ``--quick`` keeps the 200-SoC scale with
2 iterations of 2 phases.  It asserts the reference's protocol (one
train and one eval call per bucket, at most 4 buckets, n >= 200) and the
launch count (the buckets x (iterations + 1), on the card), and prints
the wall time split into compile (apps and schedules), training,
lowering (the policy suite's mode tables) and evaluation.

``--out`` writes the JSON; ``--compare`` loads such a JSON instead of
running the port; ``--reference`` (implied by ``--compare``) runs the
reference's ``fig12_dse.run`` on the CPU with its report written to a
temporary directory and prints every number that differs: the bucket
sizes, calls and padded volumes must be equal and every per-SoC metric
bitwise (``--no-fma`` builds the reference without fused multiply-add,
ROADMAP C1).  The port side imports no JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
import time

import numpy as np
import torch

from benchmarks.torch_no_fma import use_reference_without_fma

TOP_N = 10
# the engine fields both runs share; the rest of ``_engine`` and the
# timings are the run's own
SHARED_ENGINE = ("path", "n_socs", "key", "iters", "n_phases",
                 "max_buckets", "bucket_sizes", "train_calls", "eval_calls",
                 "calls_ok")


def _per_soc_rows(samples, out, families) -> list[dict]:
    nt, nm = out["norm_time"], out["norm_mem"]
    n_fixed = len(families) - 3
    rows = []
    for i, s in enumerate(samples):
        rows.append({
            "name": s.config.name,
            "seed": s.seed,
            "axes": {k: (round(v, 4) if isinstance(v, float) else v)
                     for k, v in s.axes.items()},
            "cohmeleon": [float(nt[i, -1]), float(nm[i, -1])],
            "manual": [float(nt[i, -2]), float(nm[i, -2])],
            "fixed_mean": [float(nt[i, :n_fixed].mean()),
                           float(nm[i, :n_fixed].mean())],
            "best_fixed": [float(nt[i, :n_fixed].min()),
                           float(nm[i, :n_fixed].min())],
            "speedup_vs_noncoh":
                float(out["margins"]["speedup_vs_noncoh"][i]),
            "offchip_reduction_vs_noncoh":
                float(out["margins"]["offchip_reduction_vs_noncoh"][i]),
            "speedup_vs_best_fixed":
                float(out["margins"]["speedup_vs_best_fixed"][i]),
        })
    return rows


def run_port(device=None, quick: bool = False, n: int | None = None,
             max_buckets: int = 4, key: int = 0) -> dict:
    from repro_torch import resolve_device
    from repro_torch.kernels.soc_step import ops as soc_ops
    from repro_torch.soc.config import DEFAULT_BUDGET
    from repro_torch.soc.dse import EVAL_FAMILIES, run_sweep, sample_socs

    dev = resolve_device(device)
    n = n if n is not None else (200 if quick else 256)
    iters = 2 if quick else 3
    n_phases = 2 if quick else 3
    if dev.type == "cuda":
        torch.cuda.synchronize()
    soc_ops.reset_launches()
    t0 = time.perf_counter()
    samples = sample_socs(key, n)
    out = run_sweep(samples, iters=iters, n_phases=n_phases,
                    max_buckets=max_buckets, device=dev)
    wall = time.perf_counter() - t0

    # the reference's acceptance protocol: hundreds of SoCs, one train
    # and one eval call per bucket, never one per SoC
    calls = out["calls"]
    calls_ok = (calls["train"] == calls["n_buckets"]
                and calls["eval"] == calls["n_buckets"]
                and calls["n_buckets"] <= max_buckets)
    assert calls_ok, f"one train+eval call pair per bucket violated: {calls}"
    if quick or n >= 200:
        assert n >= 200, f"sweep must cover >= 200 SoCs, got {n}"
    expected = calls["n_buckets"] * (iters + 1)
    if dev.type == "cuda":
        assert soc_ops.launches == expected, (soc_ops.launches, expected)

    margins = out["margins"]
    rows = _per_soc_rows(samples, out, EVAL_FAMILIES)
    order = np.argsort(-margins["speedup_vs_noncoh"])
    t = out["timing"]
    return {
        "_engine": {
            "path": "vecenv-bucketed", "n_socs": n, "key": key,
            "iters": iters, "n_phases": n_phases,
            "max_buckets": max_buckets,
            "bucket_sizes": [len(g) for g in out["groups"]],
            "train_calls": calls["train"], "eval_calls": calls["eval"],
            "calls_ok": calls_ok,
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
            "episode_launches": soc_ops.launches,
            "expected_episode_launches": expected,
            "wall_s": wall, "compile_s": t["compile_s"],
            "train_s": t["train_s"], "lower_s": t["lower_s"],
            "eval_s": t["eval_s"], "train_eval_s": t["train_eval_s"],
        },
        "budget": dataclasses.asdict(DEFAULT_BUDGET),
        "waste": out["waste"],
        "throughput": {k: t[k] for k in ("compile_s", "train_eval_s",
                                         "padded_steps_per_s",
                                         "real_invocations_per_s")},
        "_headline": {
            "mean_speedup_vs_noncoh":
                float(np.mean(margins["speedup_vs_noncoh"])),
            "mean_offchip_reduction_vs_noncoh":
                float(np.mean(margins["offchip_reduction_vs_noncoh"])),
            "mean_speedup_vs_fixed_mean":
                float(np.mean(margins["speedup_vs_fixed_mean"])),
            "frac_learned_beats_all_fixed":
                float(np.mean(margins["speedup_vs_best_fixed"] > 0)),
            "frac_learned_beats_noncoh":
                float(np.mean(margins["speedup_vs_noncoh"] > 0)),
        },
        "axis_ranking": out["axis_ranking"],
        "top_socs_by_learned_margin": [rows[i] for i in order[:TOP_N]],
        "bottom_socs_by_learned_margin": [rows[i] for i in order[-3:]],
        "per_soc": rows,
    }


def run_reference(quick: bool = False) -> dict:
    """The reference's ``fig12_dse.run``, its report written to a
    temporary directory and read back."""
    from benchmarks import common, fig12_dse
    saved = common.REPORT_DIR
    with tempfile.TemporaryDirectory() as tmp:
        common.REPORT_DIR = tmp
        try:
            print(f"reference: {fig12_dse.run(quick=quick)}")
            with open(f"{tmp}/fig12_dse.json") as f:
                return json.load(f)
        finally:
            common.REPORT_DIR = saved


def _leaves(x, path=""):
    if isinstance(x, dict):
        for k in sorted(x):
            yield from _leaves(x[k], f"{path}/{k}")
    elif isinstance(x, list):
        for i, v in enumerate(x):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, x


def compare(port: dict, ref: dict) -> bool:
    """Print every field of the reference's report the port's differs
    from (the timings aside); returns True when all are equal."""
    got = dict(_leaves({k: v for k, v in port.items()
                        if k not in ("_engine", "throughput")}))
    want = dict(_leaves({k: v for k, v in ref.items()
                         if k not in ("_engine", "throughput")}))
    for k in SHARED_ENGINE:
        got[f"/_engine/{k}"] = port["_engine"][k]
        want[f"/_engine/{k}"] = ref["_engine"][k]
    bad, gap = 0, 0.0
    for path, w in want.items():
        h = got.get(path)
        if h != w:
            bad += 1
            if isinstance(w, float) and isinstance(h, float):
                gap = max(gap, abs(h - w) / max(abs(w), 1e-30))
            if bad <= 40:
                print(f"differs {path}: port {h!r} reference {w!r}")
    missing = sorted(set(got) - set(want))
    print(f"{len(want)} fields compared, {bad} differ (largest relative "
          f"difference {gap:.6g}); port-only fields: {len(missing)}; "
          f"equal: {bad == 0 and not missing}")
    return bad == 0 and not missing


def print_results(tag: str, r: dict) -> None:
    e, h, w = r["_engine"], r["_headline"], r["waste"]
    print(f"{tag}: n_socs={e['n_socs']} buckets={e['bucket_sizes']} "
          f"train_calls={e['train_calls']} eval_calls={e['eval_calls']} "
          f"waste {w['padded_waste_single_call']:.6g} -> "
          f"{w['padded_waste_bucketed']:.6g} "
          f"(bucketed volume {w['padded_volume_bucketed']}, real "
          f"{w['real_invocations']})")
    print(f"{tag} headline: " + " ".join(f"{k}={v:.6g}"
                                         for k, v in h.items()))
    top = r["axis_ranking"]["speedup_vs_noncoh"]["ranked_coefficients"][0]
    print(f"{tag} top axis: {top[0]} {top[1]:+.6g}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None)
    ap.add_argument("--out")
    ap.add_argument("--compare")
    ap.add_argument("--reference", action="store_true")
    ap.add_argument("--no-fma", action="store_true")
    args = ap.parse_args()
    if args.compare:
        with open(args.compare) as f:
            port = json.load(f)
    else:
        port = run_port(args.device, quick=args.quick)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(port, f, indent=1)
    print_results("port", port)
    e = port["_engine"]
    print(f"port engine: {e['device']} wall {e['wall_s']:.3f} s (compile "
          f"{e['compile_s']:.3f}, train {e['train_s']:.3f}, lower "
          f"{e['lower_s']:.3f}, eval {e['eval_s']:.3f}); episode launches "
          f"{e['episode_launches']} (expected "
          f"{e['expected_episode_launches']} on the card)")
    if args.reference or args.compare:
        if args.no_fma:
            use_reference_without_fma()
        ref = run_reference(quick=port["_engine"]["iters"] == 2)
        print_results("reference", ref)
        compare(port, ref)


if __name__ == "__main__":
    main()
