"""Aggregate the port's dry-run roofline reports into the roofline table
(the port's ``benchmarks/roofline_table.py``).

Reads ``reports/dryrun_torch/*__pod16x16.json`` (written by
``python -m repro_torch.launch.dryrun``) and emits the per-(arch x shape)
single-pod table with the three terms, the dominant one, the useful-FLOPs
ratio and the roofline fraction, all arithmetic on the H100's datasheet
constants (``repro_torch.launch.roofline``), and a flash-adjusted memory
term.

The reference subtracts the float32 S^2 score traffic of XLA's unfused
attention (``_attention_score_bytes``, kept here as its arithmetic), which
its Pallas kernel never writes.  The port's forward never writes it
either (K3 is one op), so only what the trace counted is subtracted: the
score traffic of K3's backward, the plain attention recomputed in float32
over every (query, key) pair of every attention layer (a window is
masked, not skipped) in a train cell, and nothing in a prefill or decode
cell.  Its passes (reads and writes of an S^2 tensor, in units of one
float32 write) are counted once here, on the CPU, by running the plain
attention's forward and backward under a dispatch mode
(:func:`score_passes`).

    PYTHONPATH=src:. python -m benchmarks.torch_roofline_table
"""
from __future__ import annotations

import glob
import json
import os
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from benchmarks.common import csv_row, save_report
from repro_torch.configs import ARCHS
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch.roofline import HBM_BW
from repro_torch.models import transformer

DRYRUN_DIR = os.path.join(os.path.dirname(__file__), "..", "reports",
                          "dryrun_torch")


def _attention_score_bytes(cfg, spec) -> float:
    """fp32 S^2 score traffic the flash kernel avoids (approximation:
    ~6 passes train [write+read fwd, 4 bwd], 3 prefill, 0 decode)."""
    if spec.kind == "decode":
        return 0.0
    if cfg.family == "ssm":
        return 0.0
    passes = 6.0 if spec.kind == "train" else 3.0
    s = spec.seq_len
    b = spec.global_batch
    # local layers only attend within the window
    n_attn = cfg.n_layers
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // max(cfg.rg_pattern, 1)
    win_frac = 1.0
    if cfg.global_every and cfg.sliding_window:
        local = (cfg.global_every - 1) / cfg.global_every
        win_frac = (1 - local) + local * min(1.0, cfg.sliding_window / s)
    elif cfg.family == "hybrid" and cfg.sliding_window:
        win_frac = min(1.0, cfg.sliding_window / s)
    return passes * b * cfg.n_heads * s * s * 4.0 * n_attn * win_frac


class _ScoreBytes(TorchDispatchMode):
    """Bytes read and written of tensors whose last two dimensions are
    (sq, skv), each op's operands and results counted as the roofline
    counter counts them (views free)."""

    def __init__(self, sq: int, skv: int):
        super().__init__()
        self.dims = (sq, skv)
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            seen = {id(t) for t in ins}
            outs = [t for t in tree_leaves(out)
                    if isinstance(t, torch.Tensor) and id(t) not in seen]
            self.bytes += sum(t.numel() * t.element_size() for t in ins + outs
                              if tuple(t.shape[-2:]) == self.dims)
        return out


def score_passes(b: int = 2, h: int = 4, s: int = 64, hd: int = 16) -> float:
    """S^2 passes of K3's backward: the plain attention
    (``kernels.flash_attention.ref.attention_ref``) recomputed and
    differentiated, as ``kernels.autograd.with_ref_grad`` runs it, in
    units of ``4 * b * h * s * s`` bytes."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(b, h, s, hd, generator=gen, requires_grad=True)
               for _ in range(3))
    mode = _ScoreBytes(s, s)
    with mode:
        out = attention_ref(q, k, v, causal=True)
        torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
    return mode.bytes / (4.0 * b * h * s * s)


def counted_score_bytes(cfg, spec, passes: float) -> float:
    """The S^2 traffic the port's trace counted: ``passes`` over every
    attention layer's full square in a train cell, 0 otherwise."""
    if spec.kind != "train":
        return 0.0
    n_attn = sum(k.startswith("attn") for k in transformer.layer_kinds(cfg))
    s = spec.seq_len
    return passes * spec.global_batch * cfg.n_heads * s * s * 4.0 * n_attn


def run(quick: bool = False):
    t0 = time.perf_counter()
    passes = score_passes()
    table = {}
    for path in sorted(glob.glob(os.path.join(DRYRUN_DIR,
                                              "*__pod16x16.json"))):
        with open(path) as f:
            d = json.load(f)
        cfg = ARCHS[d["arch"]]
        spec = SHAPES[d["shape"]]
        adj_bytes = max(
            d["hlo_bytes"] - counted_score_bytes(cfg, spec, passes), 0.0)
        t_mem_adj = adj_bytes / (d["chips"] * HBM_BW)
        dom = max(("compute", d["t_comp"]), ("memory", t_mem_adj),
                  ("collective", d["t_coll"]), key=lambda kv: kv[1])
        frac = d["t_comp"] / max(d["t_comp"], t_mem_adj, d["t_coll"])
        table[f"{d['arch']}|{d['shape']}"] = {
            **{k: d[k] for k in ("t_comp", "t_mem", "t_coll", "useful_ratio",
                                 "bytes_per_device", "dominant",
                                 "roofline_fraction", "kernel_launches",
                                 "trace_seconds")},
            "t_mem_flashadj": t_mem_adj,
            "dominant_flashadj": dom[0],
            "roofline_fraction_flashadj": frac,
            "reference_score_bytes": _attention_score_bytes(cfg, spec),
        }
    save_report("torch_roofline_table", {
        "score_passes": passes,
        "constants": "H100 SXM datasheet (repro_torch.launch.roofline), "
                     "arithmetic on counted work, not measurements",
        "cells": table})
    n = len(table)
    worst = sorted(table.items(),
                   key=lambda kv: kv[1]["roofline_fraction_flashadj"])[:3]
    us = (time.perf_counter() - t0) * 1e6
    return csv_row(
        "torch_roofline_table", us,
        f"cells={n} score_passes={passes:g} worst3=" + ";".join(
            f"{k}({v['roofline_fraction_flashadj']:.3f})"
            for k, v in worst))


if __name__ == "__main__":
    print(run())
