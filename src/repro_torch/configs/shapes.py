"""Assigned input-shape sets (seq_len x global_batch per the task spec).

``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a KV
cache of seq_len); ``train_*`` lower ``train_step``; ``prefill_*`` lower the
prefill function.  ``long_500k`` requires sub-quadratic attention and only
applies to ssm/hybrid archs (skips recorded in EXPERIMENTS.md).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeSpec("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeSpec("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeSpec("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeSpec("long_500k", "decode", 524288, 1)

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}

#: Families for which 524k-token decode is tractable (sub-quadratic mixing).
LONG_CONTEXT_FAMILIES = ("ssm", "hybrid")


def applicable_shapes(family: str):
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if family in LONG_CONTEXT_FAMILIES:
        out.append(LONG_500K)
    return out
