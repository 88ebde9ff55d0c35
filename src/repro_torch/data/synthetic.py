"""Deterministic synthetic token pipeline.

Serves the role of the tokenized-corpus loader in a real deployment: each
host generates only its shard of the global batch (derived from
(step, host_id) with a counter-based PRNG, so restarts are reproducible and
no host ever materializes the global batch), with Zipf-ish token marginals
so compression/embedding paths see realistic frequency skew.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2     # token frequency skew


def _rng_for(cfg: DataConfig, step: int, host: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, host]))


def host_batch(arch: ArchConfig, cfg: DataConfig, step: int,
               host: int = 0, n_hosts: int = 1) -> dict:
    """This host's shard of the global batch for ``step``."""
    assert cfg.global_batch % n_hosts == 0
    b = cfg.global_batch // n_hosts
    rng = _rng_for(cfg, step, host)
    s = cfg.seq_len

    def tokens(shape):
        # Zipf-distributed ids clipped into the vocab.
        raw = rng.zipf(cfg.zipf_a, size=shape)
        return np.minimum(raw - 1, arch.vocab - 1).astype(np.int32)

    if arch.n_codebooks:
        toks = tokens((b, arch.n_codebooks, s + 1))
        batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    else:
        toks = tokens((b, s + 1))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    if arch.family == "vlm":
        batch["vision_embeds"] = rng.normal(
            size=(b, arch.vision_tokens, arch.vision_dim)).astype(np.float32)
        # M-RoPE positions: vision patches get a (t, h, w) grid, text is
        # linear after the grid (stub geometry: square-ish patch grid).
        side = max(int(np.sqrt(arch.vision_tokens)), 1)
        t_pos = np.zeros(arch.vision_tokens, np.int32)
        h_pos = (np.arange(arch.vision_tokens) // side).astype(np.int32)
        w_pos = (np.arange(arch.vision_tokens) % side).astype(np.int32)
        text = np.arange(s - arch.vision_tokens, dtype=np.int32) + side
        mrope = np.stack([
            np.concatenate([t_pos, text]),
            np.concatenate([h_pos, text]),
            np.concatenate([w_pos, text]),
        ])                                                   # (3, S)
        batch["mrope_positions"] = np.tile(mrope[:, None, :], (1, b, 1))
    return batch


def apply_delay_pattern(tokens: np.ndarray, pad_id: int = 0) -> np.ndarray:
    """MusicGen delay pattern: codebook k is shifted right by k steps so the
    model predicts codebooks autoregressively across the K dimension."""
    b, k, s = tokens.shape
    out = np.full_like(tokens, pad_id)
    for ki in range(k):
        out[:, ki, ki:] = tokens[:, ki, :s - ki]
    return out


def batch_iterator(arch: ArchConfig, cfg: DataConfig, host: int = 0,
                   n_hosts: int = 1, start_step: int = 0) -> Iterator[dict]:
    step = start_step
    while True:
        batch = host_batch(arch, cfg, step, host, n_hosts)
        if arch.n_codebooks:
            batch["tokens"] = apply_delay_pattern(batch["tokens"])
        yield batch
        step += 1
