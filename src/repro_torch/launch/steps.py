"""Step functions for prefill and decode, closed over the configuration
(the reference jits these; PyTorch runs them eagerly)."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer


def make_prefill_step(cfg: ArchConfig, max_len: int | None = None):
    def prefill_step(params, batch):
        return transformer.prefill(cfg, params, batch, max_len=max_len)
    return prefill_step


def make_decode_step(cfg: ArchConfig):
    def decode_step(params, cache, batch, pos):
        return transformer.decode_step(cfg, params, cache, batch, pos)
    return decode_step
