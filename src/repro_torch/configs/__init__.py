"""Architecture registry: ``--arch <id>`` resolution for every assigned
architecture, plus reduced smoke-test variants for CPU."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig
from repro_torch.configs import shapes  # noqa: F401  (re-export)
from repro_torch.configs.granite_moe_3b_a800m import CONFIG as GRANITE_MOE_3B
from repro_torch.configs.arctic_480b import CONFIG as ARCTIC_480B
from repro_torch.configs.qwen3_8b import CONFIG as QWEN3_8B
from repro_torch.configs.gemma2_27b import CONFIG as GEMMA2_27B
from repro_torch.configs.gemma2_9b import CONFIG as GEMMA2_9B
from repro_torch.configs.yi_34b import CONFIG as YI_34B
from repro_torch.configs.rwkv6_3b import CONFIG as RWKV6_3B
from repro_torch.configs.qwen2_vl_2b import CONFIG as QWEN2_VL_2B
from repro_torch.configs.recurrentgemma_9b import CONFIG as RECURRENTGEMMA_9B
from repro_torch.configs.musicgen_large import CONFIG as MUSICGEN_LARGE

ARCHS: dict[str, ArchConfig] = {
    c.name: c
    for c in (
        GRANITE_MOE_3B, ARCTIC_480B, QWEN3_8B, GEMMA2_27B, GEMMA2_9B,
        YI_34B, RWKV6_3B, QWEN2_VL_2B, RECURRENTGEMMA_9B, MUSICGEN_LARGE,
    )
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def smoke_config(name: str) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests: small width/depth,
    few experts, tiny vocab — structure (pattern, features) preserved."""
    cfg = get_arch(name)
    pattern_span = max(cfg.global_every, cfg.rg_pattern, 1)
    updates = dict(
        name=cfg.name + "-smoke",
        n_layers=2 * pattern_span,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        head_dim=16,
        d_ff=96 if not cfg.n_experts else 32,
        vocab=128,
        param_dtype="float32",
        compute_dtype="float32",
        remat=cfg.remat,
    )
    if cfg.n_experts:
        updates.update(n_experts=4, top_k=min(cfg.top_k, 2))
    if cfg.family == "ssm":
        updates.update(rwkv_head_dim=16, n_heads=4, n_kv_heads=4)
    if cfg.family == "hybrid":
        updates.update(lru_width=64, sliding_window=8, n_kv_heads=1)
    if cfg.sliding_window and cfg.family != "hybrid":
        updates.update(sliding_window=8)
    if cfg.family == "vlm":
        updates.update(vision_tokens=4, vision_dim=32,
                       mrope_sections=(4, 2, 2))
    if cfg.n_codebooks:
        updates.update(n_codebooks=2)
    return dataclasses.replace(cfg, **updates)
