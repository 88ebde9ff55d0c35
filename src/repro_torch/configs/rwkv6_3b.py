"""rwkv6-3b [ssm]: 32L d_model=2560 (attention-free) d_ff=8960,
vocab=65536 — Finch, data-dependent decay [arXiv:2404.05892]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,          # d_model / rwkv_head_dim
    n_kv_heads=40,
    d_ff=8960,
    vocab=65536,
    rwkv_head_dim=64,
    pos_emb="none",
)
