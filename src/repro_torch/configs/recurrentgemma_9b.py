"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (GQA kv=1, i.e. MQA)
d_ff=12288, vocab=256000 — RG-LRU + local attention, 1 attn per 3 blocks
[arXiv:2402.19427]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab=256000,
    head_dim=256,
    sliding_window=2048,
    rg_pattern=3,
    lru_width=4096,
    conv1d_width=4,
    act="gelu",
    embed_scale=True,
    tie_embeddings=True,
    rope_theta=10000.0,
)
