"""gemma2-9b [dense]: 42L d_model=3584 16H (GQA kv=8) d_ff=14336,
vocab=256000 — local/global alternating, logit softcaps
[arXiv:2408.00118]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    d_ff=14336,
    vocab=256000,
    head_dim=256,
    attn_softcap=50.0,
    final_softcap=30.0,
    sliding_window=4096,
    global_every=2,
    act="gelu",
    post_norms=True,
    embed_scale=True,
    tie_embeddings=True,
    rope_theta=10000.0,
)
