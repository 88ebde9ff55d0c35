"""gemma2-27b [dense]: 46L d_model=4608 32H (GQA kv=16) d_ff=36864,
vocab=256000 — local(4096)/global alternating, logit softcaps, GeGLU,
pre+post norms, scaled tied embeddings [arXiv:2408.00118]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_ff=36864,
    vocab=256000,
    head_dim=128,
    attn_softcap=50.0,
    final_softcap=30.0,
    sliding_window=4096,
    global_every=2,
    act="gelu",
    post_norms=True,
    embed_scale=True,
    tie_embeddings=True,
    remat="dots",
    rope_theta=10000.0,
)
