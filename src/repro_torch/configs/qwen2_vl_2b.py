"""qwen2-vl-2b [vlm]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960,
vocab=151936 — M-RoPE, dynamic resolution [arXiv:2409.12191].

The vision frontend is a STUB per the task spec: input_specs() provides
precomputed patch embeddings (vision_dim-wide), projected and spliced into
the first ``vision_tokens`` sequence positions.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    head_dim=128,
    mrope_sections=(16, 24, 24),
    vision_tokens=256,
    vision_dim=1280,
    rope_theta=1000000.0,
)
