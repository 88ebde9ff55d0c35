"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) d_ff=512,
vocab=49155, MoE 40 experts top-8 [hf:ibm-granite family].

Note: the task spec's primary line says "MoE 40e top-8" while its bracketed
hf pointer names the 1b-a400m sibling (32 experts); we follow the primary
spec (40 experts), matching the 3b-a800m variant.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    head_dim=64,
    n_experts=40,
    top_k=8,
    expert_pad_to=48,   # EP shards over the 16-wide model axis (3/chip)
    tie_embeddings=True,
    rope_theta=10000.0,
)
