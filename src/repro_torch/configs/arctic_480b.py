"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864,
vocab=32000, MoE 128 experts top-2 + dense residual MLP
[hf:Snowflake/snowflake-arctic-base].

480B-class: bf16 params + Adafactor (factored second moment) keep the
per-chip footprint within a v5e's 16 GB HBM at 256 chips (DESIGN.md §5).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab=32000,
    head_dim=128,
    n_experts=128,
    top_k=2,
    moe_dense_residual=True,
    param_dtype="bfloat16",
    optimizer="adafactor",
    remat="full",
    rope_theta=10000.0,
)
