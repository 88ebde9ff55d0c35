"""musicgen-large [audio]: 48L d_model=2048 32H (kv=32, full MHA)
d_ff=8192, vocab=2048 — decoder-only over EnCodec tokens (4 codebooks,
delay pattern in the data pipeline), sinusoidal positions
[arXiv:2306.05284].  The EnCodec frontend is a stub: inputs are codebook
token ids."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=2048,
    head_dim=64,
    n_codebooks=4,
    pos_emb="sinusoidal",
    act="gelu",
)
