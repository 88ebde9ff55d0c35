"""Architecture configuration schema.

One frozen dataclass covers all six assigned families (dense / moe / ssm /
vlm / hybrid / audio); family-specific fields default to "off".  Configs are
pure data — model code lives in ``repro.models``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | vlm | hybrid | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # --- attention features -------------------------------------------------
    qk_norm: bool = False          # qwen3: per-head RMSNorm on q and k
    attn_softcap: float = 0.0      # gemma2: tanh logit soft-capping
    final_softcap: float = 0.0     # gemma2: final-logit soft-capping
    sliding_window: int = 0        # window size for local-attention layers
    global_every: int = 0          # gemma2: 1 global layer per N (pattern
                                   # [local]*(N-1)+[global]); 0 = all global
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE (t, h, w) split
    pos_emb: str = "rope"          # rope | sinusoidal | none
    post_norms: bool = False       # gemma2: post-attn/post-ffn RMSNorms
    embed_scale: bool = False      # gemma2: scale embeddings by sqrt(d)

    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_dense_residual: bool = False   # arctic: parallel dense FFN
    router_aux_coef: float = 0.01
    capacity_factor: float = 1.25      # expert-capacity multiple (drops above)
    expert_pad_to: int = 0             # pad experts to a mesh multiple so
                                       # EP shards cleanly (router masks the
                                       # dead experts); 0 = no padding

    @property
    def padded_experts(self) -> int:
        return max(self.expert_pad_to, self.n_experts) if self.n_experts else 0

    # --- hybrid / ssm -------------------------------------------------------
    rg_pattern: int = 0            # recurrentgemma: 1 attn block per N
    lru_width: int = 0             # RG-LRU state width (0 -> d_model)
    conv1d_width: int = 4
    rwkv_head_dim: int = 64

    # --- vlm ----------------------------------------------------------------
    vision_tokens: int = 0         # stub frontend: #patch embeddings
    vision_dim: int = 0            # stub frontend: raw patch-embedding dim

    # --- audio --------------------------------------------------------------
    n_codebooks: int = 0           # musicgen: EnCodec codebooks

    # --- misc ---------------------------------------------------------------
    act: str = "silu"              # silu | gelu
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    # --- numerics / training ------------------------------------------------
    param_dtype: str = "float32"   # bf16 for the 480B-class config
    compute_dtype: str = "bfloat16"
    kv_cache_dtype: str = ""       # "int8" quantizes the KV cache with a
                                   # per-(pos, head) scale — halves decode
                                   # HBM traffic (§Perf Cell C lever)
    optimizer: str = "adamw"       # adamw | adafactor
    remat: str = "none"            # none | full | dots (activation ckpt)
    scan_layers: bool = True       # lax.scan over superblocks (False:
                                   # unrolled python loop — used by the
                                   # dry-run's exact cost accounting)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.resolved_head_dim

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # ---------------------------------------------------------------- sizes
    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS in §Roofline)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd = self.resolved_head_dim
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d

        def ffn(width):  # gated MLP: w_gate, w_up, w_down
            return 3 * d * width

        per_layer = 0
        if self.family == "ssm":
            # rwkv6 time-mix (r,k,v,g,w,out ~ 6 d^2 incl. lora) + channel mix
            per_layer = 6 * d * d + 2 * d * f + d * f
        elif self.family == "hybrid":
            n_attn = self.n_layers // max(self.rg_pattern, 1)
            n_rg = self.n_layers - n_attn
            lru = self.lru_width or d
            rg_block = 2 * d * lru + lru * d + lru * self.conv1d_width
            per_layer = 0  # accumulated below
            total = (n_attn * (attn + ffn(f)) + n_rg * (rg_block + ffn(f)))
            emb = v * d * (1 if self.tie_embeddings else 2)
            return total + emb + d
        else:
            per_layer = attn
            if self.n_experts:
                per_layer += self.n_experts * ffn(f) + d * self.n_experts
                if self.moe_dense_residual:
                    per_layer += ffn(f)
            else:
                per_layer += ffn(f)

        emb_mult = 1 if self.tie_embeddings else 2
        emb = v * d * emb_mult
        if self.n_codebooks:
            emb = v * d * self.n_codebooks * emb_mult
        return self.n_layers * per_layer + emb + d

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of n_experts)."""
        if not self.n_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        inactive = (self.n_experts - self.top_k) * 3 * d * f * self.n_layers
        return self.param_count() - inactive

    def embed_param_count(self) -> int:
        mult = 1 if self.tie_embeddings else 2
        per = self.vocab * self.d_model
        if self.n_codebooks:
            per *= self.n_codebooks
        return per * mult

    def active_nonembed_param_count(self) -> int:
        """Active params excluding embedding tables (flop-bearing only —
        the Kaplan 6ND convention)."""
        return self.active_param_count() - self.embed_param_count()
