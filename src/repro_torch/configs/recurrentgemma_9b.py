"""RecurrentGemma-9B (Griffin) — RG-LRU recurrent blocks + local MQA
attention in a 2:1 pattern.  [arXiv:2402.19427; unverified]"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,           # 12×(rec,rec,attn) + (rec,rec)
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,          # MQA
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("recurrent", "recurrent", "local_attn"),
    window=2048,
    lru_dim=4096,
    conv_width=4,
    mlp_kind="swiglu",
    rope_theta=10_000.0,
    tie_embeddings=True,
    supports_long_context=True,   # O(window) cache — run long_500k
    optimizer="adamw",
))
