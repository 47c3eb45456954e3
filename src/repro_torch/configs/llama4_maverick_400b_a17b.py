"""Llama-4 Maverick 400B-A17B — 128-expert top-1 MoE with shared expert,
alternating dense/MoE layers (early-fusion backbone).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    block_pattern=("attn", "moe"),   # alternating dense / MoE
    num_experts=128,
    top_k=1,
    shared_expert=True,
    mlp_kind="swiglu",
    rope_theta=500_000.0,
    optimizer="adafactor",
))
