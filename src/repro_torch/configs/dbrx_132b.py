"""DBRX-132B — fine-grained MoE, 16 experts top-4.
[hf:databricks/dbrx-base; unverified]"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    block_pattern=("moe",),          # every layer MoE (fine-grained)
    num_experts=16,
    top_k=4,
    mlp_kind="swiglu",
    rope_theta=500_000.0,
    optimizer="adafactor",           # 132B: factored stats to fit HBM
))
