"""Llama-3.2-Vision-11B — dense GQA backbone with cross-attention image
layers every 5th layer; vision frontend is a STUB (input_specs provides
precomputed patch embeddings per the assignment).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    block_pattern=("attn", "attn", "attn", "attn", "cross_attn"),
    mlp_kind="swiglu",
    rope_theta=500_000.0,
    img_seq=1601,            # 1 tile × (40×40 patches + 1 cls), stubbed
))
