"""ChatGLM3-6B — dense, 2-D (partial) RoPE over half the head dims, GQA
kv=2.  [arXiv:2406.12793; hf]"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65024,
    block_pattern=("attn",),
    mlp_kind="swiglu",
    rope_fraction=0.5,     # 2d rope: rotary on half the head dimension
    rope_theta=10_000.0,
))
