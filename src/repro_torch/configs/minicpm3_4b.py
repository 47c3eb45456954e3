"""MiniCPM3-4B — Multi-head Latent Attention (MLA): low-rank compressed
KV cache with decoupled RoPE keys.  [hf:openbmb/MiniCPM3-4B; hf]"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,       # MLA is effectively MHA over latent KV
    d_ff=6400,
    vocab_size=73448,
    block_pattern=("attn",),
    attn_kind="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_dim=64,
    qk_rope_dim=32,
    v_head_dim=64,
    head_dim=96,           # qk_nope + qk_rope
    mlp_kind="swiglu",
    rope_theta=10_000.0,
))
