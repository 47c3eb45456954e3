"""RWKV-6 "Finch" 1.6B — attention-free, data-dependent decay linear RNN.
[arXiv:2404.05892; unverified]"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,            # 2048 / head_size 64
    num_kv_heads=0,
    d_ff=7168,
    vocab_size=65536,
    block_pattern=("rwkv",),
    attn_kind="none",
    pos_embedding="none",
    rwkv_head_size=64,
    ddlerp_rank=32,
    decay_rank=64,
    mlp_kind="squared_relu",  # rwkv channel-mix uses relu^2
    supports_long_context=True,   # O(1) state — run long_500k
))
