"""Nemotron-4-340B — dense GQA with squared-ReLU MLP.
[arXiv:2402.16819; unverified]"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab_size=256000,
    block_pattern=("attn",),
    mlp_kind="squared_relu",
    rope_theta=10_000.0,
    optimizer="adafactor",   # 340B: Adam moments would not fit 16 GB/chip
    remat_group=8,           # saved layer inputs: 14.5 GB → 1.8 GB/chip
))
