"""Whisper-tiny — encoder-decoder; conv/mel frontend is a STUB
(input_specs provides precomputed frame embeddings per the assignment).
[arXiv:2212.04356; unverified]"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,            # decoder layers
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    block_pattern=("decoder",),   # self-attn + cross-attn + mlp
    encdec=True,
    encoder_layers=4,
    encoder_seq=1500,        # 30 s of audio at 50 Hz after conv stride
    mlp_kind="gelu",
    norm="layernorm",
    pos_embedding="learned",
    tie_embeddings=True,
    max_seq=32768,            # learned-pos table must cover the 32k cells
))
