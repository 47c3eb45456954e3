"""Decode-state containers: the KV cache of the GQA attention block and
the recurrent state of the RWKV-6 block.

The JAX package's ``models/cache.py`` for block kinds ``attn`` and
``rwkv``.  The other caches (ring-buffered local attention, MLA latent,
cross-attention, RG-LRU state) come with their blocks (``ROADMAP.md``).
Each leaf has its own dtype: the KV cache takes the caller's, the RWKV
state is f32 whatever the caller passes, as in the JAX package.
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from . import rwkv

PORTED_KINDS = ("attn", "rwkv")


def check_ported(cfg: ModelConfig, kind: str) -> None:
    """Raise ``NotImplementedError`` naming ROADMAP.md for a block kind,
    or the attention kind or position embedding of an attention block,
    that the port does not build yet."""
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP.md, queue 1: "
            f"LM stack, the rest); the port builds {PORTED_KINDS}")
    if kind == "attn" and (cfg.attn_kind != "gqa"
                           or cfg.pos_embedding == "learned"):
        raise NotImplementedError(
            f"attention {cfg.attn_kind!r} with {cfg.pos_embedding!r} "
            "positions is not ported yet (ROADMAP.md, queue 1: LM stack, "
            "the rest)")


def attn_cache_init(cfg: ModelConfig, batch: int, cache_len: int,
                    dtype=torch.bfloat16, device=None):
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    return {n: torch.zeros((batch, cache_len, kv, hd), dtype=dtype,
                           device=device) for n in ("k", "v")}


def attn_cache_axes():
    return {"k": "batch kv_seq kv_heads head_dim",
            "v": "batch kv_seq kv_heads head_dim"}


def block_cache_init(cfg: ModelConfig, kind: str, batch: int,
                     cache_len: int, dtype=torch.bfloat16, device=None):
    check_ported(cfg, kind)
    if kind == "rwkv":
        return rwkv.rwkv_state_init(cfg, batch, device)
    return attn_cache_init(cfg, batch, cache_len, dtype, device)


def block_cache_axes(cfg: ModelConfig, kind: str):
    check_ported(cfg, kind)
    if kind == "rwkv":
        return rwkv.rwkv_state_axes()
    return attn_cache_axes()
