"""Decode-state containers: the KV cache of the GQA attention block.

The JAX package's ``models/cache.py`` for block kind ``attn``.  The other
caches (ring-buffered local attention, MLA latent, cross-attention, RWKV
and RG-LRU states) come with their blocks (``ROADMAP.md``).
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig

PORTED_KINDS = ("attn",)


def check_ported(cfg: ModelConfig, kind: str) -> None:
    """Raise ``NotImplementedError`` naming ROADMAP.md for a block kind,
    attention kind or position embedding the port does not build yet."""
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP.md, queue 1 "
            f"item 10); the port builds {PORTED_KINDS}")
    if cfg.attn_kind != "gqa" or cfg.pos_embedding == "learned":
        raise NotImplementedError(
            f"attention {cfg.attn_kind!r} with {cfg.pos_embedding!r} "
            "positions is not ported yet (ROADMAP.md, queue 1 item 10)")


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
    return attn_cache_init(cfg, batch, cache_len, dtype, device)


def block_cache_axes(cfg: ModelConfig, kind: str):
    check_ported(cfg, kind)
    return attn_cache_axes()
