"""Decode-state containers: the KV cache of the GQA attention block (and
of the MoE block, whose attention is the same), MLA's latent cache, the
ring-buffered cache of the local attention block, the static
cross-attention caches, and the recurrent states of the RWKV-6 and
RG-LRU blocks.

The JAX package's ``models/cache.py`` for every block kind: ``attn``,
``moe``, ``rwkv``, ``recurrent``, ``local_attn``, ``cross_attn`` ({"k",
"v"} over the image tokens) and ``decoder`` ({"self", "cross_k",
"cross_v"}: its self-attention cache and K/V over the encoder's frames,
filled at prefill).  Each leaf has its own dtype: the KV caches take the
caller's, the recurrent states are f32 whatever the caller passes, as in
the JAX package.

Local-attention caches are ring buffers of size ``window`` with an
explicit ``pos_of_slot`` time map (-1 for an empty slot): O(window)
memory whatever the context length.
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from . import griffin, rwkv

PORTED_KINDS = ("attn", "moe", "rwkv", "recurrent", "local_attn",
                "cross_attn", "decoder")


def check_ported(cfg: ModelConfig, kind: str) -> None:
    """Raise ``NotImplementedError`` naming ROADMAP.md for a block kind,
    or the attention kind of an attention block, that the port does not
    build."""
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported (ROADMAP.md, queue 1: LM "
            f"stack, the rest); the port builds {PORTED_KINDS}")
    attention = {"attn": ("gqa", "mla"), "moe": ("gqa", "mla"),
                 "local_attn": ("gqa",), "decoder": ("gqa",)}.get(kind)
    if attention is not None and cfg.attn_kind not in attention:
        raise NotImplementedError(
            f"attention {cfg.attn_kind!r} in a {kind!r} block is not "
            "ported (ROADMAP.md, queue 1: LM stack, the rest)")


def attn_cache_init(cfg: ModelConfig, batch: int, cache_len: int,
                    dtype=torch.bfloat16, device=None):
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    return {n: torch.zeros((batch, cache_len, kv, hd), dtype=dtype,
                           device=device) for n in ("k", "v")}


def attn_cache_axes():
    return {"k": "batch kv_seq kv_heads head_dim",
            "v": "batch kv_seq kv_heads head_dim"}


def mla_cache_init(cfg: ModelConfig, batch: int, cache_len: int,
                   dtype=torch.bfloat16, device=None):
    return {"c_kv": torch.zeros((batch, cache_len, cfg.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, cache_len, cfg.qk_rope_dim),
                                  dtype=dtype, device=device)}


def mla_cache_axes():
    return {"c_kv": "batch kv_seq .", "k_rope": "batch kv_seq ."}


def local_cache_init(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                     device=None):
    w, kv, hd = cfg.window, cfg.num_kv_heads, cfg.head_dim
    c = {n: torch.zeros((batch, w, kv, hd), dtype=dtype, device=device)
         for n in ("k", "v")}
    c["pos_of_slot"] = torch.full((batch, w), -1, dtype=torch.int32,
                                  device=device)
    return c


def local_cache_axes():
    return {"k": "batch . kv_heads head_dim",
            "v": "batch . kv_heads head_dim",
            "pos_of_slot": "batch ."}


def cross_cache_init(cfg: ModelConfig, batch: int, seq: int,
                     dtype=torch.bfloat16, device=None):
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    return [torch.zeros((batch, seq, kv, hd), dtype=dtype, device=device)
            for _ in range(2)]


def block_cache_init(cfg: ModelConfig, kind: str, batch: int,
                     cache_len: int, dtype=torch.bfloat16, device=None):
    check_ported(cfg, kind)
    if kind == "rwkv":
        return rwkv.rwkv_state_init(cfg, batch, device)
    if kind == "recurrent":
        return griffin.recurrent_state_init(cfg, batch, device)
    if kind == "local_attn":
        return local_cache_init(cfg, batch, dtype, device)
    if kind == "cross_attn":
        k, v = cross_cache_init(cfg, batch, cfg.img_seq, dtype, device)
        return {"k": k, "v": v}
    if cfg.attn_kind == "mla":
        c = mla_cache_init(cfg, batch, cache_len, dtype, device)
    else:
        c = attn_cache_init(cfg, batch, cache_len, dtype, device)
    if kind == "decoder":  # + the static cross K/V, filled at prefill
        k, v = cross_cache_init(cfg, batch, cfg.encoder_seq, dtype, device)
        c = {"self": c, "cross_k": k, "cross_v": v}
    return c


def block_cache_axes(cfg: ModelConfig, kind: str):
    check_ported(cfg, kind)
    if kind == "rwkv":
        return rwkv.rwkv_state_axes()
    if kind == "recurrent":
        return griffin.recurrent_state_axes()
    if kind == "local_attn":
        return local_cache_axes()
    if kind == "cross_attn":
        return {"k": "batch img_seq kv_heads head_dim",
                "v": "batch img_seq kv_heads head_dim"}
    c = mla_cache_axes() if cfg.attn_kind == "mla" else attn_cache_axes()
    if kind == "decoder":
        return {"self": c,
                "cross_k": "batch enc_seq kv_heads head_dim",
                "cross_v": "batch enc_seq kv_heads head_dim"}
    return c
