"""The JAX package's ``launch/analytic.py``, copied: pure arithmetic on
the port's ``ModelConfig``.

Analytic FLOP/byte model per (arch × shape) — the MODEL_FLOPS side of
the roofline's "useful fraction" (MODEL_FLOPS / HLO_FLOPs) and the sanity
cross-check for the composed cost analysis.

Conventions (standard):
  train   : 6·N_active per token (fwd 2 + bwd 4) + attention 12·H·hd·S/2
            (+1 extra fwd of everything when remat is on → 8·N + ...)
  prefill : 2·N_active per token + attention 4·H·hd·S/2
  decode  : 2·N_active per token + attention 4·H·hd·S_ctx (full cache read)
"""

from __future__ import annotations

from typing import Dict

from ..configs.base import ModelConfig
from .specs import SHAPES


def _attn_ctx_flops_per_token(cfg: ModelConfig, s_ctx: float,
                              causal_avg: bool) -> float:
    """QK^T + PV flops per token for one layer at context s_ctx."""
    if cfg.attn_kind == "none":
        # rwkv: per-token state update ~ H·hs·hs MACs × (2 ops)
        hs = cfg.rwkv_head_size
        h = cfg.d_model // hs
        return 2 * 3 * h * hs * hs  # outer product + readout + decay
    eff = s_ctx / 2 if causal_avg else s_ctx
    qk_dim = cfg.head_dim if cfg.attn_kind != "mla" else \
        (cfg.qk_nope_dim + cfg.qk_rope_dim)
    v_dim = cfg.head_dim if cfg.attn_kind != "mla" else cfg.v_head_dim
    return 2 * cfg.num_heads * (qk_dim + v_dim) * eff


def _layer_kinds(cfg: ModelConfig):
    return list(cfg.block_pattern) * cfg.pattern_repeats + \
        list(cfg.remainder_layers)


def model_flops(cfg: ModelConfig, shape_name: str) -> Dict[str, float]:
    sh = SHAPES[shape_name]
    seq, batch = sh["seq"], sh["batch"]
    n_active = cfg.active_param_count()
    kinds = _layer_kinds(cfg)

    def attn_flops(s_ctx, causal_avg, tokens):
        per_layer = 0.0
        for kind in kinds:
            if kind in ("attn", "moe", "decoder"):
                per_layer += _attn_ctx_flops_per_token(cfg, s_ctx,
                                                       causal_avg)
            elif kind == "local_attn":
                w = min(cfg.window or s_ctx, s_ctx)
                per_layer += _attn_ctx_flops_per_token(cfg, w, causal_avg)
            elif kind == "cross_attn":
                per_layer += _attn_ctx_flops_per_token(cfg, cfg.img_seq,
                                                       False)
            elif kind == "rwkv":
                per_layer += _attn_ctx_flops_per_token(cfg, 0, False)
            elif kind == "recurrent":
                per_layer += 2 * 3 * cfg.lru_dim  # lru update per token
        return per_layer * tokens

    if sh["kind"] == "train":
        tokens = seq * batch
        tot_mult = 6.0               # fwd 2 + bwd 4 per active param
        if cfg.remat:
            tot_mult += 2.0          # remat replays the forward once
            if cfg.remat_group > 1:
                tot_mult += 2.0      # 2-level remat replays it twice
        return {"model_flops": 6.0 * n_active * tokens
                + 3 * attn_flops(seq, True, tokens),
                "compiled_expected": tot_mult * n_active * tokens
                + (tot_mult / 2.0) * attn_flops(seq, True, tokens),
                "tokens": float(tokens), "n_active": float(n_active)}
    if sh["kind"] == "prefill":
        tokens = seq * batch
        return {"model_flops": 2.0 * n_active * tokens
                + attn_flops(seq, True, tokens),
                "compiled_expected": 2.0 * n_active * tokens
                + attn_flops(seq, True, tokens),
                "tokens": float(tokens), "n_active": float(n_active)}
    # decode: one token per sequence against a seq-long context
    tokens = batch
    return {"model_flops": 2.0 * n_active * tokens
            + attn_flops(seq, False, tokens),
            "compiled_expected": 2.0 * n_active * tokens
            + attn_flops(seq, False, tokens),
            "tokens": float(tokens), "n_active": float(n_active)}


def prefill_attention_correction(cfg: ModelConfig, shape_name: str,
                                 q_chunk: int = 1024) -> float:
    """Per-DEVICE flops the composed HLO misses for prefill cells: the
    q-chunk attention scan body is counted once instead of nq times.
    Returns the additive correction (global / 256 chips)."""
    sh = SHAPES[shape_name]
    if sh["kind"] != "prefill" or sh["seq"] < 16384:
        return 0.0
    nq = sh["seq"] // q_chunk
    kinds = _layer_kinds(cfg)
    tokens = sh["seq"] * sh["batch"]
    per_layer = 0.0
    for kind in kinds:
        if kind in ("attn", "moe", "decoder"):
            per_layer += _attn_ctx_flops_per_token(cfg, sh["seq"], True)
        elif kind == "local_attn":
            per_layer += _attn_ctx_flops_per_token(
                cfg, min(cfg.window or sh["seq"], sh["seq"]), True)
    attn_total = per_layer * tokens
    return attn_total * (nq - 1) / nq / 256.0


def decode_hbm_bytes(cfg: ModelConfig, shape_name: str) -> float:
    """Decode is memory-bound: params (bf16... stored f32 here) + KV cache
    read once per step."""
    sh = SHAPES[shape_name]
    if sh["kind"] != "decode":
        return 0.0
    param_bytes = cfg.param_count() * 4.0
    kinds = _layer_kinds(cfg)
    cache = 0.0
    for kind in kinds:
        if kind in ("attn", "moe", "decoder"):
            if cfg.attn_kind == "mla":
                per_tok = (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2
            else:
                per_tok = 2 * cfg.num_kv_heads * cfg.head_dim * 2
            cache += sh["batch"] * sh["seq"] * per_tok
        elif kind == "local_attn":
            cache += sh["batch"] * min(cfg.window or 0, sh["seq"]) \
                * 2 * cfg.num_kv_heads * cfg.head_dim * 2
        elif kind == "rwkv":
            hs = cfg.rwkv_head_size
            cache += sh["batch"] * (cfg.d_model // hs) * hs * hs * 4
        elif kind == "recurrent":
            cache += sh["batch"] * cfg.lru_dim * 4
    return param_bytes + cache
