"""Model configuration system + architecture registry.

A copy of the JAX package's ``configs/base.py`` (the port imports nothing
of that package); only ``get_config`` differs, importing this package's
config modules.  The LM stack of the port builds the dense GQA families
(``models/lm.py``); every config stays registered as data.

One config file per assigned architecture lives beside this module; each
calls ``register()``.  ``reduced()`` derives the smoke-test config (same
family / block pattern, tiny dims) used by CPU tests; the full config is
exercised only through the dry-run (ShapeDtypeStruct, no allocation).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | vlm | audio | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 → d_model // num_heads

    # block structure: the repeating superblock of layer kinds; layers =
    # repeats * len(pattern) + remainder taken from the pattern prefix
    block_pattern: Tuple[str, ...] = ("attn",)   # attn|moe|rwkv|recurrent|local_attn|cross_attn

    # attention
    attn_kind: str = "gqa"          # gqa | mla | none
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0      # chatglm-style partial rotary
    window: Optional[int] = None    # local attention span
    pos_embedding: str = "rope"     # rope | learned | none

    # mlp
    mlp_kind: str = "swiglu"        # swiglu | squared_relu | gelu

    # moe
    num_experts: int = 0
    top_k: int = 0
    shared_expert: bool = False
    capacity_factor: float = 1.25
    moe_group_size: int = 1024      # dispatch group (memory/locality knob)
    router_aux_coef: float = 0.01
    router_z_coef: float = 1e-3

    # mla (minicpm3 / deepseek-style latent attention)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # rwkv
    rwkv_head_size: int = 64
    ddlerp_rank: int = 32
    decay_rank: int = 64

    # griffin / recurrentgemma
    lru_dim: int = 0                # 0 → d_model
    conv_width: int = 4

    # vlm / audio frontends (stubs per assignment: precomputed embeddings)
    img_seq: int = 0                # image-token count fed to cross-attn
    encoder_layers: int = 0
    encoder_seq: int = 0
    encdec: bool = False

    # misc
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    tie_embeddings: bool = False
    max_seq: int = 8192

    # training defaults
    optimizer: str = "adamw"        # adamw | adafactor (≥100B configs)
    remat: bool = True
    # shard the residual stream's SEQ dim over the model axis at scan
    # boundaries (Megatron-style sequence parallelism for the saved
    # activations).  NOTE: measured counterproductive under GSPMD — seq-
    # sharded token contractions turn weight grads into full-shape
    # partials + all-reduce (EXPERIMENTS.md §Perf) — prefer remat_group.
    shard_seq_boundary: bool = False
    # checkpoint every `remat_group` superblocks instead of every one:
    # saved boundary activations shrink ÷G for one extra recompute of the
    # same work (total recompute unchanged), the standard deep-stack trade
    remat_group: int = 1
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # which shape cells apply (assignment: long_500k only for sub-quadratic)
    supports_long_context: bool = False
    decoder: bool = True            # encoder-only archs would be False

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)
        if self.lru_dim == 0 and "recurrent" in self.block_pattern:
            object.__setattr__(self, "lru_dim", self.d_model)

    # --- block layout ----------------------------------------------------
    @property
    def pattern_repeats(self) -> int:
        return self.num_layers // len(self.block_pattern)

    @property
    def remainder_layers(self) -> Tuple[str, ...]:
        rem = self.num_layers % len(self.block_pattern)
        return self.block_pattern[:rem]

    # --- bookkeeping -----------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter estimate (embeddings + blocks)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        total = v * d * (1 if self.tie_embeddings else 2)
        kinds = list(self.block_pattern) * self.pattern_repeats \
            + list(self.remainder_layers)
        hd = self.head_dim

        def attn_params():
            if self.attn_kind == "mla":
                qk = self.qk_nope_dim + self.qk_rope_dim
                return (d * self.q_lora_rank
                        + self.q_lora_rank * self.num_heads * qk
                        + d * (self.kv_lora_rank + self.qk_rope_dim)
                        + self.kv_lora_rank * self.num_heads * (
                            self.qk_nope_dim + self.v_head_dim)
                        + self.num_heads * self.v_head_dim * d)
            return d * hd * (self.num_heads + 2 * self.num_kv_heads) \
                + self.num_heads * hd * d

        for kind in kinds:
            if kind in ("attn", "local_attn", "cross_attn"):
                total += attn_params() + 2 * d + self._mlp_params(False)
            elif kind == "decoder":   # self-attn + cross-attn + mlp
                total += 2 * attn_params() + 3 * d \
                    + self._mlp_params(False)
            elif kind == "moe":
                total += attn_params() + 2 * d + self._mlp_params(True)
            elif kind == "rwkv":
                total += 4 * d * d + d * ff + ff * d + 2 * d \
                    + 5 * d * self.ddlerp_rank + 2 * d * self.decay_rank \
                    + d * d  # cr gate
            elif kind == "recurrent":
                total += 2 * d * self.lru_dim \
                    + 2 * self.lru_dim * self.lru_dim \
                    + self.lru_dim * d \
                    + 3 * self.lru_dim + self.conv_width * self.lru_dim \
                    + self._mlp_params(False) + 2 * d
        if self.pos_embedding == "learned":
            total += self.max_seq * d
        if self.img_seq:
            total += d * d  # frontend-stub projection
        if self.encdec:
            # encoder layers: self-attn + mlp (+ learned positions)
            total += self.encoder_layers * (
                4 * d * hd * self.num_heads
                + (3 if self.mlp_kind == "swiglu" else 2) * d * ff + 4 * d)
            if self.pos_embedding == "learned":
                total += self.encoder_seq * d
        return int(total)

    def _mlp_params(self, moe: bool) -> int:
        d, ff = self.d_model, self.d_ff
        per = (3 if self.mlp_kind == "swiglu" else 2) * d * ff
        if not moe:
            return per
        total = self.num_experts * per + d * self.num_experts
        if self.shared_expert:
            total += per
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of num_experts)."""
        if not any(k == "moe" for k in self.block_pattern):
            return self.param_count()
        full = self.param_count()
        kinds = list(self.block_pattern) * self.pattern_repeats \
            + list(self.remainder_layers)
        n_moe = sum(1 for k in kinds if k == "moe")
        per = (3 if self.mlp_kind == "swiglu" else 2) * self.d_model * self.d_ff
        inactive = n_moe * (self.num_experts - self.top_k) * per
        return int(full - inactive)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        pat = len(self.block_pattern)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=max(pat, min(2 * pat, self.num_layers)),
            d_model=64, num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            head_dim=16, d_ff=128, vocab_size=512,
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            moe_group_size=64,
            q_lora_rank=16 if self.q_lora_rank else 0,
            kv_lora_rank=16 if self.kv_lora_rank else 0,
            qk_nope_dim=8 if self.qk_nope_dim else 0,
            qk_rope_dim=8 if self.qk_rope_dim else 0,
            v_head_dim=16 if self.v_head_dim else 0,
            rwkv_head_size=16, ddlerp_rank=8, decay_rank=8,
            lru_dim=64 if self.lru_dim else 0,
            window=min(self.window, 32) if self.window else None,
            img_seq=16 if self.img_seq else 0,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=24 if self.encoder_seq else 0,
            max_seq=128,
        )


_REGISTRY: Dict[str, ModelConfig] = {}

ARCH_IDS = [
    "dbrx-132b", "llama4-maverick-400b-a17b", "granite-3-2b",
    "chatglm3-6b", "minicpm3-4b", "nemotron-4-340b", "rwkv6-1.6b",
    "llama-3.2-vision-11b", "whisper-tiny", "recurrentgemma-9b",
]

_MODULE_OF = {
    "dbrx-132b": "dbrx_132b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "granite-3-2b": "granite_3_2b",
    "chatglm3-6b": "chatglm3_6b",
    "minicpm3-4b": "minicpm3_4b",
    "nemotron-4-340b": "nemotron_4_340b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "whisper-tiny": "whisper_tiny",
    "recurrentgemma-9b": "recurrentgemma_9b",
}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY and name in _MODULE_OF:
        importlib.import_module(f".{_MODULE_OF[name]}", __package__)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return _REGISTRY[name]


def all_configs() -> Dict[str, ModelConfig]:
    for a in ARCH_IDS:
        get_config(a)
    return dict(_REGISTRY)
