"""Abstract input/parameter specs for the dry run (nothing allocated).

The JAX package's ``launch/specs.py``.  ``input_specs`` provides
stand-ins for every model input of every (arch × shape) cell, laid out on
the given mesh: DTensors whose local shards lie on the ``meta`` device —
the only way the FULL configs (up to 400B params) are ever touched.

The parameter tree is the JAX-shaped f32 master tree the port's training
keeps (``models/convert.py``), so its leaves match the reference's one
for one, and ``param_axes`` is ``lm.param_axes``.

Assigned shape cells (LM family):
  train_4k     seq 4096   global_batch 256   → train_step
  prefill_32k  seq 32768  global_batch 32    → prefill
  decode_32k   seq 32768  global_batch 128   → decode_step (1 new token)
  long_500k    seq 524288 global_batch 1     → decode_step, sub-quadratic
                archs only (rwkv6 / recurrentgemma); skips are recorded.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..configs.base import ModelConfig
from ..models import convert, lm
from ..sharding.rules import abstract, mesh_shape, spec_for, tree_spec
from ..train import tree as T

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

# gradient-accumulation factor per arch for train_4k (the reference's:
# sized so saved layer-input activations fit 16 GB a device next to
# params + grads + optimizer state)
ACCUM = {
    "dbrx-132b": 8,
    "llama4-maverick-400b-a17b": 16,
    "granite-3-2b": 4,
    "chatglm3-6b": 4,
    "minicpm3-4b": 8,
    "nemotron-4-340b": 16,
    "rwkv6-1.6b": 8,
    "llama-3.2-vision-11b": 8,
    "whisper-tiny": 16,      # unshardable 51865-vocab logits dominate
    "recurrentgemma-9b": 8,
}


def accum_for(arch: str, mesh) -> int:
    """Cap accumulation so the microbatch stays divisible by the batch
    sharding extent (pod×data) — an unshardable microbatch would
    replicate activations on every data shard."""
    sizes = mesh_shape(mesh)
    batch_shards = sizes.get("pod", 1) * sizes.get("data", 1)
    cap = max(1, SHAPES["train_4k"]["batch"] // batch_shards)
    return min(ACCUM[arch], cap)


def cell_applicable(cfg: ModelConfig, shape_name: str) -> Tuple[bool, str]:
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return False, ("full quadratic attention at 524288 context is "
                       "intractable; arch has no sub-quadratic path "
                       "(noted in DESIGN.md §Arch-applicability)")
    if shape_name.startswith("decode") or shape_name == "long_500k":
        if not cfg.decoder:
            return False, "encoder-only arch has no decode step"
    return True, ""


def axes_probe(cfg: ModelConfig) -> ModelConfig:
    """Tiny-dims config with the same tree structure as the full one
    (axes strings are structure, not math)."""
    return dataclasses.replace(
        cfg.reduced(), name=cfg.name + "-axesprobe",
        num_layers=cfg.num_layers,
        encoder_layers=cfg.encoder_layers)


def param_axes(cfg: ModelConfig) -> Dict:
    return lm.param_axes(axes_probe(cfg))


def _tree_of(shapes: Dict) -> Dict:
    tree: Dict = {}
    for path, shape in shapes.items():
        T.put(tree, path, torch.Size(shape))
    return tree


class _Shape:
    """A leaf stand-in with a ``shape``, for ``tree_spec``."""

    def __init__(self, shape):
        self.shape = tuple(shape)


def _abstract_tree(shapes: Dict, axes: Dict, dtype_of, mesh) -> Dict:
    stand = T.tree_map(_Shape, shapes)
    specs = tree_spec(stand, axes, mesh)
    return T.tree_map(lambda s, sp, dt: abstract(s.shape, dt, sp, mesh),
                      stand, specs, dtype_of)


def abstract_params(cfg: ModelConfig, mesh):
    """(the f32 master tree as abstract DTensors on ``mesh``, axes tree)."""
    shapes = _tree_of(convert.tree_shapes(cfg))
    axes = param_axes(cfg)
    f32 = T.tree_map(lambda _: torch.float32, shapes)
    return _abstract_tree(shapes, axes, f32, mesh), axes


def abstract_opt_state(optimizer, params, axes, mesh):
    """``optimizer.init(params)``'s tree as abstract DTensors laid out by
    ``optimizer.state_axes``; the shapes come from an init on meta."""
    local = T.tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype,
                                             device="meta"), params)
    state = optimizer.init(local)
    shapes = T.tree_map(lambda t: tuple(t.shape), state)
    dtypes = T.tree_map(lambda t: t.dtype, state)
    return _abstract_tree(shapes, optimizer.state_axes(axes), dtypes, mesh)


def _spec(shape, dtype, mesh, axes_str):
    return abstract(shape, dtype, spec_for(shape, axes_str, mesh), mesh)


def batch_specs(cfg: ModelConfig, mesh, batch: int, seq: int,
                train: bool) -> Dict:
    out = {"tokens": _spec((batch, seq), torch.int32, mesh, "batch seq")}
    if train:
        out["labels"] = _spec((batch, seq), torch.int32, mesh, "batch seq")
        out["loss_mask"] = _spec((batch, seq), torch.float32, mesh,
                                 "batch seq")
    if cfg.img_seq:
        out["img_embeds"] = _spec((batch, cfg.img_seq, cfg.d_model),
                                  torch.bfloat16, mesh, "batch img_seq .")
    if cfg.encdec:
        out["enc_embeds"] = _spec((batch, cfg.encoder_seq, cfg.d_model),
                                  torch.bfloat16, mesh, "batch enc_seq .")
    return out


def cache_specs(cfg: ModelConfig, mesh, batch: int, cache_len: int):
    """``lm.init_cache``'s tree (KV caches in bf16) laid out by
    ``lm.cache_axes``."""
    shapes = lm.init_cache(cfg, batch, cache_len, torch.bfloat16,
                           device="meta")
    dtypes = T.tree_map(lambda t: t.dtype, shapes)
    return _abstract_tree(T.tree_map(lambda t: tuple(t.shape), shapes),
                          lm.cache_axes(cfg), dtypes, mesh)


def decode_input_specs(cfg: ModelConfig, mesh, batch: int):
    tok = _spec((batch,), torch.int32, mesh, "batch")
    pos = _spec((), torch.int32, mesh, "")
    return tok, pos


def input_specs(cfg: ModelConfig, mesh, shape_name: str):
    """All abstract inputs for one (arch × shape) cell."""
    sh = SHAPES[shape_name]
    if sh["kind"] == "train":
        return {"batch": batch_specs(cfg, mesh, sh["batch"], sh["seq"],
                                     train=True)}
    if sh["kind"] == "prefill":
        return {"batch": batch_specs(cfg, mesh, sh["batch"], sh["seq"],
                                     train=False)}
    # decode: cache at full context + one token
    tok, pos = decode_input_specs(cfg, mesh, sh["batch"])
    return {"cache": cache_specs(cfg, mesh, sh["batch"], sh["seq"]),
            "token": tok, "pos": pos}
