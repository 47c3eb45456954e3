"""Weights between the JAX package's parameter tree and the port's model.

The JAX package's ``lm.init`` returns a tree whose superblock leaves are
stacked on a leading ``stack`` axis (``p["blocks"]["b{j}"]``, one entry
per repeat) and whose remainder layers are separate (``p["rem"]``).
``params_from_jax`` takes that tree as numpy arrays and returns the
port's ``LM``, which then computes what the JAX model computes: each
leaf is cast once to the dtype of its port parameter, so matrices to the
compute dtype (the JAX package casts them at every use) and norm scales
(MLA's ``q_norm`` and ``kv_norm`` too), the MoE router, the RWKV block's
f32 leaves and its ``dec_b``, the RG-LRU block's ``conv_b`` and ``lam``,
and a ``cross_attn`` block's scalar ``gate`` and ``gate_mlp`` (stacked as
(repeats,) in the JAX tree) kept in f32.  The encoder's blocks are
stacked on one leading axis (``p["encoder"]["blocks"]``), one entry per
encoder layer.
``params_to_jax`` is its inverse.

Training keeps the JAX package's tree itself, as f32 tensors: the master
weights (``masters_from_jax``, or ``masters_from_model`` of a model
initialised in f32) and the optimizer state beside them
(``opt_state_from_jax`` / ``opt_state_to_jax``, AdamW's and Adafactor's
trees, ``count`` a 0-d int32).  So a checkpoint of either package names
the same leaves, and the port's train step can start from the
reference's parameters and state.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.engine import resolve_device
from ..train import tree as T
from .lm import LM, layer_slots

# port module path under a block → key path in the JAX block tree
_BLOCK_LEAVES = {
    "ln1.scale": ("ln1", "scale"), "ln1.bias": ("ln1", "bias"),
    "ln2.scale": ("ln2", "scale"), "ln2.bias": ("ln2", "bias"),
    "attn.wq": ("attn", "wq"), "attn.wk": ("attn", "wk"),
    "attn.wv": ("attn", "wv"), "attn.wo": ("attn", "wo"),
    "mlp.wi": ("mlp", "wi"), "mlp.wg": ("mlp", "wg"),
    "mlp.wo": ("mlp", "wo"),
    **{f"attn.{n}": ("attn", n) for n in (
        "wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b")},
    "mlp.router": ("mlp", "router"),
    **{f"mlp.{g}.{n}": ("mlp", g, n) for g in ("experts", "shared")
       for n in ("wi", "wg", "wo")},
    **{f"rwkv.{n}": ("rwkv", n) for n in (
        "mu", "ddl_a", "ddl_b", "wr", "wk", "wv", "wg", "wo", "w0",
        "dec_a", "dec_b", "u", "ln_x", "mu_c", "ck", "cr", "cv")},
    **{f"rec.{n}": ("rec", n) for n in (
        "w_x", "w_y", "conv_w", "conv_b", "wr", "wi", "lam", "w_out")},
    **{f"xattn.{n}": ("xattn", n) for n in ("wq", "wk", "wv", "wo")},
    "ln_x.scale": ("ln_x", "scale"), "ln_x.bias": ("ln_x", "bias"),
    "gate": ("gate",), "gate_mlp": ("gate_mlp",),
}
_TOP_LEAVES = {"embed": ("embed",), "head": ("head",),
               "ln_f.scale": ("ln_f", "scale"),
               "ln_f.bias": ("ln_f", "bias"),
               "pos_emb": ("pos_emb",), "img_proj": ("img_proj",),
               "encoder.ln_f.scale": ("encoder", "ln_f", "scale"),
               "encoder.ln_f.bias": ("encoder", "ln_f", "bias"),
               "encoder.pos_emb": ("encoder", "pos_emb")}


def _leaf_paths(cfg: ModelConfig, model: LM):
    """(port parameter, JAX key path, stack index or None) for every
    parameter of the model."""
    params = dict(model.named_parameters())
    for name, path in _TOP_LEAVES.items():
        if name in params:
            yield params[name], path, None
    slots = [(f"blocks.{i}", (group, key), r)
             for i, (group, key, r) in enumerate(layer_slots(cfg))]
    slots += [(f"encoder.blocks.{i}", ("encoder", "blocks"), i)
              for i in range(cfg.encoder_layers if cfg.encdec else 0)]
    for prefix, where, r in slots:
        for name, path in _BLOCK_LEAVES.items():
            full = f"{prefix}.{name}"
            if full in params:
                yield params[full], where + path, r


@torch.no_grad()
def params_from_jax(cfg: ModelConfig, tree: Dict, device=None) -> LM:
    """The port's model holding the weights of the JAX package's
    ``lm.init(cfg, key)[0]`` tree, given as numpy arrays."""
    model = LM(cfg, resolve_device(device))
    for param, path, r in _leaf_paths(cfg, model):
        leaf = tree
        for k in path:
            leaf = leaf[k]
        a = np.asarray(leaf if r is None else leaf[r])
        if a.shape != tuple(param.shape):
            raise ValueError(f"{'/'.join(path)}: shape {a.shape}, the port "
                             f"expects {tuple(param.shape)}")
        param.copy_(torch.from_numpy(np.array(a, np.float32)))
    return model


@torch.no_grad()
def masters_from_model(cfg: ModelConfig, model: LM) -> Dict:
    """The JAX package's parameter tree of ``model``'s weights as f32
    tensors on its device, block leaves stacked on the leading ``stack``
    axis."""
    tree: Dict = {}
    stacks: Dict = {}
    for param, path, r in _leaf_paths(cfg, model):
        if r is None:
            T.put(tree, path, param.float().clone())
        else:
            stacks.setdefault(path, {})[r] = param
    for path, rows in stacks.items():
        T.put(tree, path, torch.stack([rows[r].float()
                                       for r in sorted(rows)]))
    return tree


@torch.no_grad()
def params_to_jax(cfg: ModelConfig, model: LM) -> Dict:
    """The inverse of ``params_from_jax``: the JAX package's parameter
    tree as float32 numpy arrays, block leaves stacked on the leading
    ``stack`` axis."""
    return T.tree_map(lambda t: t.cpu().numpy(),
                      masters_from_model(cfg, model))


def check_tree(cfg: ModelConfig, tree: Dict) -> None:
    """Raise ``ValueError`` unless ``tree`` has exactly the leaves, and the
    shapes, of the JAX package's parameter tree of ``cfg``."""
    want = {}
    for param, path, r in _leaf_paths(cfg, LM(cfg, device="meta")):
        shape = tuple(param.shape)
        if r is not None:
            n = cfg.encoder_layers if path[0] == "encoder" \
                else cfg.pattern_repeats
            shape = (n,) + shape
        want[path] = shape
    have = {path: tuple(leaf.shape) for path, leaf in T.items(tree)}
    if have != want:
        diff = sorted(set(have.items()) ^ set(want.items()))
        raise ValueError(f"not the parameter tree of {cfg.name}: "
                         f"{diff[:4]}")


def masters_from_jax(cfg: ModelConfig, tree: Dict, device=None) -> Dict:
    """The f32 master weights of the JAX package's ``lm.init(cfg,
    key)[0]`` tree (numpy arrays): the same tree of f32 tensors on
    ``device``."""
    check_tree(cfg, tree)
    device = resolve_device(device)
    return T.tree_map(lambda a: torch.from_numpy(
        np.array(a, np.float32)).to(device), tree)


def opt_state_from_jax(state: Dict, device=None) -> Dict:
    """An AdamW or Adafactor state of the JAX package (numpy arrays) as
    the port's: f32 tensors, ``count`` a 0-d int32, on ``device``."""
    device = resolve_device(device)
    return T.tree_map(lambda a: torch.from_numpy(np.array(a)).to(device),
                      state)


def opt_state_to_jax(state: Dict) -> Dict:
    """The inverse: numpy arrays, ``count`` int32."""
    return T.tree_map(lambda t: t.detach().cpu().numpy(), state)
