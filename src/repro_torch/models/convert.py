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
from . import lm
from .lm import LM, param_paths

@torch.no_grad()
def params_from_jax(cfg: ModelConfig, tree: Dict, device=None) -> LM:
    """The port's model holding the weights of the JAX package's
    ``lm.init(cfg, key)[0]`` tree, given as numpy arrays."""
    model = LM(cfg, resolve_device(device))
    for param, path, r in param_paths(cfg, model):
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
    for param, path, r in param_paths(cfg, model):
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


def tree_shapes(cfg: ModelConfig) -> Dict:
    """{key path: shape} of every leaf of the JAX package's parameter tree
    of ``cfg`` (nothing allocated)."""
    want = {}
    for param, path, r in param_paths(cfg, LM(cfg, device="meta")):
        shape = tuple(param.shape)
        if r is not None:
            shape = (lm.stack_depth(cfg, path),) + shape
        want[path] = shape
    return want


def check_tree(cfg: ModelConfig, tree: Dict) -> None:
    """Raise ``ValueError`` unless ``tree`` has exactly the leaves, and the
    shapes, of the JAX package's parameter tree of ``cfg``."""
    want = tree_shapes(cfg)
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
