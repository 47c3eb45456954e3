"""The train step: f32 master weights, a compute-dtype working copy,
remat (in the model), gradient accumulation, the optimizer update.

The JAX package's ``train/step.py`` in PyTorch.  The masters are the JAX
package's parameter tree as f32 tensors (``convert.masters_from_jax``,
or ``init_masters``); only the optimizer touches them.  Each step copies
them, rounded to ``cfg.compute_dtype``, into the working parameters of
one ``lm.LM`` (the reference's ``cast_low``: every f32 leaf rounded, the
norm scales, the MoE router and the cross-attention gates included,
which the module keeps in f32 holding the rounded values), and the
backward runs through those, so the gradients are in the compute dtype.

Gradients land in buffers laid out as the masters' tree (each working
parameter's ``.grad`` is a view into its stacked leaf), in the working
parameter's dtype; with ``accum_steps`` > 1 each microbatch adds the
gradient of loss / accum_steps into them, and the sum is cast to
``grad_accum_dtype`` (the reference differentiates through its
microbatch scan and casts the same sum).  A leaf kept in f32 by the
module is cast to the compute dtype at the end, as its reference
gradient is.
"""

from __future__ import annotations

import dataclasses
from contextlib import nullcontext
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ..configs.base import ModelConfig
from ..core.engine import resolve_device
from ..models import convert, layers, lm
from ..sharding import rules as R
from . import tree as T


def init_masters(cfg: ModelConfig, seed: int = 0, device=None) -> Dict:
    """The f32 master weights of ``lm.init`` at ``seed``: the same draws,
    not rounded (the serving model holds them rounded to the compute
    dtype)."""
    device = resolve_device(device)
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    model = lm.init(f32, torch.Generator(device=device).manual_seed(seed),
                    device=device)
    return convert.masters_from_model(f32, model)


class Working:
    """The working model: an ``lm.LM`` whose parameters take the masters
    rounded to the compute dtype at every ``load``, and the gradient
    buffers its parameters' ``.grad`` are views into.

    Masters given as DTensors (the dry run's, ``launch/specs.py``) make
    the working parameters and the gradient buffers DTensors laid out as
    their masters (a stacked leaf's slice as the leaf without its
    replicated stack axis)."""

    def __init__(self, cfg: ModelConfig, device,
                 masters: Optional[Dict] = None):
        self.cd = layers.dtype_of(cfg.compute_dtype)
        laid_out = masters is not None and \
            isinstance(T.leaves(masters)[0], DTensor)
        # laid out, only the shards are made: the whole tensors are shapes
        with R.shapes_only() if laid_out else nullcontext():
            self.model = lm.LM(cfg, device)
        self.slots = []
        self.grads: Dict = {}
        for param, path, r in list(lm.param_paths(cfg, self.model)):
            master = None if masters is None else T.get(masters, path)
            if isinstance(master, DTensor):
                spec = R.spec_of(master.placements, master.device_mesh,
                                 master.dim())
                assert r is None or spec[0] is None, \
                    "a stacked leaf's stack axis is sharded"
                param = R.distribute_parameter(
                    self.model, param, spec if r is None else spec[1:],
                    master.device_mesh)
            self.slots.append((param, path, r))
            if isinstance(master, DTensor) and r in (None, 0):
                buf = torch.zeros_like(master, dtype=param.dtype)
            elif r is None:
                buf = torch.zeros_like(param)
            elif r == 0:
                buf = torch.zeros((lm.stack_depth(cfg, path),)
                                  + tuple(param.shape), dtype=param.dtype,
                                  device=param.device)
            else:
                continue
            T.put(self.grads, path, buf)
        for param, path, r in self.slots:
            buf = T.get(self.grads, path)
            param.requires_grad_(True)
            param.grad = buf if r is None else buf[r]

    @torch.no_grad()
    def load(self, masters: Dict) -> None:
        """Working parameters ← masters rounded to the compute dtype;
        gradient buffers ← 0."""
        for param, path, r in self.slots:
            src = T.get(masters, path)
            param.copy_((src if r is None else src[r]).to(self.cd))
        for g in T.leaves(self.grads):
            g.zero_()


def _to_device(batch: Dict, device) -> Dict:
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
        if k in ("tokens", "labels"):
            t = t.long()
        out[k] = t.to(device)
    return out


def make_grad_fn(cfg: ModelConfig, accum_steps: int = 1, device=None,
                 grad_accum_dtype=torch.bfloat16) -> Callable:
    """grad_fn(masters, batch) → (loss, metrics, grads): the loss and the
    ``loss_fn`` metrics (0-d tensors; with microbatches their means) and
    the gradients as a tree like the masters' (compute dtype, or
    ``grad_accum_dtype`` with accum_steps > 1).  The gradient tree is
    the step's buffer: the next call overwrites it."""
    device = resolve_device(device)
    work: Dict[str, Working] = {}

    def grad_fn(masters: Dict, batch: Dict):
        if "w" not in work:
            work["w"] = Working(cfg, device, masters)
        w = work["w"]
        w.load(masters)
        batch = _to_device(batch, device)
        if accum_steps == 1:
            loss, metrics = lm.loss_fn(cfg, w.model, batch)
            loss.backward()
            gdt = w.cd
        else:
            lsum, ms = torch.zeros((), device=device), []
            for i in range(accum_steps):
                # on a mesh each microbatch is laid out by batch again
                mb = {k: R.constrain(
                    v.reshape((accum_steps, -1) + v.shape[1:])[i],
                    ("batch",) + (None,) * (v.dim() - 1))
                    for k, v in batch.items()}
                l, m = lm.loss_fn(cfg, w.model, mb)
                (l / accum_steps).backward()
                lsum = lsum + l.detach()
                ms.append(m)
            loss = lsum / accum_steps
            metrics = {k: torch.stack([m[k].detach() for m in ms]).mean()
                       for k in ms[0]}
            gdt = grad_accum_dtype
        grads = T.tree_map(lambda g: g.to(gdt), w.grads)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    return grad_fn


def make_train_step(cfg: ModelConfig, optimizer, accum_steps: int = 1,
                    device=None, grad_accum_dtype=torch.bfloat16
                    ) -> Callable:
    """train_step(masters, opt_state, batch) → (masters, opt_state,
    metrics), the masters and the state updated in place.  ``batch``:
    numpy arrays or tensors (tokens, labels, loss_mask [, the stubs])
    with a batch dim divisible by ``accum_steps``.  Runs on ``device``
    (default ``cuda``)."""
    grad_fn = make_grad_fn(cfg, accum_steps, device, grad_accum_dtype)

    def train_step(params: Dict, opt_state: Dict, batch: Dict):
        loss, metrics, grads = grad_fn(params, batch)
        params, opt_state, opt_metrics = optimizer.update(
            grads, opt_state, params)
        return params, opt_state, dict(metrics, loss=loss, **opt_metrics)

    return train_step

