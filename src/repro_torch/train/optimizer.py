"""AdamW and Adafactor, global-norm clipping and the warmup-cosine
schedule: the JAX package's ``train/optimizer.py`` in PyTorch.

Each keeps the reference's names, state trees and arithmetic in its
order, in f32: AdamW's m = b1·m + (1 − b1)·g, v = b2·v + (1 − b2)·g²,
step = (m / bc1) / (sqrt(v / bc2) + eps) + wd·p with bc = 1 − b**count
taken in f32 (not ``torch.optim.AdamW``, which decays and places eps
otherwise); the clip's scale cast to the gradient's dtype before the
multiply; Adafactor's factored second moments (rows and columns of the
last two axes) with its update-RMS clip.  The learning rate and the bias
corrections are 0-d f32 tensors on the state's device, so a step reads
nothing back to the host.

``update`` works in place: the parameters and the state it is given are
the ones it returns (the reference donates them to its jitted step), and
the gradients are scaled in place by the clip.  A leaf of more than
``_CHUNK_UPDATE_ELEMS`` elements is updated a slice of its leading axis
at a time, so the f32 temporaries of the update are a slice's, not the
leaf's: elementwise (AdamW, Adafactor's unfactored leaves) that gives the
same bits; Adafactor's factored stats are per slice too, and its update
RMS is summed over the slices before any is applied (the slices' sums
added in order, which can round otherwise than one reduction).

States mirror the parameter tree (``train/tree.py``): AdamW's {"m", "v",
"count"}, Adafactor's {"stats": {…: {"vr", "vc"} or {"v"}}, "count"},
``count`` a 0-d int32 tensor.  ``state_axes`` names a state's logical
axes from the parameters' (``lm.param_axes``), as the reference's does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from ..sharding.rules import parse_axes
from . import tree as T

# leaves bigger than this are updated slice by slice along axis 0
_CHUNK_UPDATE_ELEMS = 32 * 1024 * 1024


# ---------------------------------------------------------------------------
# schedules / clipping
# ---------------------------------------------------------------------------


def warmup_cosine(base_lr: float, warmup: int, total: int,
                  final_frac: float = 0.1) -> Callable:
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, base_lr * cos)
    return lr


def global_norm(grads) -> torch.Tensor:
    """sqrt(Σ over leaves of Σ g²), each leaf's sum in f32, the leaves
    added in order."""
    total = None
    for g in T.leaves(grads):
        s = torch.sum(g.to(torch.float32, copy=True).square_())
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """Scales ``grads`` in place by min(1, max_norm / max(norm, 1e-9)),
    cast to each leaf's dtype; returns (grads, norm)."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for g in T.leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads, gn


def _slices(p: torch.Tensor):
    """Views of ``p`` along axis 0 of at most _CHUNK_UPDATE_ELEMS elements
    each (a whole row when one row is larger); ``p`` itself when it is
    small."""
    if p.numel() <= _CHUNK_UPDATE_ELEMS or p.dim() == 0:
        return [slice(None)]
    rows = max(1, _CHUNK_UPDATE_ELEMS // max(1, p[0].numel()))
    return [slice(i, i + rows) for i in range(0, p.shape[0], rows)]


def _mean(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """The mean as XLA takes ``jnp.mean``: the sum times 1/n, which can
    round otherwise than the sum over n."""
    if dim is None:
        return x.sum() * (1.0 / x.numel())
    return x.sum(dim, keepdim=keepdim) * (1.0 / x.shape[dim])


def _zeros_like(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _count(params) -> torch.Tensor:
    leaf = T.leaves(params)[0]
    return torch.zeros((), dtype=torch.int32, device=leaf.device)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip: float = 1.0

    def init(self, params):
        return {"m": T.tree_map(_zeros_like, params),
                "v": T.tree_map(_zeros_like, params),
                "count": _count(params)}

    def state_axes(self, param_axes):
        return {"m": param_axes, "v": param_axes, "count": ""}

    def update(self, grads, state, params):
        grads, gn = clip_by_global_norm(grads, self.clip)
        c = state["count"] + 1
        cf = c.to(torch.float32)
        bc1 = 1 - torch.pow(self.b1, cf)
        bc2 = 1 - torch.pow(self.b2, cf)
        lr = self.lr(c)

        def upd(g, m, v, p):
            # the reference's products and sums, each rounded once, on as
            # few temporaries as the order allows
            g = g.float()
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_(torch.square(g).mul_(1 - self.b2))
            step = torch.div(m, bc1).div_((v / bc2).sqrt_().add_(self.eps))
            step.add_(self.weight_decay * p)
            p.sub_(step.mul_(lr))

        for (path, g) in T.items(grads):
            m, v, p = (T.get(t, path) for t in (state["m"], state["v"],
                                                 params))
            for sl in _slices(p):
                upd(g[sl], m[sl], v[sl], p[sl])
        state["count"] = c
        return params, state, {"grad_norm": gn, "lr": lr}


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern 2018), beta1=0 variant
# ---------------------------------------------------------------------------


def _factored(shape) -> bool:
    return len(shape) >= 2


@dataclasses.dataclass(frozen=True)
class Adafactor:
    lr: Callable
    decay: float = 0.8          # \\hat{beta2}_t = 1 - t^-decay
    eps: float = 1e-30
    clip_update: float = 1.0    # update RMS clip (d in the paper)
    weight_decay: float = 0.0
    clip: float = 1.0

    def init(self, params):
        def one(p):
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32,
                                          device=p.device)}
            return {"v": _zeros_like(p)}
        return {"stats": T.tree_map(one, params), "count": _count(params)}

    def state_axes(self, param_axes):
        def one(ax):
            axes = parse_axes(ax)
            if len(axes) >= 2:
                def j(t):
                    return " ".join("." if a is None else a for a in t)
                return {"vr": j(axes[:-1]), "vc": j(axes[:-2] + axes[-1:])}
            return {"v": ax}
        return {"stats": T.tree_map(one, param_axes), "count": ""}

    def update(self, grads, state, params):
        grads, gn = clip_by_global_norm(grads, self.clip)
        c = state["count"] + 1
        cf = c.to(torch.float32)
        beta2 = 1.0 - cf ** (-self.decay)
        lr = self.lr(c)

        def stats(g, s):
            """The new second-moment stats of slice g (written into s)
            and the slice's update direction before the RMS clip."""
            g = g.float()
            g2 = torch.square(g) + self.eps
            if "vr" in s:
                s["vr"].copy_(beta2 * s["vr"] + (1 - beta2) * _mean(g2, -1))
                s["vc"].copy_(beta2 * s["vc"] + (1 - beta2) * _mean(g2, -2))
                return direction(g, s)
            s["v"].copy_(beta2 * s["v"] + (1 - beta2) * g2)
            return direction(g, s)

        def direction(g, s):
            if "vr" in s:
                vr, vc = s["vr"], s["vc"]
                denom = torch.clamp(_mean(vr, -1, keepdim=True), min=1e-30)
                vr_hat = vr / denom
                return g * torch.rsqrt(vr_hat)[..., None] \
                    * torch.rsqrt(vc)[..., None, :]
            return g * torch.rsqrt(s["v"])

        for (path, g) in T.items(grads):
            s, p = T.get(state["stats"], path), T.get(params, path)
            # the factored stats reduce over the last two axes: a 2-D
            # leaf is one slice
            sls = _slices(p) if p.dim() >= 3 else [slice(None)]
            views = [(g[sl], {k: t[sl] for k, t in s.items()}, p[sl])
                     for sl in sls]
            if len(views) == 1:
                u = stats(views[0][0], views[0][1])
                rms = torch.sqrt(_mean(torch.square(u)) + 1e-30)
                self._apply(u, p, rms, lr)
                continue
            sq = None
            for gs, ss, _ in views:
                part = torch.sum(torch.square(stats(gs, ss)))
                sq = part if sq is None else sq + part
            rms = torch.sqrt(sq * (1.0 / p.numel()) + 1e-30)
            for gs, ss, ps in views:
                self._apply(direction(gs.float(), ss), ps, rms, lr)
        state["count"] = c
        return params, state, {"grad_norm": gn, "lr": lr}

    def _apply(self, u, p, rms, lr):
        u = u / torch.clamp(rms / self.clip_update, min=1.0)
        u = u + self.weight_decay * p.float()
        p.copy_(p.float() - lr * u)


def make_optimizer(name: str, lr_fn: Callable, **kw):
    if name == "adamw":
        return AdamW(lr=lr_fn, **kw)
    if name == "adafactor":
        return Adafactor(lr=lr_fn, **kw)
    raise ValueError(name)

