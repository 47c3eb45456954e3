"""Griffin / RecurrentGemma recurrent block: gated linear branch ×
(conv1d → RG-LRU) branch.

The JAX package's ``models/griffin.py`` in PyTorch.

RG-LRU: r_t = σ(Wr x_t), i_t = σ(Wi x_t), a_t = a^(c·r_t) with
a = σ(Λ) learnable, c = 8;  h_t = a_t ⊙ h_{t-1} + √(1−a_t²) ⊙ (i_t ⊙ x_t).

State per recurrent layer: h (B, lru_dim) + conv tap history
(B, conv_width−1, lru_dim), both f32 in the cache.

Arithmetic as the reference's: r, i, log a, β and the scan in f32, the
scan's output cast to the compute dtype; the depthwise conv summed tap by
tap in the compute dtype, oldest tap first.  Serving runs the time scan
as a plain loop over t, one ``addcmul`` launch a step on the card (the
reference runs it as ``lax.scan``, outside any Pallas kernel); training
(``train=True``) runs it through ``ops.rg_lru_scan``, an autograd
Function whose forward and backward are hand-written kernels
(``kernels/csrc/rg_lru.cu``).  The reference's ``_TIME_CHUNK``
rematerialisation changes no value and has no counterpart here.

Dtypes.  The matrices (``w_x``, ``w_y``, ``conv_w``, ``wr``, ``wi``,
``w_out``) are held in the compute dtype, as everywhere in the port;
``conv_b`` and ``lam`` are f32 leaves, as in the reference, which casts
``conv_b`` to the compute dtype at use and uses ``lam`` in f32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..kernels import cost, ops
from . import layers

_C = 8.0


class Recurrent(nn.Module):
    """The 8 leaves of the JAX package's ``recurrent_init``, with its
    constants (``conv_b`` 0, ``lam`` log(expm1(4)), so a = σ(Λ) ≈ .98);
    the matrices are uninitialised until ``lm.init`` or
    ``convert.params_from_jax`` fills them."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, ld = cfg.d_model, cfg.lru_dim

        def mat(*shape):
            return layers._weight(shape, cfg, device)

        def vec(value):
            return nn.Parameter(torch.full((ld,), value, dtype=torch.float32,
                                           device=device),
                                requires_grad=False)

        self.w_x, self.w_y = mat(d, ld), mat(d, ld)
        self.conv_w = mat(cfg.conv_width, ld)
        self.conv_b = vec(0.0)
        self.wr, self.wi = mat(ld, ld), mat(ld, ld)
        self.lam = vec(math.log(math.expm1(4.0)))
        self.w_out = mat(ld, d)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` = logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))
    for every x (torch's ``softplus`` returns x itself above 20)."""
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


def _lru_terms(p: Recurrent, x):
    """a_t and the gated input g_t of h_t = a_t·h_{t−1} + g_t, (B, S, ld)
    f32, from x (B, S, ld) post-conv in the compute dtype."""
    cd = x.dtype
    r = torch.sigmoid((x @ p.wr.to(cd)).float())
    i = torch.sigmoid((x @ p.wi.to(cd)).float())
    log_a_base = -_softplus(-p.lam)                   # log σ(Λ)
    log_a = _C * r * log_a_base                       # (B, S, ld)
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9))
    return a, (i * x.float()) * beta


def _rg_lru(p: Recurrent, x, h0, train: bool = False):
    """x: (B, S, ld) post-conv, compute dtype; h0: (B, ld).  Returns
    (y (B, S, ld) in x's dtype, h_last (B, ld) f32).  ``train``: the scan
    through ``ops.rg_lru_scan``, differentiable (its kernels on the card);
    else the step loop."""
    cd = x.dtype
    a, gated = _lru_terms(p, x)
    if train:
        h_all, h = ops.rg_lru_scan(a, gated, h0.float())
        return h_all.to(cd), h
    if type(a).__name__ == "DTensor":   # a mesh's: the loop shard by shard
        ys, h = ops.per_shard(_step_loop, (a, gated, h0.float()),
                              ((0, 2), (0, 2), (0, 1)), ((0, 2), (0, 1)))
    else:
        ys, h = _step_loop(a, gated, h0.float())
    return ys.to(cd), h


def _step_loop(a, gated, h):
    """h_t = a_t·h_{t−1} + g_t, one ``addcmul`` a step; returns (every
    step's h (B, S, ld), h_last).  On meta (the dry run) the loop's
    outputs are made and its work noted (``kernels/cost.py``), not traced
    step by step."""
    if a.device.type == "meta":
        b, s, ld = a.shape
        cost.note("rg_lru_loop", cost.rg_lru_ops(b, s, ld),
                  cost.rg_lru_bytes(b, s, ld))
        return torch.empty_like(a), torch.empty_like(h)
    # time-major, so each step reads and writes contiguous (B, ld) rows
    a_t = a.transpose(0, 1).contiguous()
    g_t = gated.transpose(0, 1).contiguous()
    ys = torch.empty_like(a_t)
    for t in range(a_t.shape[0]):
        h = torch.addcmul(g_t[t], a_t[t], h, out=ys[t])  # a_t·h + g_t
    return ys.transpose(0, 1), h


def _causal_conv(p: Recurrent, x, taps):
    """Width-W depthwise causal conv in x's dtype.  taps: (B, W-1, ld)
    history.  Returns (out, the new taps in x's dtype)."""
    cd = x.dtype
    w = p.conv_w.to(cd)                               # (W, ld)
    full = torch.cat([taps.to(cd), x], dim=1)
    width, s = w.shape[0], x.shape[1]
    out = full[:, 0:s] * w[width - 1]
    for i in range(1, width):
        out = out + full[:, i:i + s] * w[width - 1 - i]
    return out + p.conv_b.to(cd), full[:, s:]


def recurrent_apply(cfg: ModelConfig, p: Recurrent, x, state,
                    train: bool = False):
    """x: (B, S, D); state {"h": (B, ld), "conv": (B, W-1, ld)}.  Returns
    (out (B, S, D), {"h": f32, "conv": in x's dtype}); ``state`` is not
    written.  ``train``: the RG-LRU through its differentiable scan."""
    cd = x.dtype
    xr = x @ p.w_x.to(cd)
    gate = F.gelu(x @ p.w_y.to(cd), approximate="tanh")
    xc, conv_taps = _causal_conv(p, xr, state["conv"])
    y, h_last = _rg_lru(p, xc, state["h"], train)
    out = (y * gate) @ p.w_out.to(cd)
    return out, {"h": h_last, "conv": conv_taps}


def recurrent_state_init(cfg: ModelConfig, batch: int, device=None,
                         dtype=torch.float32):
    return {"h": torch.zeros((batch, cfg.lru_dim), dtype=dtype,
                             device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.lru_dim),
                                dtype=dtype, device=device)}


def recurrent_state_axes():
    return {"h": "batch mlp", "conv": "batch . mlp"}
