"""RWKV-6 "Finch" block: an attention-free linear RNN with data-dependent
decay (token-shift ddlerp projections, per-channel decay from a low-rank
MLP, a multi-head matrix-valued state).

The JAX package's ``models/rwkv.py`` in PyTorch.  The recurrence goes
through ``ops.wkv6``, which on the card launches the hand-written WKV6
kernel, in prefill and at every decode step; the JAX package runs the
same recurrence as ``_wkv_scan`` in XLA.

The WKV state is f32.  The JAX model casts it to the compute dtype
before its scan (``state.astype(cd)``; its decode step passes
``c["wkv"].astype(h.dtype)``), so in bf16 it rounds the state at every
step; the Pallas kernel, and the port after it, keep the state in f32.
The two therefore agree in f32 compute and not, to any useful tolerance,
in bf16.

Dtypes.  Matrices are held in the compute dtype, as everywhere in the
port, except ``dec_b``: the reference multiplies by its f32 master, so
the port holds it in f32.  ``mu``, ``w0``, ``u``, ``ln_x`` and ``mu_c``
are f32 leaves in the reference and here.  Everything is cast to the
dtype of the activations where the reference casts it to the compute
dtype: ``w = exp(-exp(dec))`` and ``u`` reach the recurrence rounded to
that dtype, as they reach the reference's scan (u is rounded once per
dtype and held in f32, the kernel's type: ``RWKV.u_rounded``).

State per layer: {"wkv": (B, H, hs, hs), "tm_x": (B, D), "cm_x": (B, D)},
all f32; the token-shift states hold the last *normed* input token of
the time-mix and channel-mix halves.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..kernels import ops
from . import layers


def _const(shape, value: float, device) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, value, dtype=torch.float32,
                                   device=device), requires_grad=False)


class RWKV(nn.Module):
    """The 17 leaves of the JAX package's ``rwkv_init``, with its
    constants (mu 0.5, w0 -6, u 0, ln_x 1, mu_c 0.5); the matrices are
    uninitialised until ``lm.init`` or ``convert.params_from_jax`` fills
    them."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, hs, ff = cfg.d_model, cfg.rwkv_head_size, cfg.d_ff
        r, dr = cfg.ddlerp_rank, cfg.decay_rank

        def mat(*shape):
            return layers._weight(shape, cfg, device)

        self.mu = _const((5, d), 0.5, device)          # r, k, v, w, g
        self.ddl_a = mat(d, 5 * r)
        self.ddl_b = mat(5, r, d)
        self.wr, self.wk, self.wv = mat(d, d), mat(d, d), mat(d, d)
        self.wg, self.wo = mat(d, d), mat(d, d)
        self.w0 = _const((d,), -6.0, device)
        self.dec_a = mat(d, dr)
        self.dec_b = nn.Parameter(torch.empty(            # used in f32
            (dr, d), dtype=torch.float32, device=device), requires_grad=False)
        self.u = _const((d // hs, hs), 0.0, device)
        self.ln_x = _const((d,), 1.0, device)
        self.mu_c = _const((2, d), 0.5, device)        # k, r
        self.ck, self.cr, self.cv = mat(d, ff), mat(d, d), mat(ff, d)
        self._u_held = {}                              # u_rounded

    def u_rounded(self, dtype) -> torch.Tensor:
        """u rounded to ``dtype``, as the reference casts it before its
        scan, held in f32 for the kernel.  Made once for each dtype and
        value of u (an in-place change or a move makes it anew), so a
        decode step launches no cast for it."""
        key = (self.u.data_ptr(), self.u._version)
        held = self._u_held.get(dtype)
        if held is None or held[0] != key:
            held = self._u_held[dtype] = (key, self.u.to(dtype).float())
        return held[1]


def _shift(x, x_prev_last):
    """(B, S, D) → the previous token of each position: x_prev_last, then
    x[:, :-1]."""
    return torch.cat([x_prev_last[:, None, :].to(x.dtype), x[:, :-1]], 1)


def _ddlerp(p: RWKV, x, x_prev):
    """RWKV6 data-dependent token-shift: 5 interpolated views of (x, x-1),
    stacked (5, B, S, D)."""
    cd = x.dtype
    dx = x_prev - x
    base = x + dx * p.mu.to(cd)[:, None, None, :]
    lora = torch.tanh(dx @ p.ddl_a.to(cd))                 # (B, S, 5r)
    b, s, _ = x.shape
    r = p.ddl_b.shape[1]
    lora = lora.reshape(b, s, 5, r).permute(2, 0, 1, 3)     # (5, B, S, r)
    adj = lora @ p.ddl_b.to(cd)[:, None]                    # (5, B, S, D)
    return base + adj * dx[None]


def rwkv_time_mix(cfg: ModelConfig, p: RWKV, x, state, x_prev_last):
    """x (B, S, D); state (B, H, hs, hs) f32, updated in place by the
    recurrence; x_prev_last (B, D), the last token of the previous chunk.
    Returns (out, state, x's last token)."""
    b, s, d = x.shape
    hs = cfg.rwkv_head_size
    h = d // hs
    cd = x.dtype
    xr, xk, xv, xw, xg = _ddlerp(p, x, _shift(x, x_prev_last))
    r = (xr @ p.wr.to(cd)).view(b, s, h, hs)
    k = (xk @ p.wk.to(cd)).view(b, s, h, hs)
    v = (xv @ p.wv.to(cd)).view(b, s, h, hs)
    g = F.silu(xg @ p.wg.to(cd))
    dec = p.w0 + torch.tanh(xw @ p.dec_a.to(cd)).float() @ p.dec_b
    w = torch.exp(-torch.exp(dec)).to(cd).view(b, s, h, hs)
    y = ops.wkv6(r, k, v, w, p.u_rounded(cd), state)
    # per-head group norm, in f32
    yf = y.float()
    mu = yf.mean(-1, keepdim=True)
    var = (yf - mu).square().mean(-1, keepdim=True)
    yn = ((yf - mu) * torch.rsqrt(var + 1e-5)).reshape(b, s, d) * p.ln_x
    out = (yn.to(cd) * g) @ p.wo.to(cd)
    return out, state, x[:, -1, :]


def rwkv_channel_mix(cfg: ModelConfig, p: RWKV, x, x_prev_last):
    cd = x.dtype
    dx = _shift(x, x_prev_last) - x
    mu = p.mu_c.to(cd)
    xk = x + dx * mu[0]
    xr = x + dx * mu[1]
    kk = torch.relu(xk @ p.ck.to(cd)).square()
    rr = torch.sigmoid(xr @ p.cr.to(cd))
    return rr * (kk @ p.cv.to(cd)), x[:, -1, :]


def rwkv_block_apply(cfg: ModelConfig, p: RWKV, x, state) -> Tuple:
    """The time-mix half in chunk mode: returns (out, state dict) with
    the wkv state updated in place and tm_x replaced.  The caller
    (``lm._rwkv_block``) handles the pre-norms, the residuals and the
    channel-mix half."""
    tm_out, wkv, tm_x = rwkv_time_mix(cfg, p, x, state["wkv"],
                                      state["tm_x"])
    return tm_out, {"wkv": wkv, "tm_x": tm_x, "cm_x": state["cm_x"]}


def rwkv_state_init(cfg: ModelConfig, batch: int, device=None):
    """The zero state, all f32 whatever the compute dtype."""
    dtype = torch.float32
    d = cfg.d_model
    hs = cfg.rwkv_head_size
    h = d // hs
    return {"wkv": torch.zeros((batch, h, hs, hs), dtype=dtype,
                               device=device),
            "tm_x": torch.zeros((batch, d), dtype=dtype, device=device),
            "cm_x": torch.zeros((batch, d), dtype=dtype, device=device)}


def rwkv_state_axes():
    return {"wkv": "batch heads head_dim head_dim",
            "tm_x": "batch .", "cm_x": "batch ."}
