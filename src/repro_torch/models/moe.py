"""Mixture-of-Experts with scatter/gather capacity dispatch.

The JAX package's ``models/moe.py`` in PyTorch.  Paper tie-in: the
token→expert assignment is a sparse bipartite graph; dispatch and combine
are the graph processor's Dispatch Logic (scatter) and Output Logic
(gather), and the router's balance loss is its cluster load-balancing
criterion.  Tokens are routed in fixed-size *groups* (``moe_group_size``),
the clustering granularity.

Within a group each (token, choice) pair gets a slot ``expert · C +
position`` (the reference's per-group (E·C + 1, d) capacity buffer),
positions taken in GShard priority (every token's first choice, then every
second choice, and so on); a pair past its expert's capacity C goes to the
sink slot E·C, which the gather reads as zero.  The port lays the buffer
out expert-major over all groups, row (expert, group, position), with one
sink row, so the expert products read it in place: the same rows in
another order.  The choices match the reference's bit for bit:

- top-k over the f32 softmax gates, descending, equal gates taking the
  lower expert first as ``lax.top_k`` does: a stable sort, since
  ``torch.topk`` leaves the order of ties unspecified (on the CPU it does
  not take the lower index first);
- positions by an integer cumsum over the choice-major flattening, equal
  to the reference's f32 cumsum of one-hot rows (exact below 2^24);
- kept slots are distinct, so the dispatch is a copy (``index_copy_``;
  which dropped pair lands last in the sink does not matter).

The expert products are plain batched matmuls, as the reference's einsums
are plain XLA products outside any Pallas kernel: this module launches no
hand-written kernel.

Remainder quirk, kept from the reference: when B·S is not a multiple of
the group size, the trailing tokens' MoE output *is their input* (so the
block adds x + h2 there), and they take no part in routing or the aux
losses.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from . import layers


class Experts(nn.Module):
    """wi, wg (E, d, ff) and wo (E, ff, d) in the compute dtype (wg for
    SwiGLU only)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        e, d, ff = cfg.num_experts, cfg.d_model, cfg.d_ff
        self.wi = layers._weight((e, d, ff), cfg, device)
        if cfg.mlp_kind == "swiglu":
            self.wg = layers._weight((e, d, ff), cfg, device)
        self.wo = layers._weight((e, ff, d), cfg, device)


class MoE(nn.Module):
    """router (d, E) in f32 always, the expert bank, and a shared
    ``layers.MLP`` when ``cfg.shared_expert``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.router = nn.Parameter(
            torch.empty((cfg.d_model, cfg.num_experts), dtype=torch.float32,
                        device=device), requires_grad=False)
        self.experts = Experts(cfg, device)
        if cfg.shared_expert:
            self.shared = layers.MLP(cfg, device=device)


moe_init = MoE


@dataclasses.dataclass
class Routes:
    """One call's routing, per group: logits and gates (G, S, E) f32; topw
    (G, S, K) f32, renormalised; topi, pos and slot (G, S, K) int64; keep
    (G, S, K) bool; cap, the capacity C."""
    logits: torch.Tensor
    gates: torch.Tensor
    topw: torch.Tensor
    topi: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    cap: int


def capacity(cfg: ModelConfig, gs: int, dropless: bool) -> int:
    """Slots per expert and group, in Python float arithmetic as the
    reference (``gs`` when dropless)."""
    if dropless:
        return gs
    return int(max(1, gs * cfg.top_k * cfg.capacity_factor
                   / cfg.num_experts))


def router(cfg: ModelConfig, p: MoE, xt: torch.Tensor,
           dropless: bool = False) -> Routes:
    """Route the grouped tokens xt (G, gs, d): gates, top-k, GShard
    positions and slots."""
    ng, gs, _ = xt.shape
    e, k = cfg.num_experts, cfg.top_k
    logits = xt.float() @ p.router
    gates = torch.softmax(logits, dim=-1)
    topw, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
    topw, topi = topw[..., :k], topi[..., :k]
    topw = topw / topw.sum(-1, keepdim=True).clamp_min(1e-9)
    cap = capacity(cfg, gs, dropless)
    # priority: all first choices of the group, then all second choices...
    flat = topi.transpose(1, 2).reshape(ng, k * gs)
    oh = F.one_hot(flat, e)                               # (G, K*S, E)
    before = oh.cumsum(dim=1) - oh                        # exclusive
    pos = before.gather(2, flat[..., None])[..., 0]
    pos = pos.reshape(ng, k, gs).transpose(1, 2)          # (G, S, K)
    keep = pos < cap
    slot = torch.where(keep, topi * cap + pos, e * cap)
    return Routes(logits, gates, topw, topi, pos, keep, slot, cap)


def _expert_ffn(cfg: ModelConfig, p: Experts, x: torch.Tensor):
    """x (E, N, d) → (E, N, d): one batched product per leaf, E the
    batch."""
    h = torch.bmm(x, p.wi.to(x.dtype))
    if cfg.mlp_kind == "swiglu":
        h = F.silu(torch.bmm(x, p.wg.to(x.dtype))) * h
    elif cfg.mlp_kind == "squared_relu":
        h = torch.relu(h).square()
    else:  # gelu, tanh-approximated as jax.nn.gelu's default
        h = F.gelu(h, approximate="tanh")
    return torch.bmm(h, p.wo.to(x.dtype))


def moe_apply(cfg: ModelConfig, p: MoE, x: torch.Tensor,
              dropless: bool = False) -> Tuple[torch.Tensor, Dict]:
    """x (B, S, d) → (out (B, S, d), aux): ``aux_loss`` (balance + z-loss),
    ``frac_dropped`` and ``expert_load``, as the reference's.  Past an
    expert's capacity a (token, choice) pair is dropped; ``dropless``
    sizes the capacity to the group (the decode path)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    cd = x.dtype   # the compute dtype, as everywhere in the port's model
    gs = min(cfg.moe_group_size, b * s)
    tokens = x.reshape(-1, d)
    ng = tokens.shape[0] // gs
    xt = tokens[: ng * gs].reshape(ng, gs, d)
    r = router(cfg, p, xt, dropless)

    # Dispatch Logic: each kept pair's token into its slot.  The buffer
    # is expert-major, row (expert, group, position), so the expert
    # products read it in place; every dropped pair goes to the one sink
    # row at the end.
    cap = r.cap
    sink = e * ng * cap
    group = torch.arange(ng, device=x.device)[:, None, None]
    dest = torch.where(r.keep, (r.topi * ng + group) * cap + r.pos, sink)
    dest = dest.reshape(-1)
    src = xt[:, :, None, :].expand(ng, gs, k, d).reshape(-1, d)
    buf = src.new_zeros((sink + 1, d), dtype=cd)   # a DTensor on a mesh
    buf.index_copy_(0, dest, src)
    xout = _expert_ffn(cfg, p.experts, buf[:-1].view(e, ng * cap, d))

    # Output Logic: the weighted expert outputs gathered back, the sink
    # row zero
    out_buf = torch.cat([xout.reshape(-1, d), xout.new_zeros((1, d))])
    y = out_buf[dest].reshape(ng, gs, k, d)
    out = (y * r.topw[..., None].to(y.dtype)).sum(dim=2)  # (G, gs, d)

    if cfg.shared_expert:
        out = out + layers.mlp_apply(cfg, p.shared, xt)

    out_flat = out.reshape(-1, d)
    if out_flat.shape[0] < tokens.shape[0]:               # the remainder
        out_flat = torch.cat(
            [out_flat, tokens[out_flat.shape[0]:].to(out_flat.dtype)])
    out = out_flat.reshape(b, s, d)

    # load balance (the cluster balance objective) + router z-loss
    # (the counts' means as XLA takes them: the sum times 1/n, which can
    # round otherwise than the sum over n)
    me = r.gates.mean(dim=(0, 1))
    ce = F.one_hot(r.topi[..., 0], e).float().sum(dim=(0, 1)) \
        * (1.0 / (ng * gs))
    aux = cfg.router_aux_coef * e * (me * ce).sum()
    z = cfg.router_z_coef * torch.logsumexp(r.logits, -1).square().mean()
    frac_dropped = 1.0 - r.keep.float().sum() * (1.0 / r.keep.numel())
    return out, {"aux_loss": aux + z, "frac_dropped": frac_dropped,
                 "expert_load": ce}


def fill(cfg: ModelConfig, p: MoE, draw) -> None:
    """The leaves with the reference's ``moe_init`` fan-ins, through
    ``draw(w, fan_in)``: an expert bank one expert at a time, so the f32
    temporary is one expert's, not the bank's."""
    d, ff = cfg.d_model, cfg.d_ff
    banks = [(p.experts.wi, d), (p.experts.wo, ff)]
    if cfg.mlp_kind == "swiglu":
        banks.insert(1, (p.experts.wg, d))
    for w, fan_in in banks:
        for i in range(w.shape[0]):
            draw(w[i], fan_in)
    draw(p.router, d)
    shared: Optional[layers.MLP] = getattr(p, "shared", None)
    if shared is not None:
        draw(shared.wi, d)
        if cfg.mlp_kind == "swiglu":
            draw(shared.wg, d)
        draw(shared.wo, ff)
