"""Transformer building blocks: norms, RoPE, GQA attention, MLA, MLPs.

The JAX package's ``models/layers.py`` in PyTorch, for the dense GQA
families and MLA (minicpm3-4b).  Each block is an ``nn.Module`` that
holds its parameters; the functions keep the JAX package's names and take
the module as ``p``.

Weights.  The JAX package keeps f32 master weights and casts each one to
``cfg.compute_dtype`` at every use.  Serving needs no master copy, so the
port holds every matrix in the compute dtype, cast once at load: the same
operands at half the bytes in bf16.  Norm scales (and MLA's ``q_norm``
and ``kv_norm``) stay f32, as the norms use them.

The local (ring-buffer) attention block's prefill and decode live in
``lm.py``, as in the JAX package, on ``_self_attend`` and
``_decode_attend_local`` from here.  Cross-attention (``attn_apply`` with
``kv_src``, ``cross_attn_kv``, ``cross_attn_decode``) projects K/V from
the encoder's or the image stub's states and applies no RoPE; its scores
run the plain attention wherever the prompt's length differs from the
source's, as the JAX package's ``ops`` sends them to XLA.

Flash-decoding across a mesh (``_decode_attend_flash``): with a mesh in
force (``sharding.rules.use_mesh``) whose "model" axis divides a cache
of at least 4,096 rows, a decode step attends shard by shard over the
cache's local rows and combines the partials with an all-reduce max and
two all-reduce sums, as the reference does, so no shard gathers the
cache; the new K/V row is written by the shard that holds it.  One card
has no mesh and never takes this path.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..kernels import ops


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def _weight(shape, cfg: ModelConfig, device) -> nn.Parameter:
    """An uninitialised matrix in the compute dtype; ``lm.init`` or
    ``convert.params_from_jax`` fills it."""
    return nn.Parameter(torch.empty(shape, dtype=dtype_of(cfg.compute_dtype),
                                    device=device), requires_grad=False)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


class Norm(nn.Module):
    def __init__(self, cfg: ModelConfig, d: Optional[int] = None,
                 device=None):
        super().__init__()
        d = d or cfg.d_model
        self.scale = nn.Parameter(
            torch.ones((d,), dtype=torch.float32, device=device),
            requires_grad=False)
        if cfg.norm == "layernorm":
            self.bias = nn.Parameter(
                torch.zeros((d,), dtype=torch.float32, device=device),
                requires_grad=False)


norm_init = Norm


def norm_apply(cfg: ModelConfig, p: Norm, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-5) * p.scale + p.bias
    else:
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + 1e-6) * p.scale
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (full / partial-fraction "2d")
# ---------------------------------------------------------------------------


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               fraction: float = 1.0) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S).  Rotates the first
    ``fraction`` of D (chatglm-style 2d/partial rotary when < 1)."""
    d = x.shape[-1]
    rot = int(d * fraction) // 2 * 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    half = rot // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs  # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = xr[..., :half], xr[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out, xp], dim=-1) if rot < d else out


# ---------------------------------------------------------------------------
# GQA self-attention
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    """wq (d, H, hd), wk/wv (d, KV, hd), wo (H, hd, d): the JAX layout."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim)
        self.wq = _weight((d, h, hd), cfg, device)
        self.wk = _weight((d, kv, hd), cfg, device)
        self.wv = _weight((d, kv, hd), cfg, device)
        self.wo = _weight((h, hd, d), cfg, device)


attn_init = Attention


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk", x, w) as one matmul."""
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).unflatten(-1, (h, k))


def _out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd", o, wo.astype(o.dtype)) as one matmul."""
    h, k, d = wo.shape
    return o.flatten(-2) @ wo.to(o.dtype).reshape(h * k, d)


def _qkv(cfg, p: Attention, x, positions):
    q, k, v = _proj(x, p.wq), _proj(x, p.wk), _proj(x, p.wv)
    if cfg.pos_embedding == "rope":
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
        kpos = torch.arange(k.shape[1], device=x.device)[None].expand(
            k.shape[:2])
        k = apply_rope(k, kpos, cfg.rope_theta, cfg.rope_fraction)
    return q, k, v


def _self_attend(cfg, p: Attention, x, positions, window, causal=True):
    q, k, v = _qkv(cfg, p, x, positions)
    o = ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2), causal=causal, window=window)
    return _out(o.transpose(1, 2), p.wo), k, v


def _cross_attend(p: Attention, x, kv):
    """x's queries against the K/V of ``cross_attn_kv``, unmasked: the
    flash kernel on the card where the prompt is as long as the source,
    the plain attention elsewhere (``ops.attention``)."""
    q = _proj(x, p.wq)
    o = ops.attention(q.transpose(1, 2), kv["k"].transpose(1, 2),
                      kv["v"].transpose(1, 2), causal=False)
    return _out(o.transpose(1, 2), p.wo)


def attn_apply(cfg: ModelConfig, p: Attention, x, *, positions,
               window=None, causal=True, kv_src=None):
    """Full-sequence attention (train / prefill).  ``kv_src`` (B, Skv, d)
    given: cross-attention over it, no RoPE and no mask, whatever
    ``causal`` says, as in the JAX package (no caller gives it a
    window)."""
    if kv_src is None:
        return _self_attend(cfg, p, x, positions, window, causal)[0]
    return _cross_attend(p, x, cross_attn_kv(cfg, p, kv_src))


def attn_prefill(cfg: ModelConfig, p: Attention, x, *, positions, cache,
                 window=None):
    """Prefill: writes K/V into the first S rows of ``cache`` (tensors
    (B, cache_len, KV, hd), zero beyond: the JAX package's padded cache)
    and returns (out, cache)."""
    out, k, v = _self_attend(cfg, p, x, positions, window)
    for name, t in (("k", k), ("v", v)):
        if t.shape[1] == cache[name].shape[1]:
            cache[name].copy_(t)      # no slice: a DTensor's split time dim
        else:
            cache[name][:, :t.shape[1]] = t
    return out, cache


def attn_decode(cfg: ModelConfig, p: Attention, x, cache, *, pos,
                window=None):
    """One-token decode against a (B, S_max, KV, hd) cache.  ``pos`` is the
    index of the new token, (B,) or scalar.  Writes the new K/V into
    ``cache`` in place and returns (out, cache)."""
    b = x.shape[0]
    pos_arr = torch.as_tensor(pos, device=x.device).expand(b)
    q, k_new, v_new = _proj(x, p.wq), _proj(x, p.wk), _proj(x, p.wv)
    if cfg.pos_embedding == "rope":
        q = apply_rope(q, pos_arr[:, None], cfg.rope_theta,
                       cfg.rope_fraction)
        k_new = apply_rope(k_new, pos_arr[:, None], cfg.rope_theta,
                           cfg.rope_fraction)
    _scatter_time(cache["k"], k_new, pos_arr)
    _scatter_time(cache["v"], v_new, pos_arr)
    o = _decode_attend(cfg, q, cache["k"], cache["v"], pos_arr, window)
    return _out(o, p.wo), cache


def _scatter_time(cache: torch.Tensor, new: torch.Tensor,
                  pos: torch.Tensor) -> None:
    """cache (B, S, ...) ← new (B, 1, ...) at per-batch pos, in place.

    The JAX package rewrites the whole cache through a one-hot,
    ``cache * (1 - onehot) + onehot * new``, which for finite values is
    the cache with row pos replaced by new: the same values.  A position
    at or past S writes nothing there, and nothing here either."""
    seq = _seq_shards(cache)
    if seq is not None:
        return _scatter_time_sharded(cache, new, pos, *seq)
    b, s = cache.shape[:2]
    rows = torch.arange(b, device=cache.device)
    idx = pos.clamp(max=s - 1)
    keep = (pos >= s).view((b,) + (1,) * (cache.dim() - 2))
    cache[rows, idx] = torch.where(keep, cache[rows, idx],
                                   new[:, 0].to(cache.dtype))


def _seq_shards(k):
    """(mesh, the mesh axes that split k's time dim 1, shard count) when a
    mesh is in force with a "model" axis, k is a DTensor and its time
    dim is split as flash-decoding needs (``_decode_attend``'s rule);
    else None."""
    from ..sharding.rules import _current_mesh, mesh_shape
    mesh = _current_mesh()
    if mesh is None or "model" not in mesh_shape(mesh):
        return None
    from torch.distributed.tensor import DTensor, Shard
    s_len = k.shape[1]
    if not isinstance(k, DTensor) or s_len % mesh_shape(mesh)["model"] \
            or s_len < 4096:
        return None
    axes = tuple(n for n, pl in zip(mesh.mesh_dim_names, k.placements)
                 if isinstance(pl, Shard) and pl.dim == 1)
    if not axes:
        return None
    n = 1
    for ax in axes:
        n *= mesh_shape(mesh)[ax]
    return mesh, axes, n


def _shard_base(mesh, axes, chunk):
    """The global time of this rank's first local cache row."""
    idx = 0
    for ax in axes:
        idx = idx * mesh.size(mesh.mesh_dim_names.index(ax)) + \
            mesh.get_local_rank(ax)
    return idx * chunk


def _scatter_time_sharded(cache, new, pos, mesh, axes, n) -> None:
    """``_scatter_time`` on a cache whose time dim is split over ``axes``:
    each shard writes the rows that fall in its chunk, nothing moves."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    chunk = cache.shape[1] // n
    batch_pl = tuple(pl if n_ not in axes else Replicate()
                     for n_, pl in zip(mesh.mesh_dim_names,
                                       cache.placements))

    def write(cl, nl, pl):
        at = pl - _shard_base(mesh, axes, chunk)
        # a time outside this shard's chunk goes past its end: no write
        _scatter_time(cl, nl, torch.where((at >= 0) & (at < chunk), at,
                                          chunk))

    local_map(write, out_placements=None,
              in_placements=(cache.placements, batch_pl,
                             _vec_placements(mesh, cache)),
              device_mesh=mesh, redistribute_inputs=True)(cache, new, pos)


def _vec_placements(mesh, like):
    """Placements of a (B,) vector laid out as ``like``'s batch dim 0."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(0) if isinstance(pl, Shard) and pl.dim == 0
                 else Replicate() for pl in like.placements)


def _decode_attend(cfg, q, k, v, pos, window=None):
    """q (B,1,H,hd); k,v (B,S,KV,hd); masked softmax over the cached
    length.  With a mesh in force whose "model" axis divides a cache of
    at least 4,096 rows split over time, the flash-decoding path
    (otherwise every shard would gather the whole cache each step: the
    reference measured 43.9 GB a step for granite decode_32k)."""
    seq = _seq_shards(k)
    if seq is not None:
        return _decode_attend_flash(cfg, q, k, v, pos, window, *seq)
    return _decode_attend_local(q, k, v, pos, window)


def _decode_attend_local(q, k, v, pos, window, kpos=None, base=None):
    """q (B, 1, H, hd); k, v (B, S, KV, hd); masked softmax over the
    cached length.  Query head h reads kv head h // (H / KV): the heads
    are grouped, not repeated, which computes the same products.

    ``kpos`` (B, S): the time of each cache row (a ring buffer's
    ``pos_of_slot``, -1 for an empty slot, which never attends); by
    default row i holds time i, or base + i with ``base`` given.  With
    ``base`` (a shard of the cache) it returns the flash-decoding
    partial (o unnormalised (B, 1, H, hd), m (B, H, 1) the rows' max, l
    (B, H, 1) their sum of exp(s - m))."""
    b, _, h, hd = q.shape
    kvh = k.shape[2]
    cd = torch.promote_types(q.dtype, k.dtype)
    qg = q.reshape(b, kvh, h // kvh, hd).to(cd)
    scale = 1.0 / (hd ** 0.5)
    s = torch.einsum("bgrk,bsgk->bgrs", qg, k.to(cd)).float() * scale
    posb = pos[:, None, None, None]
    if kpos is None:
        kpos = torch.arange(k.shape[1], device=q.device)[None, None, None, :]
        if base is not None:
            kpos = kpos + base
        mask = kpos <= posb
    else:
        kpos = kpos[:, None, None, :]
        mask = (kpos >= 0) & (kpos <= posb)
    if window is not None:
        mask &= kpos > posb - window
    s = s.masked_fill(~mask, -torch.inf)
    if base is None:
        pda = torch.softmax(s, dim=-1).to(v.dtype)
        o = torch.einsum("bgrs,bsgk->bgrk", pda, v)
        return o.reshape(b, 1, h, hd)
    m = s.amax(dim=-1)                                   # (B, g, r)
    p = torch.exp(s - m[..., None])
    p = torch.where(torch.isfinite(s), p, 0.0)
    l_ = p.sum(dim=-1)
    o = torch.einsum("bgrs,bsgk->bgrk", p.to(v.dtype), v)
    return o.reshape(b, 1, h, hd), m.reshape(b, h, 1), l_.reshape(b, h, 1)


def _decode_attend_flash(cfg, q, k, v, pos, window, mesh, axes, n):
    """Distributed flash-decoding: each shard of the time axes ``axes``
    attends over its LOCAL cache chunk (base = shard index × chunk), then
    the partials are combined with an all-reduce max and two all-reduce
    sums over those axes: O(B·H·hd) collective bytes instead of an
    O(B·S·KV·hd) cache all-gather.  Built with ``local_map`` on the
    reference's specs: q and pos laid out by batch, k and v by "batch
    kv_seq kv_heads head_dim"."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor.experimental import local_map
    from ..sharding.rules import placements_for, spec_for
    chunk = k.shape[1] // n
    q_pl = placements_for(spec_for(tuple(q.shape), "batch . . .", mesh),
                          mesh)
    pos_pl = placements_for(spec_for(tuple(pos.shape), "batch", mesh), mesh)
    groups = [(mesh, mesh.mesh_dim_names.index(ax)) for ax in axes]

    def reduce(t, op):
        for g in groups:
            t = funcol.all_reduce(t, op, g)
        return t

    def attend(ql, kl, vl, posl):
        o, m, l_ = _decode_attend_local(
            ql, kl, vl, posl, window, base=_shard_base(mesh, axes, chunk))
        gmax = reduce(m, "max")                           # (B, H, 1)
        corr = torch.exp(m - gmax)
        l_g = reduce(l_ * corr, "sum")
        o_g = reduce(o * corr.transpose(1, 2)[..., None].to(o.dtype), "sum")
        denom = l_g.clamp_min(1e-30).transpose(1, 2)[..., None]
        return (o_g / denom.to(o_g.dtype)).to(ql.dtype)

    return local_map(attend, out_placements=(q_pl,),
                     in_placements=(q_pl, k.placements, v.placements,
                                    pos_pl),
                     device_mesh=mesh, redistribute_inputs=True)(
        q, k, v, pos)


def cross_attn_kv(cfg: ModelConfig, p: Attention, enc: torch.Tensor):
    """The cross-attention K/V (B, Skv, KV, hd) of the encoder's or the
    image stub's states ``enc``, computed once at prefill."""
    return {"k": _proj(enc, p.wk), "v": _proj(enc, p.wv)}


def cross_attn_decode(cfg: ModelConfig, p: Attention, x, kv):
    """One token's cross-attention over the static K/V ``kv`` (the
    prefill's, in the cache's dtype): kv heads repeated to H, f32 scores,
    softmax, probabilities cast to V's dtype, as the JAX package computes
    it in XLA."""
    q = _proj(x, p.wq)
    k, v = kv["k"], kv["v"]
    h, kvh = q.shape[2], k.shape[2]
    if kvh != h:
        k = k.repeat_interleave(h // kvh, dim=2)
        v = v.repeat_interleave(h // kvh, dim=2)
    cd = torch.promote_types(q.dtype, k.dtype)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bthk,bshk->bhts", q.to(cd), k.to(cd)).float() * scale
    o = torch.einsum("bhts,bshk->bthk", torch.softmax(s, -1).to(v.dtype), v)
    return _out(o, p.wo)


# ---------------------------------------------------------------------------
# MLA (MiniCPM3 / DeepSeek-style latent attention)
# ---------------------------------------------------------------------------


class MLA(nn.Module):
    """wq_a (d, q_lora), q_norm (q_lora,) f32, wq_b (q_lora, H, nope +
    rope), wkv_a (d, kv_lora + rope), kv_norm (kv_lora,) f32, wkv_b
    (kv_lora, H, nope + v_head), wo (H, v_head, d): the JAX layout."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, h = cfg.d_model, cfg.num_heads
        qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
        nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim

        def ones(n):
            return nn.Parameter(torch.ones((n,), dtype=torch.float32,
                                           device=device),
                                requires_grad=False)

        self.wq_a = _weight((d, qr), cfg, device)
        self.q_norm = ones(qr)
        self.wq_b = _weight((qr, h, nope + rope), cfg, device)
        self.wkv_a = _weight((d, kr + rope), cfg, device)
        self.kv_norm = ones(kr)
        self.wkv_b = _weight((kr, h, nope + vd), cfg, device)
        self.wo = _weight((h, vd, d), cfg, device)


mla_init = MLA


def _rms(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + 1e-6) \
        * scale
    return y.to(x.dtype)


def _mla_qkv_latent(cfg, p: MLA, x, positions):
    """q_nope, q_rope (B, S, H, ·); the latent c_kv (B, S, kv_lora) and the
    head-shared k_rope (B, S, rope), RoPE at ``positions``."""
    nope, kr = cfg.qk_nope_dim, cfg.kv_lora_rank
    cq = _rms(x @ p.wq_a.to(x.dtype), p.q_norm)
    q = _proj(cq, p.wq_b)
    q_nope = q[..., :nope]
    q_rope = apply_rope(q[..., nope:], positions, cfg.rope_theta)
    ckv_full = x @ p.wkv_a.to(x.dtype)
    c_kv = _rms(ckv_full[..., :kr], p.kv_norm)
    k_rope = apply_rope(ckv_full[..., None, kr:], positions,
                        cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, c_kv, k_rope


def _mla_attend(cfg, p: MLA, x, positions):
    """Per-head K and V materialised from the latents, then causal
    attention.  D_v (v_head) differs from D_qk (nope + rope), so
    ``ops.attention`` takes the plain path on every device, as the
    reference's ``ops`` does: the flash kernels compute D_v = D_qk only.
    Returns (out, c_kv, k_rope)."""
    nope = cfg.qk_nope_dim
    q_nope, q_rope, c_kv, k_rope = _mla_qkv_latent(cfg, p, x, positions)
    kv = _proj(c_kv, p.wkv_b)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None].expand(
        k_rope.shape[:2] + (cfg.num_heads, cfg.qk_rope_dim))], dim=-1)
    o = ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2), causal=True)
    return _out(o.transpose(1, 2), p.wo), c_kv, k_rope


def mla_apply(cfg: ModelConfig, p: MLA, x, *, positions):
    """Full-sequence MLA (train / prefill)."""
    return _mla_attend(cfg, p, x, positions)[0]


def mla_prefill(cfg: ModelConfig, p: MLA, x, *, positions, cache):
    """Prefill: writes the latents into the first S rows of ``cache``
    ({"c_kv" (B, cache_len, kv_lora), "k_rope" (B, cache_len, rope)}, zero
    beyond) and returns (out, cache)."""
    out, c_kv, k_rope = _mla_attend(cfg, p, x, positions)
    cache["c_kv"][:, :c_kv.shape[1]] = c_kv
    cache["k_rope"][:, :k_rope.shape[1]] = k_rope
    return out, cache


def mla_decode(cfg: ModelConfig, p: MLA, x, cache, *, pos):
    """Absorbed-weight MLA decode: attention runs in the latent space over
    the (c_kv, k_rope) cache, which holds kv_lora + rope values a token.
    Writes the new latents into ``cache`` in place (the reference's
    one-hot rewrite, the same values) and returns (out, cache)."""
    b = x.shape[0]
    cd = x.dtype
    pos_arr = torch.as_tensor(pos, device=x.device).expand(b)
    nope = cfg.qk_nope_dim
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_qkv_latent(
        cfg, p, x, pos_arr[:, None])
    wkv_b = p.wkv_b.to(cd)
    wk, wv = wkv_b[..., :nope], wkv_b[..., nope:]
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, wk)    # (B, 1, H, r)
    _scatter_time(cache["c_kv"], c_kv_new, pos_arr)
    _scatter_time(cache["k_rope"], k_rope_new, pos_arr)
    c_kv, k_rope = cache["c_kv"].to(cd), cache["k_rope"].to(cd)
    scale = 1.0 / ((nope + cfg.qk_rope_dim) ** 0.5)
    logits = (torch.einsum("bthr,bsr->bhts", q_lat, c_kv)
              + torch.einsum("bthk,bsk->bhts", q_rope, k_rope)
              ).float() * scale
    kpos = torch.arange(c_kv.shape[1], device=x.device)
    logits = logits.masked_fill(kpos > pos_arr[:, None, None, None],
                                -torch.inf)
    w = torch.softmax(logits, dim=-1).to(cd)
    ctx_lat = torch.einsum("bhts,bsr->bthr", w, c_kv)     # latent context
    v_ctx = torch.einsum("bthr,rhk->bthk", ctx_lat, wv)   # (B, 1, H, v)
    return _out(v_ctx, p.wo), cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, d_ff: Optional[int] = None,
                 device=None):
        super().__init__()
        d, ff = cfg.d_model, d_ff or cfg.d_ff
        self.wi = _weight((d, ff), cfg, device)
        if cfg.mlp_kind == "swiglu":
            self.wg = _weight((d, ff), cfg, device)
        self.wo = _weight((ff, d), cfg, device)


mlp_init = MLP


def mlp_apply(cfg: ModelConfig, p: MLP, x: torch.Tensor) -> torch.Tensor:
    h = x @ p.wi.to(x.dtype)
    if cfg.mlp_kind == "swiglu":
        h = F.silu(x @ p.wg.to(x.dtype)) * h
    elif cfg.mlp_kind == "squared_relu":
        h = torch.relu(h).square()
    else:  # gelu, tanh-approximated as jax.nn.gelu's default
        h = F.gelu(h, approximate="tanh")
    return h @ p.wo.to(x.dtype)
