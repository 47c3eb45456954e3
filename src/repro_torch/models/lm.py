"""The decoder stack: init, forward, prefill and one-token decode.

The JAX package's ``models/lm.py`` in PyTorch for every family it
builds: dense GQA (block kind ``attn``: granite-3-2b, chatglm3-6b,
nemotron-4-340b), MLA (``attn_kind="mla"``: minicpm3-4b), the MoE
families (block kind ``moe``: dbrx-132b, llama4-maverick-400b-a17b),
RWKV-6 (block kind ``rwkv``: rwkv6-1.6b), the Griffin hybrid (block kinds
``recurrent`` and ``local_attn``: recurrentgemma-9b), the VLM's gated
cross-attention (block kind ``cross_attn``: llama-3.2-vision-11b) and the
encoder-decoder with learned positions (block kind ``decoder`` and the
encoder: whisper-tiny).

A ``moe`` block routes with capacity drops in ``forward`` and
``prefill`` and dropless at a decode step, as the reference does
(``models/moe.py``).

A ``local_attn`` prefill runs the windowed attention through the flash
kernel and keeps the last ``window`` K/V in a ring buffer (slot = time %
window); its decode step is a masked softmax over the ring in plain
torch, as the reference computes it in XLA.

The cross-attention source comes from the frontend stubs, passed as
``extras`` (the JAX package's ``batch`` keys): ``img_embeds`` (B,
img_seq, d) through ``img_proj``, or ``enc_embeds`` (B, encoder_seq, d)
through the encoder (``encode``: its blocks unmasked, learned positions).
A ``cross_attn`` block adds its attention and its MLP through
tanh(``gate``) and tanh(``gate_mlp``), both zero at ``init``, as in the
reference; a ``decoder`` block runs its causal self-attention, then the
cross-attention through ``ln_x``, then the MLP.  Prefill keeps each
block's K/V over the source in the cache; a decode step attends over
them in plain torch.  Learned positions are added by index, a
left-padded prompt's pads included, as in the reference.

The JAX package stacks each superblock position's layers on a leading
axis and ``lax.scan``s over it; here ``LM.blocks`` holds every layer in
order (superblock r, position j; then the remainder) and a Python loop
walks them (``LM.encoder.blocks`` likewise).  The cache keeps the JAX
package's tree, leaves stacked on a leading layer axis, so
``cache_axes`` names the same dimensions.

Entry points:
  init(cfg, generator, device)                   → LM (random weights)
  forward(cfg, model, tokens, extras)            → logits (B, S, V)
  forward_train(cfg, model, batch)               → logits, aux loss
  loss_fn(cfg, model, batch)                     → loss, metrics
  prefill(cfg, model, tokens, cache_len, extras) → last logits (B, V),
                                                   cache
  decode_step(cfg, model, cache, token, pos)     → logits (B, V), cache
                                                   (updated in place)
  encode(cfg, model, enc_embeds)                 → encoder states
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..core.engine import resolve_device
from . import cache as cache_lib
from . import griffin, layers, moe, rwkv


def layer_slots(cfg: ModelConfig) -> List[Tuple[str, str, Optional[int]]]:
    """(group, key, stack index) of every layer in execution order: the
    JAX package's ``p["blocks"]["b{j}"]`` leaves at index r, then
    ``p["rem"]["r{j}"]``."""
    slots = [("blocks", f"b{j}", r) for r in range(cfg.pattern_repeats)
             for j in range(len(cfg.block_pattern))]
    slots += [("rem", f"r{j}", None)
              for j in range(len(cfg.remainder_layers))]
    return slots


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """The block kind of every layer, in ``layer_slots`` order."""
    return (list(cfg.block_pattern) * cfg.pattern_repeats
            + list(cfg.remainder_layers))


def _scalar(device) -> nn.Parameter:
    """An f32 scalar, zero: a ``cross_attn`` block's gates at init."""
    return nn.Parameter(torch.zeros((), dtype=torch.float32, device=device),
                        requires_grad=False)


class Block(nn.Module):
    """``attn`` and ``local_attn``: ln1, attn, ln2, mlp.  ``moe``: ln1,
    attn, ln2, mlp (a ``moe.MoE``).  ``rwkv``: ln1, rwkv, ln2.
    ``recurrent``: ln1, rec, ln2, mlp.  ``decoder``: ln1, attn, ln2, mlp,
    xattn (the cross-attention), ln_x.  ``cross_attn``: ln1, attn (over
    the image tokens), ln2, mlp and the f32 scalars gate and gate_mlp.
    attn is ``layers.MLA`` under ``attn_kind="mla"`` (not in a
    ``cross_attn`` block), else ``layers.Attention``."""

    def __init__(self, cfg: ModelConfig, kind: str, device=None):
        super().__init__()
        self.kind = kind
        self.ln1 = layers.norm_init(cfg, device=device)
        if kind == "rwkv":
            self.rwkv = rwkv.RWKV(cfg, device=device)
            self.ln2 = layers.norm_init(cfg, device=device)
            return
        if kind == "recurrent":
            self.rec = griffin.Recurrent(cfg, device=device)
        elif cfg.attn_kind == "mla" and kind != "cross_attn":
            self.attn = layers.mla_init(cfg, device=device)
        else:
            self.attn = layers.attn_init(cfg, device=device)
        self.ln2 = layers.norm_init(cfg, device=device)
        if kind == "moe":
            self.mlp = moe.moe_init(cfg, device=device)
        else:
            self.mlp = layers.mlp_init(cfg, device=device)
        if kind == "decoder":
            self.xattn = layers.attn_init(cfg, device=device)
            self.ln_x = layers.norm_init(cfg, device=device)
        if kind == "cross_attn":
            self.gate = _scalar(device)
            self.gate_mlp = _scalar(device)


class Encoder(nn.Module):
    """The encoder-decoder's encoder: ``encoder_layers`` ``attn`` blocks,
    ln_f, and learned positions pos_emb (encoder_seq, d) when the config
    has them."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.blocks = nn.ModuleList(Block(cfg, "attn", device)
                                    for _ in range(cfg.encoder_layers))
        self.ln_f = layers.norm_init(cfg, device=device)
        if cfg.pos_embedding == "learned":
            self.pos_emb = layers._weight((cfg.encoder_seq, cfg.d_model),
                                          cfg, device)


class LM(nn.Module):
    """embed (V, d), head (d, V) unless tied, ln_f, pos_emb (max_seq, d)
    under learned positions, img_proj (d, d) with an image stub, an
    ``Encoder`` for an encoder-decoder, and one ``Block`` per layer.
    Matrices in ``cfg.compute_dtype``; norm scales, the MoE router, the
    cross-attention gates and the RWKV and RG-LRU blocks' f32 leaves in
    f32."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        for kind in dict.fromkeys(layer_kinds(cfg)):
            cache_lib.check_ported(cfg, kind)
        self.cfg = cfg
        self.embed = layers._weight((cfg.vocab_size, cfg.d_model), cfg,
                                    device)
        if not cfg.tie_embeddings:
            self.head = layers._weight((cfg.d_model, cfg.vocab_size), cfg,
                                       device)
        self.ln_f = layers.norm_init(cfg, device=device)
        if cfg.pos_embedding == "learned":
            self.pos_emb = layers._weight((cfg.max_seq, cfg.d_model), cfg,
                                          device)
        if cfg.img_seq:
            self.img_proj = layers._weight((cfg.d_model, cfg.d_model), cfg,
                                           device)
        self.blocks = nn.ModuleList(Block(cfg, kind, device)
                                    for kind in layer_kinds(cfg))
        if cfg.encdec:
            self.encoder = Encoder(cfg, device)


def _fill(w: nn.Parameter, fan_in: int, gen: torch.Generator) -> None:
    """normal(0, 1) / sqrt(fan_in), drawn in f32, as the JAX ``_init``."""
    z = torch.randn(w.shape, generator=gen, dtype=torch.float32,
                    device=w.device)
    w.copy_(z * fan_in ** -0.5)


@torch.no_grad()
def init(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
         device=None) -> LM:
    """A model with random weights from ``generator`` (default: seed 0 on
    ``device``).  Its draws are not ``jax.random``'s: to compare with the
    JAX package, convert its parameters (``convert.params_from_jax``)."""
    device = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator(device=device).manual_seed(0)
    model = LM(cfg, device)
    d = cfg.d_model
    _fill(model.embed, d, gen)
    if not cfg.tie_embeddings:
        _fill(model.head, d, gen)
    for w in (getattr(model, "pos_emb", None),
              getattr(model, "img_proj", None)):
        if w is not None:
            _fill(w, d, gen)
    for blk in model.blocks:
        if blk.kind == "rwkv":
            _fill_rwkv(cfg, blk.rwkv, gen)
            continue
        if blk.kind == "recurrent":
            _fill_recurrent(cfg, blk.rec, gen)
            _fill(blk.mlp.wi, d, gen)
            if cfg.mlp_kind == "swiglu":
                _fill(blk.mlp.wg, d, gen)
            _fill(blk.mlp.wo, cfg.d_ff, gen)
            continue
        # the GQA dense blocks below keep their draw order, so a seed
        # gives the dense models the weights it gave them before
        if blk.kind == "moe" or isinstance(blk.attn, layers.MLA):
            _fill_attention(cfg, blk.attn, gen)
            if blk.kind == "moe":
                moe.fill(cfg, blk.mlp, lambda w, fan_in: _fill(w, fan_in,
                                                               gen))
            else:
                for w, fan_in in ((blk.mlp.wi, d), (blk.mlp.wo, cfg.d_ff)):
                    _fill(w, fan_in, gen)
                if cfg.mlp_kind == "swiglu":
                    _fill(blk.mlp.wg, d, gen)
            continue
        _fill_dense(cfg, blk, gen)
        if blk.kind == "decoder":
            _fill_attention(cfg, blk.xattn, gen)
    if cfg.encdec:
        for blk in model.encoder.blocks:
            _fill_dense(cfg, blk, gen)
        if cfg.pos_embedding == "learned":
            _fill(model.encoder.pos_emb, d, gen)
    return model


def _fill_dense(cfg: ModelConfig, blk: Block, gen) -> None:
    """A GQA block's attention and MLP, in the dense models' draw order."""
    d, hd = cfg.d_model, cfg.head_dim
    for w in (blk.attn.wq, blk.attn.wk, blk.attn.wv, blk.mlp.wi):
        _fill(w, d, gen)
    _fill(blk.attn.wo, cfg.num_heads * hd, gen)
    if cfg.mlp_kind == "swiglu":
        _fill(blk.mlp.wg, d, gen)
    _fill(blk.mlp.wo, cfg.d_ff, gen)


def _fill_attention(cfg: ModelConfig, p, gen) -> None:
    """GQA's or MLA's matrices with the JAX ``attn_init``'s or
    ``mla_init``'s fan-ins; MLA's two norms keep their ones."""
    d, h = cfg.d_model, cfg.num_heads
    if cfg.attn_kind == "mla":
        fans = ((p.wq_a, d), (p.wq_b, cfg.q_lora_rank), (p.wkv_a, d),
                (p.wkv_b, cfg.kv_lora_rank), (p.wo, h * cfg.v_head_dim))
    else:
        fans = ((p.wq, d), (p.wk, d), (p.wv, d), (p.wo, h * cfg.head_dim))
    for w, fan_in in fans:
        _fill(w, fan_in, gen)


def _fill_rwkv(cfg: ModelConfig, p: rwkv.RWKV, gen) -> None:
    """The matrices with the JAX ``rwkv_init``'s fan-ins; the constant
    leaves keep the values ``rwkv.RWKV`` gave them."""
    d = cfg.d_model
    for w in (p.ddl_a, p.wr, p.wk, p.wv, p.wg, p.wo, p.dec_a, p.ck, p.cr):
        _fill(w, d, gen)
    _fill(p.ddl_b, cfg.ddlerp_rank, gen)
    _fill(p.dec_b, cfg.decay_rank, gen)
    _fill(p.cv, cfg.d_ff, gen)


def _fill_recurrent(cfg: ModelConfig, p: griffin.Recurrent, gen) -> None:
    """The matrices with the JAX ``recurrent_init``'s fan-ins; ``conv_b``
    and ``lam`` keep the values ``griffin.Recurrent`` gave them."""
    d, ld = cfg.d_model, cfg.lru_dim
    _fill(p.w_x, d, gen)
    _fill(p.w_y, d, gen)
    _fill(p.conv_w, cfg.conv_width, gen)
    for w in (p.wr, p.wi, p.w_out):
        _fill(w, ld, gen)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _rwkv_block(cfg: ModelConfig, p: Block, x, c):
    """Time mix and channel mix from the state ``c`` ({"wkv", "tm_x",
    "cm_x"}, f32), which is updated in place.  Returns (x, c)."""
    h = layers.norm_apply(cfg, p.ln1, x)
    tm, after = rwkv.rwkv_block_apply(cfg, p.rwkv, h, c)
    x = x + tm
    h2 = layers.norm_apply(cfg, p.ln2, x)
    cm, cm_x = rwkv.rwkv_channel_mix(cfg, p.rwkv, h2, c["cm_x"])
    c["tm_x"].copy_(after["tm_x"])
    c["cm_x"].copy_(cm_x)
    return x + cm, c


def _recurrent_block(cfg: ModelConfig, p: Block, x, c):
    """The RG-LRU branch from the state ``c`` ({"h", "conv"}, f32), which
    is overwritten with the new state, then the MLP.  Returns (x, c)."""
    h = layers.norm_apply(cfg, p.ln1, x)
    ro, st = griffin.recurrent_apply(cfg, p.rec, h, c)
    c["h"].copy_(st["h"])
    c["conv"].copy_(st["conv"])
    return _mlp_half(cfg, p, x + ro)[0], c


def _mlp_half(cfg: ModelConfig, p: Block, x, dropless: bool = False):
    """ln2 and the MLP, or the MoE (dropless at a decode step).  Returns
    (x, the MoE's ``aux_loss`` or None)."""
    h2 = layers.norm_apply(cfg, p.ln2, x)
    if p.kind == "moe":
        out, info = moe.moe_apply(cfg, p.mlp, h2, dropless=dropless)
        return x + out, info["aux_loss"]
    return x + layers.mlp_apply(cfg, p.mlp, h2), None


def _gated_half(cfg: ModelConfig, p: Block, x, att):
    """The rest of a ``cross_attn`` block after its attention ``att``:
    x + tanh(gate) · att, then the MLP through tanh(gate_mlp), each gate
    cast to x's dtype (llama-vision)."""
    x = x + torch.tanh(p.gate).to(x.dtype) * att
    h2 = layers.norm_apply(cfg, p.ln2, x)
    return x + torch.tanh(p.gate_mlp).to(x.dtype) * layers.mlp_apply(
        cfg, p.mlp, h2)


def block_apply(cfg: ModelConfig, p: Block, x, *, positions, enc=None):
    """Full-sequence forward of one block (an RWKV or RG-LRU block starts
    from the zero state, as in the JAX package).  ``enc``: the
    cross-attention source (B, Skv, d) of a ``cross_attn`` or
    ``decoder`` block.  Returns (x, aux): a ``moe`` block's
    ``aux_loss`` (f32), None for the other kinds."""
    if p.kind in ("rwkv", "recurrent"):
        state = cache_lib.block_cache_init(cfg, p.kind, x.shape[0], 0,
                                           device=x.device)
        block = _rwkv_block if p.kind == "rwkv" else _recurrent_block
        return block(cfg, p, x, state)[0], None
    h = layers.norm_apply(cfg, p.ln1, x)
    if p.kind == "cross_attn":
        return _gated_half(cfg, p, x, layers.attn_apply(
            cfg, p.attn, h, positions=positions, kv_src=enc,
            causal=False)), None
    if cfg.attn_kind == "mla":
        x = x + layers.mla_apply(cfg, p.attn, h, positions=positions)
    else:
        window = cfg.window if p.kind == "local_attn" else None
        x = x + layers.attn_apply(cfg, p.attn, h, positions=positions,
                                  window=window)
    if p.kind == "decoder":
        hx = layers.norm_apply(cfg, p.ln_x, x)
        x = x + layers.attn_apply(cfg, p.xattn, hx, positions=positions,
                                  kv_src=enc, causal=False)
    return _mlp_half(cfg, p, x)


def block_prefill(cfg: ModelConfig, p: Block, x, *, positions, cache,
                  enc=None):
    """Forward + this block's decode cache, written into ``cache`` (an
    RWKV or RG-LRU block's starts as zeros: its prefill starts from the
    zero state; a local block's as an empty ring; a ``cross_attn`` or
    ``decoder`` block's K/V over ``enc`` fill its cross cache)."""
    if p.kind == "rwkv":
        return _rwkv_block(cfg, p, x, cache)
    if p.kind == "recurrent":
        return _recurrent_block(cfg, p, x, cache)
    h = layers.norm_apply(cfg, p.ln1, x)
    if p.kind == "cross_attn":
        kv = layers.cross_attn_kv(cfg, p.attn, enc)
        cache["k"].copy_(kv["k"])
        cache["v"].copy_(kv["v"])
        return _gated_half(cfg, p, x, layers._cross_attend(p.attn, h,
                                                           kv)), cache
    if cfg.attn_kind == "mla":
        att, _ = layers.mla_prefill(cfg, p.attn, h, positions=positions,
                                    cache=cache)
    elif p.kind == "local_attn":
        att, _ = _local_prefill(cfg, p.attn, h, positions, cache)
    else:
        self_cache = cache["self"] if p.kind == "decoder" else cache
        att, _ = layers.attn_prefill(cfg, p.attn, h, positions=positions,
                                     cache=self_cache)
    x = x + att
    if p.kind == "decoder":
        kv = layers.cross_attn_kv(cfg, p.xattn, enc)
        cache["cross_k"].copy_(kv["k"])
        cache["cross_v"].copy_(kv["v"])
        hx = layers.norm_apply(cfg, p.ln_x, x)
        x = x + layers._cross_attend(p.xattn, hx, kv)
    return _mlp_half(cfg, p, x)[0], cache


def _local_prefill(cfg: ModelConfig, p: layers.Attention, h, positions,
                   cache):
    """Windowed attention over the prompt (the flash kernel on the
    card), then the last min(S, window) K/V written into the ring
    ``cache`` at slot time % window, their times into ``pos_of_slot``.
    No (B, S) cache is built."""
    att, k, v = layers._self_attend(cfg, p, h, positions, cfg.window)
    s, w = h.shape[1], cfg.window
    times = torch.arange(max(0, s - w), s, device=h.device)
    slots = times % w                    # distinct: consecutive times
    cache["k"][:, slots] = k[:, times].to(cache["k"].dtype)
    cache["v"][:, slots] = v[:, times].to(cache["v"].dtype)
    cache["pos_of_slot"][:, slots] = times.to(torch.int32)
    return att, cache


def _local_decode(cfg: ModelConfig, p: layers.Attention, h, c, pos):
    """One token against the ring: its K/V written at slot pos % window
    (in place), then a masked softmax over the slots whose time is >= 0,
    <= pos and > pos - window."""
    b = h.shape[0]
    q, k_new, v_new = (layers._proj(h, w) for w in (p.wq, p.wk, p.wv))
    if cfg.pos_embedding == "rope":
        q = layers.apply_rope(q, pos[:, None], cfg.rope_theta,
                              cfg.rope_fraction)
        k_new = layers.apply_rope(k_new, pos[:, None], cfg.rope_theta,
                                  cfg.rope_fraction)
    slot = pos % cfg.window
    layers._scatter_time(c["k"], k_new, slot)
    layers._scatter_time(c["v"], v_new, slot)
    c["pos_of_slot"][torch.arange(b, device=h.device), slot] = \
        pos.to(torch.int32)
    o = layers._decode_attend_local(q, c["k"], c["v"], pos, cfg.window,
                                    kpos=c["pos_of_slot"])
    return layers._out(o, p.wo), c


def block_decode(cfg: ModelConfig, p: Block, x, c, *, pos):
    """One-token step; updates ``c`` in place.  Returns (x, c)."""
    if p.kind == "rwkv":
        return _rwkv_block(cfg, p, x, c)
    if p.kind == "recurrent":
        return _recurrent_block(cfg, p, x, c)
    h = layers.norm_apply(cfg, p.ln1, x)
    if p.kind == "cross_attn":
        return _gated_half(cfg, p, x, layers.cross_attn_decode(
            cfg, p.attn, h, c)), c
    if cfg.attn_kind == "mla":
        att, _ = layers.mla_decode(cfg, p.attn, h, c, pos=pos)
    elif p.kind == "local_attn":
        att, _ = _local_decode(cfg, p.attn, h, c, pos)
    else:
        self_cache = c["self"] if p.kind == "decoder" else c
        att, _ = layers.attn_decode(cfg, p.attn, h, self_cache, pos=pos)
    x = x + att
    if p.kind == "decoder":
        hx = layers.norm_apply(cfg, p.ln_x, x)
        x = x + layers.cross_attn_decode(
            cfg, p.xattn, hx, {"k": c["cross_k"], "v": c["cross_v"]})
    return _mlp_half(cfg, p, x, dropless=True)[0], c


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------


def _embed(cfg: ModelConfig, model: LM, tokens, positions=None):
    """Token embeddings, plus the learned positions at ``positions``
    (default 0 .. S - 1) under ``pos_embedding="learned"``."""
    x = model.embed[tokens]
    if cfg.pos_embedding == "learned":
        if positions is None:
            x = x + model.pos_emb[None, :x.shape[1]]
        else:
            x = x + model.pos_emb[positions]
    return x


def _logits(cfg: ModelConfig, model: LM, x):
    x = layers.norm_apply(cfg, model.ln_f, x)
    if cfg.tie_embeddings:
        return x @ model.embed.to(x.dtype).T
    return x @ model.head.to(x.dtype)


def _positions(tokens):
    b, s = tokens.shape
    return torch.arange(s, device=tokens.device)[None].expand(b, s)


def encode(cfg: ModelConfig, model: LM, enc_embeds) -> torch.Tensor:
    """The encoder over the frontend stub's frame embeddings (B, S, d):
    learned positions, unmasked self-attention blocks (the flash kernel
    on the card), ln_f.  Returns (B, S, d) in the compute dtype;
    differentiable where the model's parameters take gradients (the
    training step's working copy)."""
    ep = model.encoder
    x = torch.as_tensor(enc_embeds, device=model.embed.device).to(
        model.embed.dtype)
    if cfg.pos_embedding == "learned":
        x = x + ep.pos_emb[None, :x.shape[1]]
    positions = _positions(x[..., 0])
    for blk in ep.blocks:
        h = layers.norm_apply(cfg, blk.ln1, x)
        x = x + layers.attn_apply(cfg, blk.attn, h, positions=positions,
                                  causal=False)
        x = _mlp_half(cfg, blk, x)[0]
    return layers.norm_apply(cfg, ep.ln_f, x)


def _enc_for(cfg: ModelConfig, model: LM, extras: Optional[Dict]):
    """The cross-attention source from the frontend stubs: the encoder
    over ``extras["enc_embeds"]``, or ``extras["img_embeds"]`` @
    img_proj; None for a model without cross-attention."""
    if not (cfg.encdec or cfg.img_seq):
        return None
    key = "enc_embeds" if cfg.encdec else "img_embeds"
    if not extras or key not in extras:
        raise ValueError(f"{cfg.name} needs extras[{key!r}], the frontend "
                         "stub's embeddings")
    if cfg.encdec:
        return encode(cfg, model, extras[key])
    img = torch.as_tensor(extras[key], device=model.embed.device)
    return img.to(model.img_proj.dtype) @ model.img_proj


@torch.no_grad()
def forward(cfg: ModelConfig, model: LM, tokens: torch.Tensor,
            extras: Optional[Dict] = None) -> torch.Tensor:
    """tokens (B, S) → logits (B, S, V): the forward half of the JAX
    package's ``forward_train`` (no gradient, no aux loss).  ``extras``:
    the frontend stubs, keyed as the JAX package's batch
    (``img_embeds`` or ``enc_embeds``)."""
    x = _embed(cfg, model, tokens)
    positions = _positions(tokens)
    enc = _enc_for(cfg, model, extras)
    for blk in model.blocks:
        x = block_apply(cfg, blk, x, positions=positions, enc=enc)[0]
    return _logits(cfg, model, x)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def block_train(cfg: ModelConfig, p: Block, x, *, positions, enc=None):
    """``block_apply`` for ``forward_train``: an RWKV block through
    ``rwkv.rwkv_time_mix_train`` and an RG-LRU block through its
    differentiable scan (``ops.wkv6_train``, ``ops.rg_lru_scan``: their
    backwards are hand-written kernels), each from the zero state and
    writing no state; every other kind as ``block_apply``.  Returns (x,
    aux)."""
    if p.kind == "rwkv":
        b, _, d = x.shape
        x = x + rwkv.rwkv_time_mix_train(
            cfg, p.rwkv, layers.norm_apply(cfg, p.ln1, x))
        cm, _ = rwkv.rwkv_channel_mix(cfg, p.rwkv,
                                      layers.norm_apply(cfg, p.ln2, x),
                                      x.new_zeros((b, d)))
        return x + cm, None
    if p.kind == "recurrent":
        state = cache_lib.block_cache_init(cfg, p.kind, x.shape[0], 0,
                                           device=x.device)
        ro, _ = griffin.recurrent_apply(
            cfg, p.rec, layers.norm_apply(cfg, p.ln1, x), state, train=True)
        return _mlp_half(cfg, p, x + ro)
    return block_apply(cfg, p, x, positions=positions, enc=enc)


def _add(total, aux):
    return aux if total is None else total if aux is None else total + aux


def _remat(fn, x, remat: bool):
    """fn(x) → (x, aux), its activations recomputed in the backward under
    ``remat`` (the reference's ``jax.checkpoint`` with
    ``nothing_saveable``: only the input is kept)."""
    if not remat:
        return fn(x)
    return checkpoint(fn, x, use_reentrant=False, preserve_rng_state=False)


def forward_train(cfg: ModelConfig, model: LM, batch: Dict):
    """batch: ``tokens`` (B, S) [+ the ``img_embeds`` / ``enc_embeds``
    stubs].  Returns (logits (B, S, V), aux): aux is the MoE blocks'
    ``aux_loss`` summed over the superblocks and the remainder layers
    (f32; 0 without MoE).  Differentiable: the JAX package's
    ``forward_train``, with ``cfg.remat`` checkpointing each superblock
    and, when ``cfg.remat_group`` > 1 divides the repeats, each group of
    ``remat_group`` superblocks too (two levels, as the reference's
    scan over groups).  The remainder layers are not checkpointed.  Every
    block runs through ``block_train``."""
    tokens = torch.as_tensor(batch["tokens"], device=model.embed.device)
    tokens = tokens.long()
    x = _embed(cfg, model, tokens)
    positions = _positions(tokens)
    enc = _enc_for(cfg, model, batch)
    n = len(cfg.block_pattern)
    reps, rg = cfg.pattern_repeats, cfg.remat_group
    blocks = list(model.blocks)

    def superblock(r):
        def run(x):
            aux = None
            for blk in blocks[r * n:(r + 1) * n]:
                x, a = block_train(cfg, blk, x, positions=positions,
                                   enc=enc)
                aux = _add(aux, a)
            return x, aux
        return run

    def group(g):
        def run(x):
            aux = None
            for r in range(g * rg, (g + 1) * rg):
                x, a = _remat(superblock(r), x, cfg.remat)
                aux = _add(aux, a)
            return x, aux
        return run

    aux = None
    if rg > 1 and reps % rg == 0:
        for g in range(reps // rg):
            x, a = _remat(group(g), x, cfg.remat)
            aux = _add(aux, a)
    else:
        for r in range(reps):
            x, a = _remat(superblock(r), x, cfg.remat)
            aux = _add(aux, a)
    for blk in blocks[reps * n:]:
        x, a = block_train(cfg, blk, x, positions=positions, enc=enc)
        aux = _add(aux, a)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _logits(cfg, model, x), aux


def loss_fn(cfg: ModelConfig, model: LM, batch: Dict):
    """(loss, metrics) of the JAX package's ``loss_fn``: cross-entropy in
    f32 through logsumexp over ``loss_mask`` (all ones when absent), the
    z-loss 1e-4 · Σ logz² · mask / denom and the MoE aux; metrics ``ce``,
    ``zloss``, ``aux`` and ``ppl`` (0-d tensors)."""
    logits, aux = forward_train(cfg, model, batch)
    device = logits.device
    labels = torch.as_tensor(batch["labels"], device=device).long()
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)
    ll = lf.gather(-1, labels[..., None])[..., 0]
    mask = batch.get("loss_mask")
    mask = torch.ones_like(ll) if mask is None else torch.as_tensor(
        mask, dtype=torch.float32, device=device)
    denom = mask.sum().clamp_min(1.0)
    ce = ((logz - ll) * mask).sum() / denom
    zloss = 1e-4 * (logz.square() * mask).sum() / denom
    total = ce + zloss + aux
    return total, {"ce": ce, "zloss": zloss, "aux": aux,
                   "ppl": torch.exp(ce)}


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, t) for k, t in tree.items()}
    return fn(tree)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, device=None) -> Dict:
    """The JAX package's cache tree, each ``blocks`` leaf stacked on a
    leading layer axis.  ``dtype`` is the KV caches' (the cross caches'
    too); each leaf keeps the dtype and the value ``block_cache_init``
    gives it, so the recurrent states stay f32 and an empty ring's
    ``pos_of_slot`` is -1."""
    device = resolve_device(device)

    def stacked(kind, stack):
        one = cache_lib.block_cache_init(cfg, kind, batch, cache_len,
                                         dtype, device=device)
        return _tree_map(lambda t: t.expand(stack + t.shape).clone()
                         if stack else t, one)

    c = {"blocks": {f"b{j}": stacked(kind, (cfg.pattern_repeats,))
                    for j, kind in enumerate(cfg.block_pattern)}}
    if cfg.remainder_layers:
        c["rem"] = {f"r{j}": stacked(kind, ())
                    for j, kind in enumerate(cfg.remainder_layers)}
    return c


def cache_axes(cfg: ModelConfig) -> Dict:
    c = {"blocks": {
        f"b{j}": _tree_map(lambda ax: "stack " + ax,
                           cache_lib.block_cache_axes(cfg, kind))
        for j, kind in enumerate(cfg.block_pattern)}}
    if cfg.remainder_layers:
        c["rem"] = {f"r{j}": cache_lib.block_cache_axes(cfg, kind)
                    for j, kind in enumerate(cfg.remainder_layers)}
    return c


def layer_caches(cfg: ModelConfig, cache: Dict) -> List[Dict]:
    """Per-layer views into the cache tree, in execution order."""
    return [_tree_map(lambda t: t if r is None else t[r], cache[group][key])
            for group, key, r in layer_slots(cfg)]


@torch.no_grad()
def prefill(cfg: ModelConfig, model: LM, tokens: torch.Tensor,
            cache_len: int, extras: Optional[Dict] = None):
    """tokens (B, S) → (last-token logits (B, V), cache: the KV cache
    padded to cache_len, the cross K/V and the local rings in the compute
    dtype, the RWKV and RG-LRU states in f32).  ``extras``: as in
    ``forward``."""
    b, s = tokens.shape
    x = _embed(cfg, model, tokens)
    positions = _positions(tokens)
    enc = _enc_for(cfg, model, extras)
    cache = init_cache(cfg, b, cache_len, dtype=x.dtype, device=x.device)
    for blk, c in zip(model.blocks, layer_caches(cfg, cache)):
        x, _ = block_prefill(cfg, blk, x, positions=positions, cache=c,
                             enc=enc)
    return _logits(cfg, model, x[:, -1:, :])[:, 0], cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, model: LM, cache: Dict,
                token: torch.Tensor, pos):
    """token (B,); pos: scalar or (B,) position of the new token.
    Returns (logits (B, V), cache): the cache is updated in place."""
    pos_arr = torch.as_tensor(pos, device=token.device).expand(
        token.shape[0])
    x = _embed(cfg, model, token[:, None], pos_arr[:, None])
    for blk, c in zip(model.blocks, layer_caches(cfg, cache)):
        x, _ = block_decode(cfg, blk, x, c, pos=pos_arr)
    return _logits(cfg, model, x)[:, 0], cache
