"""Batched serving: prefill + decode loop, greedy/temperature sampling,
and a slot-based continuous-batching scheduler.

The JAX package's ``serve/engine.py`` in PyTorch.  ``generate`` is the
static-batch path (one wave of prompts decoded together).  ``ServeLoop``
keeps a fixed pool of B slots with a shared batched KV cache; finished
slots are refilled from the queue in *waves* (batch prefill), and each
cache leaf's "batch" dimension comes from the cache's logical axes
(``lm.cache_axes``), so slot surgery follows the cache tree.

Both run on the device of the model's weights.  On CUDA every prefill
of a GQA model goes through the hand-written flash-attention kernel, in
each layer (a Griffin model's in each local-attention layer, an MoE
model's in each layer; an MLA model's attention, whose value head is
narrower than its key head, runs the plain attention); an RWKV-6
model runs the hand-written WKV6 kernel in each layer of every prefill
and every decode step.  The RWKV and RG-LRU states, unlike a KV cache,
are f32 whatever the cache dtype: slot surgery copies them without
rounding, and a local layer's ring buffer moves with its ``pos_of_slot``
map, whose "batch" axis its axes name too.
The vision and audio families take their frontend stubs as ``extras``
(``img_embeds`` or ``enc_embeds``): ``generate(..., extras=)`` for the
static batch, ``ServeLoop(..., extras_fn=)`` called with each wave's
size; a wave's cross K/V, computed at its prefill, move into the slots'
cache rows with the rest of the cache.
Temperature sampling draws from an explicit ``torch.Generator``; it
cannot reproduce ``jax.random``'s draws.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..models import lm
from ..sharding.rules import parse_axes


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _device(model: lm.LM) -> torch.device:
    return model.embed.device


def _sample(logits, generator: Optional[torch.Generator],
            temperature: float) -> torch.Tensor:
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def generate(cfg: ModelConfig, model: lm.LM, prompts, max_new_tokens: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             extras: Optional[Dict] = None,
             eos: Optional[int] = None) -> np.ndarray:
    """prompts: (B, S) int; ``extras``: the frontend stubs of the batch
    (``lm.prefill``'s).  Returns (B, S + max_new) int32 tokens."""
    dev = _device(model)
    prompts = np.asarray(prompts, dtype=np.int32)
    b, s = prompts.shape
    cache_len = s + max_new_tokens
    toks = torch.as_tensor(prompts, dtype=torch.long, device=dev)
    logits, cache = lm.prefill(cfg, model, toks, cache_len=cache_len,
                               extras=extras)
    out = [prompts]
    tok = _sample(logits, generator, temperature)
    done = np.zeros(b, dtype=bool)
    for i in range(max_new_tokens):
        host = tok.cpu().numpy().astype(np.int32)
        out.append(host[:, None])
        if eos is not None:
            done |= host == eos
            if done.all():
                pad = np.full((b, max_new_tokens - i - 1), eos, np.int32)
                if pad.shape[1]:
                    out.append(pad)
                break
        if i == max_new_tokens - 1:
            break
        logits, cache = lm.decode_step(cfg, model, cache, tok, s + i)
        tok = _sample(logits, generator, temperature)
    return np.concatenate(out, axis=1)


# ---------------------------------------------------------------------------
# continuous batching (slot pool)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeLoop:
    """Fixed B-slot decode pool with wave prefill.  ``extras_fn(n)``
    gives the frontend stubs of a wave of n requests."""

    def __init__(self, cfg: ModelConfig, model: lm.LM, num_slots: int,
                 cache_len: int, extras_fn=None):
        self.cfg, self.model = cfg, model
        self.b, self.cache_len = num_slots, cache_len
        self.extras_fn = extras_fn or (lambda n: {})
        self.device = _device(model)
        self.cache = lm.init_cache(cfg, num_slots, cache_len,
                                   device=self.device)
        self.cache_batch_dim = _tree_map(
            lambda ax: parse_axes(ax).index("batch"), lm.cache_axes(cfg))
        self.slot_req: List[Optional[Request]] = [None] * num_slots
        self.slot_pos = np.zeros(num_slots, dtype=np.int64)
        self.last_tok = np.zeros(num_slots, dtype=np.int64)
        self.queue: List[Request] = []

    def submit(self, req: Request):
        self.queue.append(req)

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def _admit_wave(self):
        free = self._free_slots()
        wave = []
        while free and self.queue:
            wave.append((free.pop(0), self.queue.pop(0)))
        if not wave:
            return
        maxlen = max(len(r.prompt) for _, r in wave)
        toks = np.zeros((len(wave), maxlen), np.int64)
        for i, (_, r) in enumerate(wave):
            # left-padded with token 0 and no padding mask, as the JAX
            # package does: ragged prompts see the pad tokens
            toks[i, maxlen - len(r.prompt):] = r.prompt
        logits, wave_cache = lm.prefill(
            self.cfg, self.model, torch.as_tensor(toks, device=self.device),
            cache_len=self.cache_len, extras=self.extras_fn(len(wave)))
        tok = torch.argmax(logits, dim=-1).cpu().numpy()
        slots = torch.as_tensor([s for s, _ in wave], device=self.device)

        def put(c, w, d):
            c[(slice(None),) * d + (slots,)] = w.to(c.dtype)

        _tree_map(put, self.cache, wave_cache, self.cache_batch_dim)
        for i, (s, r) in enumerate(wave):
            self.slot_req[s] = r
            self.slot_pos[s] = maxlen
            self.last_tok[s] = tok[i]
            r.generated.append(int(tok[i]))

    def step(self):
        """One decode step for all active slots (+ admit new work)."""
        self._admit_wave()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return False
        logits, self.cache = lm.decode_step(
            self.cfg, self.model, self.cache,
            torch.as_tensor(self.last_tok, device=self.device),
            torch.as_tensor(self.slot_pos, device=self.device))
        tok = torch.argmax(logits, dim=-1).cpu().numpy()
        for s in active:
            r = self.slot_req[s]
            r.generated.append(int(tok[s]))
            self.slot_pos[s] += 1
            self.last_tok[s] = tok[s]
            if len(r.generated) >= r.max_new or \
                    self.slot_pos[s] >= self.cache_len - 1:
                r.done = True
                self.slot_req[s] = None
        return True

    def run(self, max_steps: int = 10_000):
        steps = 0
        while (self.queue or any(self.slot_req)) and steps < max_steps:
            self.step()
            steps += 1
        return steps
