"""Deterministic synthetic data pipeline with document packing.

Offline container ⇒ no real corpora; the generator produces a *learnable*
language: a hidden token-transition permutation with zipf-distributed
"noise" tokens and documents of random length packed into fixed windows
with EOS separators (GPT-style packing).  A small model's loss drops
quickly on it, which is what the end-to-end example/test verifies.

Determinism & distribution: batch ``i`` of shard ``h`` depends only on
(seed, i, h) — restart-safe (the loop resumes at the saved step index) and
host-shardable (each data-parallel host pulls its own shard), matching a
1000-node deployment where every host computes its slice of the global
batch independently.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class SyntheticCorpus:
    vocab_size: int
    seed: int = 0
    eos: int = 1
    structure: float = 0.85      # P(next = perm[cur]) — learnability
    mean_doc_len: int = 192

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.perm = rng.permutation(self.vocab_size)
        # zipf weights for the noise distribution
        ranks = np.arange(2, self.vocab_size + 2)
        w = 1.0 / ranks
        self.zipf_p = w / w.sum()

    def _doc(self, rng: np.random.Generator, max_len: int) -> np.ndarray:
        n = int(np.clip(rng.geometric(1.0 / self.mean_doc_len), 8, max_len))
        out = np.empty(n, dtype=np.int32)
        out[0] = rng.integers(2, self.vocab_size)
        structured = rng.random(n) < self.structure
        noise = rng.choice(self.vocab_size, size=n, p=self.zipf_p)
        for i in range(1, n):
            out[i] = self.perm[out[i - 1]] if structured[i] \
                else max(int(noise[i]), 2)
        out[-1] = self.eos
        return out

    def batch(self, index: int, batch_size: int, seq_len: int,
              shard: int = 0, num_shards: int = 1) -> Dict[str, np.ndarray]:
        """Deterministic function of (seed, index, shard)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, index, shard, num_shards]))
        need = batch_size * (seq_len + 1)
        stream = []
        total = 0
        while total < need:
            d = self._doc(rng, seq_len)
            stream.append(d)
            total += len(d)
        flat = np.concatenate(stream)[:need].reshape(batch_size,
                                                     seq_len + 1)
        return {"tokens": flat[:, :-1].astype(np.int32),
                "labels": flat[:, 1:].astype(np.int32),
                "loss_mask": np.ones((batch_size, seq_len), np.float32)}


def make_iterator(corpus: SyntheticCorpus, batch_size: int, seq_len: int,
                  start_step: int = 0, shard: int = 0, num_shards: int = 1,
                  extras: Optional[Dict] = None
                  ) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite iterator; ``start_step`` resumes mid-stream after restart."""
    i = start_step
    while True:
        b = corpus.batch(i, batch_size, seq_len, shard, num_shards)
        if extras:
            b = dict(b, **{k: f(i) for k, f in extras.items()})
        yield b
        i += 1
