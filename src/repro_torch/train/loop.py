"""Training loop: checkpoint/restart fault tolerance, simulated failures,
and a straggler-tolerant local-SGD outer loop with compressed deltas.
The JAX package's ``train/loop.py`` in PyTorch, on ``device`` (``cuda``
unless the caller names one).

Fault model:
  * a step may raise ``SimulatedFailure`` (``fail_at_step``): the loop
    restarts from the last checkpoint and rebuilds the data iterator at
    the restored step, so recovery gives the uninterrupted run's
    parameters (bit for bit where the device's kernels are
    deterministic: on the card under
    ``torch.use_deterministic_algorithms(True)``);
  * checkpoints are atomic and optionally async (``ckpt/checkpoint.py``);
  * in local-SGD mode, W workers take ``sync_period`` local steps between
    syncs and exchange int8 deltas with error feedback
    (``train/compress.py``), simulated one after another in one process.

Parameters start from ``step.init_masters(cfg, args.seed)``, the port's
``lm.init`` draws in f32, not ``jax.random``'s.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .. import ckpt
from ..configs.base import ModelConfig
from ..core.engine import resolve_device
from ..data.pipeline import SyntheticCorpus, make_iterator
from . import compress
from . import tree as T
from .optimizer import make_optimizer, warmup_cosine
from .step import init_masters, make_train_step


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class TrainArgs:
    steps: int = 100
    batch_size: int = 8
    seq_len: int = 128
    lr: float = 3e-3
    warmup: int = 20
    accum_steps: int = 1
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    seed: int = 0
    fail_at_step: Optional[int] = None    # simulate a node failure
    async_ckpt: bool = False


def _extras_for(cfg: ModelConfig, batch_size: int):
    ex = {}
    if cfg.img_seq:
        ex["img_embeds"] = lambda i: np.random.default_rng((i, 7)) \
            .standard_normal((batch_size, cfg.img_seq, cfg.d_model)) \
            .astype(np.float32)
    if cfg.encdec:
        ex["enc_embeds"] = lambda i: np.random.default_rng((i, 11)) \
            .standard_normal((batch_size, cfg.encoder_seq, cfg.d_model)) \
            .astype(np.float32)
    return ex


def train(cfg: ModelConfig, args: TrainArgs,
          hooks: Optional[Dict[str, Callable]] = None,
          device=None) -> Dict[str, Any]:
    """Single-replica training with checkpoint/restart.  Returns
    {"params" (the f32 masters), "opt_state", "history", "final_step"}.

    If a SimulatedFailure fires (or any step raises), calling ``train``
    again with the same ckpt_dir resumes from the latest checkpoint.
    ``hooks["on_log"](m)`` gets each logged record (every ``log_every``
    steps and the last: the metrics as floats, ``step`` and ``wall_s``)."""
    hooks = hooks or {}
    device = resolve_device(device)
    opt = make_optimizer(cfg.optimizer,
                         warmup_cosine(args.lr, args.warmup, args.steps))
    train_step = make_train_step(cfg, opt, args.accum_steps, device=device)

    params = init_masters(cfg, args.seed, device)
    opt_state = opt.init(params)
    start = 0
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        params, opt_state, meta = ckpt.restore(
            args.ckpt_dir, params, opt_state, device=device)
        start = int(meta["step"])

    corpus = SyntheticCorpus(cfg.vocab_size, seed=args.seed)
    it = make_iterator(corpus, args.batch_size, args.seq_len,
                       start_step=start,
                       extras=_extras_for(cfg, args.batch_size))

    history: List[Dict[str, float]] = []
    t0 = time.time()
    for step in range(start, args.steps):
        batch = next(it)
        if args.fail_at_step is not None and step == args.fail_at_step:
            raise SimulatedFailure(f"injected failure at step {step}")
        params, opt_state, metrics = train_step(params, opt_state, batch)
        if (step + 1) % args.log_every == 0 or step == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step + 1
            m["wall_s"] = time.time() - t0
            history.append(m)
            if "on_log" in hooks:
                hooks["on_log"](m)
        if args.ckpt_dir and ((step + 1) % args.ckpt_every == 0
                              or step == args.steps - 1):
            ckpt.save(args.ckpt_dir, step + 1, params, opt_state,
                      keep=args.keep, async_save=args.async_ckpt)
    ckpt.wait_for_async_saves()
    return {"params": params, "opt_state": opt_state, "history": history,
            "final_step": args.steps}


def train_with_restarts(cfg: ModelConfig, args: TrainArgs,
                        max_restarts: int = 3, device=None,
                        hooks: Optional[Dict[str, Callable]] = None
                        ) -> Dict[str, Any]:
    """Run until done: restart from the checkpoint on failure (the
    behaviour a cluster scheduler provides)."""
    restarts = 0
    while True:
        try:
            out = train(cfg, args, hooks=hooks, device=device)
            out["restarts"] = restarts
            return out
        except SimulatedFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
            args = dataclasses.replace(args, fail_at_step=None)


# ---------------------------------------------------------------------------
# local-SGD (async outer loop)
# ---------------------------------------------------------------------------


def train_local_sgd(cfg: ModelConfig, args: TrainArgs, workers: int = 2,
                    sync_period: int = 10, compress_deltas: bool = True,
                    device=None) -> Dict[str, Any]:
    """W workers each run ``sync_period`` local steps from the global
    parameters, then exchange parameter *deltas* (int8 + error feedback
    when compress_deltas) and average.  Simulated one worker after
    another in one process."""
    device = resolve_device(device)
    opt = make_optimizer(cfg.optimizer,
                         warmup_cosine(args.lr, args.warmup, args.steps))
    train_step = make_train_step(cfg, opt, args.accum_steps, device=device)

    global_params = init_masters(cfg, args.seed, device)
    opt_states = [opt.init(global_params) for _ in range(workers)]
    err = [compress.zeros_error(global_params) for _ in range(workers)]
    corpus = SyntheticCorpus(cfg.vocab_size, seed=args.seed)
    iters = [make_iterator(corpus, args.batch_size, args.seq_len,
                           shard=w, num_shards=workers,
                           extras=_extras_for(cfg, args.batch_size))
             for w in range(workers)]

    history = []
    comm_bytes = 0
    step = 0
    while step < args.steps:
        deltas = []
        losses = []
        for w in range(workers):
            p = T.tree_map(torch.clone, global_params)
            for _ in range(sync_period):
                p, opt_states[w], metrics = train_step(p, opt_states[w],
                                                       next(iters[w]))
            losses.append(float(metrics["loss"]))
            delta = T.tree_map(lambda a, b: (a - b).float(), p,
                               global_params)
            if compress_deltas:
                q, s, err[w] = compress.compress_tree(delta, err[w])
                delta = compress.decompress_tree(q, s)
                comm_bytes += compress.compressed_bytes(q)
            else:
                comm_bytes += 4 * sum(x.numel() for x in T.leaves(delta))
            deltas.append(delta)
        mean_delta = T.tree_map(lambda *ds: sum(ds) / len(ds), *deltas)
        global_params = T.tree_map(
            lambda p_, d: (p_.float() + d).to(p_.dtype), global_params,
            mean_delta)
        step += sync_period
        history.append({"step": step, "loss": float(np.mean(losses)),
                        "comm_bytes": comm_bytes})
    return {"params": global_params, "history": history,
            "comm_bytes": comm_bytes}
