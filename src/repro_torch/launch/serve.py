"""Serving driver: batched generation or continuous batching on the
reduced config of an architecture, with random weights from a seed.

    python -m repro_torch.launch.serve --arch granite-3-2b --mode static
    python -m repro_torch.launch.serve --arch rwkv6-1.6b
    python -m repro_torch.launch.serve --arch recurrentgemma-9b
    python -m repro_torch.launch.serve --arch dbrx-132b    # MoE
    python -m repro_torch.launch.serve --arch llama4-maverick-400b-a17b
    python -m repro_torch.launch.serve --arch minicpm3-4b  # MLA
    python -m repro_torch.launch.serve --arch llama-3.2-vision-11b
    python -m repro_torch.launch.serve --arch whisper-tiny
    python -m repro_torch.launch.serve --device cpu       # without a card

Every ``--arch`` runs, on the card or with ``--device cpu``.  The vision
and audio families get zero frontend stubs (``img_embeds``,
``enc_embeds``), as the JAX package's ``launch/serve.py`` feeds them.
Full-width serving goes through the library: ``serve.engine.generate`` and
``serve.engine.ServeLoop`` on ``models.lm.init(cfg)`` of the full config
(``chip_smoke.py`` serves granite-3-2b, rwkv6-1.6b, recurrentgemma-9b,
minicpm3-4b, llama-3.2-vision-11b, whisper-tiny and the first 8 of
dbrx-132b's 40 layers that way on the card).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs.base import ARCH_IDS, get_config
from ..core.engine import resolve_device
from ..models import lm
from ..serve.engine import Request, ServeLoop, generate


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="granite-3-2b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--mode", choices=["static", "continuous"],
                    default="continuous")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    model = lm.init(cfg, torch.Generator(device=device).manual_seed(
        args.seed), device=device)
    rng = np.random.default_rng(args.seed)

    def extras(n):
        out = {}
        if cfg.img_seq:
            out["img_embeds"] = np.zeros((n, cfg.img_seq, cfg.d_model),
                                         np.float32)
        if cfg.encdec:
            out["enc_embeds"] = np.zeros((n, cfg.encoder_seq, cfg.d_model),
                                         np.float32)
        return out

    t0 = time.time()
    if args.mode == "static":
        prompts = rng.integers(2, cfg.vocab_size,
                               (args.requests, args.prompt_len))
        toks = generate(cfg, model, prompts, max_new_tokens=args.max_new,
                        extras=extras(args.requests))
        print(f"generated {toks.shape} in {time.time() - t0:.1f}s")
        return toks
    sl = ServeLoop(cfg, model, num_slots=args.slots,
                   cache_len=args.prompt_len + args.max_new + 8,
                   extras_fn=extras)
    reqs = [Request(rid=i, prompt=rng.integers(
        2, cfg.vocab_size, args.prompt_len).astype(np.int32),
        max_new=args.max_new) for i in range(args.requests)]
    for r in reqs:
        sl.submit(r)
    steps = sl.run()
    done = sum(r.done for r in reqs)
    tput = sum(len(r.generated) for r in reqs) / (time.time() - t0)
    print(f"{done}/{len(reqs)} requests in {steps} decode steps; "
          f"{tput:.1f} tok/s ({args.slots} slots)")
    return reqs


if __name__ == "__main__":
    main()
