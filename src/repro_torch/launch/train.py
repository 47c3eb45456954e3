"""End-to-end training from the command line.

By default it trains the *reduced* config of an architecture; ``--full``
trains the full config (granite-3-2b at full width and depth fits one
80 GB card).  Runs on the card unless ``--device cpu``.

  python -m repro_torch.launch.train --arch granite-3-2b --device cpu \\
      --steps 20 --batch 4 --seq 64
  python -m repro_torch.launch.train --arch granite-3-2b --full \\
      --steps 8 --batch 8 --seq 1024 --lr 3e-4 --ckpt-dir build/ckpt

rwkv6-1.6b and recurrentgemma-9b raise ``NotImplementedError``
(``models.lm.check_trainable``).
"""

from __future__ import annotations

import argparse
import json

from ..configs.base import ARCH_IDS, get_config
from ..train.loop import TrainArgs, train, train_local_sgd, \
    train_with_restarts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="granite-3-2b")
    ap.add_argument("--full", action="store_true",
                    help="full config (default reduced)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure (recovered via restart)")
    ap.add_argument("--local-sgd", type=int, default=0,
                    help="worker count for the async local-SGD outer loop")
    ap.add_argument("--sync-period", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    targs = TrainArgs(steps=args.steps, batch_size=args.batch,
                      seq_len=args.seq, lr=args.lr,
                      accum_steps=args.accum, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every,
                      fail_at_step=args.fail_at)
    if args.local_sgd:
        out = train_local_sgd(cfg, targs, workers=args.local_sgd,
                              sync_period=args.sync_period,
                              device=args.device)
    elif args.fail_at is not None:
        out = train_with_restarts(cfg, targs, device=args.device)
    else:
        out = train(cfg, targs, device=args.device, hooks={
            "on_log": lambda m: print(
                f"step {m['step']:5d}  loss {m['loss']:.4f}  "
                f"ppl {m.get('ppl', 0):.1f}  {m['wall_s']:.1f}s")})
    hist = out["history"]
    print(f"final loss: {hist[-1]['loss']:.4f} "
          f"(from {hist[0]['loss']:.4f})")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(hist, f, indent=1)
    return out


if __name__ == "__main__":
    main()
