"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 20 --batch 8 --seq 2048 [--ckpt out/ckpt]

Counterpart of ``repro.launch.train`` under the same arguments and
prints, plus ``--device`` (default ``cuda``: without a card it raises
unless ``--device cpu`` is given) and ``--dtype`` (the activation and
parameter dtype; default the config's).  On the CPU use the reduced
configs (``--arch smollm-135m-reduced``).
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data import synthetic_batches
from repro_torch.models import build_model
from repro_torch.train.loop import train_loop
from repro_torch.train.optimizer import OptConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default=None)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype,
                                  param_dtype=args.dtype)
    model = build_model(cfg, device=args.device)
    oc = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                   total_steps=args.steps)
    batches = synthetic_batches(cfg, args.batch, args.seq, args.steps)

    def log(m):
        print(f"step {m['step']:5d} loss {m['loss']:.4f} "
              f"ce {m['ce']:.4f} gnorm {m['grad_norm']:.2f} "
              f"lr {m['lr']:.2e} t {m['wall_s']:.1f}s", flush=True)

    state, history = train_loop(model, batches, oc,
                                log_every=args.log_every, callback=log)
    if args.ckpt:
        f = save_checkpoint(args.ckpt, state["params"], step=args.steps,
                            metadata={"arch": args.arch})
        print("checkpoint:", f)
    first, last = history[0]["loss"], history[-1]["loss"]
    print(f"loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")


if __name__ == "__main__":
    main()
