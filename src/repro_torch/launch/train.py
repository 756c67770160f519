"""Training launcher of the port: end-to-end driver for any --arch.

The JAX package's CLI (the same arguments, printout and exit rule) on
torch: a `model.init_params` tree on the device, AdamW
(`optim/adamw.py`), `SyntheticLM` batches split into --micro
microbatches, and `launch/steps.py::make_train_step`. Exit code 0 only
if the mean of the first 5 losses exceeds the mean of the last 5.
`--ckpt DIR` saves {"params", "opt"} at the last step in the JAX
package's checkpoint format (`checkpoint/io.py`), which both packages
restore; `repro_torch.launch.serve --ckpt DIR` serves from it.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --reduced --steps 100 --batch 8 --seq 128 [--ckpt out/ckpt] \
      [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced (smoke) variant of the arch")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="width multiplier on the reduced config")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card) or 'cpu'")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import (DataConfig, SyntheticLM,
                                           microbatch_split)
    from repro_torch.device import resolve_device
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import adamw

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.scale != 1.0:
        cfg = dataclasses.replace(
            cfg, d_model=int(cfg.d_model * args.scale),
            d_ff=int(cfg.d_ff * args.scale) if cfg.d_ff else 0)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)

    print(f"training {cfg.arch_id}: {cfg.n_layers}L d={cfg.d_model} "
          f"family={cfg.family}")
    params = M.init_params(cfg, seed=args.seed, device=device)
    n_params = sum(p.numel() for p, _ in adamw.leaves(params))
    print(f"params: {n_params/1e6:.1f}M")

    opt_cfg = adamw.AdamWConfig(lr=args.lr, total_steps=args.steps,
                                warmup_steps=max(args.steps // 20, 5))
    opt_state = adamw.init_state(opt_cfg, params)
    step_fn = make_train_step(cfg, opt_cfg)

    data = SyntheticLM(cfg, DataConfig(seq_len=args.seq,
                                       global_batch=args.batch,
                                       seed=args.seed))
    losses = []
    t0 = time.time()
    for i, batch in enumerate(data.batches(args.steps)):
        batch = microbatch_split(batch, args.micro)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i:5d} loss {loss:8.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({time.time()-t0:.1f}s)")

    improved = np.mean(losses[:5]) - np.mean(losses[-5:])
    print(json.dumps({"first5_loss": float(np.mean(losses[:5])),
                      "last5_loss": float(np.mean(losses[-5:])),
                      "improvement": float(improved)}))
    if args.ckpt:
        from repro_torch.checkpoint import io
        io.save(args.ckpt, {"params": params, "opt": opt_state},
                step=args.steps)
        print(f"checkpoint -> {args.ckpt}")
    return 0 if improved > 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
