"""Serving launcher of the port: dual-precision engine over a random or
restored model.

Usage (the card is the default device):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.1-8b \
      --requests 8 --policy dual|fp16|fp8 --kv-planar
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch deepseek-coder-33b --kv-planar      # 67.6 GB served
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
      --reduced --device cpu --ckpt CKPT_DIR
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
      --reduced --device cpu --kv-planar --prompt-len 40
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
      --reduced --device cpu --speculate
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch granite-moe-3b-a800m --kv-planar     # MoE, 48 padded experts
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v3-671b \
      --reduced --device cpu --system-prompt-len 16   # MLA latent blocks
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \
      --reduced --device cpu              # slot-resident SSM state only
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \
      --reduced --device cpu              # + paged shared-attention blocks
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch phi-3-vision-4.2b --reduced --device cpu --kv-planar  # text only
--arch takes every config of `repro_torch.configs` (qwen1.5-0.5b,
llama3.1-8b, gemma3-1b, qwen3-8b, deepseek-coder-33b, the MoE family:
granite-moe-3b-a800m, deepseek-v3-671b, whose MLA pool keeps f16 latent
planes even with --kv-planar; its full 61 layers do not fit one card;
and the recurrent families: mamba2-2.7b (ssm) and zamba2-2.7b (hybrid),
whose state has no prefix cache, whose pools ignore --kv-planar, and
which refuse --speculate: a recurrence cannot roll back rejected
drafts; and phi-3-vision-4.2b, served as a text-only GQA decoder as the
JAX engine serves it. seamless-m4t-large-v2 (encdec) is refused by the
engine, as in the JAX package: the dense-slot steps of `launch/steps.py`
serve it). Random weights are
built layer by layer (`model.init_serving_params`); --ckpt restores the
JAX package's checkpoint format instead (`{"params": ...}`, as its
`launch/serve.py --ckpt` reads), nesting each layer's weights as they are
read (`checkpoint/io.py`). Prints a JSON summary (with
`window_reclaimed_blocks`, the local-layer blocks freed by window slides,
nonzero for a sliding-window arch such as gemma3-1b once sequences
outgrow the window; with --speculate also `spec_acceptance_rate` and
`spec_tokens_per_dispatch`); exits 1 if any request failed to finish.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt", default="",
                    help="a checkpoint in the JAX package's format holding "
                         "{'params': ...} of this config")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=256)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--system-prompt-len", type=int, default=0,
                    help="shared prefix tokens prepended to every request "
                         "(exercises COW prefix caching)")
    ap.add_argument("--no-prefix-cache", action="store_true")
    ap.add_argument("--speculate", action="store_true",
                    help="n-gram speculative decoding (greedy outputs equal "
                         "speculation off; summary gains spec_* fields)")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--policy", default="dual",
                    choices=["dual", "fp16", "fp8"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the hand-written kernels) or 'cpu' "
                         "(their plain PyTorch versions)")
    ap.add_argument("--kv-planar", action="store_true",
                    help="byte-planar NestedKV pool (fp8 decode reads the "
                         "hi planes only)")
    args = ap.parse_args(argv)

    from repro_torch.checkpoint import io
    from repro_torch.configs import get_arch
    from repro_torch.core.policy import DualPrecisionController, SLOConfig
    from repro_torch.device import resolve_device
    from repro_torch.models import model as M
    from repro_torch.models.convert import serving_memory_bytes
    from repro_torch.serving.engine import Engine, Request

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.speculate and cfg.cache_kind in ("ssm", "hybrid"):
        ap.error(f"--speculate: {args.arch} keeps slot-resident recurrent "
                 f"state, which cannot roll back rejected drafts")
    if args.ckpt:
        restored, _ = io.restore(
            args.ckpt, {"params": M.init_params(cfg, device="meta")},
            device=device, serving=True)
        sparams = restored["params"]
    else:
        sparams = M.init_serving_params(cfg, seed=args.seed, device=device)
    mem = serving_memory_bytes(sparams)
    print(f"serving params: {mem['total_bytes']/2**20:.1f} MiB "
          f"({mem['nested_bytes']/max(mem['total_bytes'],1)*100:.0f}% nested)")

    controller = None
    forced = None
    if args.policy == "dual":
        controller = DualPrecisionController(
            SLOConfig(), fp16_ms_per_token=0.5, fp8_ms_per_token=0.25)
    else:
        forced = args.policy

    eng = Engine(cfg, sparams, n_slots=args.slots, capacity=args.capacity,
                 controller=controller, forced_mode=forced,
                 prefix_cache=not args.no_prefix_cache,
                 kv_planar=args.kv_planar, device=device,
                 speculate=args.speculate or None)
    rng = np.random.RandomState(args.seed)
    sys_prompt = list(rng.randint(1, cfg.vocab_size, args.system_prompt_len))
    for i in range(args.requests):
        plen = max(4, int(rng.normal(args.prompt_len, 4)))
        eng.submit(Request(f"r{i}",
                           sys_prompt + list(rng.randint(1, cfg.vocab_size,
                                                         plen)),
                           max_new=args.max_new))
    fin = eng.run()
    n_tokens = sum(len(r.output) for r in fin)
    modes = [m for r in fin for m in r.modes]
    ps = eng.prefix_cache_stats()
    print(json.dumps({
        "device": str(device),
        "finished": len(fin), "tokens": n_tokens,
        "iterations": eng.iteration,
        "fp16_fraction": modes.count("fp16") / max(len(modes), 1),
        "prefix_hit_rate": round(ps["hit_rate"], 3),
        "blocks_saved": ps["blocks_saved"],
        "window_reclaimed_blocks": eng.stats["window_reclaimed_blocks"],
        **({"spec_acceptance_rate":
                round(eng.spec_stats()["acceptance_rate"], 3),
            "spec_tokens_per_dispatch":
                round(eng.spec_stats()["tokens_accepted_per_dispatch"], 3)}
           if args.speculate else {}),
    }))
    return 0 if len(fin) == args.requests else 1


if __name__ == "__main__":
    raise SystemExit(main())
