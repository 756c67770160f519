"""Serving launcher of the port: dual-precision engine over a random model.

Usage (the card is the default device):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.1-8b \
      --requests 8 --policy dual|fp16|fp8 --kv-planar
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
      --reduced --device cpu
Prints a JSON summary; exits 1 if any request failed to finish.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=256)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--system-prompt-len", type=int, default=0,
                    help="shared prefix tokens prepended to every request "
                         "(exercises COW prefix caching)")
    ap.add_argument("--no-prefix-cache", action="store_true")
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

    from repro_torch.configs import get_arch
    from repro_torch.core.policy import DualPrecisionController, SLOConfig
    from repro_torch.device import resolve_device
    from repro_torch.models import model as M
    from repro_torch.models.convert import serving_memory_bytes, to_serving
    from repro_torch.serving.engine import Engine, Request

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    sparams = to_serving(M.init_params(cfg, seed=args.seed, device=device))
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
                 kv_planar=args.kv_planar, device=device)
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
    }))
    return 0 if len(fin) == args.requests else 1


if __name__ == "__main__":
    raise SystemExit(main())
