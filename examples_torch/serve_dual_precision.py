"""Dual-precision serving demo on the PyTorch port: a bursty request
stream through the continuous-batching engine with the SLO controller
flipping between FP16 and FP8 per iteration — the paper's core serving
story.

`--arch` selects any engine-served architecture (its reduced variant):
every family routes through the same paged scheduling path via its
cache descriptor — GQA K/V blocks (qwen3-8b, the default), MLA latent
blocks (deepseek-v3-671b), hybrid shared-attn blocks + slot-resident
SSM state (zamba2-2.7b), pure SSM (mamba2-2.7b), or sliding-window GQA
(gemma3-1b: local-layer blocks are window-slide reclaimed
mid-generation while global-layer blocks stay pinned).

Run: PYTHONPATH=src python examples_torch/serve_dual_precision.py \\
         [--arch deepseek-v3-671b] [--kv-planar] [--device cpu]
"""
import argparse
import sys

import numpy as np

from repro_torch.configs import ARCHS
from repro_torch.core.policy import DualPrecisionController, SLOConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.convert import serving_memory_bytes, to_serving
from repro_torch.serving.engine import Engine, Request

EPILOG = """\
one CUDA graph a step key
  Every engine iteration is at most two model dispatches however many
  sequences are prefilling or decoding: all planned prompt chunks fuse
  into ONE batched ragged paged_step (per-row q_offset/kv_len/
  logit_position carry the raggedness; recurrent stacks run exact-length
  chunks), and the batched decode is one C=1 paged_step. On the card
  each step key — the decode per mode, the fused prefill per (mode, rows
  bucket, chunk bucket) — is a CUDA graph captured at its first use and
  replayed after (serving/graphs.py); a step stages its inputs with one
  host->device copy into the key's static buffers. Block tables are
  device-resident (incremental scatters on allocate/slide/COW), greedy
  sampling runs inside the graph, and the step's token ids come back
  with one host sync at its end (Engine._finalize_step).

kernels
  The device picks the route (kernels/ops.py): on the card the nested
  GEMMs run K1 (FP16) and the per-token quantizer + K2 (FP8), planar
  decode attention K4 (--kv-planar, GQA), and the weights are nested by
  K8; with --device cpu their plain PyTorch versions run.
"""

# a controller calibrated so a full batch trips the SLO guard
SLO = SLOConfig(tpot_ms=33.3, hysteresis_steps=3)
COST = dict(fp16_ms_per_token=0.8, fp8_ms_per_token=0.4,
            fixed_overhead_ms=2.0)


def make_engine(cfg, sparams, *, kv_planar: bool, device):
    """The demo's engine: 8 slots of capacity 128 under the calibrated
    controller. Returns (engine, controller)."""
    ctrl = DualPrecisionController(SLO, **COST)
    eng = Engine(cfg, sparams, n_slots=8, capacity=128, controller=ctrl,
                 kv_planar=kv_planar, device=device)
    return eng, ctrl


def run_traffic(eng, seed: int = 1, tag: str = "") -> None:
    """The demo's traffic: 3 light requests, then a burst of 12, all
    opening with one 32-token system prompt drawn from `seed`."""
    rng = np.random.RandomState(seed)
    # every request opens with the same system prompt — on prefix-
    # cacheable descriptors (gqa/mla) the COW prefix cache shares those KV
    # blocks across the whole burst; recurrent descriptors recompute them
    system_prompt = list(rng.randint(1, 500, 32))
    # light phase: 3 requests; burst: 12 at once
    for i in range(3):
        eng.submit(Request(f"{tag}light{i}",
                           system_prompt + list(rng.randint(1, 500, 12)),
                           max_new=6))
    eng.run(max_iters=eng.iteration + 40)
    for i in range(12):
        eng.submit(Request(f"{tag}burst{i}",
                           system_prompt + list(rng.randint(1, 500, 48)),
                           max_new=8))
    eng.run(max_iters=eng.iteration + 400)


def serve(cfg, sparams, *, kv_planar: bool, device, log=print,
          engine=None, seed: int = 1):
    """The demo: its traffic through one engine (`engine`: an (engine,
    controller) pair of `make_engine` to serve on, a fresh one by
    default), with the JAX example's printout and assertions over this
    call's steps. Returns (engine, controller)."""
    mem = serving_memory_bytes(sparams)
    desc = M.cache_descriptor(cfg)
    log(f"model: {cfg.arch_id}, serving bytes "
        f"{mem['total_bytes']/2**20:.1f} MiB")
    log(f"cache descriptor: {desc.kind}, {desc.bytes_per_token} paged "
        f"B/token, {desc.bytes_per_slot} slot-resident B/seq")
    eng, ctrl = engine or make_engine(cfg, sparams, kv_planar=kv_planar,
                                      device=device)
    n_hist, n_fin, it0 = len(ctrl.history), len(eng.finished), eng.iteration
    ps0, st0 = eng.prefix_cache_stats(), dict(eng.stats)
    # a fresh engine's count includes its block tables' first upload
    h2d0 = 0 if engine is None \
        else eng.stats["h2d_bytes"] + eng.blocks.table_h2d_bytes
    run_traffic(eng, seed)

    hist = ctrl.history[n_hist:]
    log(f"iterations: {len(hist)}, fp16 fraction: "
        f"{hist.count('fp16') / max(len(hist), 1):.2f}")
    log("mode trace: " + "".join("H" if m == "fp16" else "8" for m in hist))
    assert "fp8" in hist and "fp16" in hist, "controller must use both modes"
    ps = {k: v - ps0[k] if k != "hit_rate" else v
          for k, v in eng.prefix_cache_stats().items()}
    log(f"prefix cache: hit rate {ps['hit_rate']:.2f}, "
        f"blocks saved {ps['blocks_saved']}, cow forks {ps['cow_forks']}")
    st = {k: v - st0[k] if isinstance(v, int) else v
          for k, v in eng.stats.items()}
    windowed = any(g.window for g in desc.groups)
    if desc.prefix_cacheable and not windowed:
        assert ps["blocks_saved"] > 0, "shared system prompt never hit the cache"
    if windowed:
        # sliding-window archs: once a holder decodes past the window, the
        # shared prefix's local-layer lookback blocks are slide-freed, so
        # the reuse story is mid-generation block reclamation instead
        log(f"sliding window: {st['window_reclaimed_blocks']} "
            f"local-layer blocks reclaimed mid-generation")
        assert st["window_reclaimed_blocks"] > 0, \
            "long decode never slid a local block"
    steps = max(eng.iteration - it0, 1)
    h2d = eng.stats["h2d_bytes"] + eng.blocks.table_h2d_bytes - h2d0
    log(f"dispatch accounting over {steps} steps: "
        f"{st['prefill_dispatches']/steps:.2f} prefill + "
        f"{st['decode_dispatches']/steps:.2f} decode + "
        f"{st['aux_dispatches']/steps:.2f} aux dispatches/step, "
        f"{h2d/steps:.0f} h2d B/step")
    log(f"finished requests: {len(eng.finished) - n_fin}")
    return eng, ctrl


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter, epilog=EPILOG)
    ap.add_argument("--arch", default="qwen3-8b", choices=sorted(ARCHS),
                    help="architecture (reduced variant); any decoder-only "
                         "family serves through the paged engine")
    ap.add_argument("--kv-planar", action="store_true",
                    help="store GQA KV as NestedKV byte planes (fp8 decode "
                         "reads half the cache bytes)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card, the default) or 'cpu'")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = ARCHS[args.arch].reduced()
    sparams = to_serving(M.init_params(cfg, seed=0, device=device))
    serve(cfg, sparams, kv_planar=args.kv_planar, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
