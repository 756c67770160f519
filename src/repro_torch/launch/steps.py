"""Step functions of the dense-slot serving path (prefill_32k / decode_32k).

  make_prefill_step -> step(params, batch) -> (logits, caches)
  make_decode_step  -> step(params, caches, tokens, cache_len)
                       -> (logits, caches)

As in the JAX package, serving steps run bf16 activations with bf16-
rounded GEMM outputs (`fast_accum`) and the paper's per-tensor FP8
activation scale. The prefill caches are f16; `model.planarize_cache`
turns them into the byte-planar form that FP8 decode reads half of.
Decode writes the caches in place.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M
from repro_torch.models.layers import Runtime


def serve_rt(mode: str) -> Runtime:
    return Runtime(mode=mode, dtype=torch.bfloat16, fast_accum=True)


def make_prefill_step(cfg: ArchConfig, mode: str = "fp16",
                      capacity: int | None = None):
    rt = serve_rt(mode)

    def step(params, batch):
        logits, caches, _ = M.prefill(rt, params, cfg, batch,
                                      capacity=capacity)
        return logits, caches

    return step


def make_decode_step(cfg: ArchConfig, mode: str = "fp16"):
    rt = serve_rt(mode)

    def step(params, caches, tokens, cache_len):
        return M.decode_step(rt, params, cfg, tokens, caches, cache_len)

    return step
