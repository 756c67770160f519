"""AdamW with a cosine schedule and global-norm clipping, on the port's
trees (dicts and lists of tensors), in f32 arithmetic.

The port of the JAX package's `optim/adamw.py`. `low_mem` keeps the two
moments in bf16 (each update still computes in f32). The state is
{"step": int32 scalar, "m": tree, "v": tree}, the moments shaped as the
params; `apply_updates` writes params and moments IN PLACE, one leaf at a
time, so a step holds one leaf's f32 temporaries beside the trees.

Weight decay follows the reference's rule, `decay if p.ndim >= 2`, read
on the reference's arrays: the JAX package stacks a stack's layer params
as (L, ...), so every per-layer vector there (each layer's norm scales,
qkv biases, mamba2's D, A_log and dt_bias) is rank 2 and decayed, while
`final_norm`, `enc_norm` and the unstacked `shared_attn` / `mtp` vectors
are not (ROADMAP F-ref-4). The port keeps one dict a layer, so a leaf
under a list (`layers`, `enc_layers`) counts one rank higher here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    low_mem: bool = False          # bf16 moments


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at `step` (an int tensor), f32: linear warm-up,
    then a cosine down to min_lr_ratio * lr at total_steps. Divisions by
    the constants multiply by their f32 reciprocals, as XLA compiles the
    reference's."""
    step = step.float()
    warm = torch.clamp(step * (1.0 / max(cfg.warmup_steps, 1)), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       * (1.0 / max(cfg.total_steps - cfg.warmup_steps, 1)),
                       0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def leaves(tree, stacked: bool = False) -> Iterator[tuple[torch.Tensor, bool]]:
    """(tensor, under a list) of every tensor leaf, in tree order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v, stacked)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v, True)
    elif isinstance(tree, torch.Tensor):
        yield tree, stacked


def tree_map(fn, tree):
    """The same dicts and lists with fn(leaf) at every tensor leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def decays(p: torch.Tensor, stacked: bool) -> bool:
    """Whether the reference decays this leaf: rank >= 2 counting a
    list's stacking axis (F-ref-4)."""
    return p.dim() + int(stacked) >= 2


def init_state(cfg: AdamWConfig, params) -> dict:
    """Zero moments shaped as `params` (bf16 under low_mem, else f32) on
    the params' devices, and step 0."""
    mdt = torch.bfloat16 if cfg.low_mem else torch.float32
    dev = next(leaves(params))[0].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=mdt, device=p.device)
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares (f32)."""
    return torch.sqrt(torch.sum(torch.stack(
        [torch.sum(torch.square(g.float())) for g, _ in leaves(tree)])))


def clip_scale(cfg: AdamWConfig, gnorm: torch.Tensor) -> torch.Tensor:
    """The factor that clips the gradients to clip_norm (1 below it)."""
    return torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state: dict):
    """One AdamW step -> (params, state, {"grad_norm", "lr"}), the params
    and moments updated in place (the trees returned are the ones given).
    Each leaf computes in f32 as the reference does: the gradient clipped,
    both moments advanced, bias-corrected, then p -= lr * (m̂ / (√v̂ +
    eps) + decay * p)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = clip_scale(cfg, gnorm)
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    for (p, stacked), (g, _), (m, _), (v, _) in zip(
            leaves(params), leaves(grads), leaves(state["m"]),
            leaves(state["v"])):
        g = g.float() * scale
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        delta = (m32 / b1c) / (torch.sqrt(v32 / b2c) + cfg.eps)
        decay = cfg.weight_decay if decays(p, stacked) else 0.0
        pf = p.float()
        p.copy_(pf - lr * (delta + decay * pf))
        m.copy_(m32)
        v.copy_(v32)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
