#!/usr/bin/env python3
"""Drive the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, as a check of the port

Phases, in order; any failed check exits non-zero before the last line:
  1. card     print the card's name and power limit; build the nine CUDA
              kernels from `src/repro_torch/csrc` (one nvcc per source,
              all at once)
  2. kernels  hold each kernel against its plain PyTorch version on the
              card at llama3.1-8b's shapes, and time kernel, plain version
              and one library call (yardstick only) with cold inputs; the
              GEMMs (K1, K2, K3, K7), the decode attentions and the
              per-token quantizer also by CUDA-graph replay (device time)
  3. slice    llama3.1-8b at full width, 2 layers, one planted exception
              tensor: `paged_step` logits, and the dense-slot `prefill` +
              4 `decode_step`s in f32 activations and under `serve_rt`
              (bf16), on the card against the plain versions on the CPU,
              fp16 and fp8, planar KV
  4. serve    llama3.1-8b at full width and depth through `Engine`: 8
              requests of 128 prompt tokens and 32 new tokens in forced
              fp16, forced fp8 and dual mode, each after a warm pass of 8
              other requests that captures the engine's step graphs;
              every kernel must launch, no key may be captured in the
              timed run, every key's replay must be bitwise its eager
              call, and each engine's graphs must go with it
  5. dense    llama3.1-8b at full width and depth through the dense-slot
              steps (`launch/steps.py`): weights nested on the card, 8
              prompts of 1024 tokens prefilled, caches planarized at
              capacity 1056, then the decode step as a CUDA graph (its
              first call captures it, its first replay must be bitwise
              an eager call on cloned caches) and 32 greedy steps that
              replay it and capture nothing, fp16 and fp8; every kernel
              of the path must launch; then the decode step at long
              context: planar caches of capacity 32768 filled with
              random planes, ragged lens up to 32767, fp16 and fp8
  6. gemma_slice  gemma3-1b at full width, 6 layers (0-4 local with a
              window of 512, 5 global): `paged_step` with one block table
              per window group on the card against the plain versions on
              the CPU, prompts of 600 and 520 tokens in chunks of 256 and
              4 decode steps past them, fp16 and fp8, planar KV; then the
              dense-slot prefill (2 x 600 tokens) and 4 decode steps:
              fp16 at 6 layers (the global layer runs K6 at D = 256),
              fp8 at 2 layers, and fp8 at 4 and 6 layers as readings
  7. gemma_serve  gemma3-1b at full width and depth through `Engine`: 8
              requests of 1024 prompt tokens and 64 new tokens in forced
              fp16, forced fp8 and dual mode, then forced fp16 with window
              reclaim off, each after a warm pass; local-layer blocks must
              be reclaimed, fp16 tokens must be equal with reclaim on and
              off, every replay bitwise its eager call
  8. gemma_dense  gemma3-1b at full width, 13 of its 26 layers (DEPTH),
              through the dense-slot steps, as phase 5: K6 must launch
              once a prefill for each global layer; then the decode step
              at capacity 32768
  9. spec     llama3.1-8b at full width, 16 of its 32 layers (DEPTH),
              through `Engine` with n-gram speculation: 8 slots,
              capacity 512, planar KV, 8
              prompts of a 16-token pattern repeated 8 times, 128 new
              tokens, FP16 and FP8, speculation off and on, each engine
              after a warm pass that captures its keys; every spec key is
              captured and each one replayed is held bitwise against its
              eager call; drafts must be accepted and decode dispatches
              cut; each FP16 spec-on stream must equal its spec-off stream
              or part only where the spec-off top-2 logit margin,
              recomputed on the card, is below 1e-3 (FP8: a reading)
 10. tiered   llama3.1-8b at full width and depth with the host KV tier:
              planar KV, 4 slots, capacity 1152, 120 blocks of 16; two
              1024-token system prompts in bursts A, B, A of 4 requests
              (64 own tokens, 32 new); FP16 tier on and off (the third
              burst's TTFT, restore against recompute; tokens by the
              margin rule), FP8 tier on (half the restored bytes a block)
              then a fourth burst in FP16 (lazy lo planes); uploaded
              blocks byte-equal to their host entries; then the prefix
              store is saved, and a new engine on it serves burst A from
              the host tier with the first engine's tokens
 11. gemma_spec  gemma3-1b at full width and depth with speculation: 4
              slots, capacity 1024, 4 prompts of a 24-token pattern
              repeated 32 times, 96 new tokens, FP16 off and on, as phase
              9; the window must slide (local blocks reclaimed)
The kernels phase also holds K4, K5 and K6 at gemma3-1b's heads
(D = 256), and K7 at gemma3-1b's seven GEMM shapes; K4, K5 and K6 at
deepseek-coder-33b's (56 q heads over 8 kv heads, G = 7), and K1, K2,
K3 and K7 at qwen3-8b's and deepseek-coder-33b's seven GEMM shapes.
The rest of the dense family runs in six more phases: the three of
deepseek-coder-33b right after the kernels phase, while the card holds
nothing else, the three of qwen3-8b last:
  ds_slice    deepseek-coder-33b at full width, 2 layers (one planted
              exception tensor), card against CPU as phase 3 (a prefill
              and 2 decode steps a run): paged
              steps FP16 and FP8 (gated), FP8 at 1 and 4 layers
              (readings, not gated), the dense-slot prefill (K6 at G = 7)
              and decode steps in f32 (gated)
  ds_serve    all 62 layers through `Engine` as phase 4, the weights
              streamed onto the card layer by layer (67.6 GB): free and
              total bytes and the structural reckoning of the serving
              tree before the load, the bytes it allocated held to the
              reckoning, what two copies (FP16 + FP8) would take beside
              the card's total; each key's graph pool growth; dual
              mode's FP16 fraction and the controller's reasons
  ds_dense    31 of the 62 layers (DEPTH) through the dense-slot steps
              as phase 5 (K6 at G = 7 in every layer); the 32k decode is
              reckoned, not run
  qwen3_slice, qwen3_serve, qwen3_dense  the same for qwen3-8b (36
              layers, qk_norm; the dense-slot steps at 9: DEPTH): FP8
              readings at 1 and 4 layers, and the 32k decode run as
              llama3.1-8b's
The MoE family runs in five more phases: the two of deepseek-v3 right
after deepseek-coder-33b's, the three of granite-moe-3b after llama's:
  ds3_mla     one deepseek-v3 MLA attention module at full width (128
              heads, latent rank 512), card against CPU in f32: the paged
              phase (a chunk, a chunk over COW-shared blocks, a decode
              step) and the dense-slot prefill and decode phases; FP16
              within 1e-2, FP8 within 0.25, outputs of order 1
  ds3_serve   deepseek-v3 at full width, 1 layer (31.6 GB, streamed leaf
              by leaf, wo an exception tensor), through `Engine` with f16
              latent planes: 4 slots,
              8 requests of 512 tokens sharing a 256-token system prompt,
              32 new, FP16 and FP8; the load held to its reckoning,
              nothing lost, prefix hits on latent blocks, every replay
              bitwise its eager call
  granite_slice  granite-moe-3b at full width, 2 layers (an exception wo
              and an exception bank in layer 1), card against CPU, paged,
              planar KV, f32: held to SLICE_TOL under the routing rule
              (`RoutingCheck`: logits compared where the row's own token
              chose the same experts, flips only at router near-ties); 1
              and 4 layers as readings
  granite_serve  4 of its 32 layers (DEPTH) through `Engine` as phase 4 at
              8 x (1024 + 64), capacity 1088, planar KV, FP16 / FP8 / dual
  granite_dense  4 of its 32 layers through the dense-slot steps as phase 5
              (K6 at G = 3 in every layer; the 32k decode reckoned)
The recurrent families run last, in five more phases (each an exception
out_proj; no attention kernel runs: mamba2 has none, and zamba2's shared
attention reads f16 pools by the gathered path, as the JAX engine):
  mamba2_slice  mamba2-2.7b at full width, 2 layers, card against CPU, f32:
              a 48-token prompt in exact chunks (32 + 16) and a 20-token
              one through `paged_step`, each routed to its slot's state,
              then 4 batched decode steps, FP16 and FP8 within SLICE_TOL;
              `ssd_chunked` and `ssd_decode_step` alone at full width
  mamba2_serve  all 64 layers through `Engine` as granite_serve (8 x
              (1024 + 64), capacity 1088, FP16 / FP8 / dual): state bytes,
              a decode step's nested-linear and state-update device ms
  mamba2_dense  all 64 layers through the dense-slot steps (8 x 1024
              prefill, the decode graph replayed at cache_len 1056 and
              32768: the state is O(1) in the length)
  zamba2_slice  zamba2-2.7b at full width, 6 layers (one group: six Mamba2
              layers and one shared-attention application), as mamba2's:
              FP16 gated at 6 layers; FP8 gated on a 2-layer group
              (attn_every 2), the 6-layer FP8 run a reading (F-port-8)
  zamba2_serve  all 54 layers through `Engine` as mamba2_serve, the shared
              attention's K/V in f16 paged pools
  zamba2_dense  18 of the 54 layers (DEPTH) through the dense-slot steps:
              the shared attention's caches prefilled (K6 at D = 80) and
              planarized, the decode graph (K5 at D = 80) at capacity
              1056 and at 32768
The kernels phase also holds K1, K2, K3 and K7 at mamba2-2.7b's five GEMM
shapes and at zamba2-2.7b's in_bc and shared block.
The stub-frontend families run last, in five more phases (an exception
wo in each):
  phi3_slice  phi-3-vision-4.2b at full width (32 heads of 96), 2 layers,
              card against CPU as ds_slice (the dense-slot prefill with
              576 stub patches ahead of 48 tokens, its FP8 run gated at
              PHI3_DENSE_FP8_TOL: F-port-9); paged FP8 at 4 layers gated
              at DEEP_FP8_TOL
  phi3_serve  16 of the 32 layers (DEPTH) through `Engine`, text only as
              in the JAX engine: 8 x (1024 + 64), capacity 1088, planar
              KV, FP16 / FP8 / dual (K4 at D = 96)
  phi3_dense  16 of the 32 layers (DEPTH) through the dense-slot steps:
              8 x (576 patches + 1024 tokens) prefilled (K6 at D = 96),
              the decode graph replayed (K5 at D = 96)
  seamless_slice  seamless-m4t-v2 at full width, 2 encoder + 2 decoder
              layers, dense-slot prefill over 64 stub frames a row and 4
              decode steps through the cross caches, card against CPU in
              f32: FP16 and FP8 on the CPU's encoder memory gated at
              SLICE_TOL, the whole FP8 chain at SEAMLESS_CHAIN_FP8_TOL
              (F-port-9)
  seamless_dense  24 + 24 layers through the dense-slot steps: 8 x 1024
              tokens over 128 frames a row (the encoder's ms apart), 64
              replayed decode steps
The kernels phase also holds K4 at D = 96 (phi3's heads) and K5 and K6 at
D = 80 (zamba2's shared attention) and 96; each instance is an entry of
its own in the kernels line ("flash_prefill_attention@D80", ...), its
launches those of the phase whose model alone has that head dim.
Serving meshes run last, every shard on the one card (their times are
those of shards sharing a card, not of tensor parallelism across cards):
  tp_serve  llama3.1-8b at full width, 8 layers (DEPTH, layer 0's wo an
            exception tensor) through `Engine(mesh=...)` on 2 and 4
            shards and unsharded, 8 x (128 + 32) after a warm pass, FP16,
            FP8 and dual: first-decode logits against the unsharded model
            (FP16 at 8 layers, FP8 at 2 / 4 / 8 layers within 0.25 /
            0.35 / 0.50, the 8-layer limit set by F-port-10 beside its
            CPU control's reading), tokens under the
            margin rule, stats equal, every first replay bitwise, K1-K4
            and the quantizer halves launched at every per-shard shape
  tp_gemma  gemma3-1b at full width and depth on 4 shards (one q head
            each, the kv head and its pool whole on every shard, K4 at
            G = 1), 8 x (640 + 32), window reclaim on, FP16 and FP8,
            held as tp_serve holds its meshes
  tp_fleet  Router.build(meshes=make_replica_meshes(2, 2, ...)), llama3.1-
            8b at 4 layers: a planned kill (nothing lost, the survivor
            serves on) and a rebuild after a failed drain (the old
            engine's shard slices and pools freed, the other replica
            untouched)
  tp_moe    granite-moe-3b at full width, 4 layers, on 2 and 4 shards
            (expert-parallel banks), tp_ssm mamba2-2.7b, 8 layers, and
            tp_hybrid zamba2-2.7b, 12 layers (two shared-attention
            applications), on 4 (logits on 2 and 4): each beside the
            unsharded engine, FP16 and FP8, held as tp_serve holds its
            meshes, MoE logits under the routing rule, step keys equal,
            and every parting stream replayed as the engine ran it
            (`stream_replays`); ds3_mla also runs its module on 2 and 4
            shards against the unsharded module on the card
The kernels phase times K1, K2, K3, K4 and the quantizer's halves
(`row_absmax`, `quant_per_token_scaled`) at the per-shard shapes; the
kernels line has an entry "<kernel>@tp4" for each of K1-K4 at
llama3.1-8b's shard of 4, one for each half, and "<kernel>@<model>-tp4"
for K1-K3 at granite's, mamba2's, zamba2's and deepseek-v3's MLA shards
of 4 and K4 at granite's.
Training runs last, in three phases (no kernel runs in a train step: its
products are plain bf16 / f32 torch ops, as the reference's are XLA's):
  train_slice  qwen1.5-0.5b at full width, 2 layers: one train_loss and
            backward in f32 activations on the card against the CPU on
            the same weights and 2 x 128 tokens (loss within 1e-5,
            every gradient within a relative L2 of 1e-4), one
            apply_updates of those gradients on both (within 1e-6), and
            the loss in bf16 activations (TRAIN_RT) within 2e-2 of f32
  train     llama3.1-8b at full width, 4 layers (DEPTH): 10
            make_train_step steps of 4 x 2048 tokens in 2 microbatches;
            the reckoned bytes of params, gradients and moments beside
            the peak allocated, the losses finite and falling by the
            launcher's rule, step ms and tokens/s
  train_serve  qwen1.5-0.5b at full width and depth: launch/train.py for
            10 steps with --ckpt (5.6 GB, deleted after), {"params"}
            restored nested (K8), one wo planted as an exception tensor
            (K3), served through Engine in FP16, FP8 and dual as phase 4
The second-to-last line is the kernels JSON, the last line
{"ok": true, "device": {...}}. Exits non-zero without a result when no
GPU is present or the port is missing.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# torch.profiler leaves CUPTI subscribed after a session unless told to
# tear it down, and a subscribed CUPTI makes every later launch of a CUDA
# graph pay for each of its kernel nodes: on an H100 the launch of
# gemma3-1b's dense decode graph took 0.9-1.6 ms of host time after a
# profile, 0.03-0.05 ms with CUPTI torn down. A timed run after a profile
# would measure the profiler.
os.environ.setdefault("TEARDOWN_CUPTI", "1")

# H100 SXM published peaks (dense), the card's memory rate
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"f16": 989e12, "fp8": 1979e12, "f32": 67e12}
L2_BYTES = 50 * 2**20
GEMM_RTOL, GEMM_ATOL = 1e-3, 1e-2     # f32 outputs of f16 inputs, K <= 14336
ATTN_TOL = 2e-4
LLAMA_KN = [(4096, 4096), (4096, 1024), (4096, 1024), (4096, 4096),
            (4096, 14336), (4096, 14336), (14336, 4096)]  # q k v o gate up down


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def bound(nbytes: float, flops: float, kind: str) -> tuple[float, str]:
    tb = nbytes / PEAK_BYTES_S * 1e3
    tf = flops / PEAK_FLOPS[kind] * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def time_ms(torch, fn, n_sets: int, iters: int) -> float:
    """ms per call by CUDA events, after warm-up, cycling through `n_sets`
    input sets (cold in L2): `iters` calls in 5 groups, the median of the
    groups' means. A stall of the host idles the card inside one group;
    the median drops that group. Each group starts behind one untimed
    call, so the card is busy when timing starts."""
    for i in range(min(n_sets, 3)):
        fn(i)
    torch.cuda.synchronize()
    groups = 5
    per = max(1, iters // groups)
    means = []
    for g in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        fn((g * per - 1) % n_sets)     # the set before, as in a cycle
        start.record()
        for i in range(per):
            fn((g * per + i) % n_sets)
        end.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(end) / per)
    return sorted(means)[len(means) // 2]


def max_err(torch, got, want, rtol, atol) -> float:
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), "non-finite kernel output")
    err = (got - want).abs()
    lim = atol + rtol * want.abs()
    check(bool((err <= lim).all()),
          f"kernel vs plain: max err {err.max().item():.3g} beyond "
          f"atol {atol} + rtol {rtol}")
    return float(err.max())


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def gemm_phase(torch, iters: int) -> list[dict]:
    """K1, K2, K3 at llama3.1-8b's GEMM shapes, M = 8 (decode), 256 and
    8192 (a prefill of 8 x 1024), and at ragged M, N and K. Each also by
    CUDA-graph replay (device ms) beside its library call (K1, K3:
    torch.matmul; K2: row-wise torch._scaled_mm), with the dynamic shared
    memory of the body that runs."""
    from repro_torch.core import nestedfp as nf
    from repro_torch.core import quant
    from repro_torch.kernels import ref
    from repro_torch.kernels.f16_matmul import dynamic_smem_bytes as smem_k3
    from repro_torch.kernels.f16_matmul import f16_matmul
    from repro_torch.kernels.nestedfp16_matmul import (
        dynamic_smem_bytes as smem_k1)
    from repro_torch.kernels.nestedfp16_matmul import nestedfp16_matmul
    from repro_torch.kernels.nestedfp8_matmul import (
        dynamic_smem_bytes as smem_k2)
    from repro_torch.kernels.nestedfp8_matmul import nestedfp8_matmul

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = [(m, k, n) for m in (8, 256, 8192)
              for k, n in dict.fromkeys(LLAMA_KN)]
    shapes += [(37, 999, 1001), (5, 4096, 1000)]     # ragged M, N and K
    rows = {"nestedfp16_matmul": [], "nestedfp8_matmul": [], "f16_matmul": []}
    for m, k, n in shapes:
        wbytes = k * n
        n_sets = max(2, math.ceil(2 * L2_BYTES / wbytes) + 1)
        ws = [(torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
               ).half() for _ in range(n_sets)]
        planes = [nf.encode(w) for w in ws]
        x = torch.randn((m, k), generator=gen, device=dev)
        x16 = x.half()
        xq, xs = quant.quantize_act_per_token(x)
        flops = 2.0 * m * k * n
        out_b = m * n * 4

        def f16_lib(i):
            return torch.matmul(x16, ws[i])

        cases = {
            "nestedfp16_matmul": (
                lambda i: nestedfp16_matmul(x16, *planes[i]),
                lambda i: ref.nestedfp16_matmul_ref(x16, *planes[i]),
                f16_lib, m * k * 2 + 2 * k * n + out_b, "f16"),
            "nestedfp8_matmul": (
                lambda i: nestedfp8_matmul(xq, planes[i][0], xs),
                lambda i: ref.nestedfp8_matmul_ref(xq, planes[i][0], xs),
                None, m * k + k * n + m * 4 + out_b, "fp8"),
            "f16_matmul": (
                lambda i: f16_matmul(x16, ws[i]),
                lambda i: ref.matmul_f16_ref(x16, ws[i]),
                f16_lib, m * k * 2 + 2 * k * n + out_b, "f16"),
        }
        lib8 = scaled_mm_yardstick(torch, xq, xs, [p[0] for p in planes])
        smem = {"nestedfp16_matmul": smem_k1(x16, *planes[0]),
                "nestedfp8_matmul": smem_k2(xq, planes[0][0]),
                "f16_matmul": smem_k3(x16, ws[0])}
        for name, (kern, plain, lib, nbytes, kind) in cases.items():
            err = max_err(torch, kern(0), plain(0), GEMM_RTOL, GEMM_ATOL)
            if name == "nestedfp8_matmul":
                lib = lib8
            b_ms, b_kind = bound(nbytes, flops, kind)
            row = {"m": m, "k": k, "n": n, "max_abs_err": err,
                   "ms": time_ms(torch, kern, n_sets, iters),
                   "plain_ms": time_ms(torch, plain, n_sets, iters),
                   "library_ms": None if lib is None
                   else time_ms(torch, lib, n_sets, iters),
                   "bound_ms": b_ms, "bound_by": b_kind}
            extra = ""
            if name in smem:
                row["device_ms"] = graph_ms(torch, kern, n_sets)
                row["library_device_ms"] = (None if lib is None
                                            else graph_ms(torch, lib, n_sets))
                row["smem_bytes"] = smem[name]
                lib_d = row["library_device_ms"]
                extra = (f" device={row['device_ms']:.4f} lib_device="
                         f"{None if lib_d is None else round(lib_d, 4)} "
                         f"smem={row['smem_bytes']} B")
            rows[name].append(row)
            log(f"  {name:18s} M={m:4d} K={k:5d} N={n:5d} err={err:.2e} "
                f"ms={row['ms']:.4f} plain={row['plain_ms']:.4f} "
                f"lib={row['library_ms'] if lib is None else round(row['library_ms'], 4)} "
                f"bound={b_ms:.4f} ({b_kind}){extra}")
        del ws, planes
    gemm_layer_sums(rows)
    return rows


def gemm_layer_sums(rows: dict) -> None:
    """Log one llama3.1-8b layer's seven GEMMs for K1, K3 and torch.matmul,
    and for K2 and row-wise torch._scaled_mm, at M = 8, 256 and 8192:
    host-timed and device (graph replay) sums, the bounds, the K1/K3
    ratio (the cost of the rebuild, paper Fig. 7) and K2/_scaled_mm."""
    for m in (8, 256, 8192):
        sums = {}
        for name in ("nestedfp16_matmul", "f16_matmul", "nestedfp8_matmul"):
            sel = [(r, LLAMA_KN.count((r["k"], r["n"]))) for r in rows[name]
                   if r["m"] == m and (r["k"], r["n"]) in LLAMA_KN]
            sums[name] = {key: None if any(r[key] is None for r, _ in sel)
                          else sum(r[key] * w for r, w in sel)
                          for key in ("ms", "device_ms", "library_ms",
                                      "library_device_ms", "bound_ms")}
        k1, k3 = sums["nestedfp16_matmul"], sums["f16_matmul"]
        k2 = sums["nestedfp8_matmul"]
        lib = ("refused" if k2["library_ms"] is None else
               f"{k2['library_ms']:.4f} (device "
               f"{k2['library_device_ms']:.4f}); K2/_scaled_mm "
               f"{k2['ms'] / k2['library_ms']:.3f} (device "
               f"{k2['device_ms'] / k2['library_device_ms']:.3f})")
        log(f"  layer M={m}: K2 {k2['ms']:.4f} ms (device "
            f"{k2['device_ms']:.4f}), bound {k2['bound_ms']:.4f}, device "
            f"share of bound {k2['bound_ms'] / k2['device_ms']:.3f}; "
            f"row-wise _scaled_mm {lib}")
        log(f"  layer M={m}: K1 {k1['ms']:.4f} ms (device "
            f"{k1['device_ms']:.4f}), K3 {k3['ms']:.4f} (device "
            f"{k3['device_ms']:.4f}), torch.matmul {k1['library_ms']:.4f} "
            f"(device {k1['library_device_ms']:.4f}), bound "
            f"{k1['bound_ms']:.4f}; K1/K3 {k1['ms'] / k3['ms']:.3f} (device "
            f"{k1['device_ms'] / k3['device_ms']:.3f}), K1/matmul "
            f"{k1['ms'] / k1['library_ms']:.3f} (device "
            f"{k1['device_ms'] / k1['library_device_ms']:.3f})")


# (K, N) of one layer's seven GEMMs, q k v o gate up down
QWEN3_KN = [(4096, 4096), (4096, 1024), (4096, 1024), (4096, 4096),
            (4096, 12288), (4096, 12288), (12288, 4096)]
DS_KN = [(7168, 7168), (7168, 1024), (7168, 1024), (7168, 7168),
         (7168, 19200), (7168, 19200), (19200, 7168)]


def family_gemm_phase(torch, rows: dict, model: str, kn,
                      ms=(8, 256)) -> None:
    """K1, K2, K3 and K7 at one model's GEMM shapes, M in `ms` (8: a
    decode step of 8 rows; 256): each against its plain version on fresh
    inputs, its device ms by CUDA-graph replay beside its library call's
    (torch.matmul f16 for K1 and K3, torch._scaled_mm row-wise for K2 and
    tensor-wise for K7), and its bound. Rows go to `rows` tagged with the
    model (the kernels line counts llama3.1-8b's alone); then one layer's
    sums a kernel."""
    from repro_torch.core import nestedfp as nf
    from repro_torch.core import quant
    from repro_torch.kernels import ref
    from repro_torch.kernels.f16_matmul import f16_matmul
    from repro_torch.kernels.nestedfp16_matmul import nestedfp16_matmul
    from repro_torch.kernels.nestedfp8_matmul import nestedfp8_matmul
    from repro_torch.kernels.nestedfp8_matmul_fused_quant import (
        nestedfp8_matmul_fused_quant)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    names = ("nestedfp16_matmul", "nestedfp8_matmul", "f16_matmul",
             "nestedfp8_matmul_fused_quant")
    mine = []
    for k, n in dict.fromkeys(kn):
        n_sets = max(2, math.ceil(2 * L2_BYTES / (k * n)) + 1)
        ws = [(torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
               ).half() for _ in range(n_sets)]
        planes = [nf.encode(w) for w in ws]
        for m in ms:
            x = torch.randn((m, k), generator=gen, device=dev)
            x16, xb = x.half(), x.bfloat16()
            xq, xs = quant.quantize_act_per_token(x)
            amax = quant.absmax(xb).reshape(1)
            tq, ts = quant.quantize_act_per_tensor(xb)
            out_b = m * n * 4
            cases = {
                "nestedfp16_matmul": (
                    lambda i: nestedfp16_matmul(x16, *planes[i]),
                    lambda i: ref.nestedfp16_matmul_ref(x16, *planes[i]),
                    lambda i: torch.matmul(x16, ws[i]),
                    m * k * 2 + 2 * k * n + out_b, "f16"),
                "nestedfp8_matmul": (
                    lambda i: nestedfp8_matmul(xq, planes[i][0], xs),
                    lambda i: ref.nestedfp8_matmul_ref(xq, planes[i][0], xs),
                    scaled_mm_yardstick(torch, xq, xs, [p[0] for p in planes]),
                    m * k + k * n + m * 4 + out_b, "fp8"),
                "f16_matmul": (
                    lambda i: f16_matmul(x16, ws[i]),
                    lambda i: ref.matmul_f16_ref(x16, ws[i]),
                    lambda i: torch.matmul(x16, ws[i]),
                    m * k * 2 + 2 * k * n + out_b, "f16"),
                "nestedfp8_matmul_fused_quant": (
                    lambda i: nestedfp8_matmul_fused_quant(xb, planes[i][0],
                                                           amax),
                    lambda i: ref.nestedfp8_matmul_fused_quant_ref(
                        xb, planes[i][0], amax),
                    scaled_mm_yardstick(torch, tq, ts, [p[0] for p in planes]),
                    m * k * 2 + k * n + 4 + out_b, "fp8"),
            }
            for name in names:
                kern, plain, lib, nbytes, kind = cases[name]
                err = max_err(torch, kern(0), plain(0), GEMM_RTOL, GEMM_ATOL)
                b_ms, b_kind = bound(nbytes, 2.0 * m * k * n, kind)
                row = {"model": model, "m": m, "k": k, "n": n,
                       "max_abs_err": err, "bound_ms": b_ms,
                       "bound_by": b_kind,
                       "device_ms": graph_ms(torch, kern, n_sets),
                       "library_device_ms": None if lib is None
                       else graph_ms(torch, lib, n_sets)}
                rows[name].append(row)
                mine.append((name, row))
                lib_d = row["library_device_ms"]
                log(f"  {name:28s} {model} M={m:3d} K={k:5d} N={n:5d} "
                    f"err={err:.2e} device={row['device_ms']:.4f} lib_device="
                    f"{None if lib_d is None else round(lib_d, 4)} "
                    f"bound={b_ms:.4f} ({b_kind})")
            del x, x16, xb, xq, tq
        del ws, planes
    for m in ms:
        for name in names:
            sel = [(r, kn.count((r["k"], r["n"]))) for nm, r in mine
                   if nm == name and r["m"] == m]
            dev_ms = sum(r["device_ms"] * w for r, w in sel)
            lib = (None if any(r["library_device_ms"] is None for r, _ in sel)
                   else sum(r["library_device_ms"] * w for r, w in sel))
            b_ms = sum(r["bound_ms"] * w for r, w in sel)
            log(f"  layer {model} M={m}: {name} device {dev_ms:.4f} ms, "
                f"library {None if lib is None else round(lib, 4)}"
                f"{'' if lib is None else f' (ratio {dev_ms / lib:.3f})'}, "
                f"bound {b_ms:.4f} (share {b_ms / dev_ms:.3f})")


def k6_baseline(torch, source: str):
    """K6's C entry point built from another checkout's
    `flash_prefill_attention.cu` (same nvcc flags), wrapped like
    `flash_prefill_attention`, for a bitwise comparison of the two
    builds."""
    import ctypes
    import hashlib

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_prefill_attention as k6
    from repro_torch.kernels._common import stream_handle

    src = Path(source)
    lib = _build.BUILD_DIR / (
        "k6_baseline-" + hashlib.sha256(src.read_bytes()).hexdigest()[:16]
        + ".so")
    if not lib.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                        str(lib), str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).flash_prefill_attention
    fn.argtypes, fn.restype = k6._ARGS, ctypes.c_int

    def call(q, k, v):
        b, s, h, d = q.shape
        out = torch.empty((b, s, h, d), dtype=torch.float32, device=q.device)
        _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), k6._DTYPES[q.dtype], b, s, h,
                        k.shape[2], d, float(d ** -0.5),
                        stream_handle(q.device)), "K6 baseline")
        return out
    log(f"  K6 baseline built from {source}")
    return call


def scaled_mm_yardstick(torch, xq, xs, uppers):
    """torch._scaled_mm on the same e4m3 operands (weights copied to the
    column-major layout it requires, M padded to 16; bf16 output), with
    row-wise scales for an (M, 1) xs and one scalar scale for a 1-element
    xs, or None where it refuses the inputs. A yardstick only; the port
    never calls it."""
    m = xq.shape[0]
    mp = -(-m // 16) * 16
    rowwise = xs.numel() > 1
    if mp != m:
        pad = torch.zeros((mp - m, xq.shape[1]), device=xq.device,
                          dtype=torch.uint8)
        xq = torch.cat([xq.view(torch.uint8), pad]).view(torch.float8_e4m3fn)
        if rowwise:
            xs = torch.cat([xs, torch.ones((mp - m, 1), device=xs.device)])
    w8 = [u.t().contiguous().t().view(torch.float8_e4m3fn) for u in uppers]
    if rowwise:
        sb = torch.full((1, uppers[0].shape[1]), 2.0 ** -8, device=xq.device)
    else:
        xs = xs.reshape(()).float()
        sb = torch.tensor(2.0 ** -8, device=xq.device)
    fn = (lambda i: torch._scaled_mm(xq, w8[i], scale_a=xs, scale_b=sb,
                                     out_dtype=torch.bfloat16))
    try:
        fn(0)
    except (RuntimeError, TypeError, ValueError) as e:
        log(f"  _scaled_mm refused the inputs ({type(e).__name__}: "
            f"{str(e).splitlines()[0][:120]}); library_ms null")
        return None
    return fn


def attention_phase(torch, iters: int, *, h=32, hkv=8, d=128, mb=16,
                    lens_l=(160, 129, 17, 1, 256, 0, 100, 33),
                    windows=(None, 0, 40)) -> list[dict]:
    """K4 over a paged pool of blocks of 16 keys: llama3.1-8b's heads,
    8 rows of lens <= 256 by default; gemma3-1b's (4 q heads, 1 kv head,
    D = 256) at lens <= 1088 and windows 0 and 512 from the gemma kernels
    phase."""
    import torch.nn.functional as F

    from repro_torch.core import nestedfp as nf
    from repro_torch.kernels import ref
    from repro_torch.kernels.planar_decode_attention import (
        paged_planar_decode_attention)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    b, bs = len(lens_l), 16
    nb = 1 + b * mb
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    # shuffled physical blocks; rows 1 and 6 share their first 2 blocks
    # (COW prefix aliasing); holes past each row's length are trash
    perm = torch.randperm(nb - 1, generator=gen, device=dev).to(torch.int32) + 1
    tables = perm[: b * mb].reshape(b, mb).clone()
    tables[6, :2] = tables[1, :2]
    for r in range(b):
        used = -(-int(lens[r]) // bs)
        tables[r, used:] = 0
    q = torch.randn((b, h, d), generator=gen, device=dev)
    rows = []
    for fp8 in (False, True):
        for window in windows:
            n_sets = 4
            pools = []
            for _ in range(n_sets):
                kv = (torch.randn((2, nb, bs, hkv, d), generator=gen,
                                  device=dev)).half()
                k_hi, k_lo = nf.split_bytes(kv[0])
                v_hi, v_lo = nf.split_bytes(kv[1])
                pools.append((k_hi, k_lo, v_hi, v_lo))

            def kern(i):
                return paged_planar_decode_attention(
                    q, *pools[i], tables, lens, fp8=fp8, window=window)

            def plain(i):
                return ref.paged_planar_decode_attention_ref(
                    q, *pools[i], tables, lens, fp8=fp8, window=window)

            live = lens > 0
            err = max_err(torch, kern(0)[live], plain(0)[live], ATTN_TOL,
                          ATTN_TOL)
            check(bool(torch.isfinite(kern(0)).all()), "len=0 row not finite")
            # bytes this data needs: the keys each row attends to
            w = window if window and window > 0 else None
            keys = sum(min(int(n), w) if w else int(n) for n in lens.tolist())
            plane_b = 1 if fp8 else 2
            nbytes = (keys * hkv * d * 2 * plane_b + q.numel() * 4
                      + tables.numel() * 4 + b * 4 + b * h * d * 4)
            flops = 4.0 * keys * (h // hkv) * hkv * d
            b_ms, b_kind = bound(nbytes, flops, "f32")
            lib = sdpa_yardstick(torch, F, q, pools, tables, lens, fp8, w)
            row = {"h": h, "hkv": hkv, "d": d, "fp8": fp8, "window": window,
                   "max_abs_err": err,
                   "ms": time_ms(torch, kern, n_sets, iters),
                   "plain_ms": time_ms(torch, plain, n_sets, iters),
                   "library_ms": time_ms(torch, lib, n_sets, iters),
                   "bound_ms": b_ms, "bound_by": b_kind,
                   **device_times(torch, kern, lib, n_sets, b_ms)}
            rows.append(row)
            log(f"  paged_planar_decode_attention H={h} Hkv={hkv} D={d} "
                f"fp8={fp8} "
                f"window={window} kept keys={keys} "
                f"err={err:.2e} ms={row['ms']:.4f} plain={row['plain_ms']:.4f}"
                f" lib={row['library_ms']:.4f} bound={b_ms:.5f} ({b_kind}) "
                f"device={row['device_ms']:.4f} lib_device="
                f"{row['library_device_ms']:.4f} share={row['bound_share']:.3f}")
    return rows


def sdpa_yardstick(torch, F, q, pools, tables, lens, fp8, window):
    """scaled_dot_product_attention over K/V gathered (outside the timed
    call) from the pool and joined to f16, with the same masks."""
    from repro_torch.core import nestedfp as nf
    b, h, d = q.shape
    bs, hkv = pools[0][0].shape[1], pools[0][0].shape[2]
    mb = tables.shape[1]
    cap = mb * bs
    idx = (tables.long()[..., None] * bs
           + torch.arange(bs, device=q.device)).reshape(b, cap)
    kpos = torch.arange(cap, device=q.device)[None]
    keep = kpos < lens[:, None]
    if window:
        keep &= kpos > lens[:, None] - 1 - window
    mask = keep[:, None, None, :]
    qh = q.half()[:, :, None, :]
    gathered = []
    for k_hi, k_lo, v_hi, v_lo in pools:
        def g(hi, lo):
            hi = hi.reshape(-1, hkv, d)[idx]
            if fp8:
                return nf.e5m2_view(hi, torch.float16)
            return nf.join_bytes(hi, lo.reshape(-1, hkv, d)[idx])
        gathered.append((g(k_hi, k_lo).transpose(1, 2),
                         g(v_hi, v_lo).transpose(1, 2)))

    def fn(i):
        k, v = gathered[i]
        return F.scaled_dot_product_attention(qh, k, v, attn_mask=mask,
                                              enable_gqa=True)
    return fn


def device_times(torch, kern, lib, n_sets: int, b_ms: float) -> dict:
    """Device ms of a kernel and of its library yardstick by CUDA-graph
    replay, and the kernel's share of the bound."""
    dev_ms = graph_ms(torch, kern, n_sets)
    return {"device_ms": dev_ms,
            "library_device_ms": graph_ms(torch, lib, n_sets),
            "bound_share": b_ms / dev_ms}


def graph_ms(torch, fn, n_sets: int, reps: int = 30) -> float:
    """Device ms per call: `reps` calls (cycling through the input sets)
    captured in one CUDA graph and replayed, so host overhead between the
    launches is gone. For calls too small to keep the card busy from the
    host (decode M)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(0)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=side):
            for i in range(reps):
                fn(i % n_sets)
    torch.cuda.current_stream().wait_stream(side)
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def fused_quant_phase(torch, iters: int) -> list[dict]:
    """K7 at llama3.1-8b's seven GEMM shapes, M = 8 (decode), 256 and 8192
    (a prefill of 8 x 1024), on bf16 activations as the serving runtime
    gives them, each held against the plain version (a repeated shape is
    checked on fresh inputs, timed once); then ragged shapes in f32, f16
    and bf16. Beside the host-timed ms, the device ms of K7 and of
    `_scaled_mm` from CUDA-graph replay, the achieved TFLOP/s, the share
    of the bound and the dynamic shared memory of the body that runs."""
    from repro_torch.core import nestedfp as nf
    from repro_torch.core import quant
    from repro_torch.kernels import ref
    from repro_torch.kernels.nestedfp8_matmul_fused_quant import (
        dynamic_smem_bytes, nestedfp8_matmul_fused_quant)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    rows = []
    err_k14336 = 0.0
    for k, n in dict.fromkeys(LLAMA_KN):
        n_sets = max(2, math.ceil(2 * L2_BYTES / (k * n)) + 1)
        uppers = [nf.encode((torch.randn((k, n), generator=gen, device=dev)
                             * k ** -0.5).half())[0] for _ in range(n_sets)]
        for m in (8, 256, 8192):
            errs = []
            for _ in range(LLAMA_KN.count((k, n))):   # every GEMM of a layer
                x = torch.randn((m, k), generator=gen, device=dev).bfloat16()
                amax = quant.absmax(x).reshape(1)
                errs.append(max_err(
                    torch, nestedfp8_matmul_fused_quant(x, uppers[0], amax),
                    ref.nestedfp8_matmul_fused_quant_ref(x, uppers[0], amax),
                    GEMM_RTOL, GEMM_ATOL))
            xq, xs = quant.quantize_act_per_tensor(x)

            def kern(i):
                return nestedfp8_matmul_fused_quant(x, uppers[i], amax)

            def plain(i):
                return ref.nestedfp8_matmul_fused_quant_ref(x, uppers[i], amax)

            lib = scaled_mm_yardstick(torch, xq, xs, uppers)
            flops = 2.0 * m * k * n
            b_ms, b_kind = bound(m * k * 2 + k * n + 4 + m * n * 4, flops,
                                 "fp8")
            row = {"m": m, "k": k, "n": n, "max_abs_err": max(errs),
                   "ms": time_ms(torch, kern, n_sets, iters),
                   "plain_ms": time_ms(torch, plain, n_sets, iters),
                   "library_ms": None if lib is None
                   else time_ms(torch, lib, n_sets, iters),
                   "bound_ms": b_ms, "bound_by": b_kind,
                   "device_ms": graph_ms(torch, kern, n_sets),
                   "library_device_ms": None if lib is None
                   else graph_ms(torch, lib, n_sets),
                   "smem_bytes": dynamic_smem_bytes(uppers[0], m)}
            row["tflops"] = flops / row["device_ms"] / 1e9
            row["bound_share"] = b_ms / row["device_ms"]
            if k == 14336:
                err_k14336 = max(err_k14336, row["max_abs_err"])
            rows.append(row)
            lib_d = row["library_device_ms"]
            log(f"  nestedfp8_matmul_fused_quant M={m:4d} K={k:5d} N={n:5d} "
                f"err={row['max_abs_err']:.2e} ms={row['ms']:.4f} "
                f"plain={row['plain_ms']:.4f} lib={row['library_ms']} "
                f"device={row['device_ms']:.4f} lib_device="
                f"{None if lib_d is None else round(lib_d, 4)} "
                f"{row['tflops']:.1f} TFLOP/s, {row['bound_share']:.3f} of "
                f"bound={b_ms:.4f} ({b_kind}), smem={row['smem_bytes']} B")
            del x, xq
        del uppers
    log(f"  nestedfp8_matmul_fused_quant max |kernel - plain| at K = 14336: "
        f"{err_k14336:.3e} (atol {GEMM_ATOL}, rtol {GEMM_RTOL})")
    for m, k, n in ((37, 999, 1001), (37, 1040, 1008), (100, 48, 80),
                    (1, 64, 8)):
        u = nf.encode((torch.randn((k, n), generator=gen, device=dev)
                       * k ** -0.5).half())[0]
        for dtype in (torch.float32, torch.float16, torch.bfloat16):
            x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
            amax = quant.absmax(x).reshape(1)
            err = max_err(torch, nestedfp8_matmul_fused_quant(x, u, amax),
                          ref.nestedfp8_matmul_fused_quant_ref(x, u, amax),
                          GEMM_RTOL, GEMM_ATOL)
            log(f"  nestedfp8_matmul_fused_quant ragged M={m} K={k} N={n} "
                f"{str(dtype)[6:]} err={err:.2e} smem="
                f"{dynamic_smem_bytes(u, m)} B")
    return rows


# gemma3-1b's seven GEMMs of a layer, (K, N): q k v o gate up down
GEMMA_KN = [(1152, 1024), (1152, 256), (1152, 256), (1024, 1152),
            (1152, 6912), (1152, 6912), (6912, 1152)]


def fused_quant_gemma(torch) -> list[dict]:
    """K7 at gemma3-1b's seven GEMM shapes (the dense-slot FP8 path's),
    M = 8 (decode) and 8192 (a prefill of 8 x 1024), bf16 activations:
    each GEMM on fresh inputs against its plain version, with its device
    ms by CUDA-graph replay, its bound and the dynamic shared memory of
    the body the shape rule picks (0: the in-register body)."""
    from repro_torch.core import nestedfp as nf
    from repro_torch.core import quant
    from repro_torch.kernels import ref
    from repro_torch.kernels.nestedfp8_matmul_fused_quant import (
        dynamic_smem_bytes, nestedfp8_matmul_fused_quant)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    rows = []
    for name, (k, n) in zip(("q", "k", "v", "o", "gate", "up", "down"),
                            GEMMA_KN):
        upper = nf.encode((torch.randn((k, n), generator=gen, device=dev)
                           * k ** -0.5).half())[0]
        for m in (8, 8192):
            x = torch.randn((m, k), generator=gen, device=dev).bfloat16()
            amax = quant.absmax(x).reshape(1)

            def kern(i):
                return nestedfp8_matmul_fused_quant(x, upper, amax)

            err = max_err(torch, kern(0),
                          ref.nestedfp8_matmul_fused_quant_ref(x, upper, amax),
                          GEMM_RTOL, GEMM_ATOL)
            b_ms, b_kind = bound(m * k * 2 + k * n + 4 + m * n * 4,
                                 2.0 * m * k * n, "fp8")
            row = {"model": "gemma3-1b", "gemm": name, "m": m, "k": k, "n": n,
                   "max_abs_err": err, "device_ms": graph_ms(torch, kern, 1),
                   "bound_ms": b_ms, "bound_by": b_kind,
                   "smem_bytes": dynamic_smem_bytes(upper, m)}
            rows.append(row)
            log(f"  nestedfp8_matmul_fused_quant gemma3-1b {name} M={m:4d} "
                f"K={k:4d} N={n:4d} err={err:.2e} device="
                f"{row['device_ms']:.4f} bound={b_ms:.4f} ({b_kind}), "
                f"smem={row['smem_bytes']} B")
    return rows


def quant_phase(torch, iters: int) -> list[dict]:
    """The per-token quantizer in front of K2: codes and scales bitwise
    those of `quant.quantize_act_per_token` (its plain version) on the
    card, for f32 (the engine's activations), f16 and bf16 rows with an
    all-zero row and rows reaching +-amax; timed at llama3.1-8b's GEMM
    input widths (K = 4096 for q/k/v, o, gate/up; 14336 for down),
    M = 8, 256 and 8192, host and device (graph replay) ms."""
    from repro_torch.core import quant
    from repro_torch.kernels.quant_per_token import quant_per_token

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    rows = []
    for k in (4096, 14336):
        for m in (8, 256, 8192):
            for dtype in (torch.float32, torch.float16, torch.bfloat16):
                n_sets = max(2, math.ceil(2 * L2_BYTES / (m * k * 2)) + 1)
                xs = []
                for _ in range(n_sets):
                    x = torch.randn((m, k), generator=gen, device=dev)
                    x *= torch.exp(torch.empty((m, 1), device=dev).uniform_(
                        -4, 4, generator=gen))
                    x[1] = 0.0
                    x[2, k // 3] = x[2].abs().max() * 2
                    x[3, k - 1] = -x[3].abs().max() * 2
                    xs.append(x.to(dtype))

                def kern(i):
                    return quant_per_token(xs[i])

                def plain(i):
                    return quant.quantize_act_per_token(xs[i])

                for i in range(n_sets):
                    (q, s), (wq, ws) = kern(i), plain(i)
                    check(torch.equal(s, ws) and torch.equal(
                        q.view(torch.uint8), wq.view(torch.uint8)),
                        f"quant_per_token M={m} K={k} {dtype}: codes or "
                        f"scales differ from quant.quantize_act_per_token")
                es = xs[0].element_size()
                b_ms, b_kind = bound(m * k * (es + 1) + 4 * m, 0.0, "f32")
                row = {"m": m, "k": k, "dtype": str(dtype)[6:],
                       "max_abs_err": 0.0,
                       "ms": time_ms(torch, kern, n_sets, iters),
                       "plain_ms": time_ms(torch, plain, n_sets, iters),
                       "library_ms": None, "bound_ms": b_ms,
                       "bound_by": b_kind,
                       "device_ms": graph_ms(torch, kern, n_sets),
                       "plain_device_ms": graph_ms(torch, plain, n_sets)}
                rows.append(row)
                log(f"  quant_per_token M={m:4d} K={k:5d} {row['dtype']:8s} "
                    f"bitwise; ms={row['ms']:.4f} plain={row['plain_ms']:.4f}"
                    f" device={row['device_ms']:.4f} plain_device="
                    f"{row['plain_device_ms']:.4f} bound={b_ms:.5f} "
                    f"({b_kind}); no single PyTorch call quantizes per row")
                del xs
    # ROADMAP F-port-6: PyTorch divides a CUDA tensor by a Python number
    # as a multiply by the number's reciprocal, which is why
    # quant._dequant_scale divides by a tensor; the share of amax values
    # where the two differ
    amax = torch.empty(20000, device=dev).uniform_(1, 2, generator=gen) * (
        2.0 ** torch.randint(-30, 30, (20000,), device=dev, generator=gen))
    ieee = amax / torch.full_like(amax, 448.0)
    check(torch.equal(ieee.cpu(), amax.cpu() / torch.full((20000,), 448.0)),
          "tensor / tensor on the card is not the CPU's IEEE quotient")
    share = float(((amax / 448.0) != ieee).float().mean())
    log(f"  amax / 448.0 on the card misses the IEEE quotient for "
        f"{share:.4f} of 20000 amax values")
    return rows


LLAMA_DENSE_CASES = (
    (1056, [1056, 1040, 17, 1, 700, 1056, 333, 1024], (None,)),
    (32768, [32768, 30001, 1, 20000, 32768, 5, 16384, 32000], (None, 4096)))


def dense_decode_phase(torch, iters: int, *, h=32, hkv=8, d=128,
                       cases=LLAMA_DENSE_CASES) -> list[dict]:
    """K5 over dense per-slot planes: llama3.1-8b's heads, 8 rows, ragged
    lens up to 1056 (the dense phase's capacity) and up to 32768 (the
    decode_32k length, also with a window of 4096), fp16 and fp8; host
    and device (graph replay) ms of K5 and of SDPA over joined planes.
    `cases`: (capacity, lens, windows) of each pool."""
    import torch.nn.functional as F

    from repro_torch.core import nestedfp as nf
    from repro_torch.kernels import ref
    from repro_torch.kernels.planar_decode_attention import (
        planar_decode_attention)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    b = 8
    q = torch.randn((b, h, d), generator=gen, device=dev)
    rows = []
    for cap, lens_l, windows in cases:
        lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
        n_sets = max(2, math.ceil(2 * L2_BYTES / (4 * b * cap * hkv * d)) + 1)
        pools = []
        for _ in range(n_sets):
            planes = []
            for _kv in range(2):
                x = torch.randn((b, cap, hkv, d), generator=gen,
                                device=dev).half()
                planes += nf.split_bytes(x)
                del x
            pools.append((planes[0], planes[1], planes[2], planes[3]))
        kpos = torch.arange(cap, device=dev)[None]
        for fp8, window in [(f, w) for w in windows for f in (False, True)]:
            keep = kpos < lens[:, None]
            if window:
                keep &= kpos > lens[:, None] - 1 - window
            mask = keep[:, None, None, :]

            def kern(i):
                return planar_decode_attention(q, *pools[i], lens, fp8=fp8,
                                               window=window)

            def plain(i):
                return ref.planar_decode_attention_ref(q, *pools[i], lens,
                                                       fp8=fp8, window=window)

            def joined(hi, lo):
                return (nf.e5m2_view(hi, torch.float16) if fp8
                        else nf.join_bytes(hi, lo)).transpose(1, 2)

            kv = [(joined(p[0], p[1]), joined(p[2], p[3])) for p in pools]
            qh = q.half()[:, :, None, :]

            def lib(i):
                return F.scaled_dot_product_attention(
                    qh, kv[i][0], kv[i][1], attn_mask=mask, enable_gqa=True)

            err = max_err(torch, kern(0), plain(0), ATTN_TOL, ATTN_TOL)
            keys = int(keep.sum())        # the keys this data attends to
            nbytes = (keys * hkv * d * 2 * (1 if fp8 else 2) + q.numel() * 4
                      + b * 4 + b * h * d * 4)
            b_ms, b_kind = bound(nbytes, 4.0 * keys * h * d, "f32")
            row = {"h": h, "hkv": hkv, "d": d, "cap": cap, "fp8": fp8,
                   "window": window,
                   "max_abs_err": err,
                   "ms": time_ms(torch, kern, n_sets, iters),
                   "plain_ms": time_ms(torch, plain, n_sets, iters),
                   "library_ms": time_ms(torch, lib, n_sets, iters),
                   "bound_ms": b_ms, "bound_by": b_kind,
                   **device_times(torch, kern, lib, n_sets, b_ms)}
            rows.append(row)
            log(f"  planar_decode_attention H={h} Hkv={hkv} D={d} cap={cap} "
                f"fp8={fp8} "
                f"window={window} kept keys={keys} err={err:.2e} "
                f"ms={row['ms']:.4f} plain={row['plain_ms']:.4f} "
                f"lib={row['library_ms']:.4f} bound={b_ms:.5f} ({b_kind}) "
                f"device={row['device_ms']:.4f} lib_device="
                f"{row['library_device_ms']:.4f} share={row['bound_share']:.3f}")
            del kv
        del pools
    return rows


# K6's cases (dtype, B, S, H, Hkv, D): llama3.1-8b's heads at the dense
# phase's prefill (8, 1024), a long (1, 8192), a ragged S = 1000 and f16;
# then gemma3-1b's global layers (D = 256) in bf16 and f16 at the dense
# prefill and in f32 (the slices' body) at a ragged S
K6_CASES = (("bfloat16", 8, 1024, 32, 8, 128), ("bfloat16", 1, 8192, 32, 8, 128),
            ("bfloat16", 8, 1000, 32, 8, 128), ("float16", 8, 1024, 32, 8, 128),
            ("bfloat16", 8, 1024, 4, 1, 256), ("float16", 8, 1024, 4, 1, 256),
            ("float32", 2, 65, 4, 1, 256),
            # deepseek-coder-33b's heads, 56 over 8 (G = 7: 9 positions a
            # block, one dead row), at the dense prefill, and f32 at a
            # ragged S (65 = 7 blocks of 9 positions + 2)
            ("bfloat16", 8, 1024, 56, 8, 128),
            ("float16", 8, 1024, 56, 8, 128),
            ("float32", 2, 65, 56, 8, 128),
            # granite-moe-3b's heads, 24 over 8 (G = 3), D = 64
            ("bfloat16", 8, 1024, 24, 8, 64),
            # zamba2-2.7b's shared attention (32 heads of 80) and
            # phi-3-vision's (32 of 96), MHA, at their dense prefills
            # (phi3: 576 patches + 1024 tokens), then f32 at a ragged S
            ("bfloat16", 8, 1024, 32, 32, 80), ("float16", 8, 1024, 32, 32, 80),
            ("bfloat16", 8, 1600, 32, 32, 96), ("float16", 8, 1600, 32, 32, 96),
            ("float32", 2, 65, 32, 32, 80), ("float32", 2, 65, 32, 32, 96))


def prefill_attention_phase(torch, iters: int, baseline=None) -> list[dict]:
    """K6 at each of K6_CASES against its plain version, timed with its
    plain version and SDPA (causal, k and v expanded; yardstick only);
    the D = 80, 96 and 256 and G = 7 cases also by CUDA-graph replay
    (device ms).
    With `baseline` (a K6 library built from another checkout's source,
    `k6_baseline`), every case whose G divides 64 must give that build's
    output bitwise."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_prefill_attention import (
        flash_prefill_attention)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    rows = []
    for dname, b, s, h, hkv, d in K6_CASES:
        dtype = getattr(torch, dname)
        n_sets = 2
        sets = [tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                      for shape in ((b, s, h, d), (b, s, hkv, d),
                                    (b, s, hkv, d)))
                for _ in range(n_sets)]
        expanded = [(q.transpose(1, 2),
                     k.repeat_interleave(h // hkv, dim=2).transpose(1, 2),
                     v.repeat_interleave(h // hkv, dim=2).transpose(1, 2))
                    for q, k, v in sets]

        def kern(i):
            return flash_prefill_attention(*sets[i])

        def plain(i):
            return ref.flash_prefill_attention_ref(*sets[i])

        def lib(i):
            return F.scaled_dot_product_attention(*expanded[i], is_causal=True)

        err = max_err(torch, kern(0), plain(0), ATTN_TOL, ATTN_TOL)
        same = None
        if baseline is not None and 64 % (h // hkv) == 0:
            same = all(bool(torch.equal(kern(i), baseline(*sets[i])))
                       for i in range(n_sets))
            check(same, f"K6 {dname} B={b} S={s} H={h} Hkv={hkv} D={d}: "
                  f"output differs from the baseline build's")
        esz = sets[0][0].element_size()
        nbytes = esz * (b * s * h * d + 2 * b * s * hkv * d) + b * s * h * d * 4
        b_ms, b_kind = bound(nbytes, 4.0 * b * h * s * s * d / 2,
                             "f32" if esz == 4 else "f16")
        row = {"dtype": dname, "b": b, "s": s, "h": h, "hkv": hkv, "d": d,
               "max_abs_err": err,
               "ms": time_ms(torch, kern, n_sets, iters),
               "plain_ms": time_ms(torch, plain, n_sets, iters),
               "library_ms": time_ms(torch, lib, n_sets, iters),
               "bound_ms": b_ms, "bound_by": b_kind, "bitwise_baseline": same}
        timed = d in (80, 96, 256) or 64 % (h // hkv)
        if timed:
            row.update(device_times(torch, kern, lib, n_sets, b_ms))
        rows.append(row)
        extra = "" if not timed else (
            f" device={row['device_ms']:.4f} lib_device="
            f"{row['library_device_ms']:.4f} "
            f"({row['bound_share']:.3f} of bound)")
        log(f"  flash_prefill_attention {dname} B={b} S={s} H={h} Hkv={hkv} "
            f"D={d} err={err:.2e} ms={row['ms']:.4f} "
            f"plain={row['plain_ms']:.4f} lib={row['library_ms']:.4f} "
            f"bound={b_ms:.4f} ({b_kind}){extra}"
            + ("" if same is None else "; bitwise the baseline build's"))
        del sets, expanded
    return rows


def encode_phase(torch, iters: int) -> list[dict]:
    """K8: every f16 bit pattern byte-identical to `nestedfp.encode` on
    the CPU, then one llama3.1-8b MLP weight (4096 x 14336) timed."""
    from repro_torch.core import nestedfp as nf
    from repro_torch.kernels import ref
    from repro_torch.kernels.nestedfp_encode import nestedfp_encode

    dev = torch.device("cuda")
    w_all = nf._bits_to_f16(torch.arange(65536, dtype=torch.int32))
    u, lo = nestedfp_encode(w_all.reshape(256, 256).to(dev))
    wu, wl = nf.encode(w_all.reshape(256, 256))
    check(torch.equal(u.cpu(), wu) and torch.equal(lo.cpu(), wl),
          "nestedfp_encode differs from nestedfp.encode on some f16 pattern")
    k, n = 4096, 14336
    n_sets = max(2, math.ceil(2 * L2_BYTES / (2 * k * n)) + 1)
    gen = torch.Generator(device=dev).manual_seed(5)
    ws = [(torch.randn((k, n), generator=gen, device=dev) * k ** -0.5).half()
          for _ in range(n_sets)]

    def kern(i):
        return nestedfp_encode(ws[i])

    def plain(i):
        return ref.nestedfp_encode_ref(ws[i])

    got, want = kern(0), plain(0)
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "nestedfp_encode differs from its plain version")
    b_ms, b_kind = bound(4 * k * n, 0.0, "f32")
    row = {"k": k, "n": n, "max_abs_err": 0.0,
           "ms": time_ms(torch, kern, n_sets, iters),
           "plain_ms": time_ms(torch, plain, n_sets, iters),
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_kind}
    log(f"  nestedfp_encode all 65536 f16 patterns byte-identical; "
        f"{k}x{n}: ms={row['ms']:.4f} plain={row['plain_ms']:.4f} "
        f"bound={b_ms:.4f} ({b_kind}); no single PyTorch call encodes")
    # one granite-moe-3b expert bank, a 3-D tensor (48 x 1536 x 512)
    shape = (48, 1536, 512)
    nel = math.prod(shape)
    banks = [(torch.randn(shape, generator=gen, device=dev) * 1536 ** -0.5
              ).half() for _ in range(2)]
    got, want = nestedfp_encode(banks[0]), ref.nestedfp_encode_ref(banks[0])
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "nestedfp_encode of a 3-D bank differs from its plain version")
    b_ms, b_kind = bound(4 * nel, 0.0, "f32")
    bank = {"model": "granite-moe-3b", "shape": shape, "max_abs_err": 0.0,
            "ms": time_ms(torch, lambda i: nestedfp_encode(banks[i]), 2,
                          iters),
            "plain_ms": time_ms(torch, lambda i: ref.nestedfp_encode_ref(
                banks[i]), 2, iters),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_kind}
    log(f"  nestedfp_encode granite bank {shape} bitwise its plain version: "
        f"ms={bank['ms']:.4f} plain={bank['plain_ms']:.4f} "
        f"bound={b_ms:.4f} ({b_kind})")
    return [row, bank]


def summarize(rows: list[dict], weight) -> dict:
    """The line's numbers for one kernel: times summed over the calls that
    `weight(row)` counts (0 = not counted), max error over every check."""
    sel = [(r, weight(r)) for r in rows if weight(r)]
    lib = [r["library_ms"] for r, _ in sel]

    def tot(key):
        return sum(r[key] * w for r, w in sel)
    return {"max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": tot("ms"), "plain_ms": tot("plain_ms"),
            "bound_ms": tot("bound_ms"),
            "bound_by": sel[0][0]["bound_by"],
            "library_ms": None if any(x is None for x in lib)
            else tot("library_ms")}


# ---------------------------------------------------------------------------
# phases 3 and 4: the slice
# ---------------------------------------------------------------------------

def plant_path(cfg) -> str:
    """The weight a phase plants as an exception tensor: attention's wo,
    or a recurrent stack's Mamba2 out_proj."""
    return ("mamba/out_proj/w" if cfg.family in ("ssm", "hybrid")
            else "attn/wo/w")


def make_serving_params(torch, cfg, seed, device, plant_layer):
    """Random params from a seeded generator on `device`, streamed weight
    by weight (`model.init_serving_params`: the device holds one f32
    weight at a time), with one exception tensor planted: [0, 0] = 2.0 of
    layer `plant_layer`'s wo (a recurrent stack's out_proj)."""
    from repro_torch.models import model as M

    where = plant_path(cfg)

    def plant(i, path, w):
        if (i, path) == (plant_layer, where):
            w[0, 0] = 2.0
    sp = M.init_serving_params(cfg, seed=seed, device=device, plant=plant)
    node = sp["layers"][plant_layer]
    for key in where.split("/")[:-1]:
        node = node[key]
    check(node.weight.is_exception, "planted exception tensor was nested")
    return sp


def slice_phase(torch, cfg) -> dict:
    from repro_torch.models.convert import params_to

    cfg2 = dataclasses.replace(cfg, n_layers=2)
    t0 = time.time()
    # made on the card (K8 nests them there) and copied to the CPU: the
    # CPU's plain encode took 18.7 s of the phase (PR 29's final run)
    sp_gpu = make_serving_params(torch, cfg2, 0, "cuda", plant_layer=1)
    sp_cpu = params_to(sp_gpu, "cpu")
    log(f"  2-layer full-width params made on the card and copied to the "
        f"CPU in {time.time() - t0:.1f} s")
    params = {"cpu": sp_cpu, "cuda": sp_gpu}
    out = {mode: paged_slice(torch, cfg2, params, mode)
           for mode in ("fp16", "fp8")}
    out["dense"] = dense_slice(torch, cfg2, params)
    return out


def paged_slice(torch, cfg, params, mode, *, n_layers=None, gated=True,
                label="slice", n_steps=5, tol=None) -> dict:
    """`paged_step` on the first n_layers layers of `params` ({"cpu": ...,
    "cuda": ...}), card against CPU, planar KV: a prefill of 2 prompts
    (32 and 20 tokens) and n_steps - 1 decode steps (K4), teacher-forced
    by the CPU's greedy tokens; logits held to `tol` (default
    SLICE_TOL[mode]) when `gated`, printed as a reading otherwise. An MoE
    model is held under the routing rule (`RoutingCheck`): a row's logits
    are compared at a step only where its own token chose the same
    experts on both devices in every layer."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models.layers import Runtime

    n_layers = n_layers or cfg.n_layers
    cut = dataclasses.replace(cfg, n_layers=n_layers)
    prm = {d: {**params[d], "layers": params[d]["layers"][:n_layers]}
           for d in params}
    bs = 16
    tables = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32)
    rng = torch.Generator().manual_seed(3)
    plens = [32, 20]
    prompt = torch.randint(1, cfg.vocab_size, (2, 32), generator=rng,
                           dtype=torch.int32)
    prompt[1, plens[1]:] = 0
    rt = Runtime(mode=mode, dtype=torch.float32, act_quant="per_token")
    caches = {dev: M.init_paged_cache(cut, 9, bs, planar=True, device=dev)
              for dev in ("cpu", "cuda")}

    aux = {"cpu": [], "cuda": []} if cut.moe is not None else None

    def step(dev, toks, qo, kvl, lp=None):
        return M.paged_step(
            rt, prm[dev], cut, toks.to(dev), caches[dev],
            tables.to(dev), q_offset=qo.to(dev), kv_len=kvl.to(dev),
            block_size=bs, return_logits=True,
            logit_position=None if lp is None else lp.to(dev),
            aux=None if aux is None else aux[dev])

    lens = torch.tensor(plens, dtype=torch.int32)
    args = (prompt, torch.zeros(2, dtype=torch.int32), lens, lens - 1)
    cmp = LogitCheck(torch, mode, tol or SLICE_TOL[mode], gated)
    route = RoutingCheck(torch, cut.moe.top_k) if aux is not None else None
    t0 = time.time()
    for s in range(n_steps):
        before = ops.all_launch_counters()
        want = step("cpu", *args)
        got = step("cuda", *args)
        after = ops.all_launch_counters()
        if route is None:
            cmp.add(got, want, f"paged step {s}")
        else:
            own = args[3] if s == 0 else torch.zeros(2, dtype=torch.long)
            real = torch.arange(args[0].shape[1])[None, :] < (
                args[2] - args[1])[:, None]
            ok = route.add(aux["cuda"], aux["cpu"], own, real)
            aux["cpu"].clear()
            aux["cuda"].clear()
            if ok.any():
                cmp.add(got[ok.cuda()], want[ok], f"paged step {s}")
        if s > 0:   # decode steps go through K4
            check(after["paged_planar_decode_attention"]
                  > before["paged_planar_decode_attention"],
                  "decode step did not launch K4")
        nxt = want.argmax(-1).to(torch.int32)[:, None]  # teacher forcing
        args = (nxt, lens.clone(), lens + 1)
        lens = lens + 1
    res = cmp.done(f"{label} {n_layers} layers")
    if route is not None:
        res["routing"] = route.done(f"{label} {n_layers} layers {mode}",
                                    gated)
    res["seconds"] = time.time() - t0
    return res


class RoutingCheck:
    """The routing rule of an MoE comparison (card against CPU): for each
    step, every layer's chosen experts on both devices at every real
    position. A flip (a position whose expert set differs in some layer)
    must sit where the CPU's gap between its k-th and (k+1)-th router
    logit is below 4x the largest router-logit difference seen at
    positions that agree; a row's logits are compared only at steps
    whose own token (its logit position) routed alike in every layer,
    and at least 3/4 of the (step, row) pairs must so qualify."""

    def __init__(self, torch, k):
        self.torch, self.k = torch, k
        self.gaps, self.diff, self.flips, self.pos = [], 0.0, 0, 0
        self.rows, self.held = 0, 0

    def _sets(self, logits):
        idx = self.torch.sort(logits, dim=-1, descending=True,
                              stable=True)[1][..., :self.k]
        return self.torch.sort(idx, dim=-1)[0]

    def add(self, got_aux, want_aux, own, real):
        """got_aux / want_aux: each layer's aux dict of one step (card,
        CPU); own (B,): each row's logit column; real (B, C) bool: the
        row's real (not pad) columns. Returns (B,) bool: rows to hold."""
        torch = self.torch
        agree = torch.ones_like(real)
        for g, w in zip(got_aux, want_aux):
            gl = g["router_logits"].float().cpu()
            wl = w["router_logits"].float().cpu()
            same = (self._sets(gl) == self._sets(wl)).all(-1)
            agree &= same
            flip = ~same & real
            srt = wl[flip].sort(dim=-1, descending=True)[0]
            self.gaps += (srt[:, self.k - 1] - srt[:, self.k]).tolist()
            ok = same & real
            if ok.any():
                self.diff = max(self.diff, float((gl - wl).abs()[ok].max()))
        self.flips += int((~agree & real).sum())
        self.pos += int(real.sum())
        rows = agree[torch.arange(len(own)), own.long()]
        self.rows += len(own)
        self.held += int(rows.sum())
        return rows

    def done(self, label, gated: bool = True) -> dict:
        near = all(g < 4 * self.diff for g in self.gaps)
        log(f"  {label} routing: {self.flips} flipped positions of "
            f"{self.pos} (layer flips {len(self.gaps)}); CPU k/k+1 router "
            f"logit gaps at flips {[f'{g:.2e}' for g in self.gaps[:8]]}"
            f"{' ...' if len(self.gaps) > 8 else ''} against 4 x the "
            f"largest difference where routing agreed "
            f"{4 * self.diff:.2e}; rows held {self.held}/{self.rows}")
        if gated:
            check(near, f"{label}: a routing flip away from a near-tie")
            check(self.held >= 0.75 * self.rows,
                  f"{label}: only {self.held}/{self.rows} rows routed alike")
        return {"flipped_positions": self.flips, "positions": self.pos,
                "layer_flips": len(self.gaps), "gaps": self.gaps,
                "max_router_diff": self.diff, "near_ties": near,
                "rows_held": self.held, "rows": self.rows}


def family_slice_phase(torch, cfg, label: str, readings=()) -> dict:
    """A cut of qwen3-8b or deepseek-coder-33b at full width, card against
    the CPU plain versions, layer 1's wo an exception tensor: the paged
    step at 2 layers in FP16 and FP8 (gated at SLICE_TOL), FP8 at each
    layer count of `readings` (a prefill and 2 decode steps: deeper than
    2 layers gated at DEEP_FP8_TOL, a reading otherwise), and the
    dense-slot prefill (K6 at the model's G; a vlm's stub patches ahead
    of the text) and decode steps at 2 layers in f32 (gated; a vlm's
    FP8 run at PHI3_DENSE_FP8_TOL, F-port-9). The weights
    are streamed onto the card (K8 nests them there) and copied to the
    CPU, whose plain GEMMs take one weight at a time (and sum in f64,
    F-port-5). The CPU's plain versions take most of the phase's time:
    the 2-layer runs take a prefill and 2 decode steps (3 paged steps,
    `n_steps`), every gate and kernel kept (PR 30 cut them from 4 for
    the training phases' time)."""
    from repro_torch.models.convert import params_to

    n = max((2, *readings))
    t0 = time.time()
    sp_gpu = make_serving_params(torch, dataclasses.replace(cfg, n_layers=n),
                                 0, "cuda", plant_layer=1)
    sp_cpu = params_to(sp_gpu, "cpu")
    log(f"  {n}-layer full-width params on the card and copied to the CPU "
        f"in {time.time() - t0:.1f} s")
    params = {"cpu": sp_cpu, "cuda": sp_gpu}
    out = {mode: paged_slice(torch, cfg, params, mode, n_layers=2,
                             label=label, n_steps=3)
           for mode in ("fp16", "fp8")}
    for n_l in readings:
        out[f"fp8_{n_l}l"] = paged_slice(torch, cfg, params, "fp8",
                                         n_layers=n_l, gated=n_l > 2,
                                         label=label, n_steps=3,
                                         tol=DEEP_FP8_TOL if n_l > 2
                                         else None)
    t0 = time.time()
    # a vlm's dense-slot FP8 run (576 patches ahead of the text, the
    # per-tensor FP8 scale) is gated at PHI3_DENSE_FP8_TOL: there the
    # port's CPU path and the JAX package part by 0.347 at 2 layers (0.303
    # without the patches; `tests/_fport8_phi3_control.py`, ROADMAP §3
    # F-port-9)
    out["dense"] = dense_slice(
        torch, dataclasses.replace(cfg, n_layers=2), params,
        runs=[("fp16", "f32", 2, True),
              ("fp8", "f32", 2, PHI3_DENSE_FP8_TOL
               if cfg.frontend == "vision" else True)],
        label=f"{label} dense", n_dec=2)
    out["dense"]["seconds"] = time.time() - t0
    del params, sp_gpu, sp_cpu
    torch.cuda.empty_cache()
    return out


class LogitCheck:
    """Card logits against the CPU plain versions', step after step: the
    error within `tol`, and the same greedy token wherever the CPU's
    top-2 margin is above twice the error."""

    def __init__(self, torch, mode, tol, gated: bool = True):
        self.torch, self.mode, self.tol, self.gated = torch, mode, tol, gated
        self.errs, self.agree, self.n, self.clear_misses = [], 0, 0, 0

    def add(self, got, want, what):
        self.torch.cuda.synchronize()
        got = got.float().cpu()
        check(bool(self.torch.isfinite(got).all()), f"{what}: non-finite logits")
        self.errs.append(float((got - want).abs().max()))
        top2 = want.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        same = got.argmax(-1) == want.argmax(-1)
        clear_miss = int((~same & (margin > 2 * self.errs[-1])).sum())
        self.clear_misses += clear_miss
        check(clear_miss == 0 or not self.gated,
              f"{self.mode} {what}: greedy token differs with a clear margin")
        self.agree += int(same.sum())
        self.n += same.numel()

    def done(self, label) -> dict:
        """Log the run and, if gated, fail it beyond the tolerance; a run
        that is not gated is a reading, printed beside the tolerance."""
        tol = self.tol
        log(f"  {label} {self.mode}: max |logit err| per step "
            f"{[f'{e:.2e}' for e in self.errs]} (tol {tol}"
            f"{'' if self.gated else ', not gated'}); greedy agree "
            f"{self.agree}/{self.n}, clear-margin misses {self.clear_misses}")
        check(max(self.errs) <= tol or not self.gated,
              f"{label} {self.mode} logits beyond tolerance {tol}")
        return {"max_logit_err": max(self.errs), "tol": tol,
                "gated": self.gated, "greedy_agree": self.agree,
                "greedy_total": self.n, "clear_misses": self.clear_misses}


def dense_slice(torch, cfg, params, *, s=48, cap=56, runs=None,
                label="dense slice", n_dec: int = 4) -> dict:
    """The dense-slot path on a cut of the model, card against CPU:
    prefill of 2 x s tokens (K6 on the global layers; K1 or K7),
    planarize at `cap` (plus a vlm's patches), n_dec decode steps (K5), with
    the per-tensor FP8 scale. Each run is (mode, act, n_layers, gate): f32 activations at
    SLICE_TOL or `steps.serve_rt` (bf16 activations, bf16-rounded GEMM
    outputs) at BF16_TOL, on the first n_layers layers of `params`; gate
    False: printed only; a number: gated at that tolerance. Default: fp16
    and fp8, f32 and bf16, all layers, gated. A stub frontend's inputs
    (`steps.stub_frontend`: a vlm's patches, ahead of the text, and an
    encdec's frames, whose encoder runs inside the prefill and is in the
    comparison) come from a seeded CPU generator."""
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.models.layers import Runtime

    runs = runs or [(m, a, cfg.n_layers, True) for a in ("f32", "bf16")
                    for m in ("fp16", "fp8")]
    gen = torch.Generator().manual_seed(5)
    prompt = torch.randint(1, cfg.vocab_size, (2, s), generator=gen,
                           dtype=torch.int32)
    extra = steps.stub_frontend(cfg, 2, s, generator=gen, device="cpu")
    cap += cfg.frontend_len if cfg.frontend == "vision" else 0
    gemm = {"fp16": "nestedfp16_matmul", "fp8": "nestedfp8_matmul_fused_quant"}
    out = {}
    for mode, act, n_layers, gate in runs:
        cut = dataclasses.replace(cfg, n_layers=n_layers)
        prm = {d: {**params[d], "layers": params[d]["layers"][:n_layers]}
               for d in params}
        if act == "f32":
            rt, tol = Runtime(mode=mode, dtype=torch.float32), SLICE_TOL[mode]
        else:
            rt, tol = steps.serve_rt(mode), BF16_TOL[mode]
        if not isinstance(gate, bool):
            tol = gate
        cmp = LogitCheck(torch, mode, tol, gate is not False)
        need = [gemm[mode]] + (["flash_prefill_attention"]
                               if None in M._layer_windows(cut) else [])
        before = ops.all_launch_counters()
        res = {d: M.prefill(rt, prm[d], cut, {
            "tokens": prompt.to(d), **{k: v.to(d) for k, v in extra.items()}},
            capacity=cap) for d in ("cpu", "cuda")}
        after = ops.all_launch_counters()
        for name in need:
            check(after[name] > before[name], f"dense prefill: no {name}")
        cmp.add(res["cuda"][0], res["cpu"][0], "dense prefill")
        want, n = res["cpu"][0], res["cpu"][2]
        caches = {d: M.planarize_cache(res[d][1]) for d in res}
        for i in range(n_dec):
            nxt = want.argmax(-1).to(torch.int32)[:, None]  # teacher forcing
            before = ops.all_launch_counters()
            want, _ = M.decode_step(rt, prm["cpu"], cut, nxt,
                                    caches["cpu"], n + i)
            got, _ = M.decode_step(rt, prm["cuda"], cut, nxt.cuda(),
                                   caches["cuda"], n + i)
            after = ops.all_launch_counters()
            check(after["planar_decode_attention"]
                  > before["planar_decode_attention"],
                  "dense decode step did not launch K5")
            cmp.add(got, want, f"dense decode {i}")
        tag = f"{mode}_{act}" + ("" if n_layers == cfg.n_layers
                                 else f"_{n_layers}l")
        out[tag] = cmp.done(f"{label} {act} {n_layers} layers")
    return out


# logits of a 2-layer full-width llama, card vs CPU plain versions. The
# f32 sums run in other orders on the two devices, and each nested GEMM
# re-rounds its input activations to f16 (fp16 mode) or e4m3 (fp8 mode),
# so values next to a rounding boundary land on neighbouring codes:
# frequent one-ulp f16 steps move logits by a few 1e-3; a rare e4m3 step
# (1/16 of one value) moves a row by up to ~0.1. Greedy tokens must agree
# wherever the CPU top-2 margin is above twice the error.
SLICE_TOL = {"fp16": 1e-2, "fp8": 0.25}
# FP8 runs of stacks deeper than 2 layers: there e4m3 re-rounding parts
# two correct implementations by more than 0.25 (card against CPU 0.25-
# 0.28 at 4-6 layers; the port's CPU path against the JAX package on the
# same schedule, the control, 0.28-0.31): ROADMAP §3, F-port-8
DEEP_FP8_TOL = 0.35
# F-port-9 (ROADMAP §3), two FP8 dense-slot runs with the per-tensor
# scale, gated above their card readings and their controls (the port's
# CPU path against the JAX package on the same weights and schedule, full
# width): e4m3 re-rounding, which two correct implementations show alike
# (F-port-1), carried through phi-3-vision's 576 stub patches and through
# seamless-m4t-v2's encoder memory into every decoder layer.
# phi3_slice's dense-slot FP8 at 2 layers with 576 patches: card 0.377,
# control 0.347 (tests/_fport8_phi3_control.py)
PHI3_DENSE_FP8_TOL = 0.45
# seamless_slice's whole 2 + 2 layer FP8 chain: card 0.51, control 0.468
# (tests/_fport8_seamless_control.py)
SEAMLESS_CHAIN_FP8_TOL = 0.60
# the same under bf16 activations with bf16-rounded GEMM outputs: a sum
# that differs in its last f32 bit can round to the neighbouring bf16
# value (2^-8 relative), so the tolerance is tests/test_torch_dense.py's
# for the JAX package's serve_rt against the port's
BF16_TOL = {"fp16": 0.1, "fp8": 0.5}


def serve_phase(torch, cfg, n_layers: int, host_tier: bool = True,
                label: str = "serve", memory: bool = False, *,
                n_slots: int = 8, capacity: int = 256, prompt_len: int = 128,
                max_new: int = 32, sys_len: int = 0,
                policies=("fp16", "fp8", "dual"), plant_layer: int = 0,
                need: dict | None = None, params=None) -> dict:
    """The paged engine at full width and depth, forced FP16, forced FP8
    and dual. Each engine first serves 8 other prompts of the same
    shapes (the warm pass: it captures every step key and holds each
    key's replay bitwise against an eager call; in dual mode a pass for
    each mode), then the 8 timed prompts; then the engine is freed with
    its graphs. `host_tier` is the engine's `host_offload` (on by
    default, as in the engine): the timed run spills the warm pass's
    evicted prefix blocks, and its host seconds in captures and
    checksums are logged. Each key's capture logs what it added to the
    graphs' pool, and dual mode the controller's reasons for FP8. With
    `memory`, the load is reckoned first (`memory_reckoning`) and the
    bytes it allocates are held to the reckoning. The shape (slots,
    capacity, prompt_len tokens of which the first sys_len are one system
    prompt shared by every request, max_new), the policies, the layer
    whose wo is planted as an exception tensor and the kernels each mode
    must launch
    (`need`) default to llama3.1-8b's serve phase. `params`: serving
    params already on the card (a restored checkpoint), served as given
    in place of random ones."""
    from repro_torch.core.policy import DualPrecisionController, SLOConfig
    from repro_torch.kernels import ops
    from repro_torch.models.convert import serving_memory_bytes
    from repro_torch.serving.engine import Engine, Request

    cfgn = dataclasses.replace(cfg, n_layers=n_layers)
    results = {}
    if memory:
        results["memory"] = memory_reckoning(torch, cfgn, label)
    torch.cuda.reset_peak_memory_stats()
    alloc0 = torch.cuda.memory_allocated()
    req0 = torch.cuda.memory_stats()["requested_bytes.all.current"]
    t0 = time.time()
    sp = params if params is not None else make_serving_params(
        torch, cfgn, 0, "cuda", plant_layer=plant_layer)
    torch.cuda.synchronize()
    load_s = time.time() - t0
    mem = serving_memory_bytes(sp)
    log(f"  {label}: {n_layers}-layer params on the card in {load_s:.1f} s: "
        f"{mem['nested_bytes'] / 1e9:.2f} GB nested, "
        f"{mem['other_bytes'] / 1e9:.2f} GB other")
    if memory:
        # the bytes the load's tensors asked for, and the allocator's
        # blocks that hold them (a cached block is handed out whole when
        # what would be left of it is 1 MiB or less)
        got = torch.cuda.memory_stats()["requested_bytes.all.current"] - req0
        blocks = torch.cuda.memory_allocated() - alloc0
        want = results["memory"]["structural_total_bytes"]
        results["memory"].update(
            load_s=load_s, requested_by_load=got, allocated_by_load=blocks,
            load_peak_bytes=torch.cuda.max_memory_allocated())
        log(f"  {label}: the load's tensors took {got} B against the "
            f"structural {want} B (allocator blocks {blocks} B, "
            f"{blocks / 1e9:.3f} GB); peak during the load "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        check(abs(got - want) <= 2**20,
              f"{label}: the load took {got} B for a reckoned {want} B")
    rng = torch.Generator().manual_seed(7)
    sysp = torch.randint(1, cfg.vocab_size, (sys_len,), generator=rng).tolist()
    prompts = [sysp + torch.randint(1, cfg.vocab_size, (prompt_len - sys_len,),
                                    generator=rng).tolist()
               for _ in range(24)]
    warm, prompts = [prompts[8:16], prompts[16:]], prompts[:8]
    ops.reset_launch_counters()          # the main path's run starts here
    for policy in policies:
        ctrl = None
        if policy == "dual":
            ctrl = DualPrecisionController(SLOConfig(), fp16_ms_per_token=0.5,
                                           fp8_ms_per_token=0.25)
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        eng = Engine(cfgn, sp, n_slots=n_slots, capacity=capacity,
                     kv_planar=True, controller=ctrl,
                     forced_mode=None if policy == "dual" else policy,
                     host_offload=host_tier, device="cuda")
        host_s = host_tier_timers(eng)
        grown = record_captures(eng)
        reasons = record_reasons(ctrl) if ctrl else {}
        # warm pass: 8 other prompts of the same shapes (in dual mode one
        # set forced to each mode), so that the timed run finds every key
        # captured; each key's first replay is held against an eager call
        t0 = time.monotonic()
        n_checked = 0
        for w, mode in enumerate(["fp16", "fp8"] if ctrl else [policy]):
            eng.forced_mode = mode
            for i, p in enumerate(warm[w]):
                eng.submit(Request(f"w{w}.{i}", list(p), max_new=max_new))
            n_checked += serve_checked(eng, policy, label)
        eng.forced_mode = None if ctrl else policy
        torch.cuda.synchronize()
        warm_s = time.monotonic() - t0
        check(n_checked == len(eng.graphs.keys()) == eng.graphs.n_captured,
              f"{policy}: {n_checked} keys checked of "
              f"{len(eng.graphs.keys())}")
        n_graphs = eng.graphs.n_captured
        log(f"  {label} {policy}: pool bytes each key's capture added: "
            f"{ {str(k): v for k, v in grown.items()} }")
        reasons.clear()                  # the timed run's decisions only
        stats0, n_warm = dict(eng.stats), len(eng.finished)
        host0 = dict(host_s)
        prefix0 = eng.prefix_cache_stats()
        for i, p in enumerate(prompts):
            eng.submit(Request(f"r{i}", list(p), max_new=max_new))
        before = ops.all_launch_counters()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        step_ms, decode_ms, decode_modes = [], [], []
        while eng.queue or eng.active or eng.prefilling:
            n_pre = eng.stats["prefill_dispatches"]
            eng.step()
            step_ms.append(eng._last_step_ms)
            if eng.stats["prefill_dispatches"] == n_pre:
                decode_ms.append(eng._last_step_ms)
                decode_modes.append(ctrl.history[-1] if ctrl else policy)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {k: v - before[k] for k, v in ops.all_launch_counters().items()}
        check(eng.graphs.n_captured == n_graphs,
              f"{policy}: a step key was captured inside the timed run")
        fin = eng.finished[n_warm:]
        check(len(fin) == 8, f"{policy}: {len(fin)}/8 requests finished")
        check(all(len(r.output) == max_new and all(0 <= t < cfg.vocab_size
                                               for t in r.output) for r in fin),
              f"{policy}: outputs of the wrong length or out of vocab")
        modes = [m for r in fin for m in r.modes]
        n_tok = sum(len(r.output) for r in fin)
        # device time of each decode step's graph (CUDA events around
        # back-to-back replays on its last inputs; not counted as launches)
        graph_dev = {m: replay_ms(torch, eng.graphs.graph(("decode", m)))
                     for m in sorted(set(decode_modes))}
        idle = sorted(1 - graph_dev[m] / w
                      for m, w in zip(decode_modes, decode_ms))
        res = {"wall_s": wall, "warm_pass_s": warm_s, "tokens": n_tok,
               "tokens_per_s": n_tok / wall, "steps": len(step_ms),
               "step_ms_mean": sum(step_ms) / len(step_ms),
               "step_ms_median": sorted(step_ms)[len(step_ms) // 2],
               "decode_step_ms_median": sorted(decode_ms)[len(decode_ms) // 2],
               "decode_graph_device_ms": graph_dev,
               "decode_idle_share_median": idle[len(idle) // 2],
               "ttft_ms_mean": 1e3 * sum(r.first_token_s - t0 for r in fin) / 8,
               "tpot_ms_mean": 1e3 * sum((r.finished_s - r.first_token_s)
                                         / (len(r.output) - 1)
                                         for r in fin) / 8,
               "fp16_fraction": modes.count("fp16") / len(modes),
               "prefix_hit_tokens": eng.prefix_cache_stats()["hit_tokens"]
               - prefix0["hit_tokens"],
               "graphs": n_graphs, "keys": sorted(map(str, eng.graphs.keys())),
               "graph_pool_bytes": eng.graphs.pool_bytes(),
               "launches": launches,
               "stats": {k: v - stats0[k] if isinstance(v, int) else v
                         for k, v in eng.stats.items()},
               "host_tier_s": {k: v - host0[k] for k, v in host_s.items()}}
        log(f"  {label} {policy}: {n_tok} tokens in {wall:.3f} s "
            f"({res['tokens_per_s']:.1f} tok/s), {len(step_ms)} steps, "
            f"step ms mean {res['step_ms_mean']:.2f} median "
            f"{res['step_ms_median']:.2f}, decode-only step ms median "
            f"{res['decode_step_ms_median']:.2f}, decode graph device ms "
            f"{ {m: round(v, 3) for m, v in graph_dev.items()} }, idle share "
            f"{res['decode_idle_share_median']:.3f}, TTFT mean "
            f"{res['ttft_ms_mean']:.1f} ms, TPOT mean "
            f"{res['tpot_ms_mean']:.2f} ms, fp16 fraction "
            f"{res['fp16_fraction']:.2f}; {n_graphs} graphs, pool "
            f"{res['graph_pool_bytes'] / 2**20:.1f} MiB, warm pass "
            f"{warm_s:.2f} s, prefix hit tokens {res['prefix_hit_tokens']} "
            f"({eng.desc.kind} blocks); launches {launches}")
        log(f"  {label} {policy}: host tier {'on' if host_tier else 'off'}, "
            f"{res['stats']['spilled_blocks']} blocks spilled in the timed "
            f"run, host s in captures {res['host_tier_s']['capture_s']:.4f}"
            f" (checksums {res['host_tier_s']['checksum_s']:.4f})")
        res["replays_bitwise"] = n_checked
        res["capture_pool_growth"] = {str(k): v for k, v in grown.items()}
        if ctrl:
            res["controller_reasons"] = dict(reasons)
            log(f"  {label} dual: controller decisions in the timed run by "
                f"reason {dict(reasons)} (cost model 0.5 / 0.25 ms a "
                f"token; fp16 fraction {res['fp16_fraction']:.2f})")
        pool = tuple(eng.graphs._pool)
        unwrap(eng)
        del eng
        torch.cuda.synchronize()
        left = torch.cuda.memory_allocated() - mem0
        torch.cuda.empty_cache()
        check(not [s for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == pool],
              f"{policy}: the graphs' pool outlived its engine")
        log(f"  {label} {policy}: engine freed, {left / 2**20:.1f} MiB left "
            f"allocated against before it (the capture stream's cuBLAS "
            f"workspace stays after the first engine)")
        check(left <= 128 * 2**20, f"{policy}: {left} bytes outlived the engine")
        res["bytes_left_after_engine"] = left
        results[policy] = res
    need = need or {"fp16": ("nestedfp16_matmul", "f16_matmul",
                             "paged_planar_decode_attention"),
                    "fp8": ("nestedfp8_matmul", "quant_per_token",
                            "f16_matmul", "paged_planar_decode_attention")}
    for policy, names in need.items():
        for name in names:
            check(results[policy]["launches"][name] > 0,
                  f"serve {policy}: {name} never launched")
    results["launches_total"] = ops.all_launch_counters()
    for mode in ("fp16", "fp8"):
        results[f"profile_{mode}"] = profile_decode(
            torch, Engine, Request, cfgn, sp, prompts, mode,
            results[mode]["decode_step_ms_median"], n_slots=n_slots,
            capacity=capacity, max_new=max_new)
    results["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"  peak device memory {results['peak_mem_gb']:.1f} GB")
    return results


def serve_checked(eng, policy: str, label: str = "serve") -> int:
    """Run the engine to the end of its queue; right after the run that
    captures a key (inside its step, while the block tables are those the
    run read: a sliding-window decode slides blocks that the same step's
    prefill wrote), hold one replay of it bitwise against an eager call
    of the same step on clones of its inputs and the pool (launches not
    counted; `StepGraphs.check_first_runs`). Returns the number of keys
    checked."""
    g = eng.graphs
    before = set(g.checks)
    g.check_first_runs = True
    while eng.queue or eng.active or eng.prefilling:
        eng.step()
    g.check_first_runs = False
    new = sorted(set(g.checks) - before)
    for key in new:
        same = g.checks[key]
        check(all(same.values()),
              f"{policy} {key}: replay differs from the eager call {same}")
        log(f"  {label} {policy}: {key} captured; its replay is bitwise "
            f"the eager call (ids of live rows, pool planes)")
    return len(new)


def replay_ms(torch, graph, reps: int = 20) -> float:
    """Device ms of one replay of a captured step: CUDA events around
    `reps` back-to-back replays, after one untimed."""
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_decode(torch, Engine, Request, cfg, sp, prompts, mode,
                   step_ms: float, n_steps: int = 4, n_slots: int = 8,
                   capacity: int = 256, max_new: int = 32,
                   mesh=None) -> dict:
    """Device time by kernel over `n_steps` decode-only steps (the torch
    profiler lists the kernels inside each graph replay), after the
    run's prefill is done; run after the main path's launch counts were
    read, and outside the timed runs. The idle share is taken against
    `step_ms`, the unprofiled decode-only step time. `mesh`: the
    engine's serving mesh."""
    eng = Engine(cfg, sp, n_slots=n_slots, capacity=capacity, kv_planar=True,
                 forced_mode=mode, device="cuda", mesh=mesh)
    for i, p in enumerate(prompts):
        eng.submit(Request(f"p{i}", list(p), max_new=max_new))
    while eng.queue or eng.prefilling or eng.iteration < 8:
        eng.step()
    torch.cuda.synchronize()
    wall_ms, by_name = device_ms_by_kernel(torch, eng.step, n_steps)
    res = profile_summary(f"profile {mode}: {n_steps} decode steps "
                          f"(graph replays; {len(by_name)} kernel names)",
                          wall_ms, step_ms, by_name)
    # K2 (its mma body's RowScale instances, or the WMMA body's kNested8
    # instances) and the per-token quantizer
    res["k2_device_ms_per_step"] = sum(
        v for k, v in by_name.items()
        if ("mma_kernel" in k and "RowScale" in k)
        or ("gemm_kernel" in k and "(nfp::Op)1" in k))
    res["quant_device_ms_per_step"] = sum(
        v for k, v in by_name.items() if "quant_per_token_kernel" in k)
    # every nested linear: K1 / K3 (wg_kernel), K2 (mma_kernel), the
    # fallback body (gemm_kernel) and the quantizer in front of K2
    res["linear_device_ms_per_step"] = sum(
        v for k, v in by_name.items() if any(
            n in k for n in ("wg_kernel", "mma_kernel", "gemm_kernel",
                             "quant_per_token_kernel")))
    log(f"  profile {mode}: K2 {res['k2_device_ms_per_step']:.3f} ms, "
        f"per-token quantizer {res['quant_device_ms_per_step']:.3f} ms, "
        f"all nested linears {res['linear_device_ms_per_step']:.3f} ms of "
        f"device time a decode step")
    return res


def device_ms_by_kernel(torch, run, n_calls: int):
    """(profiled wall ms, {kernel name: device ms}) per call of run(),
    over n_calls calls under the torch profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(n_calls):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3 / n_calls
    by_name = {}
    for ev in prof.key_averages():
        # device-side kernel events only: an aten op's own entry repeats
        # the time of the kernels it launched
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0))
        by_name[ev.key] = by_name.get(ev.key, 0.0) + t / 1e3 / n_calls
    return wall_ms, by_name


def profile_summary(label, wall_ms, step_ms, by_name) -> dict:
    """Log and return device busy time, idle share against `step_ms` (the
    unprofiled time of the same call) and the top kernels."""
    dev_ms = sum(by_name.values())
    check(dev_ms > 0, "the profiler saw no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    log(f"  {label}, wall {wall_ms:.2f} ms/call profiled, {step_ms:.2f} "
        f"unprofiled; device busy {dev_ms:.3f} ms/call, idle share "
        f"{1 - dev_ms / step_ms:.3f}")
    for k, v in top:
        log(f"    {v:8.3f} ms/call  {k[:90]}")
    return {"profiled_wall_ms_per_step": wall_ms,
            "device_ms_per_step": dev_ms, "idle_share": 1 - dev_ms / step_ms,
            "top_kernels_ms_per_step": top}


def prefill_attention_layers(cfg) -> int:
    """Self-attention layers a dense-slot prefill runs K6 on: the global
    layers, or a hybrid's shared-attention applications (an encdec's
    encoder runs the plain bidirectional attention, as in the JAX
    package)."""
    from repro_torch.models import model as M
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return M._layer_windows(cfg).count(None)


def dense_phase(torch, cfg, label: str = "dense", plant_layer: int = 0,
                n_dec: int = 32, long_ctx: bool = True,
                reckon: bool = False) -> dict:
    """The dense-slot serving steps at full width and depth: weights
    nested on the card (K8), 8 x 1024-token prefill (K6 on every global
    layer or shared-attention application, K1 / K7, K3; a vlm's 576
    stub patches ahead of the text, an encdec's encoder over 128 stub
    frames a row, timed apart), planarize at the prefill's length + 32
    (1056 for text alone; + n_dec when longer), then the decode step as
    a CUDA graph: its
    first call captures it, its first replay is held bitwise against an
    eager call on cloned caches (`check_replay`), then n_dec greedy steps
    replay it, timed (none may capture) — fp16, then fp8. Launch counts
    are read over this whole run. Then profiles (the eager prefill, the
    decode replays) and the step at long context; with `reckon`, the dry
    run's reckoning of the same decode step held to what the card holds
    and to the replayed step (`dense_reckoning`)."""
    from repro_torch.core.linear import NestedLinearParams
    from repro_torch.core.nestedfp import NestedTensor
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.models.convert import serving_memory_bytes

    b, s = 8, 1024
    n = s + (cfg.frontend_len if cfg.frontend == "vision" else 0)
    cap = n + max(32, n_dec)
    n_global = prefill_attention_layers(cfg)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counters()          # the dense path's run starts here
    t0 = time.time()
    sp = make_serving_params(torch, cfg, 0, "cuda", plant_layer=plant_layer)
    torch.cuda.synchronize()
    mem = serving_memory_bytes(sp)
    nested = sum(not p.weight.is_exception
                 for p in _linears(sp, NestedLinearParams)) \
        + sum(not t.is_exception for t in _linears(sp, NestedTensor))  # banks
    log(f"  {label}: {cfg.n_layers}-layer params nested on the card in "
        f"{time.time() - t0:.1f} s: {mem['nested_bytes'] / 1e9:.2f} GB "
        f"nested, {mem['other_bytes'] / 1e9:.2f} GB other; {nested} "
        f"applicable tensors")
    check(ops.all_launch_counters()["nestedfp_encode"] == nested,
          "to_serving did not encode each applicable tensor through K8")
    prompts = torch.randint(1, cfg.vocab_size, (b, s),
                            generator=torch.Generator().manual_seed(11),
                            dtype=torch.int32).cuda()
    batch = {"tokens": prompts, **steps.stub_frontend(
        cfg, b, s, generator=torch.Generator(device="cuda").manual_seed(12),
        device="cuda")}
    res = {"layers": cfg.n_layers, "batch": b, "prompt_len": s, "capacity": cap,
           "decode_steps": n_dec, "global_layers": n_global,
           "prefill_len": n}
    need = {"fp16": ("flash_prefill_attention", "planar_decode_attention",
                     "nestedfp16_matmul", "f16_matmul"),
            "fp8": ("flash_prefill_attention", "planar_decode_attention",
                    "nestedfp8_matmul_fused_quant", "f16_matmul")}
    kept = {}
    for mode in ("fp16", "fp8"):
        before = ops.all_launch_counters()
        prefill = steps.make_prefill_step(cfg, mode, capacity=cap)
        decode = steps.make_decode_step(cfg, mode)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        logits, caches = prefill(sp, batch)
        torch.cuda.synchronize()
        prefill_ms = (time.monotonic() - t0) * 1e3
        check(tuple(logits.shape) == (b, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()),
              f"{label} {mode}: prefill logits not finite or mis-shaped")
        k6 = ops.all_launch_counters()["flash_prefill_attention"] \
            - before["flash_prefill_attention"]
        check(k6 == n_global, f"{label} {mode}: K6 launched {k6} times in a "
              f"prefill of {n_global} global layers")
        t0 = time.monotonic()
        caches = M.planarize_cache(caches)
        torch.cuda.synchronize()
        planarize_ms = (time.monotonic() - t0) * 1e3
        nxt = logits.argmax(-1).to(torch.int32)[:, None]
        t0 = time.monotonic()
        decode(sp, caches, nxt, n)            # eager, then captured
        torch.cuda.synchronize()
        capture_ms = (time.monotonic() - t0) * 1e3
        same = decode.check_replay(sp, caches, nxt, n)
        check(all(same.values()), f"{label} {mode}: the decode graph's first "
              f"replay differs from its eager call: {same}")
        n_graphs = decode.n_captured
        step_ms, call_ms, out = [], [], []
        for i in range(n_dec):
            t0 = time.monotonic()
            logits, caches = decode(sp, caches, nxt, n + i)
            call_ms.append((time.monotonic() - t0) * 1e3)
            nxt = logits.argmax(-1).to(torch.int32)[:, None]
            torch.cuda.synchronize()
            step_ms.append((time.monotonic() - t0) * 1e3)
            out.append(nxt)
        check(decode.n_captured == n_graphs == len(decode.keys()) == 1,
              f"{label} {mode}: {decode.n_captured} graphs for "
              f"{len(decode.keys())} keys; the timed loop captured")
        check(bool(torch.isfinite(logits).all()),
              f"{label} {mode}: decode logits not finite")
        toks = torch.cat(out, 1)
        check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
              f"{label} {mode}: tokens out of vocab")
        launches = {k: v - before[k] for k, v in ops.all_launch_counters().items()}
        for name in need[mode]:
            check(launches[name] > 0, f"{label} {mode}: {name} never launched")
        (key,) = decode.keys()
        med = sorted(step_ms)[n_dec // 2]
        # where a step's wall time goes beside the graph's device time:
        # the host's call (staging and the graph's launch), and a bare
        # replay started on an idle card, host launch time and wall
        launch_ms, idle_ms = [], []
        for _ in range(9):
            t0 = time.monotonic()
            decode.graph(key).replay()
            launch_ms.append((time.monotonic() - t0) * 1e3)
            torch.cuda.synchronize()
            idle_ms.append((time.monotonic() - t0) * 1e3)
        r = {"prefill_ms": prefill_ms, "planarize_ms": planarize_ms,
             "capture_ms": capture_ms, "replay_check": same,
             "decode_call_ms_median": sorted(call_ms)[n_dec // 2],
             "bare_replay_launch_ms_median": sorted(launch_ms)[4],
             "bare_replay_wall_ms_median": sorted(idle_ms)[4],
             "decode_ms_per_step_median": med,
             "decode_ms_per_step_mean": sum(step_ms) / n_dec,
             "decode_tokens_per_s": b * n_dec / (sum(step_ms) / 1e3),
             "prefill_tokens_per_s": b * n / (prefill_ms / 1e3),
             "graph_device_ms": replay_ms(torch, decode.graph(key)),
             "graph_pool_bytes": decode.pool_bytes(), "launches": launches}
        log(f"  {label} {mode}: prefill {b}x{n} in {prefill_ms:.1f} ms "
            f"({r['prefill_tokens_per_s']:.0f} tok/s, K6 {k6} launches), "
            f"planarize {planarize_ms:.1f} ms, decode first call (eager + "
            f"capture) {capture_ms:.1f} ms, first replay bitwise its eager "
            f"call; {n_dec} replayed steps median {med:.2f} ms mean "
            f"{r['decode_ms_per_step_mean']:.2f} ms "
            f"({r['decode_tokens_per_s']:.1f} tok/s), decode graph device "
            f"{r['graph_device_ms']:.3f} ms, pool "
            f"{r['graph_pool_bytes'] / 2**20:.1f} MiB; launches {launches}")
        log(f"  {label} {mode}: a replayed step's host call (staging + "
            f"launch) median {r['decode_call_ms_median']:.3f} ms; a bare "
            f"replay from an idle card: launch "
            f"{r['bare_replay_launch_ms_median']:.3f} ms, wall "
            f"{r['bare_replay_wall_ms_median']:.3f} ms")
        res[mode] = r
        kept[mode] = (decode, caches, nxt)
    res["launches_total"] = ops.all_launch_counters()   # read: the run ends
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"  {label} peak device memory {res['peak_mem_gb']:.1f} GB")
    for mode in ("fp16", "fp8"):
        # the idle share against a second, warm prefill: the first one
        # also grew the allocator's pool
        prefill = steps.make_prefill_step(cfg, mode, capacity=cap)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        prefill(sp, batch)
        torch.cuda.synchronize()
        warm_ms = res[mode]["prefill_ms_warm"] = (time.monotonic() - t0) * 1e3
        if cfg.family == "encdec":
            # the encoder alone (frontend projection, bidirectional stack,
            # enc_norm), warm; the rest of the prefill is the decoder's
            rt = steps.serve_rt(mode)
            t0 = time.monotonic()
            M.encode_memory(rt, sp, cfg, batch["frames"])
            torch.cuda.synchronize()
            enc_ms = res[mode]["encoder_ms_warm"] = (time.monotonic() - t0) * 1e3
            res[mode]["decoder_prefill_ms_warm"] = warm_ms - enc_ms
            log(f"  {label} {mode}: warm prefill {warm_ms:.1f} ms = encoder "
                f"({cfg.n_enc_layers} layers over {b} x "
                f"{batch['frames'].shape[1]} frames) {enc_ms:.1f} ms + "
                f"decoder {warm_ms - enc_ms:.1f} ms")
        wall, by_name = device_ms_by_kernel(
            torch, lambda: prefill(sp, batch), 1)
        res[f"profile_prefill_{mode}"] = profile_summary(
            f"profile {label} prefill {mode} (against a warm prefill of "
            f"{warm_ms:.1f} ms)", wall, warm_ms, by_name)
        decode, caches, nxt = kept.pop(mode)
        med = res[mode]["decode_ms_per_step_median"]
        # the same step eager, as it ran before it was captured
        rt, eager_ms = steps.serve_rt(mode), []
        for _ in range(5):
            t0 = time.monotonic()
            M.decode_step(rt, sp, cfg, nxt, caches, n + n_dec - 1)[0].argmax(-1)
            torch.cuda.synchronize()
            eager_ms.append((time.monotonic() - t0) * 1e3)
        res[mode]["eager_decode_ms_median"] = sorted(eager_ms)[2]
        if reckon:
            res[mode]["reckoning"] = dense_reckoning(
                torch, cfg, sp, caches, nxt, n + n_dec - 1, mode,
                res[mode]["decode_ms_per_step_median"])
        wall, by_name = device_ms_by_kernel(
            torch, lambda: decode(sp, caches, nxt, n + n_dec - 1), 4)
        prof = profile_summary(f"profile {label} decode {mode}: 4 replays",
                               wall, med, by_name)
        prof["wall_over_busy"] = med / prof["device_ms_per_step"]
        prof["eager_wall_over_busy"] = (res[mode]["eager_decode_ms_median"]
                                        / prof["device_ms_per_step"])
        log(f"  {label} decode {mode}: replayed step wall / device busy = "
            f"{prof['wall_over_busy']:.3f}; the eager step "
            f"{res[mode]['eager_decode_ms_median']:.2f} ms, "
            f"{prof['eager_wall_over_busy']:.3f} of device busy")
        res[f"profile_decode_{mode}"] = prof
        del decode, caches
    torch.cuda.empty_cache()
    if long_ctx:
        res["long_decode"] = long_decode(torch, cfg, sp, label)
    else:
        # what the 32k decode's caches would need beside the weights
        kv_token = (2 * cfg.n_layers * cfg.n_kv_heads
                    * cfg.resolved_head_dim * 2)
        kv_bytes = 8 * 32768 * kv_token
        weights = serving_memory_bytes(sp)["total_bytes"]
        free, total = torch.cuda.mem_get_info()
        res["long_decode"] = {"run": False, "kv_bytes_per_token": kv_token,
                              "kv_bytes": kv_bytes, "weight_bytes": weights,
                              "card_total_bytes": total}
        log(f"  {label} long decode not run: 8 rows x 32768 tokens x "
            f"{kv_token} B = {kv_bytes / 1e9:.1f} GB of KV beside "
            f"{weights / 1e9:.1f} GB of weights on a card of "
            f"{total / 1e9:.1f} GB")
    return res


def dense_reckoning(torch, cfg, sp, caches, nxt, pos: int, mode: str,
                    step_ms: float) -> dict:
    """The dry run (`launch/dryrun.py::reckon`, on meta tensors) of the
    dense-slot decode step that `dense_phase` just replayed, on a
    one-device layout (`make_debug_mesh(1, 1)`): its reckoned arguments
    against the bytes the params, planar caches, tokens and cache_len
    hold on the card (gate: within 1 %), its temporaries against one
    eager step's peak above what was allocated before it (a reading),
    and its roofline bound (H100 SXM5 data-sheet rates) against the
    replayed step's median (gate: bound / step <= 1.05; a bound above
    the measured time is a counting fault)."""
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as M
    from repro_torch.models.convert import serving_memory_bytes

    b, cap = nxt.shape[0], M.cache_capacity(caches)
    t0 = time.time()
    rec = dryrun.reckon(cfg, InputShape("dense decode", cap, b, "decode"),
                        make_debug_mesh(1, 1), mode=mode, kv="planar")
    reckon_s = time.time() - t0
    held = serving_memory_bytes(sp)["total_bytes"] + sum(
        p.numel() * p.element_size() for planes in caches.values()
        for p in planes.values()) + 4 * b + 4      # + tokens, cache_len
    args = rec["memory"]["argument_gib"] * 2**30
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    M.decode_step(steps.serve_rt(mode), sp, cfg, nxt, caches, pos)
    torch.cuda.synchronize()
    step_peak = torch.cuda.max_memory_allocated() - base
    roof = rec["roofline"]
    share = roof["bound_step_s"] * 1e3 / step_ms
    log(f"  dense reckoning {mode} ({reckon_s:.1f} s on meta tensors): "
        f"arguments {args:.0f} B reckoned, {held} B held on the card "
        f"({args / held - 1:+.2e}); temp {rec['memory']['temp_gib']:.3f} "
        f"GiB reckoned, an eager step peaked {step_peak / 2**30:.3f} GiB "
        f"above the {base / 2**30:.3f} GiB allocated; bound "
        f"{roof['bound_step_s'] * 1e3:.3f} ms ({roof['dominant']}: compute "
        f"{roof['compute_s'] * 1e3:.3f}, memory {roof['memory_s'] * 1e3:.3f}"
        f" ms) against the replayed step's {step_ms:.3f} ms: share "
        f"{share:.3f}; FLOPs by class "
        f"{rec['cost']['flops_global_by_class']}")
    check(abs(args - held) <= 0.01 * held,
          f"dense reckoning {mode}: {args:.0f} B reckoned against {held} B "
          f"held")
    check(share <= 1.05, f"dense reckoning {mode}: bound "
          f"{roof['bound_step_s'] * 1e3:.3f} ms above the measured "
          f"{step_ms:.3f} ms")
    return {"reckon_s": reckon_s, "argument_bytes": args, "held_bytes": held,
            "temp_gib": rec["memory"]["temp_gib"],
            "eager_step_peak_bytes": step_peak, "roofline": roof,
            "share": share, "flops_by_class": rec["cost"][
                "flops_global_by_class"],
            "analytic_traffic": rec["analytic_traffic"]}


def memory_reckoning(torch, cfg, label: str) -> dict:
    """Before a load: the card's free and total bytes, the serving tree's
    bytes reckoned on meta tensors (`to_serving(structural=True)`, nothing
    allocated), and what two copies would take instead (an FP16 copy and a
    separate FP8 copy of every linear weight, 3 bytes a weight, beside the
    same embedding and head). Fails loudly where the tree does not fit
    the free bytes: no phase runs fewer layers in its place."""
    from repro_torch.models import model as M
    from repro_torch.models.convert import serving_memory_bytes, to_serving
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    mem = serving_memory_bytes(to_serving(M.init_params(cfg, device="meta"),
                                          structural=True))
    two = mem["nested_bytes"] * 3 // 2 + mem["other_bytes"]
    log(f"  {label}: card {free / 1e9:.2f} GB free of {total / 1e9:.2f} GB "
        f"(mem_get_info) before the load; {torch.cuda.memory_allocated()} B "
        f"allocated; structural reckoning of the serving tree "
        f"{mem['total_bytes']} B ({mem['nested_bytes'] / 1e9:.2f} GB nested "
        f"+ {mem['other_bytes'] / 1e9:.2f} GB embedding, head and norms); "
        f"two copies (FP16 + FP8) would take {two / 1e9:.2f} GB against the "
        f"card's {total / 1e9:.2f} GB")
    check(mem["total_bytes"] < free,
          f"{label}: {mem['total_bytes']} B of weights do not fit the "
          f"{free} B free")
    return {"free_bytes_before": free, "card_total_bytes": total,
            "structural_nested_bytes": mem["nested_bytes"],
            "structural_total_bytes": mem["total_bytes"],
            "two_copy_bytes": two}


def long_decode(torch, cfg, sp, label: str, n_steps: int = 5,
                n_prof: int = 3) -> dict:
    """The dense decode step at long context, through `make_decode_step`:
    8 rows, all layers, planar caches of capacity 32768 from
    `init_cache(planar=True)` (a hybrid's shared-attention caches, one a
    group, made planar here beside its zero state) filled one layer at a
    time with the planes of random f16 (a 32k prefill would not fit the
    time limit), ragged cache lengths up to 32766 (kv lengths up to
    32767); fp16, then fp8.
    A mode's first call captures the step; a second call on the same
    inputs (a hybrid's state put back first) is its first replay, which
    rewrites the slots the eager call wrote and must give its logits
    bitwise (no clone of the caches needs
    to fit beside them); then n_steps replays (median step ms, host
    clock), then n_prof replays under the torch profiler (device busy ms
    and K5's ms a step), rewriting the same positions."""
    from repro_torch.core import nestedfp as nf
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import model as M

    b, cap = 8, 32768
    top = cap - 3 - n_steps          # the profiled steps' kv length: cap - 2
    lens0 = [top, 30001, 1, 20000, top, 5, 16384, 32000]
    torch.cuda.empty_cache()
    t_start = t0 = time.time()
    n_attn = cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" \
        else cfg.n_layers
    if cfg.family == "hybrid":
        caches = {"ssm": M.init_cache(cfg, b, 1, device="cuda")["ssm"],
                  "shared": {n: torch.zeros(
                      (n_attn, b, cap, cfg.n_kv_heads, cfg.resolved_head_dim),
                      dtype=torch.uint8, device="cuda")
                      for n in ("k_hi", "k_lo", "v_hi", "v_lo")}}
        planes = caches["shared"]
    else:
        caches = M.init_cache(cfg, b, cap, planar=True, device="cuda")
        planes = caches["attn"]
    gen = torch.Generator(device="cuda").manual_seed(13)
    for layer in range(n_attn):
        for kind in ("k", "v"):
            x = torch.randn(planes["k_hi"].shape[1:], generator=gen,
                            device="cuda", dtype=torch.float16)
            hi, lo = nf.split_bytes(x)
            planes[f"{kind}_hi"][layer].copy_(hi)
            planes[f"{kind}_lo"][layer].copy_(lo)
            del x, hi, lo
    torch.cuda.synchronize()
    cache_gb = sum(p.numel() for p in planes.values()) / 1e9
    log(f"  {label} long decode: {cache_gb:.1f} GB of planar caches (capacity "
        f"{cap}, {n_attn} attention layers) filled in {time.time() - t0:.1f} s")
    tokens = torch.randint(1, cfg.vocab_size, (b, 1), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(14),
                           dtype=torch.int32)
    res = {"batch": b, "capacity": cap, "cache_gb": cache_gb}
    k5 = ("planar_split_kernel", "combine_kernel")
    for mode in ("fp16", "fp8"):
        decode = steps.make_decode_step(cfg, mode)
        lens = torch.tensor(lens0, dtype=torch.int32, device="cuda")
        before = ops.all_launch_counters()["planar_decode_attention"]
        # a recurrent state advances in place: the replay starts from the
        # state the eager call read (attention caches are rewritten alike)
        state = {n: p.clone() for n, p in caches.get("ssm", {}).items()}
        first = decode(sp, caches, tokens, lens)[0].clone()   # eager + capture
        for n, p in state.items():
            caches["ssm"][n].copy_(p)
        again = decode(sp, caches, tokens, lens)[0]           # first replay
        del state
        check(bool(torch.equal(first, again)),
              f"{label} long decode {mode}: the first replay differs from "
              f"the eager call")
        nxt = again.argmax(-1).to(torch.int32)[:, None]
        step_ms = []
        for _ in range(n_steps):
            lens = lens + 1
            t0 = time.monotonic()
            logits, caches = decode(sp, caches, nxt, lens)
            nxt = logits.argmax(-1).to(torch.int32)[:, None]
            torch.cuda.synchronize()
            step_ms.append((time.monotonic() - t0) * 1e3)
        check(tuple(logits.shape) == (b, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()),
              f"{label} long decode {mode}: logits not finite or mis-shaped")
        check(decode.n_captured == len(decode.keys()) == 1,
              f"{label} long decode {mode}: {decode.n_captured} graphs")
        launched = ops.all_launch_counters()["planar_decode_attention"] - before
        check(launched == n_attn * (2 + n_steps),
              f"{label} long decode {mode}: K5 launched {launched} times")
        med = sorted(step_ms)[n_steps // 2]
        wall, by_name = device_ms_by_kernel(
            torch, lambda: decode(sp, caches, nxt, lens), n_prof)
        prof = profile_summary(
            f"profile {label} long decode {mode}: {n_prof} replays", wall,
            med, by_name)
        k5_ms = sum(v for k, v in by_name.items() if any(n in k for n in k5))
        (key,) = decode.keys()
        res[mode] = {"step_ms_median": med, "step_ms": step_ms,
                     "max_kv_len": int(lens.max()) + 1,
                     "k5_launches": launched,
                     "k5_device_ms_per_step": k5_ms,
                     "graph_device_ms": replay_ms(torch, decode.graph(key)),
                     "graph_pool_bytes": decode.pool_bytes(), **prof}
        log(f"  {label} long decode {mode}: first replay bitwise its eager "
            f"call; replayed step median {med:.2f} ms (host), graph device "
            f"{res[mode]['graph_device_ms']:.3f} ms, device busy "
            f"{prof['device_ms_per_step']:.2f} ms a step, K5 {k5_ms:.3f} ms a "
            f"step ({n_attn} calls), pool "
            f"{res[mode]['graph_pool_bytes'] / 2**20:.1f} MiB")
        del decode
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["seconds"] = time.time() - t_start
    log(f"  {label} long decode peak device memory {res['peak_mem_gb']:.1f} "
        f"GB, {res['seconds']:.1f} s in all")
    del caches, planes
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phases 6 and 7: sliding-window serving, gemma3-1b
# ---------------------------------------------------------------------------

# K4 and K5 at deepseek-coder-33b's heads (56 q heads over 8 kv heads,
# G = 7: one group of 7 rows a kv head in their split kernels), D = 128,
# FP16 and FP8: K4 at the llama lens (<= 256), K5 at the dense capacity
DS_K4 = dict(h=56, hkv=8, d=128, windows=(None,))
DS_K5 = dict(h=56, hkv=8, d=128, cases=(
    (1056, [1056, 1040, 17, 1, 700, 1056, 333, 1024], (None,)),))


def timed_phase(run) -> dict:
    """run() -> its result dict, with the phase's seconds added (logged)."""
    t0 = time.time()
    res = run()
    res["seconds"] = time.time() - t0
    log(f"  phase took {res['seconds']:.1f} s")
    return res


# K4 and K5 at gemma3-1b's heads (4 q heads, 1 kv head, D = 256), windows
# 0 (global) and 512 (a local layer): K4 over blocks of 16 keys at lens
# <= 1088 (the serve phase's capacity), K5 at lens <= 4096
GEMMA_K4 = dict(h=4, hkv=1, d=256, mb=68,
                lens_l=(1088, 1024, 513, 1, 600, 0, 512, 1087),
                windows=(0, 512))
GEMMA_K5 = dict(h=4, hkv=1, d=256, cases=(
    (4096, [4096, 4000, 1, 2048, 513, 512, 3333, 1024], (0, 512)),))


def gemma_slice_phase(torch, cfg) -> dict:
    """gemma3-1b at full width and 6 layers (0-4 local, 5 global; layer
    5's wo an exception tensor): `paged_step` on the card against the
    plain versions on the CPU, one block table per window group, planar
    KV, FP16 and FP8. Prompts of 600 and 520 tokens prefill in chunks of
    256, then 4 decode steps (K4) run past them, so the local layers'
    window of 512 cuts keys; the local table's blocks wholly before the
    window point at the trash block, as the engine's slides leave them."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models.convert import params_to
    from repro_torch.models.layers import Runtime

    cfg6 = dataclasses.replace(cfg, n_layers=6)
    desc = M.cache_descriptor(cfg6, planar=True)
    check(desc.group_windows == (None, 512)
          and list(desc.layer_group_map(6)) == [1, 1, 1, 1, 1, 0],
          f"gemma3 window groups {desc.groups}")
    t0 = time.time()
    sp_cpu = make_serving_params(torch, cfg6, 0, "cpu", plant_layer=5)
    sp_gpu = params_to(sp_cpu, "cuda")
    log(f"  6-layer full-width params made on the CPU in "
        f"{time.time() - t0:.1f} s")
    bs, chunk, n_dec, w = 16, 256, 4, cfg.sliding_window
    plens = [600, 520]
    mb = -(-(max(plens) + n_dec) // bs)
    gen = torch.Generator().manual_seed(3)
    ids = [torch.arange(1, 1 + 2 * mb, dtype=torch.int32).reshape(2, mb),
           (torch.randperm(2 * mb, generator=gen) + 1).to(torch.int32)
           .reshape(2, mb)]
    prompt = torch.randint(1, cfg.vocab_size, (2, max(plens)), generator=gen,
                           dtype=torch.int32)

    def tables_at(qo):
        """(2, 2, mb): the local group's blocks below each row's slide
        point (qo - w + 1) // bs point at the trash block."""
        loc = ids[1].clone()
        for r, q0 in enumerate(qo.tolist()):
            loc[r, :max(0, (q0 - w + 1) // bs)] = 0
        return torch.stack([ids[0], loc])

    out = {}
    for mode in ("fp16", "fp8"):
        rt = Runtime(mode=mode, dtype=torch.float32, act_quant="per_token")
        caches = {dev: M.init_paged_cache(cfg6, 1 + 2 * mb, bs, planar=True,
                                          device=dev)
                  for dev in ("cpu", "cuda")}
        params = {"cpu": sp_cpu, "cuda": sp_gpu}

        def step(dev, toks, qo, kvl, lp=None):
            return M.paged_step(
                rt, params[dev], cfg6, toks.to(dev), caches[dev],
                tables_at(qo).to(dev), q_offset=qo.to(dev),
                kv_len=kvl.to(dev), block_size=bs, return_logits=True,
                logit_position=None if lp is None else lp.to(dev))

        cmp = LogitCheck(torch, mode, SLICE_TOL[mode])
        lens = torch.zeros(2, dtype=torch.int32)
        plen = torch.tensor(plens, dtype=torch.int32)
        t0 = time.time()
        while bool((lens < plen).any()):
            take = torch.clamp(plen - lens, max=chunk)
            toks = torch.zeros((2, int(take.max())), dtype=torch.int32)
            for r in range(2):
                toks[r, :int(take[r])] = prompt[r, int(lens[r]):
                                                int(lens[r] + take[r])]
            want = step("cpu", toks, lens, lens + take,
                        torch.clamp(take - 1, min=0))
            got = step("cuda", toks, lens, lens + take,
                       torch.clamp(take - 1, min=0))
            cmp.add(got, want, f"prefill chunk at {lens.tolist()}")
            lens = lens + take
        for i in range(n_dec):
            nxt = want.argmax(-1).to(torch.int32)[:, None]  # teacher forcing
            before = ops.all_launch_counters()
            want = step("cpu", nxt, lens, lens + 1)
            got = step("cuda", nxt, lens, lens + 1)
            after = ops.all_launch_counters()
            check(after["paged_planar_decode_attention"]
                  > before["paged_planar_decode_attention"],
                  "gemma decode step did not launch K4")
            cmp.add(got, want, f"decode at {lens.tolist()}")
            lens = lens + 1
        check(int(lens.min()) > w, "the window cut no key")
        out[mode] = cmp.done("gemma slice")
        out[mode]["seconds"] = time.time() - t0
    # the dense-slot path on the same weights: prompts of 600 tokens, so
    # the window of 512 cuts keys; fp16 at 6 layers (the global layer 5
    # runs K6), fp8 at 2 layers as llama's slice; fp8 at 4 and 6 layers
    # gated at DEEP_FP8_TOL (ROADMAP F-port-7, F-port-8)
    t0 = time.time()
    out["dense"] = dense_slice(
        torch, cfg6, {"cpu": sp_cpu, "cuda": sp_gpu}, s=600, cap=608,
        runs=[("fp16", "f32", 6, True), ("fp16", "bf16", 6, True),
              ("fp8", "f32", 2, True), ("fp8", "bf16", 2, True),
              ("fp8", "f32", 4, DEEP_FP8_TOL),
              ("fp8", "f32", 6, DEEP_FP8_TOL)],
        label="gemma dense slice")
    out["dense"]["seconds"] = time.time() - t0
    return out


def gemma_serve_phase(torch, cfg, host_tier: bool = True) -> dict:
    """gemma3-1b at full width and depth (26 layers) through `Engine`,
    planar KV, window groups: 8 requests of 1024 prompt tokens and 64 new
    tokens in forced FP16, forced FP8 and dual mode, then forced FP16 with
    window reclaim off; each engine after a warm pass of 8 other prompts
    of the same shapes that captures its step keys and holds each key's
    replay bitwise against an eager call. Checks: blocks reclaimed from
    the local layers in every mode with reclaim on (none with it off),
    forced-FP16 tokens bitwise equal with reclaim on and off, no key
    captured in a timed run, K4 launched, each engine's graphs freed
    with it. `host_tier` is the engines' `host_offload`, as in
    `serve_phase`."""
    from repro_torch.core.policy import DualPrecisionController, SLOConfig
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models.convert import serving_memory_bytes
    from repro_torch.models.layers import Runtime
    from repro_torch.serving.engine import Engine, Request

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    sp = make_serving_params(torch, cfg, 0, "cuda", plant_layer=5)
    torch.cuda.synchronize()
    mem = serving_memory_bytes(sp)
    log(f"  {cfg.n_layers}-layer params on the card in {time.time() - t0:.1f}"
        f" s: {mem['nested_bytes'] / 1e9:.2f} GB nested, "
        f"{mem['other_bytes'] / 1e9:.2f} GB other")
    plen, max_new, cap = 1024, 64, 1088
    rng = torch.Generator().manual_seed(17)
    prompts = [torch.randint(1, cfg.vocab_size, (plen,), generator=rng)
               .tolist() for _ in range(24)]
    warm, prompts = [prompts[8:16], prompts[16:]], prompts[:8]
    results, tokens = {}, {}
    ops.reset_launch_counters()          # the gemma path's run starts here
    for policy, reclaim in (("fp16", True), ("fp8", True), ("dual", True),
                            ("fp16", False)):
        label = policy if reclaim else f"{policy}-no-reclaim"
        ctrl = None
        if policy == "dual":
            ctrl = DualPrecisionController(SLOConfig(), fp16_ms_per_token=0.5,
                                           fp8_ms_per_token=0.25)
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        eng = Engine(cfg, sp, n_slots=8, capacity=cap, kv_planar=True,
                     chunk_tokens=2 * plen, controller=ctrl,
                     forced_mode=None if policy == "dual" else policy,
                     window_reclaim=reclaim, host_offload=host_tier,
                     device="cuda")
        host_s = host_tier_timers(eng)
        t0 = time.monotonic()
        n_checked = 0
        for wi, mode in enumerate(["fp16", "fp8"] if ctrl else [policy]):
            eng.forced_mode = mode
            for i, p in enumerate(warm[wi]):
                eng.submit(Request(f"w{wi}.{i}", list(p), max_new=max_new))
            n_checked += serve_checked(eng, label, "gemma serve")
        eng.forced_mode = None if ctrl else policy
        torch.cuda.synchronize()
        warm_s = time.monotonic() - t0
        check(n_checked == len(eng.graphs.keys()) == eng.graphs.n_captured,
              f"gemma {label}: {n_checked} keys checked of "
              f"{len(eng.graphs.keys())}")
        n_graphs = eng.graphs.n_captured
        stats0, n_warm = dict(eng.stats), len(eng.finished)
        host0 = dict(host_s)
        for i, p in enumerate(prompts):
            eng.submit(Request(f"r{i}", list(p), max_new=max_new))
        before = ops.all_launch_counters()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        step_ms, decode_ms, decode_modes, peak = [], [], [], 0
        while eng.queue or eng.active or eng.prefilling:
            n_pre = eng.stats["prefill_dispatches"]
            eng.step()
            step_ms.append(eng._last_step_ms)
            peak = max(peak, eng.blocks.blocks_in_use())
            if eng.stats["prefill_dispatches"] == n_pre:
                decode_ms.append(eng._last_step_ms)
                decode_modes.append(ctrl.history[-1] if ctrl else policy)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {k: v - before[k]
                    for k, v in ops.all_launch_counters().items()}
        check(eng.graphs.n_captured == n_graphs,
              f"gemma {label}: a step key was captured inside the timed run")
        fin = eng.finished[n_warm:]
        check(len(fin) == 8, f"gemma {label}: {len(fin)}/8 requests finished")
        check(all(len(r.output) == max_new
                  and all(0 <= t < cfg.vocab_size for t in r.output)
                  for r in fin),
              f"gemma {label}: outputs of the wrong length or out of vocab")
        reclaimed = eng.stats["window_reclaimed_blocks"] \
            - stats0["window_reclaimed_blocks"]
        check((reclaimed > 0) == reclaim,
              f"gemma {label}: {reclaimed} blocks reclaimed")
        check(launches["paged_planar_decode_attention"] > 0,
              f"gemma {label}: K4 never launched")
        tokens[label] = {r.request_id: list(r.output) for r in fin}
        modes = [m for r in fin for m in r.modes]
        n_tok = sum(len(r.output) for r in fin)
        graph_dev = {m: replay_ms(torch, eng.graphs.graph(("decode", m)))
                     for m in sorted(set(decode_modes))}
        idle = sorted(1 - graph_dev[m] / x
                      for m, x in zip(decode_modes, decode_ms))
        res = {"wall_s": wall, "warm_pass_s": warm_s, "tokens": n_tok,
               "tokens_per_s": n_tok / wall, "steps": len(step_ms),
               "decode_step_ms_median": sorted(decode_ms)[len(decode_ms) // 2],
               "decode_graph_device_ms": graph_dev,
               "decode_idle_share_median": idle[len(idle) // 2],
               "ttft_ms_mean": 1e3 * sum(r.first_token_s - t0 for r in fin) / 8,
               "tpot_ms_mean": 1e3 * sum((r.finished_s - r.first_token_s)
                                         / (len(r.output) - 1)
                                         for r in fin) / 8,
               "fp16_fraction": modes.count("fp16") / len(modes),
               "window_reclaimed_blocks": reclaimed,
               "peak_blocks_in_use": peak,
               "pool_blocks_per_group": eng.blocks.n_blocks,
               "graphs": n_graphs,
               "keys": sorted(map(str, eng.graphs.keys())),
               "graph_pool_bytes": eng.graphs.pool_bytes(),
               "launches": launches, "replays_bitwise": n_checked,
               "spilled_blocks": eng.stats["spilled_blocks"]
               - stats0["spilled_blocks"],
               "host_tier_s": {k: v - host0[k] for k, v in host_s.items()}}
        log(f"  gemma serve {label}: {n_tok} tokens in {wall:.3f} s "
            f"({res['tokens_per_s']:.1f} tok/s), {len(step_ms)} steps, "
            f"decode-only step ms median {res['decode_step_ms_median']:.2f}, "
            f"decode graph device ms "
            f"{ {m: round(v, 3) for m, v in graph_dev.items()} }, idle share "
            f"{res['decode_idle_share_median']:.3f}, TTFT mean "
            f"{res['ttft_ms_mean']:.1f} ms, TPOT mean "
            f"{res['tpot_ms_mean']:.2f} ms, fp16 fraction "
            f"{res['fp16_fraction']:.2f}; window reclaimed {reclaimed} "
            f"blocks, peak blocks in use {peak} of "
            f"{eng.blocks.n_groups} x {eng.blocks.n_blocks}; {n_graphs} "
            f"graphs, pool {res['graph_pool_bytes'] / 2**20:.1f} MiB; "
            f"launches {launches}; host tier {'on' if host_tier else 'off'}"
            f", {res['spilled_blocks']} blocks spilled, host s in captures "
            f"{res['host_tier_s']['capture_s']:.4f} (checksums "
            f"{res['host_tier_s']['checksum_s']:.4f})")
        if reclaim and policy != "dual":
            wall_p, by_name = device_ms_by_kernel(
                torch, eng.graphs.graph(("decode", policy)).replay, 4)
            res["profile_decode"] = profile_summary(
                f"gemma profile {policy}: 4 decode graph replays", wall_p,
                res["decode_step_ms_median"], by_name)
            res["k4_device_ms_per_step"] = sum(
                v for k, v in by_name.items() if "paged_split_kernel" in k)
            log(f"  gemma profile {policy}: K4 (D = 256) "
                f"{res['k4_device_ms_per_step']:.3f} ms of device time a "
                f"decode step")
        pool = tuple(eng.graphs._pool)
        unwrap(eng)
        del eng
        torch.cuda.synchronize()
        left = torch.cuda.memory_allocated() - mem0
        torch.cuda.empty_cache()
        check(not [x for x in torch.cuda.memory_snapshot()
                   if tuple(x.get("segment_pool_id", ())) == pool],
              f"gemma {label}: the graphs' pool outlived its engine")
        check(left <= 128 * 2**20,
              f"gemma {label}: {left} bytes outlived the engine")
        results[label] = res
    results["launches_total"] = ops.all_launch_counters()   # the run ends
    check(tokens["fp16"] == tokens["fp16-no-reclaim"],
          "gemma fp16: tokens differ with window reclaim on and off")
    log("  gemma serve fp16: tokens bitwise equal with window reclaim on "
        "and off")
    # the tied LM head: the f32 (262144 x 1152) embedding against 8 rows,
    # inside every step's graph
    h = torch.randn((8, 1, cfg.d_model), device="cuda")
    rt = Runtime(mode="fp16", dtype=torch.float32)
    results["lm_head_device_ms"] = graph_ms(
        torch, lambda i: M.lm_logits(rt, sp, cfg, h), 1)
    log(f"  gemma tied LM head (8 rows): {results['lm_head_device_ms']:.4f} "
        f"ms device time")
    results["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"  gemma peak device memory {results['peak_mem_gb']:.1f} GB")
    return results


# ---------------------------------------------------------------------------
# phases 9-11: speculation and the tiered KV cache on the paged engine
# ---------------------------------------------------------------------------

MARGIN_RULE = 1e-3      # a spec-on or tier-on stream may part from its
                        # control only where the control's top-2 logit
                        # margin is below this: the two read the pool
                        # through other attention paths (K4 for one-token
                        # decodes, gathered attention for verify chunks),
                        # or prefill in other chunks, so they sum in other
                        # orders


def top2_margin(torch, cfg, sp, mode, seq) -> float:
    """The top-2 logit margin after `seq` (a prompt and the first tokens
    of a stream): one f32 `paged_step` over the whole sequence on the
    card, in a pool of its own. Leaves the launch counters as they were."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models.layers import Runtime

    before = ops.all_launch_counters()
    bs = 16
    nb = -(-len(seq) // bs)
    caches = probe_caches(cfg, nb + 1, device="cuda", n_slots=1)
    tables = torch.arange(1, nb + 1, dtype=torch.int32, device="cuda")[None]
    rt = Runtime(mode=mode, dtype=torch.float32, act_quant="per_token")
    n = torch.tensor([len(seq)], dtype=torch.int32, device="cuda")
    logits = M.paged_step(
        rt, sp, cfg, torch.tensor([seq], dtype=torch.int32, device="cuda"),
        caches, tables, q_offset=torch.zeros(1, dtype=torch.int32,
                                             device="cuda"),
        kv_len=n, block_size=bs, logit_position=n - 1, return_logits=True)
    top2 = logits[0].topk(2).values
    after = ops.all_launch_counters()
    # a reference recompute, not a launch of the path being counted
    ops.add_launches({k: before[k] - after[k] for k in after})
    return float(top2[0] - top2[1])


def margin_rule(torch, cfg, sp, mode, prompts, control, got, label,
                gated=True, rule: float = MARGIN_RULE, replay=None) -> dict:
    """Hold each stream of `got` to its `control` stream (request id ->
    tokens; prompts: request id -> prompt): equal, or parting only at a
    token where the control's top-2 margin, recomputed on the card, is
    below `rule` (default MARGIN_RULE). With `replay` (replay(prompt,
    tokens): the stream's first tokens replayed on both sides as the
    engine computed them, `stream_replays`), the margin is the replay's,
    and a parting also passes where it is below twice the two sides'
    logit difference at that token, or, for an MoE stack, where a
    routing flip of the replay sat at a near-tie. Prints every parting
    with its margin; a parting otherwise fails a gated check."""
    partings = []
    for rid, ref in sorted(control.items()):
        out = got[rid]
        j = next((i for i, (a, b) in enumerate(zip(ref, out)) if a != b),
                 None)
        if j is None:
            check(len(out) == len(ref) or not gated,
                  f"{label} {rid}: lengths differ")
            continue
        r = None if replay is None else replay(list(prompts[rid]), ref[:j])
        m = top2_margin(torch, cfg, sp, mode, list(prompts[rid]) + ref[:j]) \
            if r is None else r["margin"]
        partings.append({"request": rid, "position": j, "margin": m,
                         "replay": r})
        log(f"  {label}: {rid} parts from its control at token {j} "
            f"(control {ref[j]}, got {out[j]}), control top-2 margin "
            f"{m:.3e}" + ("" if r is None else
                          f", the two sides' logits there {r['err']:.3e} "
                          f"apart"))
        ok = m < rule
        if r is not None:
            routed = r.get("routing")
            ok = ok or m < 2 * r["err"] or (
                routed is not None and routed["layer_flips"] > 0
                and routed["near_ties"])
        check(ok or not gated,
              f"{label} {rid}: parts at token {j} with a top-2 margin of "
              f"{m:.3e} (rule {rule:.3e})")
    equal = len(control) - len(partings)
    log(f"  {label}: {equal}/{len(control)} streams equal to the control"
        f"{'' if gated else ' (a reading, not gated)'}")
    return {"equal_streams": equal, "streams": len(control),
            "partings": partings, "gated": gated}


def host_tier_timers(eng) -> dict:
    """Wrap the engine's spill capture and the host tier's checksums to
    add their host seconds to the returned dict (`capture_s`: whole
    captures, enqueue and settle (which overlaps the step's graph on the
    card), their checksums included; `checksum_s`: every checksum, at
    capture (`checksums`, on worker threads), match and drain). `unwrap`
    takes the wrappers off."""
    host_s = {"checksum_s": 0.0, "capture_s": 0.0}
    if eng.blocks.host is None:
        return host_s
    for obj, name, slot in ((eng.blocks.host, "checksum", "checksum_s"),
                            (eng.blocks.host, "checksums", "checksum_s"),
                            (eng, "_capture_blocks", "capture_s"),
                            (eng, "_settle_captures", "capture_s")):
        def timed_fn(*a, _f=getattr(obj, name), _slot=slot):
            t0 = time.perf_counter()
            out = _f(*a)
            host_s[_slot] += time.perf_counter() - t0
            return out
        setattr(obj, name, timed_fn)
    return host_s


def unwrap(eng) -> None:
    """Take `host_tier_timers`' wrappers and the tiered phase's upload
    recorder off the engine and its host tier: each holds a bound method
    of the object it is set on, a reference cycle that would keep the
    engine, its graph pool and its host entries alive past `del eng`;
    so does `record_captures`' wrapper, taken off too."""
    vars(eng.graphs).pop("_capture", None)
    for obj in (eng, eng.blocks.host):
        for name in ("_capture_blocks", "_settle_captures", "_tier_upload",
                     "checksum", "checksums"):
            if obj is not None and name in vars(obj):
                delattr(obj, name)


def record_captures(eng) -> dict:
    """Wrap the engine's graph capture to record, per key, the bytes its
    capture added to the graphs' shared pool."""
    g, grown = eng.graphs, {}
    capture = g._capture

    def recorded(st):
        before = g.pool_bytes()
        capture(st)
        grown[st.key] = g.pool_bytes() - before
    g._capture = recorded
    return grown


def record_reasons(ctrl) -> dict:
    """Wrap a DualPrecisionController's `decide` to count its decisions by
    reason: each FP8 decision by the overload tests that held (the cost
    model's prediction over budget, the measured FP16 p90 over budget, a
    KV pool below its free-block floor), and FP16 and FP8 dwell steps.
    The controller decides as before."""
    counts: dict[str, int] = {}
    decide = ctrl.decide

    def recorded(obs):
        mode = decide(obs)
        budget = ctrl.slo.tpot_ms * ctrl.slo.headroom
        why = [name for name, hit in (
            ("predicted", ctrl.predict_step_ms(
                obs.batch_tokens + obs.prefill_tokens, "fp16") > budget),
            ("measured", (ctrl._p90("fp16") or 0.0) > budget),
            ("kv_pool", obs.free_block_frac is not None
             and obs.free_block_frac < ctrl.slo.free_block_frac_min)) if hit]
        key = f"{mode}: " + ("+".join(why) if why and mode == "fp8" else
                             "dwell" if mode == "fp8" else "within budget")
        counts[key] = counts.get(key, 0) + 1
        return mode
    ctrl.decide = recorded
    return counts


def serve_burst(torch, eng, reqs, label) -> dict:
    """Submit [(request id, prompt, max_new)] and run to the end; returns
    the outputs, the wall s and the mean TTFT from the submission."""
    from repro_torch.serving.engine import Request

    n0 = len(eng.finished)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for rid, p, mx in reqs:
        eng.submit(Request(rid, list(p), max_new=mx))
    while eng.queue or eng.active or eng.prefilling:
        eng.step()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    fin = eng.finished[n0:]
    check(len(fin) == len(reqs), f"{label}: {len(fin)}/{len(reqs)} finished")
    check(all(len(r.output) == mx and all(0 <= t < eng.cfg.vocab_size
                                          for t in r.output)
              for r, (_i, _p, mx) in zip(sorted(fin, key=lambda r: r.request_id),
                                         sorted(reqs))),
          f"{label}: outputs of the wrong length or out of vocab")
    return {"outputs": {r.request_id: list(r.output) for r in fin},
            "wall_s": wall,
            "ttft_ms_mean": 1e3 * sum(r.first_token_s - t0 for r in fin)
            / len(fin),
            "tokens": sum(len(r.output) for r in fin)}


def spec_runs(torch, cfg, sp, *, label, modes, n_slots, capacity, prompts,
              warm, max_new, profile=False) -> dict:
    """Serve `prompts` in each mode with speculation off, then on, each
    engine after a warm pass over `warm` that captures its keys (each
    key's first replay held bitwise against an eager call inside its
    step, `serve_checked`); the spec-on engine then captures every spec
    key its warm pass left, and the timed run checks the first replay of
    each it uses the same way, so no key is captured in a timed run. Each
    spec-on stream is held to its spec-off stream by the margin rule
    (FP8: a reading). With `profile`, the widest spec key replayed and
    the decode key are profiled after the run (replays, not counted as
    launches of the path: the counts are read before)."""
    from repro_torch.core.policy import AdaptiveKController, SpeculationConfig
    from repro_torch.serving.engine import Engine, Request

    reqs = [(f"r{i}", p, max_new) for i, p in enumerate(prompts)]
    res = {}
    for mode in modes:
        outs = {}
        for spec in (False, True):
            tag = f"{label} {mode} spec {'on' if spec else 'off'}"
            scfg = SpeculationConfig(ngram_min=1) if spec else None
            eng = Engine(cfg, sp, n_slots=n_slots, capacity=capacity,
                         kv_planar=True, forced_mode=mode, device="cuda",
                         speculate=scfg)
            grown = record_captures(eng)
            t0 = time.monotonic()
            if spec:
                # the warm pass starts at the widest draft, so that every
                # chunk bucket is used (captured and checked) before the
                # timed run, which starts from a fresh K controller
                eng._spec_k.k = scfg.k_max
            for i, p in enumerate(warm):
                eng.submit(Request(f"w{i}", list(p), max_new=max_new))
            n_checked = serve_checked(eng, mode, tag)
            spec_keys = []
            if spec:
                eng._spec_k = AdaptiveKController(scfg)
                # the chunk buckets of 1 + K drafts, K <= k_max
                spec_keys = sorted({("spec", mode, 1 << k.bit_length())
                                    for k in range(1, scfg.k_max + 1)})
                for key in spec_keys:
                    eng.graphs.capture(key)
            warm_s = time.monotonic() - t0
            n_graphs = eng.graphs.n_captured
            stats0 = dict(eng.stats)
            eng.graphs.check_first_runs = True
            run = serve_burst(torch, eng, reqs, tag)
            eng.graphs.check_first_runs = False
            check(eng.graphs.n_captured == n_graphs,
                  f"{tag}: a step key was captured inside the timed run")
            for key, same in eng.graphs.checks.items():
                check(all(same.values()),
                      f"{tag} {key}: replay differs from the eager call {same}")
            st = {k: eng.stats[k] - stats0[k] for k in
                  ("decode_dispatches", "spec_dispatches", "spec_drafted",
                   "spec_accepted", "decode_rows", "decode_tokens",
                   "window_reclaimed_blocks", "preemptions")}
            r = {"wall_s": run["wall_s"], "tokens": run["tokens"],
                 "wall_ms_per_token": 1e3 * run["wall_s"] / run["tokens"],
                 "ttft_ms_mean": run["ttft_ms_mean"],
                 "warm_pass_s": warm_s, "stats": st,
                 "tokens_per_dispatch": st["decode_tokens"] / st["decode_rows"],
                 "acceptance_rate": st["spec_accepted"] / st["spec_drafted"]
                 if st["spec_drafted"] else 0.0,
                 "keys_checked_warm": n_checked,
                 "graph_pool_bytes": eng.graphs.pool_bytes()}
            log(f"  {tag}: {run['tokens']} tokens in {run['wall_s']:.3f} s, "
                f"{r['wall_ms_per_token']:.3f} wall ms an emitted token, "
                f"decode dispatches {st['decode_dispatches']} (verify chunks "
                f"{st['spec_dispatches']}), tokens a dispatch "
                f"{r['tokens_per_dispatch']:.3f}, acceptance "
                f"{r['acceptance_rate']:.3f} ({st['spec_accepted']}/"
                f"{st['spec_drafted']}), window reclaimed "
                f"{st['window_reclaimed_blocks']}, preemptions "
                f"{st['preemptions']}; graphs {n_graphs}, pool "
                f"{r['graph_pool_bytes'] / 2**20:.1f} MiB, warm pass "
                f"{warm_s:.1f} s")
            if spec:
                r["k_history"] = list(eng._spec_k.history)
                r["spec_keys"] = {}
                for key in spec_keys:
                    r["spec_keys"][str(key)] = v = {
                        "device_ms": replay_ms(torch, eng.graphs.graph(key)),
                        "pool_bytes_at_capture": grown.get(key, 0),
                        "replayed_and_checked": key in eng.graphs.checks}
                    log(f"  {tag} {key}: graph device ms "
                        f"{v['device_ms']:.3f}, pool grew "
                        f"{v['pool_bytes_at_capture'] / 2**20:.1f} MiB at its "
                        f"capture; first replay bitwise its eager call: "
                        f"{'yes' if v['replayed_and_checked'] else 'not replayed'}")
                check(all(v["replayed_and_checked"]
                          for v in r["spec_keys"].values()),
                      f"{tag}: a spec key was never replayed and checked")
                if profile:
                    # where a verify chunk's time goes, beside the decode
                    # step's: the widest spec key the run replayed
                    key = max(k for k in spec_keys if k in eng.graphs.checks)
                    for k in (key, ("decode", mode)):
                        wall_p, by_name = device_ms_by_kernel(
                            torch, eng.graphs.graph(k).replay, 4)
                        r[f"profile {k}"] = profile_summary(
                            f"{tag} profile {k}: 4 replays", wall_p,
                            replay_ms(torch, eng.graphs.graph(k)), by_name)
                h = r["k_history"]
                log(f"  {tag}: K history ({len(h)} steps) {h[:96]}"
                    f"{' ...' if len(h) > 96 else ''}")
            outs[spec] = run["outputs"]
            res[f"{mode}_{'on' if spec else 'off'}"] = r
            unwrap(eng)
            del eng
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        on, off = res[f"{mode}_on"], res[f"{mode}_off"]
        check(on["stats"]["spec_accepted"] > 0,
              f"{label} {mode}: no draft was accepted")
        check(on["stats"]["decode_dispatches"]
              < off["stats"]["decode_dispatches"],
              f"{label} {mode}: speculation cut no decode dispatch")
        log(f"  {label} {mode}: decode dispatches on "
            f"{on['stats']['decode_dispatches']} against off "
            f"{off['stats']['decode_dispatches']}; wall ms an emitted token "
            f"on {on['wall_ms_per_token']:.3f} against off "
            f"{off['wall_ms_per_token']:.3f}")
        res[f"{mode}_agreement"] = margin_rule(
            torch, cfg, sp, mode, {rid: p for rid, p, _ in reqs}, outs[False],
            outs[True], f"{label} {mode} spec on vs off",
            gated=mode == "fp16")
    return res


def pattern_prompts(torch, vocab, n, period, reps, seed):
    """n prompts, each a random `period`-token pattern repeated `reps`
    times, from a seeded generator."""
    gen = torch.Generator().manual_seed(seed)
    return [torch.randint(1, vocab, (period,), generator=gen).tolist() * reps
            for _ in range(n)]


def spec_phase(torch, cfg, sp) -> dict:
    """llama3.1-8b at full width (16 layers: DEPTH): 8 slots, capacity
    512, planar KV; 8 prompts of a 16-token pattern repeated 8 times, 128
    new tokens; FP16 and FP8, speculation off and on (`spec_runs`)."""
    from repro_torch.kernels import ops

    ops.reset_launch_counters()          # this path's run starts here
    prompts = pattern_prompts(torch, cfg.vocab_size, 16, 16, 8, seed=23)
    res = spec_runs(torch, cfg, sp, label="spec", modes=("fp16", "fp8"),
                    n_slots=8, capacity=512, prompts=prompts[:8],
                    warm=prompts[8:], max_new=128, profile=True)
    res["launches_total"] = ops.all_launch_counters()   # the run ends
    for name in ("nestedfp16_matmul", "nestedfp8_matmul", "quant_per_token",
                 "f16_matmul", "paged_planar_decode_attention"):
        check(res["launches_total"][name] > 0, f"spec: {name} never launched")
    return res


def gemma_spec_phase(torch, cfg) -> dict:
    """gemma3-1b at full width and depth: window 512 on the local layers,
    4 slots, capacity 1024, planar KV; 4 prompts of a 24-token pattern
    repeated 32 times (768 tokens), 96 new tokens; FP16, speculation off
    and on. The window slides during verify chunks, so `truncate` meets
    slide-freed holes."""
    from repro_torch.kernels import ops

    sp = make_serving_params(torch, cfg, 0, "cuda", plant_layer=5)
    ops.reset_launch_counters()          # this path's run starts here
    prompts = pattern_prompts(torch, cfg.vocab_size, 8, 24, 32, seed=29)
    res = spec_runs(torch, cfg, sp, label="gemma spec", modes=("fp16",),
                    n_slots=4, capacity=1024, prompts=prompts[:4],
                    warm=prompts[4:], max_new=96, profile=True)
    res["launches_total"] = ops.all_launch_counters()   # the run ends
    check(res["fp16_on"]["stats"]["window_reclaimed_blocks"] > 0,
          "gemma spec: no local-layer block was reclaimed")
    check(res["launches_total"]["paged_planar_decode_attention"] > 0,
          "gemma spec: K4 never launched")
    return res


def tiered_phase(torch, cfg, sp) -> dict:
    """llama3.1-8b at full width and depth through `Engine` with the host
    KV tier: planar KV, 4 slots, capacity 1152, blocks of 16, 120 blocks.
    Two system prompts of 1024 tokens (64 blocks, 128 MiB of planes each)
    and bursts of 4 requests (system prompt + 64 tokens of their own, 32
    new tokens): A, then B, then A again. The pool holds one prefix beside
    a burst but not two, so A's blocks spill during B and are restored in
    the third burst.

    FP16 with the tier on (the restore uploads are timed with a sync on
    each side, for the h2d rate) and off; the third burst's TTFT, restore
    against recompute; the tier-on tokens held to the tier-off tokens by
    the margin rule. Then FP8 with the tier on through the same bursts
    (hi planes restored only: half of FP16's bytes a block) and a fourth
    burst A in FP16, which lands the deferred lo planes; every upload's
    blocks are compared with their host entries byte for byte after the
    burst. Last, the FP16 engine's prefix store is saved, the engine
    freed, and a new `Engine(persist_dir=...)` serves burst A from the
    host tier with the first engine's tokens."""
    import shutil

    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Engine

    store = ROOT / "prefix_store"
    shutil.rmtree(store, ignore_errors=True)
    gen = torch.Generator().manual_seed(31)
    sysp = {s: torch.randint(1, cfg.vocab_size, (1024,), generator=gen)
            .tolist() for s in "AB"}

    def burst(s, b):
        return [(f"{s}{b}.{i}", sysp[s] + torch.randint(
            1, cfg.vocab_size, (64,), generator=torch.Generator()
            .manual_seed(1000 * b + i)).tolist(), 32) for i in range(4)]
    order = [("A", 0), ("B", 1), ("A", 2)]
    prompts = {rid: p for s, b in order for rid, p, _ in burst(s, b)}

    def engine(mode, host, **kw):
        return Engine(cfg, sp, n_slots=4, capacity=1152, kv_planar=True,
                      block_size=16, n_blocks=120, forced_mode=mode,
                      host_offload=host, device="cuda", **kw)

    def watch(eng, timed):
        """Record every upload (and, if `timed`, its wall time between two
        syncs) for the checks after the burst; with `timed`, also the
        host seconds spent in host-entry checksums and in spill captures
        (`host_tier_timers`)."""
        seen = []
        host_s = host_tier_timers(eng) if timed else {}
        upload = eng._tier_upload

        def recorded(g, items, names):
            if timed:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = upload(g, items, names)
            if timed:
                torch.cuda.synchronize()
            seen.append((g, list(items), names, n, time.perf_counter() - t0))
            return n
        eng._tier_upload = recorded
        return seen, host_s

    def bytes_match(eng, seen) -> int:
        """Compare each uploaded block still holding its entry's content
        with the entry, plane by plane; returns the blocks compared."""
        bm, n = eng.blocks, 0
        torch.cuda.synchronize()
        for g, items, names, _n, _t in seen:
            li = eng._group_layers[g]
            for b, h in items:
                if bm._hash_of.get((g, b)) != h or (g, h) not in bm.host:
                    continue
                entry = bm.host.entries[(g, h)]
                for name in names:
                    got = eng.caches["attn"][name][li, b].cpu().numpy()
                    check(got.tobytes() == entry[name].tobytes(),
                          f"tiered: block {g}/{b} {name} differs from its "
                          f"host entry")
                n += 1
        return n

    ops.reset_launch_counters()          # this path's run starts here
    res, outs = {}, {}
    for host in (True, False):
        tag = f"tiered fp16 host {'on' if host else 'off'}"
        eng = engine("fp16", host)
        seen, host_s = watch(eng, timed=True) if host else ([], {})
        bursts, parts = {}, {}
        for s, b in order:
            before = dict(host_s)
            n_up = len(seen)
            bursts[f"{s}{b}"] = serve_burst(torch, eng, burst(s, b),
                                            f"{tag} {s}{b}")
            if host:
                parts[f"{s}{b}"] = dict(
                    {k: host_s[k] - before[k] for k in host_s},
                    upload_s=sum(x[-1] for x in seen[n_up:]))
        outs[host] = {k: v for r in bursts.values()
                      for k, v in r["outputs"].items()}
        ts = eng.tiered_stats()
        r = {"tiered_stats": ts,
             "ttft_ms_mean": {k: v["ttft_ms_mean"] for k, v in bursts.items()},
             "wall_s": {k: v["wall_s"] for k, v in bursts.items()},
             "graphs": eng.graphs.n_captured, "host_s_by_burst": parts}
        if host:
            # every timed upload (hi planes at restore, lo planes at the
            # first FP16 touch) against the bytes each returned
            up_s = sum(t for *_x, t in seen)
            r["upload_bytes"] = sum(x[3] for x in seen)
            check(r["upload_bytes"] == ts["restored_bytes"]
                  + ts["lo_lazy_bytes"], f"{tag}: upload bytes disagree")
            r["restore_gb_s"] = r["upload_bytes"] / up_s / 1e9
            r["uploads"] = len(seen)
            r["blocks_compared"] = bytes_match(eng, seen)
            check(ts["restored_blocks"] > 0, f"{tag}: nothing restored")
            check(eng.stats["corrupt_fallbacks"] == 0,
                  f"{tag}: a host entry failed its checksum")
            n_saved = eng.save_prefix_store(str(store))
            r["store_entries"] = n_saved
            r["store_bytes"] = sum(f.stat().st_size for f in store.iterdir())
        log(f"  {tag}: spilled {ts['spilled_blocks']} blocks "
            f"({ts['spilled_bytes'] / 2**20:.1f} MiB), restored "
            f"{ts['restored_blocks']} ({ts['restored_bytes'] / 2**20:.1f} "
            f"MiB, hi planes) and lo planes of {ts['lo_lazy_blocks']} "
            f"({ts['lo_lazy_bytes'] / 2**20:.1f} MiB), restore fallbacks "
            f"{ts['restore_fallbacks']}, host hits "
            f"{ts['host_hit_blocks']} blocks; TTFT mean by burst "
            f"{ {k: round(v, 1) for k, v in r['ttft_ms_mean'].items()} } ms"
            + (f"; restore uploads {r['uploads']} "
               f"({r['upload_bytes'] / 2**20:.1f} MiB, hi and lo planes) at "
               f"{r['restore_gb_s']:.2f} GB/s (host staging, h2d and "
               f"scatter, between syncs); {r['blocks_compared']} restored "
               f"blocks equal their host entries; prefix store "
               f"{r['store_entries']} entries, "
               f"{r['store_bytes'] / 2**20:.1f} MiB; host s by burst "
               f"{ {k: {x: round(y, 4) for x, y in v.items()} for k, v in parts.items()} }"
               if host else ""))
        res[f"fp16_{'on' if host else 'off'}"] = r
        unwrap(eng)
        del eng
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    on, off = res["fp16_on"], res["fp16_off"]
    log(f"  tiered fp16: third burst TTFT mean {on['ttft_ms_mean']['A2']:.1f}"
        f" ms restoring against {off['ttft_ms_mean']['A2']:.1f} ms "
        f"recomputing")
    res["fp16_agreement"] = margin_rule(
        torch, cfg, sp, "fp16", prompts, outs[False], outs[True],
        "tiered fp16 host on vs off")
    # FP8 restores the hi planes only; a fourth burst A in FP16 lands the
    # deferred lo planes
    eng = engine("fp8", True)
    seen, _ = watch(eng, timed=False)
    for s, b in order:
        serve_burst(torch, eng, burst(s, b), f"tiered fp8 {s}{b}")
    ts8 = eng.tiered_stats()
    eng.forced_mode = "fp16"
    serve_burst(torch, eng, burst("A", 3), "tiered fp8 then fp16 A3")
    ts = eng.tiered_stats()
    n_cmp = bytes_match(eng, seen)
    check(eng.stats["corrupt_fallbacks"] == 0,
          "tiered fp8: a host entry failed its checksum")
    # bytes uploaded a restored block: a planar restore sends the hi
    # planes at once and the lo planes at the first FP16 step, which in
    # FP16 mode is the restore's own step
    ts16 = on["tiered_stats"]
    per16 = (ts16["restored_bytes"] + ts16["lo_lazy_bytes"]) \
        / ts16["restored_blocks"]
    check(ts8["restored_blocks"] > 0, "tiered fp8: nothing restored")
    per8 = (ts8["restored_bytes"] + ts8["lo_lazy_bytes"]) \
        / ts8["restored_blocks"]
    check(per8 * 2 == per16, f"tiered fp8: {per8} bytes uploaded a "
          f"restored block against FP16's {per16}")
    check(ts["lo_lazy_blocks"] > 0, "tiered fp8 then fp16: no lo plane landed")
    res["fp8_on"] = {"tiered_stats_after_third_burst": ts8,
                     "tiered_stats": ts, "blocks_compared": n_cmp,
                     "restored_bytes_per_block": per8,
                     "fp16_restored_bytes_per_block": per16}
    log(f"  tiered fp8: restored {ts8['restored_blocks']} blocks, "
        f"{per8 / 2**20:.2f} MiB uploaded a block against FP16's "
        f"{per16 / 2**20:.2f}; then FP16 landed {ts['lo_lazy_blocks']} "
        f"deferred lo planes ({ts['lo_lazy_bytes'] / 2**20:.1f} MiB); "
        f"{n_cmp} uploaded blocks equal their host entries")
    unwrap(eng)
    del eng
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # a new engine on the saved prefix store
    eng = engine("fp16", True, persist_dir=str(store))
    loaded = len(eng.blocks.host)
    run = serve_burst(torch, eng, burst("A", 0), "tiered restart A0")
    hits = eng.blocks.prefix_stats["host_hit_blocks"]
    check(loaded > 0 and hits > 0,
          f"tiered restart: {loaded} entries loaded, {hits} host hits")
    res["restart"] = {"loaded_entries": loaded, "host_hit_blocks": hits,
                      "ttft_ms_mean": run["ttft_ms_mean"],
                      "restored_blocks": eng.stats["restored_blocks"]}
    res["restart_agreement"] = margin_rule(
        torch, cfg, sp, "fp16", prompts,
        {k: v for k, v in outs[True].items() if k.startswith("A0.")},
        run["outputs"], "tiered restart vs first engine")
    log(f"  tiered restart: {loaded} entries loaded, {hits} host-tier hits, "
        f"TTFT mean {run['ttft_ms_mean']:.1f} ms")
    unwrap(eng)
    del eng
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    shutil.rmtree(store, ignore_errors=True)
    res["launches_total"] = ops.all_launch_counters()   # the run ends
    return res


# ---------------------------------------------------------------------------
# phase 12: the fleet (router, fault injection, degradation), llama3.1-8b
# ---------------------------------------------------------------------------

# each replica: 4 slots, planar KV, host tier on, 112 blocks of 16: the
# four prompts a replica admits (two or three system prompts among them)
# fill the pool, so the first decode blocks preempt the youngest row and
# its blocks spill to the host tier before any request finishes
FLEET_ENGINE = dict(n_slots=4, capacity=640, kv_planar=True, block_size=16,
                    n_blocks=112, forced_mode="fp16")
FLEET_SLACK = 608       # a primary two requests ahead of the least loaded
                        # yields: the burst lands 3 / 4 / 5
# (router step, replica, kind[, ms]): the corrupt lands on replica 2 while
# its host tier holds only the blocks of preempted rows, which re-admit
# later and walk their chains through the corrupted entry
FLEET_PLAN = [(3, 1, "stall", 50.0), (10, 1, "raise"), (20, 0, "kill"),
              (45, 2, "corrupt"), (50, 0, "revive")]
FLEET_REBUILD_STEP = 16
FLEET_CHAOS = dict(seed=2, replicas=3, steps=90, p_raise=0.02, p_stall=0.1,
                   p_corrupt=0.05, p_kill=0.02, revive_after=20)
FLEET_SHED_BUDGET = 2400


def fleet_phase(torch, cfg, sp) -> dict:
    """llama3.1-8b at full width and depth behind the port's `Router`: three
    replicas built by `Router.build` from one serving tree (one copy of the
    weights, asserted by address; a pool and a graph pool each), forced
    FP16, planar KV, host tier on. Traffic: 4 system prompts of 512 tokens,
    each shared by 3 requests of 32 own tokens and 64 new tokens, spread
    over the replicas by a balance slack.

    1. control: no faults.
    2. planned: a 50 ms stall, a raise on replica 1, a kill of replica 0
       mid-decode, a corrupted host entry on replica 2 and the revive of
       replica 0. Nothing lost, every request complete, failover tokens
       restored and recomputed, the corruption caught and recomputed, and
       every stream equal to the control's or parting below MARGIN_RULE.
    3. rebuild: replica 0 raises mid-decode and its drain fails; the
       router rebuilds it from its factory. The old engine must be gone
       (no reference, its pool returned) before the new one is built, and
       the rebuild grows the allocated bytes by no more than the new
       engine's pool.
    4. chaos: a seeded `FaultPlan` over the 3 replicas with requests
       arriving over the run, under a `VirtualClock` and a
       `StepCostModel` fitted to this run's measured FP16 and FP8 step
       times, with and without `DegradePolicy(force_fp8=True,
       shed_budget_tokens=...)`: nothing lost, sheds counted; the modelled
       p90 TPOT of both is printed.

    Every run is held to its plan: the router catches any exception of a
    replica's step and fails its requests over, so a run's step errors
    must be exactly its fired injected raises, its kills and revives no
    more than planned, and a rebuild only where the phase failed a drain.

    On one card the replicas step one after another, so the wall time of a
    router step is the sum of its replicas' steps; the modelled latency
    comes from the VirtualClock."""
    import collections
    import gc
    import weakref

    import numpy as np

    from repro_torch.core.policy import DegradePolicy
    from repro_torch.kernels import ops
    from repro_torch.models.convert import leaves
    from repro_torch.serving.engine import Request
    from repro_torch.serving.faults import FaultEvent, FaultPlan
    from repro_torch.serving.router import Router, StepCostModel, VirtualClock

    def allocated() -> int:
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    def pool_bytes(eng) -> int:
        return sum(p.numel() * p.element_size()
                   for p in eng.caches["attn"].values())

    gen = torch.Generator().manual_seed(41)
    sysp = [torch.randint(1, cfg.vocab_size, (512,), generator=gen).tolist()
            for _ in range(4)]
    prompts = {f"p{s}.{i}": sysp[s] + torch.randint(
        1, cfg.vocab_size, (32,), generator=gen).tolist()
        for s in range(4) for i in range(3)}
    max_new = 64

    def fleet(plan=None, engine=None, **kw) -> Router:
        ekw = dict(FLEET_ENGINE, **(engine or {}))
        return Router.build(cfg, sp, 3, engine_kwargs=ekw, plan=plan,
                            affinity_blocks=1,
                            balance_slack_tokens=FLEET_SLACK, **kw)

    def finish(r, label, t0, plan=None, rebuilds=0) -> dict:
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = r.stats()
        n = len(prompts)
        # only injected faults may be absorbed: any other exception of a
        # step would count as a step error and fail over unseen
        fired = r.injector.fired if r.injector is not None else []
        planned = collections.Counter(
            e.kind for e in (plan.events if plan is not None else []))
        check(st["step_errors"] == sum(e.kind == "raise" for e in fired)
              and st["kills"] <= planned["kill"]
              and st["revives"] <= planned["revive"]
              and st["rebuilds"] == rebuilds
              and all(x.usable for x in r.replicas),
              f"{label}: a failure that was not injected: {brief(st)}; "
              f"fired {collections.Counter(e.kind for e in fired)}, "
              f"planned {dict(planned)}")
        check(st["lost"] == 0, f"{label}: {st['lost']} requests lost")
        check(st["completed"] + st["shed"] == n and st["in_flight"] == 0,
              f"{label}: {st['completed']} completed + {st['shed']} shed "
              f"of {n}")
        check(st["shed"] == len(r.shed_requests),
              f"{label}: sheds not counted")
        outs = {q.request_id: list(q.output) for q in r.finished}
        check(all(len(o) == max_new and all(0 <= t < cfg.vocab_size
                                            for t in o)
                  for o in outs.values()),
              f"{label}: outputs of the wrong length or out of vocab")
        return {"outputs": outs, "stats": st, "wall_s": wall,
                "steps": r.step_count}

    def serve(r, label, plan=None) -> dict:
        t0 = time.perf_counter()
        for rid, p in prompts.items():
            r.submit(Request(rid, list(p), max_new))
        r.run()
        return finish(r, label, t0, plan)

    def brief(st) -> str:
        keys = ("steps", "replicas", "kills", "revives", "step_errors",
                "rebuilds", "failover_requests", "failover_restored_tokens",
                "failover_recomputed_tokens", "corrupt_detected",
                "corrupt_fallbacks", "degrade_fp8_steps", "shed", "stall_ms")
        return ", ".join(f"{k} {st[k]}" for k in keys)

    def timed_steps(eng, samples):
        """Record each launched step's wall ms (each step ends in the
        engine's one host sync), mode, decode and prefill tokens; steps
        that captured a graph are left out (a capture runs the step
        eagerly first)."""
        step = eng.step

        def timed():
            d0, c0 = eng.stats["decode_tokens"], eng.stats["chunk_tokens"]
            n0 = eng.graphs.n_captured
            t0 = time.perf_counter()
            step()
            ms = (time.perf_counter() - t0) * 1e3
            dt = (eng.stats["decode_tokens"] - d0,
                  eng.stats["chunk_tokens"] - c0)
            if any(dt) and eng.graphs.n_captured == n0:
                samples.append((ms, eng.last_mode) + dt)
        eng.step = timed

    res: dict = {}
    ops.reset_launch_counters()          # this path's run starts here
    a_start = allocated()

    # 1. control, its step times (FP16), then FP8 step times on the same
    # engines
    r = fleet()
    engines = [rep.engine for rep in r.replicas]
    ptrs = [[t.data_ptr() for t in leaves(e.params)] for e in engines]
    check(ptrs[0] == ptrs[1] == ptrs[2]
          == [t.data_ptr() for t in leaves(sp)],
          "fleet: the replicas do not share one copy of the weights")
    samples: list = []
    for e in engines:
        timed_steps(e, samples)
    control = serve(r, "fleet control")
    placed = {q.request_id: i for i, e in enumerate(engines)
              for q in e.finished}
    for i, e in enumerate(engines):
        # FP8 step samples: four fresh prompts of the same length a replica
        e.forced_mode = "fp8"
        for j in range(4):
            e.submit(Request(f"fp8.{i}.{j}", torch.randint(
                1, cfg.vocab_size, (544,), generator=gen).tolist(), 32))
        e.run()
        del e.step                       # the timer held a bound method
    res["replicas"] = [{"requests": sorted(k for k, v in placed.items()
                                           if v == i),
                        "pool_bytes": pool_bytes(e),
                        "graph_pool_bytes": e.graphs.pool_bytes(),
                        "graphs": e.graphs.n_captured}
                       for i, e in enumerate(engines)]
    weights = sum(t.numel() * t.element_size() for t in leaves(sp))
    for i, x in enumerate(res["replicas"]):
        log(f"  fleet replica {i}: requests {x['requests']}, pool "
            f"{x['pool_bytes'] / 2**20:.1f} MiB, graph pool "
            f"{x['graph_pool_bytes'] / 2**20:.1f} MiB ({x['graphs']} graphs)")
    log(f"  fleet: 3 replicas share one copy of the weights "
        f"({weights / 2**30:.2f} GiB, same addresses)")
    res["control"] = {k: v for k, v in control.items() if k != "outputs"}
    log(f"  fleet control: {control['steps']} router steps, "
        f"{control['wall_s']:.2f} s wall; {brief(control['stats'])}")
    del r, engines, e
    # fit StepCostModel per mode: decode-only steps by least squares, ms =
    # a + d * rows; prefill steps give the median ms a prefill token over
    # that line. The model's one fixed cost is the smaller intercept; a
    # mode's excess intercept is spread over its mean decode rows.
    modes = ("fp16", "fp8")
    fit, per_token, prefill = {}, {}, {}
    for m in modes:
        dec = [(ms, d) for ms, mm, d, c in samples if mm == m and not c]
        A = np.array([[1.0, d] for _ms, d in dec])
        a, d = np.linalg.lstsq(A, np.array([ms for ms, _d in dec]),
                               rcond=None)[0]
        a, d = float(a), max(float(d), 0.0)
        pre = [(ms - a - d * dd) / c for ms, mm, dd, c in samples
               if mm == m and c]
        fit[m] = {"a": a, "d": d, "decode_steps": len(dec),
                  "prefill_steps": len(pre),
                  "mean_rows": float(np.mean([dd for _ms, dd in dec]))}
        prefill[m] = max(float(np.median(pre)), 0.0)
    fixed = min(f["a"] for f in fit.values())
    for m in modes:
        per_token[m] = fit[m]["d"] + (fit[m]["a"] - fixed) \
            / fit[m]["mean_rows"]
    cost = StepCostModel(fixed_ms=fixed, ms_per_token=per_token,
                         prefill_ms_per_token=prefill)
    res["cost_model"] = dataclasses.asdict(cost)
    res["cost_fit"] = fit
    log(f"  fleet cost model from this run's steps (captures left out): "
        + "; ".join(f"{m} decode {f['decode_steps']} steps, ms = "
                    f"{f['a']:.3f} + {f['d']:.4f} x rows (mean rows "
                    f"{f['mean_rows']:.2f}), {f['prefill_steps']} prefill "
                    f"steps" for m, f in fit.items())
        + f"; model: fixed {cost.fixed_ms:.3f} ms, decode ms a token "
        f"{ {m: round(v, 4) for m, v in per_token.items()} }, prefill ms a "
        f"token { {m: round(v, 4) for m, v in prefill.items()} }")

    def agree(run, label):
        return margin_rule(torch, cfg, sp, "fp16", prompts,
                           control["outputs"], run["outputs"], label)

    # 2. the planned plan
    plan = FaultPlan([FaultEvent(*e) for e in FLEET_PLAN])
    r = fleet(plan, clock=VirtualClock(), cost_model=cost)
    planned = serve(r, "fleet planned", plan)
    st = planned["stats"]
    fired = sorted({e.kind for e in r.injector.fired}
                   | {k for k in ("kill", "revive") if st[k + "s"]})
    check(fired == sorted(e[2] for e in FLEET_PLAN),
          f"fleet planned: fired {fired}")
    check(st["kills"] == 1 and st["revives"] == 1 and st["step_errors"] == 1,
          f"fleet planned: {brief(st)}")
    check(st["failover_restored_tokens"] > 0
          and st["failover_recomputed_tokens"] > 0,
          f"fleet planned: failover tokens restored "
          f"{st['failover_restored_tokens']}, recomputed "
          f"{st['failover_recomputed_tokens']}")
    preempted = sum(rep.engine.stats["preemptions"] for rep in r.replicas)
    check(st["corrupt_detected"] >= 1,
          f"fleet planned: the corrupted host entry was never caught")
    log(f"  fleet planned: {planned['steps']} router steps, "
        f"{planned['wall_s']:.2f} s wall; {brief(st)}; preemptions "
        f"{preempted}; host entries by replica "
        f"{[len(rep.engine.blocks.host) for rep in r.replicas]}")
    res["planned"] = {k: v for k, v in planned.items() if k != "outputs"}
    res["planned"]["agreement"] = agree(planned, "fleet planned vs control")
    del r

    # 3. a drain failure rebuilt from the factory
    plan = FaultPlan([FaultEvent(FLEET_REBUILD_STEP, 0, "raise")])
    r = fleet(plan)
    rep = r.replicas[0]

    def failed_drain():
        raise RuntimeError("fleet rebuild: drain failed")
    rep.engine.drain_requests = failed_drain
    mem: dict = {}
    build = rep.factory

    def factory():
        mem["free"] = allocated()        # the old engine must be gone here
        mem["old_alive"] = old() is not None
        eng = build()
        mem["built"] = allocated()
        mem["new_pool"] = pool_bytes(eng)
        return eng
    rep.factory = factory
    t0 = time.perf_counter()
    for rid, p in prompts.items():
        r.submit(Request(rid, list(p), max_new))
    while r.in_flight():
        if r.step_count == FLEET_REBUILD_STEP:
            old = weakref.ref(rep.engine)
            old_pool = rep.engine.graphs._pool
            mem["old_pool"] = pool_bytes(rep.engine)
            mem["old_graphs"] = rep.engine.graphs.pool_bytes()
            mem["before"] = allocated()
        r.step()
    rebuild = finish(r, "fleet rebuild", t0, plan, rebuilds=1)
    st = rebuild["stats"]
    check(st["rebuilds"] == 1 and st["step_errors"] == 1,
          f"fleet rebuild: {brief(st)}")
    check(not mem["old_alive"] and old() is None,
          "fleet rebuild: the old engine outlived its rebuild")
    returned = mem["before"] - mem["free"]
    check(returned >= mem["old_pool"],
          f"fleet rebuild: {returned} bytes returned, the old pool alone "
          f"is {mem['old_pool']}")
    grown = mem["built"] - mem["before"]
    check(grown <= mem["new_pool"],
          f"fleet rebuild grew the allocated bytes by {grown}, more than "
          f"the new engine's pool ({mem['new_pool']})")
    torch.cuda.empty_cache()
    check(not [g for g in torch.cuda.memory_snapshot()
               if tuple(g.get("segment_pool_id", ())) == tuple(old_pool)],
          "fleet rebuild: the old engine's graph pool is still held")
    mem["returned"] = returned
    mem["grown"] = grown
    res["rebuild"] = {k: v for k, v in rebuild.items() if k != "outputs"}
    res["rebuild"]["memory"] = mem
    log(f"  fleet rebuild: {brief(st)}; old engine freed before the new "
        f"one was built: {returned / 2**20:.1f} MiB returned "
        f"(its pool {mem['old_pool'] / 2**20:.1f} MiB, graph pool "
        f"{mem['old_graphs'] / 2**20:.1f} MiB), the rebuild grew the "
        f"allocated bytes by {grown / 2**20:.1f} MiB (the new "
        f"pool {mem['new_pool'] / 2**20:.1f} MiB)")
    res["rebuild"]["agreement"] = agree(rebuild, "fleet rebuild vs control")
    del r, rep

    # 4. seeded chaos, requests arriving over the run, with and without
    # degradation; both on the fitted cost model's virtual clock
    seed = FLEET_CHAOS["seed"]
    plan = FaultPlan.seeded(seed, **{k: v for k, v in FLEET_CHAOS.items()
                                     if k != "seed"})
    arrivals = {rid: 3 * i for i, rid in enumerate(prompts)}
    res["chaos_plan"] = plan.to_dict()
    for degrade in (True, False):
        label = f"fleet chaos {'degrade' if degrade else 'no degrade'}"
        vc = VirtualClock()
        pol = DegradePolicy(force_fp8=True,
                            shed_budget_tokens=FLEET_SHED_BUDGET) \
            if degrade else None
        r = fleet(plan, engine={"clock": vc}, clock=vc, cost_model=cost,
                  policy=pol)
        t0 = time.perf_counter()
        waiting = dict(arrivals)
        while waiting or r.in_flight():
            for rid in [k for k, at in waiting.items() if at <= r.step_count]:
                if any(x.serving for x in r.replicas):
                    r.submit(Request(rid, list(prompts[rid]), max_new))
                    del waiting[rid]
            r.step()
            check(r.step_count < 2000, f"{label}: no end")
        run = finish(r, label, t0, plan)
        st = run["stats"]
        tpot = [(q.token_times[-1] - q.token_times[0]) * 1e3
                / (len(q.token_times) - 1) for q in r.finished]
        run["p90_tpot_ms"] = float(np.percentile(tpot, 90))
        run["virtual_s"] = vc.now
        run["modes"] = {m: sum(q.modes.count(m) for q in r.finished)
                        for m in modes}
        log(f"  {label}: {run['steps']} router steps, {run['wall_s']:.2f} s "
            f"wall, {vc.now:.3f} s modelled; modelled p90 TPOT "
            f"{run['p90_tpot_ms']:.2f} ms; tokens by mode {run['modes']}; "
            f"{brief(st)}")
        res["chaos_degrade" if degrade else "chaos_plain"] = {
            k: v for k, v in run.items() if k != "outputs"}
        del r
    d, p = res["chaos_degrade"], res["chaos_plain"]
    check(d["stats"]["degrade_fp8_steps"] > 0,
          "fleet chaos: degradation never pinned a survivor to FP8")
    log(f"  fleet chaos: modelled p90 TPOT {d['p90_tpot_ms']:.2f} ms with "
        f"degradation ({d['stats']['degrade_fp8_steps']} FP8 replica-steps, "
        f"{d['stats']['shed']} shed) against {p['p90_tpot_ms']:.2f} ms "
        f"without")
    res["allocated_bytes"] = {"start": a_start, "end": allocated()}
    res["launches_total"] = ops.all_launch_counters()   # the run ends
    return res


# ---------------------------------------------------------------------------
# the MoE family: granite-moe-3b (GQA, 40 experts top-8 in banks of 48) and
# deepseek-v3 (MLA latent attention, 256 experts top-8 + 1 shared)
# ---------------------------------------------------------------------------

# K4 and K5 at granite-moe-3b's heads (24 q heads over 8 kv heads, G = 3,
# D = 64): K4 at the granite serve phase's lens (<= 1088), K5 at the
# dense capacity
GRANITE_K4 = dict(h=24, hkv=8, d=64, mb=68,
                  lens_l=(1088, 1024, 513, 1, 600, 0, 512, 1087),
                  windows=(None,))
GRANITE_K5 = dict(h=24, hkv=8, d=64, cases=(
    (1056, [1056, 1040, 17, 1, 700, 1056, 333, 1024], (None,)),))
# the head dims of the last families: K4 at phi-3-vision's 32 heads of 96
# (MHA, G = 1) over the phi3 serve phase's lens (capacity 1088); K5 at
# zamba2-2.7b's shared attention (32 heads of 80) at the dense capacity
# and at 32768, and at phi3's heads at its dense capacity (576 patches +
# 1024 tokens + 32)
PHI3_K4 = dict(h=32, hkv=32, d=96, mb=68,
               lens_l=(1088, 1024, 513, 1, 600, 0, 512, 1087),
               windows=(None,))
ZAMBA2_K5 = dict(h=32, hkv=32, d=80, cases=(
    (1056, [1056, 1040, 17, 1, 700, 1056, 333, 1024], (None,)),
    (32768, [32768, 30001, 1, 20000, 32768, 5, 16384, 32000], (None,))))
PHI3_K5 = dict(h=32, hkv=32, d=96, cases=(
    (1632, [1632, 1600, 17, 1, 700, 1632, 333, 1601], (None,)),))
# granite's four attention GEMMs (q, k, v, o); deepseek-v3's paged-path
# GEMMs: MLA wq_a, wq_b, wkv_a (N = 576), wo (K = 16384), and the shared
# expert's gate, up and down
GRANITE_KN = [(1536, 1536), (1536, 512), (1536, 512), (1536, 1536)]
DS3_KN = [(7168, 1536), (1536, 24576), (7168, 576), (16384, 7168),
          (7168, 2048), (7168, 2048), (2048, 7168)]


def granite_plant(layer_index: int):
    """plant(i, path, w) for `init_serving_params`: in layer
    `layer_index`, wo[0, 0] = 2.0 (an exception tensor, K3) and
    w_down[0, 0, 0] = 2.0 (an exception bank, read as f16 in both
    modes)."""
    def plant(i, path, w):
        if i == layer_index and path in ("attn/wo/w", "moe/w_down"):
            w.view(-1)[0] = 2.0
    return plant


def granite_slice_phase(torch, cfg) -> dict:
    """granite-moe-3b at full width, card against the CPU plain versions,
    planar KV, f32: the paged step at 2 layers in FP16 and FP8, held to
    SLICE_TOL under the routing rule (`RoutingCheck`), and 1 and 4 layers
    as readings. Layer 1 holds an exception wo and an exception bank."""
    from repro_torch.models import model as M
    from repro_torch.models.convert import params_to

    t0 = time.time()
    sp_gpu = M.init_serving_params(dataclasses.replace(cfg, n_layers=4),
                                   seed=0, device="cuda",
                                   plant=granite_plant(1))
    moe1 = sp_gpu["layers"][1]
    check(moe1["attn"]["wo"].weight.is_exception
          and moe1["moe"]["w_down"].is_exception
          and not moe1["moe"]["w_gate"].is_exception,
          "granite slice: the planted exception wo / bank was nested")
    sp_cpu = params_to(sp_gpu, "cpu")
    log(f"  4-layer full-width params on the card and copied to the CPU in "
        f"{time.time() - t0:.1f} s")
    params = {"cpu": sp_cpu, "cuda": sp_gpu}
    out = {mode: paged_slice(torch, cfg, params, mode, n_layers=2,
                             label="granite slice")
           for mode in ("fp16", "fp8")}
    for n_l in (1, 4):
        for mode in ("fp16", "fp8"):
            out[f"{mode}_{n_l}l"] = paged_slice(
                torch, cfg, params, mode, n_layers=n_l, gated=False,
                label="granite slice", n_steps=3)
    del params, sp_gpu, sp_cpu
    torch.cuda.empty_cache()
    return out


# one MLA module's outputs (max |out| 0.75-4.26), card against CPU: FP16
# as SLICE_TOL; FP8 set from the readings (<= 1.6e-2 on an H100), at
# about 3x the largest (the 0.25 of a whole model's logits let an error
# 15x the readings pass)
DS3_MLA_TOL = {"fp16": 1e-2, "fp8": 0.05}


def ds3_mla_phase(torch, cfg) -> dict:
    """One deepseek-v3 MLA attention module at full width (128 heads,
    latent rank 512), card against the CPU plain versions, f32
    activations: the paged phase (row 0 prefills 64 tokens as a chunk,
    row 1 shares its first two blocks (COW) and prefills 32 more, then
    both decode a token), and the dense-slot prefill and decode phases.
    Outputs of order 1; max |error| <= DS3_MLA_TOL[mode]."""
    from repro_torch.core.nestedfp import NestedTensor
    from repro_torch.models import mla as MLA
    from repro_torch.models.convert import params_to, wrap_nested_linears
    from repro_torch.models.layers import Runtime

    m = cfg.mla
    gen = torch.Generator(device="cuda").manual_seed(0)
    p_gpu = wrap_nested_linears(MLA.init_mla(gen, cfg,
                                             NestedTensor.from_f16))
    params = {"cuda": p_gpu, "cpu": params_to(p_gpu, "cpu")}
    rng = torch.Generator().manual_seed(9)
    out = {}
    for mode in ("fp16", "fp8"):
        rt = Runtime(mode=mode, dtype=torch.float32)
        tol = DS3_MLA_TOL[mode]
        pools = {d: mla_pool(torch, cfg, d) for d in params}
        errs, scale = [], []
        for step_ in DS3_MLA_STEPS:
            pos, kl, paged = mla_paged_args(torch, *step_)
            x = torch.randn((2, step_[3], cfg.d_model), generator=rng)
            res = {}
            for d in params:
                res[d] = MLA.mla_attention(
                    rt, params[d], cfg, x.to(d), phase="paged",
                    positions=pos.to(d), cache=pools[d], kv_len=kl.to(d),
                    paged=tuple(t.to(d) for t in paged))[0]
            live = kl > 0
            got, want = res["cuda"].cpu()[live], res["cpu"][live]
            errs.append(float((got - want).abs().max()))
            scale.append(float(want.abs().max()))
        # the dense-slot phases: a 64-token prefill, then 2 decode steps
        x = torch.randn((2, 64, cfg.d_model), generator=rng)
        pos = torch.arange(64)[None, :]
        caches, res = {}, {}
        for d in params:
            res[d], lat = MLA.mla_attention(rt, params[d], cfg, x.to(d),
                                            phase="prefill",
                                            positions=pos.to(d))
            caches[d] = {n: torch.zeros((2, 80) + t.shape[2:],
                                        dtype=torch.float16, device=d)
                         for n, t in lat.items()}
            for n, t in lat.items():
                caches[d][n][:, :64] = t
        errs.append(float((res["cuda"].cpu() - res["cpu"]).abs().max()))
        scale.append(float(res["cpu"].abs().max()))
        for i in range(2):
            xd = torch.randn((2, 1, cfg.d_model), generator=rng)
            lens = torch.full((2,), 65 + i, dtype=torch.int32)
            for d in params:
                res[d] = MLA.mla_attention(
                    rt, params[d], cfg, xd.to(d), phase="decode",
                    positions=(lens - 1)[:, None].to(d), cache=caches[d],
                    kv_len=lens.to(d))[0]
            errs.append(float((res["cuda"].cpu() - res["cpu"]).abs().max()))
            scale.append(float(res["cpu"].abs().max()))
        log(f"  ds3 mla {mode}: max |err| per call (paged chunk, shared "
            f"chunk, paged decode, prefill, 2 decode) "
            f"{[f'{e:.2e}' for e in errs]} (tol {tol}); max |out| "
            f"{[f'{v:.2f}' for v in scale]}")
        check(max(errs) <= tol, f"ds3 mla {mode}: error beyond {tol}")
        check(all(0.1 < v < 100 for v in scale),
              f"ds3 mla {mode}: outputs not of order 1: {scale}")
        out[mode] = {"max_abs_err": errs, "max_abs_out": scale, "tol": tol}
    del params
    out["mesh"] = ds3_mla_mesh(torch, cfg, p_gpu)
    out["launches_total"] = out["mesh"].pop("launches_total")
    del p_gpu
    torch.cuda.empty_cache()
    return out


# ds3_mla's paged steps: (tables, q_offset, kv_len, chunk width): row 0
# prefills 64 tokens as a chunk, row 1 shares its first two blocks (COW)
# and prefills 32 more, then both decode a token
DS3_MLA_STEPS = [
    ([[1, 2, 3, 4], [0, 0, 0, 0]], [0, 0], [64, 0], 64),
    ([[1, 2, 3, 4], [1, 2, 5, 6]], [64, 32], [64, 64], 32),
    ([[1, 2, 3, 4], [1, 2, 5, 6]], [64, 64], [65, 65], 1)]


def mla_pool(torch, cfg, device, n_blocks: int = 10) -> dict:
    """One MLA layer's f16 latent pool planes, blocks of 16 tokens."""
    m = cfg.mla
    return {"c_kv": torch.zeros((n_blocks, 16, m.kv_lora_rank),
                                dtype=torch.float16, device=device),
            "k_rope": torch.zeros((n_blocks, 16, m.qk_rope_dim),
                                  dtype=torch.float16, device=device)}


def mla_paged_args(torch, tables, qoff, klen, c, bs: int = 16):
    """(positions, kv_len, paged) of one of DS3_MLA_STEPS on the host:
    paged = (phys_write, phys_read, q_offset, tables), as
    `mla.mla_attention`'s paged phase takes them."""
    tab = torch.tensor(tables)
    qo, kl = torch.tensor(qoff), torch.tensor(klen, dtype=torch.int32)
    pos = qo[:, None] + torch.arange(c)[None, :]
    real = pos < kl[:, None]
    blk = torch.gather(tab, 1, (pos // bs).clamp(max=3))
    write = torch.where(real, blk * bs + pos % bs,
                        torch.arange(c)[None, :] % bs)
    read = (tab[..., None] * bs + torch.arange(bs)).reshape(2, -1)
    return pos, kl, (write, read, qo, tab)


def ds3_mla_mesh(torch, cfg, p) -> dict:
    """ds3_mla's paged steps through `mla.mla_attention_mesh` on 2 and 4
    colocated shards of the card, the module's weights cut by
    `param_spec` (wq_a by columns, wq_b / wk_b / wv_b by heads, wo by
    rows, wkv_a whole; every shard its own copy of the latent pool),
    against the unsharded module on the card on the same inputs, f32
    activations, per-token FP8 (the paged engine's): within DS3_MLA_TOL,
    every shard's output the same, and K1, K2 and the quantizer halves
    launched at the per-shard shapes. Launches are counted from 0 at the
    mesh runs' start (the unsharded runs are comparisons)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models import mla as MLA
    from repro_torch.models.layers import Runtime
    from repro_torch.serving import shard as SHARD

    m_ = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    rng = torch.Generator().manual_seed(10)
    out = {}
    ops.reset_launch_counters()          # the mesh runs start here
    for m in (2, 4):
        mesh = make_serving_mesh(m, devices=[torch.device("cuda", 0)] * m)
        lay = SH.serving_layout(cfg, mesh)
        ps = SHARD.shard_subtree(p, ("layers", 0, "attn"), cfg, mesh)
        with ShapeLog() as shapes:
            for mode in ("fp16", "fp8"):
                rt = Runtime(mode=mode, dtype=torch.float32,
                             act_quant="per_token")
                ref_pool = mla_pool(torch, cfg, "cuda")
                pools = [mla_pool(torch, cfg, "cuda") for _ in range(m)]
                errs = []
                for step_ in DS3_MLA_STEPS:
                    pos, kl, paged = mla_paged_args(torch, *step_)
                    pos, kl = pos.cuda(), kl.cuda()
                    paged = tuple(t.cuda() for t in paged)
                    x = torch.randn((2, step_[3], d), generator=rng).cuda()
                    before = ops.all_launch_counters()
                    want = MLA.mla_attention(
                        rt, p, cfg, x, phase="paged", positions=pos,
                        cache=ref_pool, kv_len=kl, paged=paged)[0]
                    after = ops.all_launch_counters()
                    ops.add_launches({k: before[k] - after[k] for k in after})
                    got = MLA.mla_attention_mesh(
                        rt, mesh, lay, ps, cfg, [x] * m, positions=[pos] * m,
                        caches=pools, kv_len=[kl] * m, paged=[paged] * m)
                    check(all(torch.equal(g, got[0]) for g in got),
                          f"ds3 mla {m} shards {mode}: shards differ")
                    live = (kl > 0).cpu()
                    errs.append(float((got[0].cpu() - want.cpu())[live]
                                      .abs().max()))
                tol = DS3_MLA_TOL[mode]
                log(f"  ds3 mla {m} shards {mode}: max |err| against the "
                    f"unsharded module on the card per call (paged chunk, "
                    f"shared chunk, paged decode) "
                    f"{[f'{e:.2e}' for e in errs]} (tol {tol})")
                check(max(errs) <= tol,
                      f"ds3 mla {m} shards {mode}: error beyond {tol}")
                out[f"{mode}_{m}"] = {"max_abs_err": errs, "tol": tol}
        kn = [(d, m_.q_lora_rank // m),
              (m_.q_lora_rank, h * (m_.qk_nope_dim + m_.qk_rope_dim) // m),
              (d, m_.kv_lora_rank + m_.qk_rope_dim),
              (h * m_.v_head_dim // m, d)]
        want_shapes = {"nestedfp16_matmul": kn, "nestedfp8_matmul": kn,
                       "row_absmax": [(kn[3][0],)],
                       "quant_per_token_scaled": [(kn[3][0],)]}
        miss = shapes.missing(want_shapes)
        check(not miss, f"ds3 mla {m} shards: never launched at {miss}")
        log(f"  ds3 mla {m} shards: launched at every per-shard shape "
            f"{want_shapes}")
        del ps
    out["launches_total"] = ops.all_launch_counters()
    return out


def ds3_serve_phase(torch, cfg, host_tier: bool) -> dict:
    """deepseek-v3 at full width, 1 layer (31.6 GB served: the banks,
    MLA, the shared expert, mtp, and the f32 embedding and head), through
    `Engine` with f16 latent planes (the engine keeps MLA f16 though
    planar KV is asked for): 4 slots, 8 requests of 512 prompt tokens
    that share a 256-token system prompt, 32 new, FP16 and FP8, each
    after a warm pass. The weights stream leaf by leaf (a bank drawn in
    f32, 15 GB, nested by K8, freed), with wo planted as an exception
    tensor (K3 at K = 16384); the load is held to its structural
    reckoning."""
    return serve_phase(
        torch, cfg, 1, host_tier, label="ds3 serve", memory=True,
        n_slots=4, capacity=544, prompt_len=512, max_new=32, sys_len=256,
        policies=("fp16", "fp8"),
        need={"fp16": ("nestedfp16_matmul", "f16_matmul"),
              "fp8": ("nestedfp8_matmul", "quant_per_token", "f16_matmul")})


# ---------------------------------------------------------------------------
# the recurrent families: mamba2-2.7b (ssm), zamba2-2.7b (hybrid)
# ---------------------------------------------------------------------------

# (K, N) of a mamba2-2.7b layer's five GEMMs: in_z, in_x, in_bc, in_dt,
# out_proj; zamba2-2.7b's layers differ only in in_bc (N = 128), which is
# given with its shared block's seven (q, k, v, o, gate, up, down)
MAMBA2_KN = [(2560, 5120), (2560, 5120), (2560, 256), (2560, 80),
             (5120, 2560)]
ZAMBA2_KN = [(2560, 128), (2560, 2560), (2560, 2560), (2560, 2560),
             (2560, 2560), (2560, 10240), (2560, 10240), (10240, 2560)]
def seamless_slice_phase(torch, cfg) -> dict:
    """seamless-m4t-v2 at full width, 2 encoder and 2 decoder layers
    (decoder layer 1's self-attention wo an exception tensor), streamed
    onto the card and copied to the CPU: the dense-slot prefill (the
    encoder over 64 stub frames a row, the decoder's K6 and cross-
    attention) and 4 decode steps through the cross caches (K5 over the
    planarized self-attention caches), card against CPU in f32
    activations. FP16 over the whole chain (the encoder in the
    comparison) and FP8 with the card's decoder on the CPU's encoder
    memory (2 layers deep) are gated at SLICE_TOL; the whole FP8 chain
    (2 + 2 layers, the memory's error feeding both decoder layers) at
    SEAMLESS_CHAIN_FP8_TOL: there two correct implementations part by
    more than 0.25 (the port's CPU path against the JAX package reads
    0.468, the decoder on a shared memory 0.211:
    `tests/_fport8_seamless_control.py`, ROADMAP §3 F-port-9). The
    encoder's memory is compared alone too."""
    from repro_torch.models import model as M
    from repro_torch.models.convert import params_to
    from repro_torch.models.layers import Runtime

    cut = dataclasses.replace(cfg, n_layers=2, n_enc_layers=2)
    t0 = time.time()
    sp_gpu = make_serving_params(torch, cut, 0, "cuda", plant_layer=1)
    params = {"cpu": params_to(sp_gpu, "cpu"), "cuda": sp_gpu}
    log(f"  2 + 2-layer full-width params on the card and copied to the "
        f"CPU in {time.time() - t0:.1f} s")
    frames = torch.randn((2, 64, cfg.frontend_dim),
                         generator=torch.Generator().manual_seed(6))
    out = {"memory": {}}
    for mode in ("fp16", "fp8"):
        rt = Runtime(mode=mode, dtype=torch.float32)
        mem = {d: M.encode_memory(rt, params[d], cut, frames.to(d))
               for d in params}
        err = float((mem["cuda"].cpu() - mem["cpu"]).abs().max())
        out["memory"][mode] = {"max_abs_err": err,
                               "max_abs": float(mem["cpu"].abs().max())}
        log(f"  seamless slice encoder memory {mode}: max |card - CPU| "
            f"{err:.2e} of max |memory| {out['memory'][mode]['max_abs']:.2f}")
    out.update(dense_slice(
        torch, cut, params, label="seamless slice",
        runs=[("fp16", "f32", 2, True),
              ("fp8", "f32", 2, SEAMLESS_CHAIN_FP8_TOL)]))
    real = M.encode_memory
    cpu_memory = []

    def shared(rt, prm, c, fr):
        """The CPU computes its memory (it prefills first); the card's
        decoder reads that memory."""
        if fr.is_cuda:
            return cpu_memory.pop().to(fr.device)
        cpu_memory.append(real(rt, prm, c, fr))
        return cpu_memory[-1]
    M.encode_memory = shared
    try:
        dec = dense_slice(torch, cut, params,
                          runs=[("fp8", "f32", 2, True)],
                          label="seamless slice, the CPU's memory,")
    finally:
        M.encode_memory = real
    out["fp8_f32_shared_memory"] = dec["fp8_f32"]
    del params, sp_gpu
    torch.cuda.empty_cache()
    return out


RECURRENT_NEED = {"fp16": ("nestedfp16_matmul", "f16_matmul"),
                  "fp8": ("nestedfp8_matmul", "quant_per_token",
                          "f16_matmul")}


def recurrent_slice(torch, cfg, params, mode, label, n_steps=4,
                    gated: bool = True, tol=None) -> dict:
    """`paged_step` on a recurrent stack (`params`: {"cpu": ..., "cuda":
    ...}), card against CPU, f32 activations: slot 0's 48-token prompt in
    two exact chunks (32 + 16) and slot 1's 20-token prompt in one, each
    routed to its state row (a hybrid's shared attention writes its f16
    pool through the slot's block-table row), then n_steps batched
    decode steps over both slots, teacher-forced by the CPU's greedy
    tokens. Logits held to `tol` (default SLICE_TOL[mode]) when `gated`,
    printed as a reading otherwise; the largest state difference at the
    end is a reading. The mode's nested GEMMs must launch."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models.layers import Runtime

    bs = 16
    tables = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32)
    gen = torch.Generator().manual_seed(3)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen,
                             dtype=torch.int32) for n in (48, 20)]
    rt = Runtime(mode=mode, dtype=torch.float32, act_quant="per_token")
    caches = {d: M.init_paged_cache(cfg, 9, bs, n_slots=2, device=d)
              for d in ("cpu", "cuda")}
    cmp = LogitCheck(torch, mode, tol or SLICE_TOL[mode], gated)
    t0 = time.time()
    before = ops.all_launch_counters()

    def step(toks, qo, kvl, lp=None, slot=None):
        out = {}
        for d in ("cpu", "cuda"):
            sl = None if slot is None else torch.tensor([slot]).to(d)
            out[d] = M.paged_step(
                rt, params[d], cfg, toks.to(d), caches[d], tables.to(d),
                q_offset=torch.tensor(qo).to(d),
                kv_len=torch.tensor(kvl, dtype=torch.int32).to(d),
                block_size=bs, return_logits=True,
                logit_position=None if lp is None else torch.tensor(lp).to(d),
                rows=sl, slot=sl)
        return out

    nxt = []
    for slot, chunks in ((0, (32, 16)), (1, (20,))):
        start = 0
        for take in chunks:
            out = step(prompts[slot][None, start:start + take], [start],
                       [start + take], [take - 1], slot)
            cmp.add(out["cuda"], out["cpu"], f"slot {slot} chunk "
                    f"{start}+{take}")
            start += take
        nxt.append(int(out["cpu"].argmax()))
    lens = [48, 20]
    for i in range(n_steps):
        out = step(torch.tensor(nxt, dtype=torch.int32)[:, None], lens,
                   [n + 1 for n in lens])
        cmp.add(out["cuda"], out["cpu"], f"decode {i}")
        nxt = out["cpu"].argmax(-1).tolist()
        lens = [n + 1 for n in lens]
    after = ops.all_launch_counters()
    for name in RECURRENT_NEED[mode]:
        check(after[name] > before[name], f"{label} {mode}: no {name}")
    res = cmp.done(f"{label} {cfg.n_layers} layers")
    res["state_max_abs_diff"] = {
        n: float((p.cpu().float() - caches["cpu"]["ssm"][n].float())
                 .abs().max()) for n, p in caches["cuda"]["ssm"].items()}
    res["seconds"] = time.time() - t0
    log(f"  {label} {mode}: state planes after the run, max |card - CPU| "
        f"{ {n: f'{v:.2e}' for n, v in res['state_max_abs_diff'].items()} }"
        f" (a reading)")
    return res


def ssd_readings(torch, cfg) -> dict:
    """`ssd_chunked` and `ssd_decode_step` alone at the config's widths
    (mamba2-2.7b: 80 heads of 64, d_state 128, one group, chunk 256),
    card against the CPU in f32: a 300-token scan of one row from a
    random initial state (padded to two chunks), and one decode step of
    8 rows. Max |error| of y and of the state (readings: the scan sums in
    another order on the card), max |y|, and the card's device ms of each
    by graph replay; `layer_update_ms` is one layer's decode-step state
    update as the engine runs it (the step, the kv_len mask of every
    state plane, the write-back)."""
    from repro_torch.models import mamba2 as M2

    s = cfg.ssm
    _, h, _ = M2.ssm_dims(cfg)
    p, n = s.head_dim, s.d_state
    gen = torch.Generator().manual_seed(17)

    def inputs(b, l):
        return (torch.randn((b, l, h, p), generator=gen),
                torch.rand((b, l, h), generator=gen) * 0.1 + 0.001,
                -(torch.rand((h,), generator=gen) * 15 + 1),
                torch.randn((b, l, 1, n), generator=gen),
                torch.randn((b, l, 1, n), generator=gen),
                torch.ones((h,)))
    out = {}
    x, dt, A, B, C, D = inputs(1, 300)
    s0 = torch.randn((1, h, p, n), generator=gen) * 0.1
    want = M2.ssd_chunked(x, dt, A, B, C, D, chunk=s.chunk_size,
                          initial_state=s0)
    cuda = [t.cuda() for t in (x, dt, A, B, C, D, s0)]
    got = M2.ssd_chunked(*cuda[:6], chunk=s.chunk_size,
                         initial_state=cuda[6])
    out["chunked"] = {
        "y_err": float((got[0].cpu() - want[0]).abs().max()),
        "state_err": float((got[1].cpu() - want[1]).abs().max()),
        "y_max": float(want[0].abs().max()),
        "device_ms": graph_ms(torch, lambda i: M2.ssd_chunked(
            *cuda[:6], chunk=s.chunk_size, initial_state=cuda[6]), 1, 5)}
    x, dt, A, B, C, D = inputs(8, 1)
    s0 = torch.randn((8, h, p, n), generator=gen) * 0.1
    args = (x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], D)
    want = M2.ssd_decode_step(s0, *args)
    cuda = [t.cuda() for t in (s0, *args)]
    got = M2.ssd_decode_step(*cuda)
    plane = cuda[0].clone()
    act = torch.tensor([1] * 7 + [0], device="cuda") > 0

    def layer_update(i):
        y, new = M2.ssd_decode_step(plane, *cuda[1:])
        plane.copy_(torch.where(act[:, None, None, None], new, plane))
        return y
    out["decode_step"] = {
        "y_err": float((got[0].cpu() - want[0]).abs().max()),
        "state_err": float((got[1].cpu() - want[1]).abs().max()),
        "y_max": float(want[0].abs().max()),
        "device_ms": graph_ms(torch, lambda i: M2.ssd_decode_step(*cuda), 1),
        "layer_update_ms": graph_ms(torch, layer_update, 1)}
    for k, v in out.items():
        log(f"  ssd {k} (card vs CPU, f32): max |y err| {v['y_err']:.2e} of "
            f"max |y| {v['y_max']:.2f}, max |state err| "
            f"{v['state_err']:.2e}; device {v['device_ms']:.4f} ms"
            + (f", one layer's state update in the decode step "
               f"{v['layer_update_ms']:.4f} ms" if "layer_update_ms" in v
               else ""))
        check(v["y_err"] <= 1e-2 * max(1.0, v["y_max"]),
              f"ssd {k}: card and CPU part by {v['y_err']}")
    return out


def recurrent_slice_phase(torch, cfg, label: str, n_layers: int) -> dict:
    """A recurrent stack at full width, `n_layers` layers (layer 1's
    out_proj an exception tensor), streamed onto the card and copied to
    the CPU: `recurrent_slice` in FP16 and FP8, gated at SLICE_TOL; an
    ssm stack also reads the SSD alone (`ssd_readings`). A hybrid stack's
    FP8 run is gated at SLICE_TOL on one group of 2 layers (attn_every 2:
    two Mamba2 layers, then the shared attention), and its n_layers FP8
    run at DEEP_FP8_TOL, as the other FP8 slices are gated at 2 layers
    with deeper runs beside: card-vs-CPU FP8 logits cross 0.25 from about
    4 layers on, where e4m3 re-rounding of inputs that differ in their
    last bits moves them (ROADMAP F-port-7, F-port-8; zamba2's 6 layers
    read 0.267 in FP8, 3.8e-3 in FP16)."""
    from repro_torch.models.convert import params_to

    cut = dataclasses.replace(cfg, n_layers=n_layers)
    t0 = time.time()
    sp_gpu = make_serving_params(torch, cut, 0, "cuda", plant_layer=1)
    params = {"cpu": params_to(sp_gpu, "cpu"), "cuda": sp_gpu}
    log(f"  {n_layers}-layer full-width params on the card and copied to "
        f"the CPU in {time.time() - t0:.1f} s")
    out = {"fp16": recurrent_slice(torch, cut, params, "fp16", label)}
    if cfg.family == "hybrid":
        group = dataclasses.replace(cfg, n_layers=2, attn_every=2)
        out["fp8"] = recurrent_slice(
            torch, group, {d: {**params[d], "layers": params[d]["layers"][:2]}
                           for d in params}, "fp8", label)
        out[f"fp8_{n_layers}l"] = recurrent_slice(torch, cut, params, "fp8",
                                                  label, tol=DEEP_FP8_TOL)
    else:
        out["fp8"] = recurrent_slice(torch, cut, params, "fp8", label)
        out["ssd"] = ssd_readings(torch, cfg)
    del params, sp_gpu
    torch.cuda.empty_cache()
    return out


def recurrent_serve_phase(torch, cfg, label: str) -> dict:
    """All layers of a recurrent stack through `Engine` as the granite
    serve phase: 8 slots, capacity 1088, 8 x (1024 + 64), FP16 / FP8 /
    dual, an exception out_proj in layer 0 (K3), exact-length prompt
    chunks (one "chunk" key a length), slot-resident state (no prefix
    cache, no host tier). Adds the state's bytes, and one decode step's
    split into nested linears (the profile's K1 / K2 / K3 / quantizer
    device ms) and state updates (one layer's update as the engine runs
    it, timed alone at the step's shapes, times the layers)."""
    from repro_torch.models import mamba2 as M2
    from repro_torch.models import model as M

    res = serve_phase(torch, cfg, cfg.n_layers, False, label=label,
                      capacity=1088, prompt_len=1024, max_new=64,
                      need=RECURRENT_NEED)
    desc = M.cache_descriptor(cfg)
    _, h, _ = M2.ssm_dims(cfg)
    s = cfg.ssm
    plane = torch.zeros((8, h, s.head_dim, s.d_state), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((8, h, s.head_dim), device="cuda", generator=gen)
    dt = torch.rand((8, h), device="cuda", generator=gen) * 0.1
    A = -torch.rand((h,), device="cuda", generator=gen) - 1
    bc = torch.randn((8, 1, s.d_state), device="cuda", generator=gen)
    act = torch.ones(8, dtype=torch.bool, device="cuda")

    def layer_update(i):
        y, new = M2.ssd_decode_step(plane, x, dt, A, bc, bc, A)
        plane.copy_(torch.where(act[:, None, None, None], new, plane))
        return y
    update_ms = graph_ms(torch, layer_update, 1) * cfg.n_layers
    res["state"] = {"bytes_per_slot": desc.bytes_per_slot,
                    "bytes_8_slots": 8 * desc.bytes_per_slot,
                    "update_ms_per_step": update_ms}
    for mode in ("fp16", "fp8"):
        prof = res[f"profile_{mode}"]
        lin = prof["linear_device_ms_per_step"]
        busy = prof["device_ms_per_step"]
        res["state"][mode] = {"linear_ms": lin, "busy_ms": busy,
                              "linear_share": lin / busy,
                              "state_update_share": update_ms / busy}
        log(f"  {label} {mode}: state {desc.bytes_per_slot / 1e6:.1f} MB a "
            f"slot ({8 * desc.bytes_per_slot / 1e9:.3f} GB for 8); a decode "
            f"step's device busy {busy:.2f} ms: nested linears {lin:.2f} ms "
            f"({lin / busy:.3f}), state updates {update_ms:.2f} ms "
            f"({update_ms / busy:.3f}; {cfg.n_layers} layers x one layer's "
            f"update timed alone)")
    del plane
    torch.cuda.empty_cache()
    return res


def recurrent_dense_phase(torch, cfg, label: str, n_dec: int = 16) -> dict:
    """All layers of an ssm stack through the dense-slot steps
    (`launch/steps.py`, bf16): weights nested on the card (K8), layer 0's
    out_proj an exception tensor (K3); 8 x 1024 prompt tokens prefilled
    (eager; K1 or K7), then the decode step as a CUDA graph: its first
    call captures it, its first replay is held bitwise against an eager
    call on cloned state (`check_replay`), then n_dec replays timed at
    cache_len 1056 and n_dec at 32768 (the same graph: the state is O(1)
    in the cache length), fp16 then fp8. Launch counts are read over the
    run; then a profile of 4 replays and one of a warm prefill a mode."""
    from repro_torch.core.linear import NestedLinearParams
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models.convert import serving_memory_bytes

    b, s = 8, 1024
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counters()          # the dense path's run starts here
    t0 = time.time()
    sp = make_serving_params(torch, cfg, 0, "cuda", plant_layer=0)
    torch.cuda.synchronize()
    mem = serving_memory_bytes(sp)
    nested = sum(not p.weight.is_exception for layer in sp["layers"]
                 for p in _linears(layer, NestedLinearParams))
    log(f"  {label}: {cfg.n_layers}-layer params nested on the card in "
        f"{time.time() - t0:.1f} s: {mem['nested_bytes'] / 1e9:.2f} GB "
        f"nested, {mem['other_bytes'] / 1e9:.2f} GB other; {nested} "
        f"applicable tensors")
    check(ops.all_launch_counters()["nestedfp_encode"] == nested,
          "to_serving did not encode each applicable tensor through K8")
    prompts = torch.randint(1, cfg.vocab_size, (b, s),
                            generator=torch.Generator().manual_seed(11),
                            dtype=torch.int32).cuda()
    res = {"layers": cfg.n_layers, "batch": b, "prompt_len": s}
    need = {"fp16": ("nestedfp16_matmul", "f16_matmul"),
            "fp8": ("nestedfp8_matmul_fused_quant", "f16_matmul")}
    kept = {}
    for mode in ("fp16", "fp8"):
        before = ops.all_launch_counters()
        prefill = steps.make_prefill_step(cfg, mode)
        decode = steps.make_decode_step(cfg, mode)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        logits, caches = prefill(sp, {"tokens": prompts})
        torch.cuda.synchronize()
        prefill_ms = (time.monotonic() - t0) * 1e3
        check(tuple(logits.shape) == (b, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()),
              f"{label} {mode}: prefill logits not finite or mis-shaped")
        nxt = logits.argmax(-1).to(torch.int32)[:, None]
        t0 = time.monotonic()
        decode(sp, caches, nxt, s)            # eager, then captured
        torch.cuda.synchronize()
        capture_ms = (time.monotonic() - t0) * 1e3
        same = decode.check_replay(sp, caches, nxt, s)
        check(all(same.values()), f"{label} {mode}: the decode graph's first "
              f"replay differs from its eager call: {same}")
        r = {"prefill_ms": prefill_ms, "capture_ms": capture_ms,
             "replay_check": same,
             "prefill_tokens_per_s": b * s / (prefill_ms / 1e3)}
        for cache_len in (1056, 32768):
            step_ms = []
            for i in range(n_dec):
                t0 = time.monotonic()
                logits, caches = decode(sp, caches, nxt, cache_len + i)
                nxt = logits.argmax(-1).to(torch.int32)[:, None]
                torch.cuda.synchronize()
                step_ms.append((time.monotonic() - t0) * 1e3)
            check(bool(torch.isfinite(logits).all())
                  and bool(((nxt >= 0) & (nxt < cfg.vocab_size)).all()),
                  f"{label} {mode}: decode logits or tokens out of range")
            r[f"decode_ms_median_at_{cache_len}"] = sorted(step_ms)[n_dec // 2]
        check(decode.n_captured == len(decode.keys()) == 1,
              f"{label} {mode}: {decode.n_captured} graphs for "
              f"{len(decode.keys())} keys; one key serves every length")
        (key,) = decode.keys()
        r["graph_device_ms"] = replay_ms(torch, decode.graph(key))
        r["graph_pool_bytes"] = decode.pool_bytes()
        launches = {k: v - before[k] for k, v in
                    ops.all_launch_counters().items()}
        for name in need[mode]:
            check(launches[name] > 0, f"{label} {mode}: {name} never launched")
        r["launches"] = launches
        a, z = r["decode_ms_median_at_1056"], r["decode_ms_median_at_32768"]
        log(f"  {label} {mode}: prefill {b}x{s} in {prefill_ms:.1f} ms "
            f"({r['prefill_tokens_per_s']:.0f} tok/s), decode first call "
            f"(eager + capture) {capture_ms:.1f} ms, first replay bitwise its "
            f"eager call; replayed step median at cache_len 1056 {a:.2f} ms, "
            f"at 32768 {z:.2f} ms (ratio {z / a:.3f}), graph device "
            f"{r['graph_device_ms']:.3f} ms, pool "
            f"{r['graph_pool_bytes'] / 2**20:.1f} MiB; launches {launches}")
        res[mode] = r
        kept[mode] = (decode, caches, nxt)
    res["launches_total"] = ops.all_launch_counters()   # read: the run ends
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"  {label} peak device memory {res['peak_mem_gb']:.1f} GB")
    for mode in ("fp16", "fp8"):
        decode, caches, nxt = kept.pop(mode)
        med = res[mode]["decode_ms_median_at_1056"]
        wall, by_name = device_ms_by_kernel(
            torch, lambda: decode(sp, caches, nxt, s), 4)
        res[f"profile_decode_{mode}"] = profile_summary(
            f"profile {label} decode {mode}: 4 replays", wall, med, by_name)
        del decode, caches
        # a warm prefill, then one under the profiler
        prefill = steps.make_prefill_step(cfg, mode)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        prefill(sp, {"tokens": prompts})
        torch.cuda.synchronize()
        warm_ms = res[mode]["prefill_ms_warm"] = (time.monotonic() - t0) * 1e3
        wall, by_name = device_ms_by_kernel(
            torch, lambda: prefill(sp, {"tokens": prompts}), 1)
        res[f"profile_prefill_{mode}"] = profile_summary(
            f"profile {label} prefill {mode} (against a warm prefill of "
            f"{warm_ms:.1f} ms)", wall, warm_ms, by_name)
    del sp
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# tensor-parallel serving: a mesh's shards placed together on one card
# ---------------------------------------------------------------------------

# the GEMMs (K, N) one shard runs in one layer at 4 and 2 shards (q, k, v,
# o, gate, up, down): llama3.1-8b's 32 / 8 heads and d_ff 14336 cut by
# heads and columns, wo and down by rows; gemma3-1b's at 4 shards (one q
# head each, the one kv head whole, d_ff 6912 / 4 = 1728)
LLAMA_TP_KN = {
    4: [(4096, 1024), (4096, 256), (4096, 256), (1024, 4096), (4096, 3584),
        (4096, 3584), (3584, 4096)],
    2: [(4096, 2048), (4096, 512), (4096, 512), (2048, 4096), (4096, 7168),
        (4096, 7168), (7168, 4096)]}
GEMMA_TP4_KN = [(1152, 256), (1152, 256), (1152, 256), (256, 1152),
                (1152, 1728), (1152, 1728), (1728, 1152)]
TP_GEMMS = (("llama3.1-8b tp4", LLAMA_TP_KN[4]),
            ("llama3.1-8b tp2", LLAMA_TP_KN[2]),
            ("gemma3-1b tp4", GEMMA_TP4_KN))
# K4 on one shard's q heads and pool planes: llama at 4 shards (8 / 2
# heads) and 2 shards (16 / 4); gemma3-1b at 4 (one q head over its copy
# of the one kv head, D = 256, a local layer's window of 512)
TP_K4 = (dict(h=8, hkv=2, d=128, windows=(None,)),
         dict(h=16, hkv=4, d=128, windows=(None,)),
         dict(h=1, hkv=1, d=256, mb=68,
              lens_l=(1088, 1024, 513, 1, 600, 0, 512, 1087),
              windows=(512,)))
# the row-parallel layers' activation widths a shard quantizes (wo, down)
TP_QUANT_K = {"llama3.1-8b tp4": (1024, 3584), "llama3.1-8b tp2": (2048, 7168),
              "gemma3-1b tp4": (256, 1728)}
TP_PHASES = ("tp_serve", "tp_gemma", "tp_fleet")
# the GEMMs (K, N) one shard of 4 runs in one layer of the moe, ssm and
# hybrid families: granite-moe-3b's attention (24 / 8 heads of 64: q, k,
# v, o; its banks are einsums); mamba2-2.7b's block (in_z and in_x by
# heads, in_bc and in_dt whole, out_proj by rows); zamba2-2.7b's shared
# block (32 heads of 80: q, k, v, o; gate, up, down of d_ff 10240; its
# Mamba2 layers are mamba2's, in_bc N = 128); deepseek-v3's MLA module
# (wq_a by columns, wq_b by heads, wkv_a whole, wo by rows). Each label:
# (its shapes, the phases whose launches its line entries count)
TP_FAMILY_GEMMS = {
    "granite tp4": ([(1536, 384), (1536, 128), (1536, 128), (384, 1536)],
                    ("tp_moe",)),
    "mamba2 tp4": ([(2560, 1280), (2560, 1280), (2560, 256), (2560, 80),
                    (1280, 2560)], ("tp_ssm",)),
    "zamba2 tp4": ([(2560, 640), (2560, 640), (2560, 640), (640, 2560),
                    (2560, 2560), (2560, 2560), (2560, 2560)],
                   ("tp_hybrid",)),
    "ds3 tp4": ([(7168, 384), (1536, 6144), (7168, 576), (4096, 7168)],
                ("ds3_mla",))}
# K4 on one granite shard of 4: 6 q / 2 kv heads of 64, lens <= 1088
GRANITE_TP4_K4 = dict(h=6, hkv=2, d=64, mb=68,
                      lens_l=(1088, 1024, 513, 1, 600, 0, 512, 1087),
                      windows=(None,))
TP_FAMILY_PHASES = ("tp_moe", "tp_ssm", "tp_hybrid")
TP_LABEL = ("shards placed together on one card: times of a colocated mesh, "
            "not of tensor parallelism across cards")


def tp_gemm_phase(torch, rows: dict, label: str, kn, iters: int) -> None:
    """K1, K2 (per-token scales) and K3 at one shard's GEMM shapes, M = 8:
    each against its plain version, timed (host and CUDA-graph replay)
    beside its library call (torch.matmul f16; row-wise torch._scaled_mm)
    and its bound. Rows go to `rows` tagged with `label`."""
    from repro_torch.core import nestedfp as nf
    from repro_torch.core import quant
    from repro_torch.kernels import ref
    from repro_torch.kernels.f16_matmul import f16_matmul
    from repro_torch.kernels.nestedfp16_matmul import nestedfp16_matmul
    from repro_torch.kernels.nestedfp8_matmul import nestedfp8_matmul

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(28)
    m = 8
    for k, n in dict.fromkeys(kn):
        n_sets = max(2, math.ceil(2 * L2_BYTES / (k * n)) + 1)
        ws = [(torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
               ).half() for _ in range(n_sets)]
        planes = [nf.encode(w) for w in ws]
        x = torch.randn((m, k), generator=gen, device=dev)
        x16 = x.half()
        xq, xs = quant.quantize_act_per_token(x)
        out_b = m * n * 4
        cases = {
            "nestedfp16_matmul": (
                lambda i: nestedfp16_matmul(x16, *planes[i]),
                lambda i: ref.nestedfp16_matmul_ref(x16, *planes[i]),
                lambda i: torch.matmul(x16, ws[i]),
                m * k * 2 + 2 * k * n + out_b, "f16"),
            "nestedfp8_matmul": (
                lambda i: nestedfp8_matmul(xq, planes[i][0], xs),
                lambda i: ref.nestedfp8_matmul_ref(xq, planes[i][0], xs),
                scaled_mm_yardstick(torch, xq, xs, [p[0] for p in planes]),
                m * k + k * n + m * 4 + out_b, "fp8"),
            "f16_matmul": (
                lambda i: f16_matmul(x16, ws[i]),
                lambda i: ref.matmul_f16_ref(x16, ws[i]),
                lambda i: torch.matmul(x16, ws[i]),
                m * k * 2 + 2 * k * n + out_b, "f16")}
        for name, (kern, plain, lib, nbytes, kind) in cases.items():
            err = max_err(torch, kern(0), plain(0), GEMM_RTOL, GEMM_ATOL)
            b_ms, b_kind = bound(nbytes, 2.0 * m * k * n, kind)
            row = {"model": label, "m": m, "k": k, "n": n,
                   "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_kind,
                   "ms": time_ms(torch, kern, n_sets, iters),
                   "plain_ms": time_ms(torch, plain, n_sets, iters),
                   "library_ms": None if lib is None
                   else time_ms(torch, lib, n_sets, iters),
                   "device_ms": graph_ms(torch, kern, n_sets),
                   "library_device_ms": None if lib is None
                   else graph_ms(torch, lib, n_sets)}
            rows[name].append(row)
            lib_d = row["library_device_ms"]
            log(f"  {name:18s} {label} M={m} K={k:5d} N={n:5d} err={err:.2e}"
                f" ms={row['ms']:.4f} plain={row['plain_ms']:.4f} device="
                f"{row['device_ms']:.4f} lib_device="
                f"{None if lib_d is None else round(lib_d, 4)} "
                f"bound={b_ms:.5f} ({b_kind})")
        del ws, planes


def tp_quant_phase(torch, iters: int) -> dict:
    """The per-token quantizer's two halves for a row-parallel layer
    (`row_absmax`, `quant_per_token_scaled`) at M = 8, f32, the slice
    widths of TP_QUANT_K: each bitwise its plain version, and the slices
    of a whole row (4096 cut in 4, 14336 cut in 4 and 2, 6912 cut in 4)
    quantized under the max of their absmaxes give the one-launch
    quantizer's codes of the whole row, bitwise. Timed host and device."""
    from repro_torch.core import quant
    from repro_torch.kernels import ref
    from repro_torch.kernels.quant_per_token import (quant_per_token,
                                                     quant_per_token_scaled,
                                                     row_absmax)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(29)
    for k, parts in ((4096, 4), (14336, 4), (14336, 2), (6912, 4)):
        x = torch.randn((8, k), generator=gen, device=dev)
        x[1] = 0.0
        x[2, -1] = 1e3
        q, s = quant_per_token(x)
        c = k // parts
        sl = [x[:, i * c:(i + 1) * c].contiguous() for i in range(parts)]
        amax = torch.stack([row_absmax(p) for p in sl]).amax(0)
        scale = quant.scale_from_amax(amax)
        codes = torch.cat([quant_per_token_scaled(p, scale).view(torch.uint8)
                           for p in sl], dim=1)
        check(torch.equal(scale, s) and torch.equal(codes, q.view(torch.uint8)),
              f"row-parallel quantization of K = {k} in {parts}: codes or "
              f"scales differ from the one-launch quantizer's")
    log("  row-parallel FP8: slices of rows of 4096, 14336 and 6912 in 2 and "
        "4 quantized under the max of their absmaxes give the one-launch "
        "codes and scales, bitwise")
    out = {"row_absmax": [], "quant_per_token_scaled": []}
    for label, ks in TP_QUANT_K.items():
        for k in ks:
            n_sets = max(2, math.ceil(2 * L2_BYTES / (8 * k * 4)) + 1)
            xs = [torch.randn((8, k), generator=gen, device=dev)
                  for _ in range(n_sets)]
            sc = [quant.scale_from_amax(ref.row_absmax_ref(x)) for x in xs]
            cases = {
                "row_absmax": (lambda i: row_absmax(xs[i]),
                               lambda i: ref.row_absmax_ref(xs[i]),
                               8 * k * 4 + 8 * 4),
                "quant_per_token_scaled": (
                    lambda i: quant_per_token_scaled(xs[i], sc[i]),
                    lambda i: ref.quantize_scaled_ref(xs[i], sc[i]),
                    8 * k * 4 + 8 * 4 + 8 * k)}
            for name, (kern, plain, nbytes) in cases.items():
                for i in range(n_sets):
                    check(torch.equal(kern(i).view(torch.uint8),
                                      plain(i).view(torch.uint8)),
                          f"{name} K={k}: not bitwise its plain version")
                b_ms, b_kind = bound(nbytes, 0.0, "f32")
                row = {"model": label, "m": 8, "k": k, "dtype": "float32",
                       "max_abs_err": 0.0,
                       "ms": time_ms(torch, kern, n_sets, iters),
                       "plain_ms": time_ms(torch, plain, n_sets, iters),
                       "library_ms": None, "bound_ms": b_ms,
                       "bound_by": b_kind,
                       "device_ms": graph_ms(torch, kern, n_sets)}
                out[name].append(row)
                log(f"  {name:22s} {label} M=8 K={k:5d} bitwise; ms="
                    f"{row['ms']:.4f} plain={row['plain_ms']:.4f} device="
                    f"{row['device_ms']:.4f} bound={b_ms:.5f} ({b_kind}); "
                    f"no single PyTorch call")
    return out


class ShapeLog:
    """While active, record the shapes at which the main path's kernel
    wrappers are called (a capture calls them; its replays run the same
    shapes): (K, N) of K1, K2 and K3, (H, Hkv, D) of K4, K of the
    quantizer halves. The wrappers still count their launches."""

    ARGS = {"nestedfp16_matmul": lambda x, u, *a: (x.shape[1], u.shape[1]),
            "nestedfp8_matmul": lambda x, u, *a: (x.shape[1], u.shape[1]),
            "f16_matmul": lambda x, w, *a: (x.shape[1], w.shape[1]),
            "paged_planar_decode_attention":
                lambda q, k, *a, **kw: (q.shape[1], k.shape[2], q.shape[2]),
            "row_absmax": lambda x, *a: (x.shape[1],),
            "quant_per_token_scaled": lambda x, *a: (x.shape[1],)}

    def __init__(self):
        from repro_torch.kernels import ops
        self.ops, self.seen, self.saved = ops, set(), {}

    def __enter__(self):
        for name, shape in self.ARGS.items():
            fn = self.saved[name] = getattr(self.ops, name)

            def logged(*a, _fn=fn, _name=name, _shape=shape, **kw):
                self.seen.add((_name, _shape(*a, **kw)))
                return _fn(*a, **kw)
            setattr(self.ops, name, logged)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.ops, name, fn)

    def missing(self, want: dict) -> list:
        return [(n, s) for n, shapes in want.items() for s in shapes
                if (n, s) not in self.seen]


def tp_want_shapes(cfg, m: int) -> dict:
    """The per-shard shapes a run on m shards must launch, from the layout
    the weights' specs give (`sharding.serving_layout`): every nested
    GEMM of a layer in FP16 (K1) and FP8 (K2) (GQA attention, a dense or
    shared SwiGLU, a Mamba2 block's projections), the planted exception
    (K3: wo, or a recurrent stack's out_proj), K4's (q heads, kv heads,
    D) over a planar pool, the row-parallel layers' widths for the
    quantizer halves. For llama3.1-8b these are LLAMA_TP_KN[m]'s; an MoE
    stack's banks are einsums, not kernels."""
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import Layout

    lay = SH.serving_layout(cfg, Layout(("model",), (m,)))
    d = cfg.d_model

    def cut(k, n, kind):
        return {"col": (k, n // m), "row": (k // m, n), "whole": (k, n)}[kind]

    def down(kind):
        return "row" if kind == "col" else "whole"
    kn, quant_k, heads, exc = [], [], [], None
    if cfg.n_heads and cfg.mla is None:      # GQA (a hybrid's shared block)
        hd = cfg.resolved_head_dim
        q, kv = cfg.n_heads * hd, cfg.n_kv_heads * hd
        kn += [cut(d, q, lay.q), cut(d, kv, lay.kv), cut(q, d, lay.wo)]
        exc = kn[2]
        quant_k += [kn[2][0]] if lay.wo == "row" else []
        if cfg.cache_kind == "gqa":          # K4 reads planar pools only
            heads = [(cfg.n_heads // m if lay.q == "col" else cfg.n_heads,
                      cfg.n_kv_heads // m if lay.pool else cfg.n_kv_heads,
                      hd)]
    if lay.mlp is not None:
        kn += [cut(d, cfg.d_ff, lay.mlp), cut(cfg.d_ff, d, down(lay.mlp))]
        quant_k += [kn[-1][0]] if lay.mlp == "col" else []
    if cfg.ssm is not None:
        s = cfg.ssm
        d_inner = s.expand * d
        kn += [cut(d, d_inner, lay.ssm), (d, 2 * s.n_groups * s.d_state),
               (d, d_inner // s.head_dim), cut(d_inner, d, down(lay.ssm))]
        exc = kn[-1]
        quant_k += [kn[-1][0]] if lay.ssm == "col" else []
    return {"nestedfp16_matmul": sorted(set(kn)),
            "nestedfp8_matmul": sorted(set(kn)),
            "f16_matmul": [exc],
            "paged_planar_decode_attention": heads,
            "row_absmax": [(k,) for k in sorted(set(quant_k))],
            "quant_per_token_scaled": [(k,) for k in sorted(set(quant_k))]}


class RouterLog:
    """While active, record each MoE layer's router logits where the
    routing computes them (`moe._route`: once a layer unsharded, once a
    layer and device on a mesh, so a colocated mesh records what the
    unsharded model does), one {"router_logits": (B, S, E)} a call, as
    `RoutingCheck.add` reads them."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.calls = moe, []

    def __enter__(self):
        self.fn = self.moe._route

        def logged(*a, **kw):
            r = self.fn(*a, **kw)
            self.calls.append({"router_logits": r.logits})
            return r
        self.moe._route = logged
        return self

    def __exit__(self, *exc):
        self.moe._route = self.fn


def first_decode_logits(torch, cfg, step, params, caches, prompts, mode,
                        ids=None):
    """The logits of the first decode step after `prompts` (B rows of one
    length) through `step` (`model.paged_step` or a mesh's), prefilled in
    one chunk into `caches` (a recurrent stack's state: B slots) over
    identity block tables; the decode token is the prefill's argmax, or
    `ids`. Returns (prefill ids, logits, router logs): an MoE stack's
    per-layer router logits of the prefill and of the decode step
    (`RouterLog`), else None. The launch counters are left as they were
    (a comparison, not the path)."""
    from repro_torch.kernels import ops
    from repro_torch.models.layers import Runtime

    before = ops.all_launch_counters()
    dev = torch.device("cuda")
    b, s = len(prompts), len(prompts[0])
    bs, mb = 16, -(-(s + 1) // 16)
    tables = (1 + torch.arange(b * mb, dtype=torch.int32, device=dev)
              ).reshape(b, mb)
    rt = Runtime(mode=mode, dtype=torch.float32, act_quant="per_token")
    zero = torch.zeros(b, dtype=torch.int32, device=dev)
    toks = torch.tensor(prompts, dtype=torch.int32, device=dev)
    with RouterLog() as pre:
        got = step(rt, params, cfg, toks, caches, tables, q_offset=zero,
                   kv_len=zero + s, block_size=bs)
    ids = got if ids is None else ids
    with RouterLog() as dec:
        logits = step(rt, params, cfg, ids[:, None], caches, tables,
                      q_offset=zero + s, kv_len=zero + s + 1, block_size=bs,
                      return_logits=True)
    torch.cuda.synchronize()
    after = ops.all_launch_counters()
    ops.add_launches({k: before[k] - after[k] for k in after})
    routes = (pre.calls, dec.calls) if cfg.moe is not None else None
    return ids, logits, routes


def probe_caches(cfg, n_blocks: int, **kw):
    """The paged caches of a comparison run: planar GQA pools (f16 MLA
    latents and hybrid pools), `n_slots` for a recurrent stack's state."""
    from repro_torch.models import model as M
    return M.init_paged_cache(cfg, n_blocks, 16, planar=cfg.cache_kind == "gqa",
                              **kw)


def logits_limit(mode: str, n_layers: int) -> float:
    """The limits of a mesh's first-decode logits against the unsharded
    model: FP16 at SLICE_TOL; FP8 at SLICE_TOL's 0.25 at 2 layers,
    DEEP_FP8_TOL at 3 and 4, TP_DEEP_FP8_TOL deeper."""
    if mode == "fp16":
        return SLICE_TOL["fp16"]
    if n_layers <= 2:
        return SLICE_TOL["fp8"]
    return DEEP_FP8_TOL if n_layers <= 4 else TP_DEEP_FP8_TOL


# FP8 first-decode logits of a mesh deeper than 4 layers are gated at 0.50
# (ROADMAP §3 F-port-10, decided): the mesh against the
# unsharded model on an H100 read 0.385 / 0.372 at 8 layers on 2 / 4
# shards and 0.298 at gemma3-1b's 26; the control, the unsharded model on
# the card against the CPU plain versions at 8 layers, 0.464. 0.50 sits
# above both; the 2- and 4-layer gates stay (the cuts F-port-8's rule was
# set on, run on each phase's first layers: TP_FP8_CUTS, or a hybrid's
# multiples of its shared-attention period).
TP_DEEP_FP8_TOL = 0.50
TP_FP8_CUTS = (2, 4)


def fp8_cuts(cfg) -> tuple:
    """The depths below cfg's at which a mesh's FP8 logits are also held:
    TP_FP8_CUTS, or for a hybrid the multiples of its period (a cut must
    hold whole shared-attention groups)."""
    if cfg.attn_every:
        return tuple(range(cfg.attn_every, cfg.n_layers, cfg.attn_every))
    return tuple(n for n in TP_FP8_CUTS if n < cfg.n_layers)


def _cut(tree: dict, n: int) -> dict:
    return {**tree, "layers": tree["layers"][:n]}


def tp_compare_logits(torch, cfg, sp, mesh, shard_params, prompts, mode,
                      n_layers: int, ref_cache: dict, label: str,
                      gated: bool = True) -> dict:
    """The first decode step's logits of the mesh against the unsharded
    model on the same card and weights, on their first `n_layers` layers:
    within `logits_limit` when `gated`, a reading otherwise. An MoE stack
    is held under the routing rule (`RoutingCheck`): a row's logits are
    compared where its prompt's last token and its decode token chose
    the same experts in every layer on both sides, and every flip sits at
    a near-tie."""
    import functools

    from repro_torch.models import model as M
    from repro_torch.serving import shard as SHARD

    cut = dataclasses.replace(cfg, n_layers=n_layers)
    b, s = len(prompts), len(prompts[0])
    nb = 1 + b * -(-(s + 1) // 16)
    if (mode, n_layers) not in ref_cache:
        caches = probe_caches(cut, nb, device="cuda", n_slots=b)
        ref_cache[mode, n_layers] = first_decode_logits(
            torch, cut, M.paged_step, _cut(sp, n_layers), caches, prompts,
            mode)
        del caches
    ids, want, want_routes = ref_cache[mode, n_layers]
    caches = probe_caches(cut, nb, mesh=mesh, n_slots=b)
    _, got, routes = first_decode_logits(
        torch, cut, functools.partial(SHARD.sharded_paged_step, mesh),
        [_cut(p, n_layers) for p in shard_params], caches, prompts, mode,
        ids=ids)
    del caches
    check(bool(torch.isfinite(got).all()), f"{label} {mode}: non-finite")
    rows = torch.ones(b, dtype=torch.bool)
    res = {}
    if routes is not None:
        route = RoutingCheck(torch, cfg.moe.top_k)
        rows = route.add(routes[0], want_routes[0],
                         torch.full((b,), s - 1), torch.ones((b, s),
                                                             dtype=torch.bool))
        rows &= route.add(routes[1], want_routes[1],
                          torch.zeros(b, dtype=torch.long),
                          torch.ones((b, 1), dtype=torch.bool))
        res["routing"] = route.done(
            f"{label} {mode} {n_layers} layers {mesh.size} shards", gated)
    err = float((got - want)[rows.to(got.device)].abs().max())
    tol = logits_limit(mode, n_layers)
    log(f"  {label} {mode} {n_layers} layers: first decode step's logits, "
        f"{mesh.size} shards against the unsharded model, max |err| "
        f"{err:.3e} over {int(rows.sum())}/{b} rows (limit {tol}"
        f"{'' if gated else ', a reading'})")
    check(err <= tol or not gated,
          f"{label} {mode} {n_layers} layers: logits beyond {tol}")
    return {"max_logit_err": err, "tol": tol, "gated": gated, **res}


def tp_logit_checks(torch, cfg, sp, mesh, shard_params, prompts,
                    ref_cache: dict, label: str) -> dict:
    """FP16 at the phase's depth, FP8 at `fp8_cuts` and at the phase's
    depth, each within `logits_limit`."""
    out = {}
    for mode in ("fp16", "fp8"):
        cuts = (cfg.n_layers,) if mode == "fp16" \
            else fp8_cuts(cfg) + (cfg.n_layers,)
        for n in cuts:
            out[f"{mode}_{n}l"] = tp_compare_logits(
                torch, cfg, sp, mesh, shard_params, prompts, mode, n,
                ref_cache, label)
    return out


def tp_cpu_control(torch, cfg, sp, prompts) -> float:
    """F-port-10's control: the unsharded model's first decode logits on
    the card against the CPU plain versions (f64 sums) on the same
    weights and prompts, FP8 at the phase's depth: how far two correct
    implementations part there."""
    from repro_torch.models import model as M
    from repro_torch.models.convert import params_to

    nb = 1 + len(prompts) * -(-(len(prompts[0]) + 1) // 16)
    caches = M.init_paged_cache(cfg, nb, 16, planar=True, device="cuda")
    ids, want, _ = first_decode_logits(torch, cfg, M.paged_step, sp, caches,
                                       prompts, "fp8")
    del caches
    from repro_torch.models.layers import Runtime
    rt = Runtime(mode="fp8", dtype=torch.float32, act_quant="per_token")
    spc = params_to(sp, "cpu")
    b, s = len(prompts), len(prompts[0])
    mb = -(-(s + 1) // 16)
    tables = (1 + torch.arange(b * mb, dtype=torch.int32)).reshape(b, mb)
    zero = torch.zeros(b, dtype=torch.int32)
    cc = M.init_paged_cache(cfg, nb, 16, planar=True, device="cpu")
    M.paged_step(rt, spc, cfg, torch.tensor(prompts, dtype=torch.int32), cc,
                 tables, q_offset=zero, kv_len=zero + s, block_size=16)
    got = M.paged_step(rt, spc, cfg, ids.cpu()[:, None], cc, tables,
                       q_offset=zero + s, kv_len=zero + s + 1, block_size=16,
                       return_logits=True)
    err = float((got - want.cpu()).abs().max())
    log(f"  F-port-10 control: the unsharded model, card against the CPU "
        f"plain versions, FP8 at {cfg.n_layers} layers, {b} rows: max |err| "
        f"{err:.3e}")
    return err


def tp_engine_run(torch, cfg, sp, mesh, policy, warm, timed, max_new, label,
                  capacity, engine_kw=None) -> dict:
    """One engine (unsharded, or on `mesh`) in one policy: a warm pass over
    `warm` (dual: half forced to each mode) that captures every step key
    and holds each key's first replay bitwise against an eager call, then
    the timed prompts: outputs, stats, TTFT, TPOT, the decode graph's
    device ms. The engine is freed after, with its graphs."""
    from repro_torch.core.policy import DualPrecisionController, SLOConfig
    from repro_torch.serving.engine import Engine, Request

    ctrl = None
    if policy == "dual":
        ctrl = DualPrecisionController(SLOConfig(), fp16_ms_per_token=0.5,
                                       fp8_ms_per_token=0.25)
    eng = Engine(cfg, sp, n_slots=len(timed), capacity=capacity,
                 kv_planar=True, controller=ctrl,
                 forced_mode=None if ctrl else policy, device="cuda",
                 mesh=mesh, **(engine_kw or {}))
    n_checked = 0
    halves = [warm[:len(warm) // 2], warm[len(warm) // 2:]] if ctrl \
        else [warm]
    for w, (mode, reqs) in enumerate(zip(["fp16", "fp8"] if ctrl
                                         else [policy], halves)):
        eng.forced_mode = mode
        for i, p in enumerate(reqs):
            eng.submit(Request(f"w{w}.{i}", list(p), max_new=max_new))
        n_checked += serve_checked(eng, policy, label)
    eng.forced_mode = None if ctrl else policy
    check(n_checked == len(eng.graphs.keys())
          and (not eng.graphs.capturing
               or n_checked == eng.graphs.n_captured),
          f"{label} {policy}: {n_checked} keys checked of "
          f"{len(eng.graphs.keys())}")
    n_warm = len(eng.finished)
    for i, p in enumerate(timed):
        eng.submit(Request(f"r{i}", list(p), max_new=max_new))
    torch.cuda.synchronize()
    t0 = time.monotonic()
    decode_ms, modes = [], []
    while eng.queue or eng.active or eng.prefilling:
        n_pre = eng.stats["prefill_dispatches"]
        eng.step()
        if eng.stats["prefill_dispatches"] == n_pre:
            decode_ms.append(eng._last_step_ms)
            modes.append(eng.last_mode)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    fin = eng.finished[n_warm:]
    check(len(fin) == len(timed) and all(
        len(r.output) == max_new and all(0 <= t < cfg.vocab_size
                                         for t in r.output) for r in fin),
          f"{label} {policy}: {len(fin)}/{len(timed)} finished, or outputs "
          f"of the wrong length or out of vocab")
    graph_dev = {m: replay_ms(torch, eng.graphs.graph(("decode", m)))
                 for m in sorted(set(modes))} if eng.graphs.capturing else {}
    res = {"outputs": {r.request_id: list(r.output) for r in fin},
           "stats": dict(eng.stats), "wall_s": wall,
           "ttft_ms_mean": 1e3 * sum(r.first_token_s - t0 for r in fin)
           / len(fin),
           "tpot_ms_mean": 1e3 * sum((r.finished_s - r.first_token_s)
                                     / (len(r.output) - 1) for r in fin)
           / len(fin),
           "decode_step_ms_median": sorted(decode_ms)[len(decode_ms) // 2],
           "decode_graph_device_ms": graph_dev,
           "graphs": eng.graphs.n_captured, "replays_bitwise": n_checked,
           "keys": sorted(eng.graphs.keys(), key=str),
           "window_reclaimed_blocks": eng.stats["window_reclaimed_blocks"]}
    pool = eng.graphs._pool
    unwrap(eng)
    del eng
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    check(pool is None or not [
        s for s in torch.cuda.memory_snapshot()
        if tuple(s.get("segment_pool_id", ())) == tuple(pool)],
          f"{label} {policy}: the graphs' pool outlived its engine")
    shards = "unsharded" if mesh is None else f"{mesh.size} shards"
    log(f"  {label} {policy} {shards}: TPOT mean {res['tpot_ms_mean']:.2f} "
        f"ms, TTFT mean {res['ttft_ms_mean']:.1f} ms, decode-only step "
        f"median {res['decode_step_ms_median']:.2f} ms, decode graph device "
        f"ms { {m: round(v, 3) for m, v in graph_dev.items()} }, "
        f"{res['graphs']} graphs (each first replay bitwise its eager "
        f"call){'' if mesh is None else '; ' + TP_LABEL}")
    return res


def tp_hold_to_unsharded(torch, cfg, sp, runs, errs, prompts, label,
                         replays=None) -> dict:
    """Each mesh run against the unsharded run of its policy (fp16, fp8):
    `stats` and step keys equal (logical steps), and every stream equal
    to the unsharded one or parting only where the unsharded top-2
    margin is below twice the mesh's first-decode logit error
    (`margin_rule`), or, with `replays[m](mode)` (`stream_replays`),
    below twice the two sides' difference at the parting, or at a
    routing near-tie."""
    out = {}
    for (m, policy), run in runs.items():
        if m == 1 or policy == "dual":
            continue
        ref = runs[(1, policy)]
        check(run["stats"] == ref["stats"],
              f"{label} {policy} {m} shards: stats differ from the "
              f"unsharded engine's: "
              f"{ {k: (v, run['stats'][k]) for k, v in ref['stats'].items() if run['stats'][k] != v} }")
        check(run["keys"] == ref["keys"],
              f"{label} {policy} {m} shards: step keys {run['keys']} differ "
              f"from the unsharded engine's {ref['keys']}")
        rule = 2 * errs[(m, policy)]["max_logit_err"]
        out[f"{policy}_{m}"] = margin_rule(
            torch, cfg, sp, policy, prompts, ref["outputs"], run["outputs"],
            f"{label} {policy} {m} shards vs unsharded", rule=rule,
            replay=None if replays is None else replays[m](policy))
    log(f"  {label}: stats and step keys of every mesh run equal the "
        f"unsharded engine's")
    return out


def tp_serve_phase(torch, cfg) -> dict:
    """llama3.1-8b at full width (DEPTH["tp_serve"] layers, layer 0's wo an
    exception tensor) through `Engine(mesh=...)` at 2 and 4 shards on one
    card (`make_serving_mesh(m, devices=[cuda:0] * m)`), planar KV, 8
    slots, capacity 256, 8 x (128 + 32) after a warm pass of 8 others, in
    FP16, FP8 and dual, beside the unsharded engine on the same weights:
    first-decode logits within `logits_limit` (FP16 at full depth, FP8 at
    TP_FP8_CUTS; FP8 at full depth a reading beside its CPU control,
    F-port-10), tokens under the margin rule, stats equal, every first
    replay bitwise, K1-K4 and the quantizer halves launched at the
    per-shard shapes. With two or more cards, one
    mesh across them too (eager steps; a line, not gated)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serving import shard as SHARD

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    sp = make_serving_params(torch, cfg, 0, "cuda", plant_layer=0)
    log(f"  tp serve: {cfg.n_layers}-layer params on the card in "
        f"{time.time() - t0:.1f} s")
    gen = torch.Generator().manual_seed(7)
    prompts = [torch.randint(1, cfg.vocab_size, (128,), generator=gen)
               .tolist() for _ in range(16)]
    timed, warm = prompts[:8], prompts[8:]
    res: dict = {"layers": cfg.n_layers, "label": TP_LABEL}
    runs, errs, ref_logits, logits = {}, {}, {}, {}
    ops.reset_launch_counters()          # the main path's run starts here
    for m in (1, 2, 4):
        mesh = None if m == 1 else make_serving_mesh(
            m, devices=[torch.device("cuda", 0)] * m)
        if mesh is not None:
            shp = SHARD.shard_serving_params(sp, cfg, mesh)
            logits[m] = tp_logit_checks(torch, cfg, sp, mesh, shp, timed,
                                        ref_logits, "tp serve")
            for mode in ("fp16", "fp8"):
                errs[(m, mode)] = logits[m][f"{mode}_{cfg.n_layers}l"]
            del shp
        with ShapeLog() as shapes:
            for policy in ("fp16", "fp8", "dual"):
                runs[(m, policy)] = tp_engine_run(
                    torch, cfg, sp, mesh, policy, warm, timed, 32,
                    "tp serve", capacity=256)
        if mesh is not None:
            want = tp_want_shapes(cfg, m)
            miss = shapes.missing(want)
            check(not miss, f"tp serve {m} shards: kernels never launched "
                  f"at {miss}")
            log(f"  tp serve {m} shards: K1, K2, K3, K4 and the quantizer "
                f"halves launched at every per-shard shape {want}")
    res["logits"] = logits
    res["fport10_control"] = tp_cpu_control(torch, cfg, sp, timed[:4])
    res["agreement"] = tp_hold_to_unsharded(
        torch, cfg, sp, runs, errs,
        {f"r{i}": p for i, p in enumerate(timed)}, "tp serve")
    res["runs"] = {f"{policy}_{m}": {k: v for k, v in r.items()
                                     if k not in ("outputs", "stats")}
                   for (m, policy), r in runs.items()}
    res["launches_total"] = ops.all_launch_counters()
    # where a colocated mesh's decode step goes: the unsharded engine's
    # and the 4-shard mesh's, by kernel (after the counts were read)
    from repro_torch.serving.engine import Engine, Request
    for m in (1, 4):
        mesh = None if m == 1 else make_serving_mesh(
            m, devices=[torch.device("cuda", 0)] * m)
        label = "unsharded" if mesh is None else f"{m} shards"
        log(f"  tp serve {label} fp16: the decode step by kernel")
        res[f"profile_fp16_{m}"] = profile_decode(
            torch, Engine, Request, cfg, sp, timed, "fp16",
            runs[(m, "fp16")]["decode_step_ms_median"], mesh=mesh)
    if torch.cuda.device_count() >= 2:
        mesh = make_serving_mesh(2)
        r = tp_engine_run(torch, cfg, sp, mesh, "fp16", warm, timed, 32,
                          "tp serve across cards", capacity=256)
        res["across_cards"] = {k: v for k, v in r.items()
                               if k not in ("outputs", "stats")}
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"  tp serve: peak device memory {res['peak_mem_gb']:.1f} GB (the "
        f"weights, one mesh's shard slices and the pools)")
    del sp
    torch.cuda.empty_cache()
    return res


def tp_gemma_phase(torch, cfg) -> dict:
    """gemma3-1b at full width and depth (26 layers, 4 q heads and 1 kv
    head of 256, windows of 512 on five layers of six; layer 5's wo an
    exception tensor) on 4 shards of one card: each shard one q head, the
    kv head and the pool whole on every shard (its own copy, K4 per shard
    at G = 1), window reclaim on. 8 x (640 + 32), capacity 704, FP16 and
    FP8, beside the unsharded engine: the comparisons of tp_serve, and
    local-layer blocks reclaimed."""
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serving import shard as SHARD

    torch.cuda.reset_peak_memory_stats()
    sp = make_serving_params(torch, cfg, 0, "cuda", plant_layer=5)
    gen = torch.Generator().manual_seed(8)
    prompts = [torch.randint(1, cfg.vocab_size, (640,), generator=gen)
               .tolist() for _ in range(16)]
    timed, warm = prompts[:8], prompts[8:]
    res: dict = {"layers": cfg.n_layers, "label": TP_LABEL}
    runs, errs, ref_logits = {}, {}, {}
    ops.reset_launch_counters()          # the main path's run starts here
    mesh4 = make_serving_mesh(4, devices=[torch.device("cuda", 0)] * 4)
    shp = SHARD.shard_serving_params(sp, cfg, mesh4)
    logits = tp_logit_checks(torch, cfg, sp, mesh4, shp, timed, ref_logits,
                             "tp gemma")
    for mode in ("fp16", "fp8"):
        errs[(4, mode)] = logits[f"{mode}_{cfg.n_layers}l"]
    del shp
    for m, mesh in ((1, None), (4, mesh4)):
        with ShapeLog() as shapes:
            for policy in ("fp16", "fp8"):
                runs[(m, policy)] = tp_engine_run(
                    torch, cfg, sp, mesh, policy, warm, timed, 32,
                    "tp gemma", capacity=704)
                check(runs[(m, policy)]["window_reclaimed_blocks"] > 0,
                      f"tp gemma {policy}: no local-layer block reclaimed")
    want = tp_want_shapes(cfg, 4)
    miss = shapes.missing(want)
    check(not miss, f"tp gemma: kernels never launched at {miss}")
    log(f"  tp gemma 4 shards: launched at every per-shard shape {want}")
    res["logits"] = logits
    res["agreement"] = tp_hold_to_unsharded(
        torch, cfg, sp, runs, errs,
        {f"r{i}": p for i, p in enumerate(timed)}, "tp gemma")
    res["runs"] = {f"{policy}_{m}": {k: v for k, v in r.items()
                                     if k not in ("outputs", "stats")}
                   for (m, policy), r in runs.items()}
    res["launches_total"] = ops.all_launch_counters()
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"  tp gemma: peak device memory {res['peak_mem_gb']:.1f} GB")
    del sp
    torch.cuda.empty_cache()
    return res


def tp_fleet_phase(torch, cfg) -> dict:
    """`Router.build(meshes=make_replica_meshes(2, 2, devices=[cuda:0] *
    4))`: two replicas of 2 shards each on one card (four disjoint shard
    slots), llama3.1-8b at full width and DEPTH["tp_fleet"] layers, forced
    FP16, planar KV. Planned: replica 0 killed mid-decode; every request
    completes on the survivor, none lost. Rebuild: replica 0 raises
    mid-decode and its drain fails; the router rebuilds it from its
    factory: the old engine (its shards' weight slices, pools and graphs)
    is gone before the new one is built, and replica 1's weights and pool
    are untouched."""
    import gc
    import weakref

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_replica_meshes
    from repro_torch.models.convert import leaves
    from repro_torch.serving.engine import Request
    from repro_torch.serving.faults import FaultEvent, FaultPlan
    from repro_torch.serving.router import Router

    def allocated() -> int:
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    sp = make_serving_params(torch, cfg, 0, "cuda", plant_layer=0)
    meshes = make_replica_meshes(2, 2, devices=[torch.device("cuda", 0)] * 4)
    check(not set(meshes[0].slots) & set(meshes[1].slots),
          "tp fleet: replica meshes share a shard slot")
    gen = torch.Generator().manual_seed(43)
    prompts = {f"q{i}": torch.randint(1, cfg.vocab_size, (128,),
                                      generator=gen).tolist()
               for i in range(6)}
    max_new = 32
    ekw = dict(n_slots=4, capacity=192, kv_planar=True, forced_mode="fp16",
               device="cuda")
    res: dict = {"layers": cfg.n_layers, "label": TP_LABEL}
    ops.reset_launch_counters()          # the main path's run starts here

    def serve(plan, label, on_step=None) -> Router:
        r = Router.build(cfg, sp, 2, meshes=meshes, plan=plan,
                         affinity_blocks=1, engine_kwargs=ekw)
        if on_step:
            on_step(r, None)
        t0 = time.perf_counter()
        for rid, p in prompts.items():
            r.submit(Request(rid, list(p), max_new))
        while r.in_flight():
            if on_step:
                on_step(r, r.step_count)
            r.step()
        torch.cuda.synchronize()
        st = r.stats()
        check(st["lost"] == 0 and st["completed"] == len(prompts),
              f"{label}: {st['lost']} lost, {st['completed']} completed")
        check(all(len(q.output) == max_new for q in r.finished),
              f"{label}: outputs of the wrong length")
        log(f"  {label}: {r.step_count} router steps in "
            f"{time.perf_counter() - t0:.2f} s, kills {st['kills']}, "
            f"rebuilds {st['rebuilds']}, step errors {st['step_errors']}, "
            f"failover requests {st['failover_requests']}, lost "
            f"{st['lost']}")
        return r

    plan = FaultPlan([FaultEvent(6, 0, "kill")])
    seen = {}

    def mark(r, step):
        if step == 6:
            seen["survivor_done"] = len(r.replicas[1].engine.finished)
    r = serve(plan, "tp fleet planned", mark)
    st = r.stats()
    check(st["kills"] == 1 and st["failover_requests"] > 0,
          f"tp fleet planned: kills {st['kills']}, failover requests "
          f"{st['failover_requests']}")
    after = len(r.replicas[1].engine.finished) - seen["survivor_done"]
    check(after > 0, "tp fleet planned: the survivor stopped serving")
    res["planned"] = {k: st[k] for k in ("kills", "failover_requests",
                                         "lost", "completed", "step_errors")}
    res["planned"]["survivor_finished_after_kill"] = after
    del r

    # a drain failure rebuilt from the factory
    plan = FaultPlan([FaultEvent(6, 0, "raise")])
    mem: dict = {}

    def owned(eng) -> int:
        base = {t.data_ptr() for t in leaves(sp)}
        return sum(t.numel() * t.element_size() for p in eng.params
                   for t in leaves(p) if t.data_ptr() not in base) + sum(
            p.numel() * p.element_size() for c in eng.caches
            for p in c["attn"].values())

    def hooks(r, step):
        rep = r.replicas[0]
        if step is None:
            def failed_drain():
                raise RuntimeError("tp fleet rebuild: drain failed")
            rep.engine.drain_requests = failed_drain
            build = rep.factory

            def factory():
                mem["free"] = allocated()
                mem["old_alive"] = mem["old"]() is not None
                eng = build()
                mem["new_owned"] = owned(eng)
                return eng
            rep.factory = factory
            other = r.replicas[1].engine
            mem["other_ptrs"] = [t.data_ptr() for p in other.params
                                 for t in leaves(p)]
            mem["other"] = other
        elif step == 6:
            mem["old"] = weakref.ref(rep.engine)
            mem["old_owned"] = owned(rep.engine)
            mem["before"] = allocated()
    r = serve(plan, "tp fleet rebuild", hooks)
    st = r.stats()
    check(st["rebuilds"] == 1 and st["step_errors"] == 1,
          f"tp fleet rebuild: rebuilds {st['rebuilds']}, step errors "
          f"{st['step_errors']}")
    check(not mem["old_alive"] and mem["old"]() is None,
          "tp fleet rebuild: the old engine outlived its rebuild")
    returned = mem["before"] - mem["free"]
    check(returned >= mem["old_owned"],
          f"tp fleet rebuild: {returned} bytes returned, the old engine "
          f"owned {mem['old_owned']}")
    other = r.replicas[1].engine
    check(other is mem["other"] and [t.data_ptr() for p in other.params
                                     for t in leaves(p)]
          == mem["other_ptrs"],
          "tp fleet rebuild: replica 1's engine or weights changed")
    log(f"  tp fleet rebuild: the old engine's {mem['old_owned'] / 2**30:.2f}"
        f" GiB of shard slices and pools returned ({returned / 2**30:.2f} GiB"
        f" freed before the rebuild), the new engine owns "
        f"{mem['new_owned'] / 2**30:.2f} GiB; replica 1 untouched")
    res["rebuild"] = {"returned_bytes": returned,
                      "old_owned_bytes": mem["old_owned"],
                      "new_owned_bytes": mem["new_owned"],
                      **{k: st[k] for k in ("rebuilds", "step_errors",
                                            "lost", "completed")}}
    res["launches_total"] = ops.all_launch_counters()
    del r, mem
    del sp
    torch.cuda.empty_cache()
    return res


def stream_replays(torch, cfg, sp, mesh, shard_params):
    """mode -> replay(prompt, tokens) for `margin_rule`: a stream replayed
    as the engine computed it, the prompt as one chunk (of the engine's
    bucketed width, which an MoE step's capacity follows; exact-length
    for a recurrent stack), then one decode step a token, on the
    unsharded model and on the mesh. Returns the unsharded model's top-2
    margin after the last token, the two sides' largest logit difference
    there, and for an MoE stack the routing rule's reading over every
    step (`RoutingCheck`: each layer's experts at every real position).
    Leaves the launch counters as they were."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models.layers import Runtime
    from repro_torch.serving import shard as SHARD
    from repro_torch.serving.engine import _bucket

    def for_mode(mode):
        def replay(prompt, tokens):
            before = ops.all_launch_counters()
            n = len(prompt)
            width = n if cfg.cache_kind in ("ssm", "hybrid") else _bucket(n)
            nb = -(-(n + len(tokens)) // 16)
            dev = torch.device("cuda")
            tables = torch.arange(1, nb + 1, dtype=torch.int32,
                                  device=dev)[None]
            rt = Runtime(mode=mode, dtype=torch.float32, act_quant="per_token")

            def i32(v):
                return torch.tensor(v, dtype=torch.int32, device=dev)
            calls, last = {}, {}
            for side, step, params, where in (
                    ("ref", M.paged_step, sp, dict(device="cuda")),
                    ("mesh", functools.partial(SHARD.sharded_paged_step, mesh),
                     shard_params, dict(mesh=mesh))):
                caches = probe_caches(cfg, nb + 1, n_slots=1, **where)
                with RouterLog() as rl:
                    logits = step(
                        rt, params, cfg, i32([prompt + [0] * (width - n)]),
                        caches, tables, q_offset=i32([0]), kv_len=i32([n]),
                        block_size=16, logit_position=i32([n - 1]),
                        return_logits=True)
                    for j, t in enumerate(tokens):
                        logits = step(rt, params, cfg, i32([[t]]), caches,
                                      tables, q_offset=i32([n + j]),
                                      kv_len=i32([n + j + 1]), block_size=16,
                                      return_logits=True)
                calls[side], last[side] = rl.calls, logits
                del caches
            after = ops.all_launch_counters()
            ops.add_launches({k: before[k] - after[k] for k in after})
            top2 = last["ref"][0].topk(2).values
            out = {"margin": float(top2[0] - top2[1]),
                   "err": float((last["mesh"] - last["ref"]).abs().max())}
            if cfg.moe is not None:
                route = RoutingCheck(torch, cfg.moe.top_k)
                nl = cfg.n_layers
                for i in range(len(tokens) + 1):
                    real = (torch.arange(width) < n)[None] if i == 0 \
                        else torch.ones((1, 1), dtype=torch.bool)
                    route.add(calls["mesh"][i * nl:(i + 1) * nl],
                              calls["ref"][i * nl:(i + 1) * nl],
                              torch.tensor([n - 1 if i == 0 else 0]), real)
                out["routing"] = route.done(
                    f"{mode} {mesh.size} shards, the stream replayed to its "
                    f"parting", False)
            return out
        return replay
    return for_mode


def tp_family_phase(torch, cfg, label: str, *, engine_shards=(2, 4),
                    logit_shards=(2, 4), prompt_lens=(128, 100)) -> dict:
    """A family's model at full width (its DEPTH) through
    `Engine(mesh=...)` on colocated shards of one card, beside the
    unsharded engine on the same weights, loaded once (layer 1's wo, or a
    recurrent stack's out_proj, an exception tensor): FP16 and FP8, 8
    slots, 8 x (prompt_lens[0] + 32) timed after a warm pass of 8 (half of
    them prompt_lens[1] long: a recurrent stack's exact-length chunks
    give one step key a length). Checks: first-decode logits of every
    mesh in `logit_shards` within `logits_limit` (FP16 at full depth, FP8
    at `fp8_cuts` and full depth; an MoE stack under the routing rule),
    tokens of each engine mesh under the margin rule (`margin_rule` with
    the stream replayed to each parting: `stream_replays`), `stats` and
    step keys equal,
    every first replay bitwise, and K1-K4 and the quantizer halves
    launched at the per-shard shapes (`tp_want_shapes`)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serving import shard as SHARD

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    sp = make_serving_params(torch, cfg, 0, "cuda", plant_layer=1)
    log(f"  {label}: {cfg.n_layers}-layer params on the card in "
        f"{time.time() - t0:.1f} s")
    gen = torch.Generator().manual_seed(9)
    timed = [torch.randint(1, cfg.vocab_size, (prompt_lens[0],),
                           generator=gen).tolist() for _ in range(8)]
    warm = [torch.randint(1, cfg.vocab_size, (prompt_lens[i % 2],),
                          generator=gen).tolist() for i in range(8)]
    res: dict = {"layers": cfg.n_layers, "label": TP_LABEL}
    runs, errs, ref_logits, logits, replays = {}, {}, {}, {}, {}
    meshes = {m: make_serving_mesh(m, devices=[torch.device("cuda", 0)] * m)
              for m in sorted(set(engine_shards) | set(logit_shards))}
    shards = {}
    ops.reset_launch_counters()          # the main path's run starts here
    for m in sorted(meshes):
        shp = SHARD.shard_serving_params(sp, cfg, meshes[m])
        logits[m] = tp_logit_checks(torch, cfg, sp, meshes[m], shp, timed,
                                    ref_logits, label)
        for mode in ("fp16", "fp8"):
            errs[(m, mode)] = logits[m][f"{mode}_{cfg.n_layers}l"]
        if m in engine_shards:
            shards[m] = shp
            replays[m] = stream_replays(torch, cfg, sp, meshes[m], shp)
        del shp
    for m in (1,) + tuple(engine_shards):
        with ShapeLog() as shapes:
            for policy in ("fp16", "fp8"):
                runs[(m, policy)] = tp_engine_run(
                    torch, cfg, sp, meshes.get(m), policy, warm, timed, 32,
                    label, capacity=prompt_lens[0] + 32)
        if m > 1:
            want = tp_want_shapes(cfg, m)
            miss = shapes.missing(want)
            check(not miss, f"{label} {m} shards: kernels never launched at "
                  f"{miss}")
            log(f"  {label} {m} shards: launched at every per-shard shape "
                f"{want}")
    res["logits"] = logits
    res["agreement"] = tp_hold_to_unsharded(
        torch, cfg, sp, runs, errs,
        {f"r{i}": p for i, p in enumerate(timed)}, label, replays=replays)
    res["runs"] = {f"{policy}_{m}": {k: v for k, v in r.items()
                                     if k not in ("outputs", "stats")}
                   for (m, policy), r in runs.items()}
    res["launches_total"] = ops.all_launch_counters()
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"  {label}: peak device memory {res['peak_mem_gb']:.1f} GB")
    del sp, shards, replays
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# training (PR 30): the train loss, AdamW, the train step and the CLI
# ---------------------------------------------------------------------------

TRAIN_LOSS_RTOL = 1e-5      # card against CPU, f32 activations
TRAIN_GRAD_RTOL = 1e-4      # each gradient leaf, relative L2
TRAIN_UPDATE_RTOL = 1e-6    # apply_updates on the same gradients
TRAIN_BF16_RTOL = 2e-2      # the bf16 loss against the f32 loss


def _grad_leaves(tree, path=""):
    """(path, leaf) of a port tree, a list's entries by index."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _grad_leaves(v, f"{path}/{k}" if path else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _grad_leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def train_slice_phase(torch, cfg) -> dict:
    """qwen1.5-0.5b at full width, 2 layers: one `train_loss` and its
    backward in f32 activations on the card against the port's CPU path
    on the same weights and batch (2 x 128 tokens from `SyntheticLM`):
    the loss within TRAIN_LOSS_RTOL, each parameter's gradient within a
    relative L2 of TRAIN_GRAD_RTOL; then the same step in TRAIN_RT (bf16
    activations) on the card, its loss within TRAIN_BF16_RTOL of the f32
    loss and its gradients finite; then one `apply_updates` of the card's
    f32 gradients on both devices, params and moments within
    TRAIN_UPDATE_RTOL of each leaf's largest value."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.steps import TRAIN_RT
    from repro_torch.models import model as M
    from repro_torch.models.convert import params_to
    from repro_torch.models.layers import Runtime
    from repro_torch.optim import adamw

    cut = dataclasses.replace(cfg, n_layers=2)
    t0 = time.time()
    prm = {"cpu": M.init_params(cut, seed=0, device="cpu")}
    prm["cuda"] = params_to(prm["cpu"], "cuda")
    batch = next(SyntheticLM(cut, DataConfig(seq_len=128, global_batch=2))
                 .batches(1))
    log(f"  train slice: 2-layer full-width f32 params "
        f"({sum(p.numel() for p, _ in adamw.leaves(prm['cpu'])) / 1e6:.1f}M)"
        f" made on the CPU and copied in {time.time() - t0:.1f} s")
    rt = Runtime(mode="train", dtype=torch.float32)
    loss, dt = {}, {}
    for dev in ("cpu", "cuda"):
        for p, _ in adamw.leaves(prm[dev]):
            p.requires_grad_(True)
        t0 = time.time()
        lv, _ = M.train_loss(rt, prm[dev], cut, {
            k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        lv.backward()
        loss[dev] = float(lv.detach())
        dt[dev] = time.time() - t0
    rel = abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"])
    worst, worst_at = 0.0, ""
    for (path, pc), (_, pg) in zip(_grad_leaves(prm["cpu"]),
                                   _grad_leaves(prm["cuda"])):
        want, got = pc.grad.double(), pg.grad.double().cpu()
        den = float(torch.linalg.norm(want))
        e = float(torch.linalg.norm(got - want)) / den if den else \
            float(torch.linalg.norm(got))
        if e >= worst:
            worst, worst_at = e, path
    log(f"  train slice f32: loss card {loss['cuda']:.7f} CPU "
        f"{loss['cpu']:.7f} (rel {rel:.2e}, tol {TRAIN_LOSS_RTOL}); worst "
        f"gradient rel L2 {worst:.2e} at {worst_at} (tol {TRAIN_GRAD_RTOL});"
        f" loss + backward card {dt['cuda']:.2f} s, CPU {dt['cpu']:.2f} s")
    check(math.isfinite(loss["cuda"]) and rel <= TRAIN_LOSS_RTOL,
          f"train slice: card loss {loss['cuda']} against CPU {loss['cpu']}")
    check(worst <= TRAIN_GRAD_RTOL,
          f"train slice: gradient {worst_at} rel L2 {worst:.2e}")
    grads = adamw.tree_map(lambda p: p.grad.detach().clone(), prm["cuda"])
    # the same step in bf16 activations on the card, on the same weights
    for p, _ in adamw.leaves(prm["cuda"]):
        p.grad = None
    lv, _ = M.train_loss(TRAIN_RT, prm["cuda"], cut, {
        k: torch.from_numpy(v).cuda() for k, v in batch.items()})
    lv.backward()
    lb, lf = float(lv.detach()), loss["cuda"]
    brel = abs(lb - lf) / abs(lf)
    finite = all(bool(torch.isfinite(p.grad).all())
                 for p, _ in adamw.leaves(prm["cuda"]))
    log(f"  train slice bf16 (TRAIN_RT): loss {lb:.6f} against f32 {lf:.6f}"
        f" (rel {brel:.2e}, tol {TRAIN_BF16_RTOL}); gradients finite: "
        f"{finite}")
    check(math.isfinite(lb) and finite and brel <= TRAIN_BF16_RTOL,
          f"train slice: bf16 loss {lb} against f32 {lf}")
    ocfg = adamw.AdamWConfig(warmup_steps=1)
    state, om = {}, {}
    for dev in ("cpu", "cuda"):
        state[dev] = adamw.init_state(ocfg, prm[dev])
        g = grads if dev == "cuda" else params_to(grads, "cpu")
        _, state[dev], om[dev] = adamw.apply_updates(ocfg, prm[dev], g,
                                                     state[dev])
    upd = 0.0
    for a, b in ((prm["cpu"], prm["cuda"]), (state["cpu"]["m"],
                                             state["cuda"]["m"]),
                 (state["cpu"]["v"], state["cuda"]["v"])):
        for (_, x), (_, y) in zip(_grad_leaves(a), _grad_leaves(b)):
            scale = float(x.detach().abs().max()) or 1.0
            upd = max(upd, float((y.detach().cpu() - x.detach()).abs().max())
                      / scale)
    log(f"  train slice apply_updates: params and moments card against CPU "
        f"within {upd:.2e} of each leaf's largest value (tol "
        f"{TRAIN_UPDATE_RTOL}); grad_norm {float(om['cuda']['grad_norm']):.6f}"
        f" / {float(om['cpu']['grad_norm']):.6f}, lr "
        f"{float(om['cuda']['lr']):.3e}")
    check(upd <= TRAIN_UPDATE_RTOL, f"train slice: apply_updates {upd:.2e}")
    del prm, grads, state
    torch.cuda.empty_cache()
    return {"loss_cuda": loss["cuda"], "loss_cpu": loss["cpu"],
            "loss_rel": rel, "grad_rel_l2_max": worst,
            "grad_rel_l2_worst_leaf": worst_at, "update_rel_max": upd,
            "bf16_loss": lb, "f32_loss": lf, "bf16_rel": brel,
            "card_s": dt["cuda"], "cpu_s": dt["cpu"]}


def train_phase(torch, cfg, n_steps: int = 10, batch: int = 4,
                seq: int = 2048, n_micro: int = 2) -> dict:
    """llama3.1-8b at full width, cut to DEPTH["train"] layers (f32
    params, gradients and two moments of all 32 layers are ~128 GB):
    n_steps `make_train_step` steps in TRAIN_RT on `SyntheticLM` batches
    of batch x seq tokens in n_micro microbatches. The reckoned bytes of
    params, gradients and moments (16 B a parameter) beside the peak
    allocated; every loss and grad_norm finite and the launcher's exit
    rule met (mean of the first 5 losses above the mean of the last 5);
    step ms and tokens/s as readings, then one more step profiled (device
    ms by kernel, bf16 and f32 GEMMs apart)."""
    from repro_torch.data.pipeline import (DataConfig, SyntheticLM,
                                           microbatch_split)
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.optim import adamw

    n_params = sum(p.numel() for p, _ in adamw.leaves(
        steps.param_structs(cfg, serving=False)))
    reckoned = 16 * n_params
    log(f"  train: {cfg.n_layers} layers, {n_params / 1e9:.3f} B params; "
        f"params + gradients + two moments reckoned at {reckoned / 1e9:.2f} "
        f"GB (f32 each)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = M.init_params(cfg, seed=0, device="cuda")
    ocfg = adamw.AdamWConfig(total_steps=n_steps,
                             warmup_steps=max(n_steps // 20, 5))
    opt = adamw.init_state(ocfg, params)
    step = steps.make_train_step(cfg, ocfg)
    data = SyntheticLM(cfg, DataConfig(seq_len=seq, global_batch=batch))
    losses, gnorms, ms = [], [], []
    for b in data.batches(n_steps):
        b = microbatch_split(b, n_micro)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    held = torch.cuda.memory_allocated() - base
    peak = torch.cuda.max_memory_allocated() - base
    improved = sum(losses[:5]) / 5 - sum(losses[-5:]) / 5
    warm = sorted(ms[1:])
    med = warm[len(warm) // 2]
    tok_s = batch * seq / (med / 1e3)
    log(f"  train: losses {[round(x, 4) for x in losses]}; grad_norm "
        f"{[round(x, 3) for x in gnorms]}")
    log(f"  train: first step {ms[0]:.1f} ms, later steps median "
        f"{med:.1f} ms ({tok_s:.0f} tokens/s of {batch} x {seq}); held after "
        f"the run {held / 1e9:.2f} GB (params, gradients, moments: reckoned "
        f"{reckoned / 1e9:.2f}), peak allocated {peak / 1e9:.2f} GB; "
        f"improvement {improved:.4f}")
    check(all(math.isfinite(x) for x in losses + gnorms),
          "train: a non-finite loss or grad_norm")
    check(improved > 0, f"train: the loss did not fall ({improved:.4f})")
    reckoning = train_reckoning(cfg, batch, seq, held, peak - held, med)
    # one more step under the profiler, after the run: device ms by kernel
    wall, by_name = device_ms_by_kernel(
        torch, lambda: step(params, opt, b), 1)
    prof = profile_summary("train profile: 1 step", wall, med, by_name)
    # cuBLAS names: f32 GEMMs "sgemm" / "gemm_f32f32..."; the bf16 ones
    # "nvjet_..." (cuBLASLt) or "...gemm_bf16..."
    gemm = {"bf16": 0.0, "f32": 0.0}
    for k, v in by_name.items():
        kl = k.lower()
        if "sgemm" in kl or "gemm_f32" in kl:
            gemm["f32"] += v
        elif "nvjet" in kl or ("gemm" in kl and "bf16" in kl):
            gemm["bf16"] += v
    prof["gemm_ms_by_dtype"] = gemm
    log(f"  train profile: GEMMs bf16 {gemm['bf16']:.1f} ms, f32 (the LM "
        f"head, attention's score and value products) {gemm['f32']:.1f} ms "
        f"of {prof['device_ms_per_step']:.1f} ms device time a step")
    del params, opt, step
    torch.cuda.empty_cache()
    return {"losses": losses, "grad_norms": gnorms, "step_ms": ms,
            "step_ms_median": med, "tokens_per_s": tok_s,
            "n_params": n_params, "reckoned_bytes": reckoned,
            "held_bytes": held, "peak_bytes": peak, "improvement": improved,
            "profile": prof, "reckoning": reckoning}


def train_reckoning(cfg, batch: int, seq: int, held: int, above: int,
                    step_ms: float) -> dict:
    """The dry run of the train step `train_phase` timed (batch x seq
    tokens; the dry run's microbatches are one row each, as the JAX
    package lays them out on one data shard) on a one-device layout: its
    reckoned held bytes (params and moments, updated in place, and the
    f32 gradients kept in .grad) against what stayed allocated (gate:
    within 1 %), its temporaries beside the measured peak above that (a
    reading), its FLOPs by class, and its roofline bound against the
    measured step (gate: bound / step <= 1.05)."""
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh

    t0 = time.time()
    rec = dryrun.reckon(cfg, InputShape("train", seq, batch, "train"),
                        make_debug_mesh(1, 1))
    reckon_s = time.time() - t0
    got = rec["memory"]["held_after_gib"] * 2**30
    roof = rec["roofline"]
    share = roof["bound_step_s"] * 1e3 / step_ms
    by = rec["cost"]["flops_global_by_class"]
    dots = rec["cost"]["dot_flops_global_by_class"]
    log(f"  train reckoning ({reckon_s:.1f} s on meta tensors): held "
        f"{got:.0f} B reckoned, {held} B measured ({got / held - 1:+.2e}); "
        f"temp {rec['memory']['temp_gib']:.2f} GiB reckoned (1-row "
        f"microbatches), peak {above / 2**30:.2f} GiB above the held bytes "
        f"measured; FLOPs by class {by} (dots {dots}); bound "
        f"{roof['bound_step_s'] * 1e3:.1f} ms ({roof['dominant']}: compute "
        f"{roof['compute_s'] * 1e3:.1f}, memory {roof['memory_s'] * 1e3:.1f}"
        f" ms) against the measured {step_ms:.1f} ms: share {share:.3f}")
    check(abs(got - held) <= 0.01 * held,
          f"train reckoning: {got:.0f} B reckoned against {held} B held")
    check(share <= 1.05, f"train reckoning: bound "
          f"{roof['bound_step_s'] * 1e3:.1f} ms above the measured "
          f"{step_ms:.1f} ms")
    return {"reckon_s": reckon_s, "held_bytes_reckoned": got,
            "temp_gib": rec["memory"]["temp_gib"], "roofline": roof,
            "share": share, "flops_by_class": by,
            "dot_flops_by_class": rec["cost"]["dot_flops_global_by_class"]}


def train_serve_phase(torch, cfg, n_steps: int = 10) -> dict:
    """qwen1.5-0.5b at full width and depth: `repro_torch.launch.train`
    for n_steps steps (8 x 128 tokens, 2 microbatches) with --ckpt into
    a temporary directory (deleted after), which must exit 0; its
    {"params"} restored with
    serving=True (every weight slice nested on the card by K8), layer 0's
    wo then re-nested with one weight set to 2.0 (an exception tensor,
    K3); served through `Engine` in FP16, FP8 and dual as `serve_phase`
    serves (8 x (128 + 32), every first replay bitwise its eager call;
    K1, K2, K3, K4 and the quantizer launched). Launches: the
    restore's and the serve's, each counted from 0 at its start."""
    import contextlib
    import io as stdio
    import shutil
    import tempfile

    from repro_torch.checkpoint import io
    from repro_torch.core.nestedfp import NestedTensor
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli
    from repro_torch.models import model as M

    ckpt = Path(tempfile.mkdtemp(prefix="train_ckpt_"))
    out = stdio.StringIO()
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(out):
            rc = train_cli.main([
                "--arch", cfg.arch_id, "--steps", str(n_steps), "--batch",
                "8", "--seq", "128", "--micro", "2", "--ckpt", str(ckpt),
                "--log-every", "3"])
        train_s = time.time() - t0
        for line in out.getvalue().splitlines():
            log(f"  train serve | {line}")
        check(rc == 0, f"train serve: the launcher exited {rc}")
        ck_bytes = sum(f.stat().st_size for f in ckpt.iterdir())
        log(f"  train serve: {n_steps} steps and the checkpoint "
            f"({ck_bytes / 1e9:.2f} GB) in {train_s:.1f} s")
        torch.cuda.empty_cache()
        ops.reset_launch_counters()        # the restore starts here
        t0 = time.time()
        restored, step = io.restore(
            str(ckpt), {"params": M.init_params(cfg, device="meta")},
            device="cuda", serving=True)
        torch.cuda.synchronize()
        restore_s = time.time() - t0
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    check(step == n_steps, f"train serve: checkpoint step {step}")
    sp = restored["params"]
    wo = sp["layers"][0]["attn"]["wo"]
    w16 = wo.weight.read_f16().clone()
    w16[0, 0] = 2.0
    wo.weight = NestedTensor.from_f16(w16)
    check(wo.weight.is_exception, "train serve: planted wo was nested")
    restore_launches = ops.all_launch_counters()
    log(f"  train serve: restored and nested in {restore_s:.1f} s "
        f"(K8 launches {restore_launches['nestedfp_encode']}, the planted "
        f"exception tensor's included)")
    check(restore_launches["nestedfp_encode"] > 0,
          "train serve: the restore never launched K8")
    res = serve_phase(torch, cfg, cfg.n_layers, label="train serve",
                      params=sp)
    res["launches_total"] = {k: v + restore_launches[k] for k, v in
                             res["launches_total"].items()}
    res.update(train_s=train_s, restore_s=restore_s,
               checkpoint_bytes=ck_bytes, restore_launches=restore_launches)
    del sp, restored
    torch.cuda.empty_cache()
    return res


def _linears(tree, cls):
    if isinstance(tree, cls):
        return [tree]
    if isinstance(tree, dict):
        return [p for v in tree.values() for p in _linears(v, cls)]
    if isinstance(tree, list):
        return [p for v in tree for p in _linears(v, cls)]
    return []


SOURCES = {
    "nestedfp16_matmul": ("src/repro_torch/csrc/nestedfp16_matmul.cu",
                          "src/repro/kernels/nestedfp16_matmul.py:81"),
    "nestedfp8_matmul": ("src/repro_torch/csrc/fp8_mma_gemm.cuh",
                         "src/repro/kernels/nestedfp8_matmul.py:67"),
    "f16_matmul": ("src/repro_torch/csrc/f16_matmul.cu",
                   "src/repro/kernels/f16_matmul.py:48"),
    "paged_planar_decode_attention": (
        "src/repro_torch/csrc/paged_planar_decode_attention.cu",
        "src/repro/kernels/planar_decode_attention.py:193"),
    "planar_decode_attention": (
        "src/repro_torch/csrc/planar_decode_attention.cu",
        "src/repro/kernels/planar_decode_attention.py:241"),
    "flash_prefill_attention": (
        "src/repro_torch/csrc/flash_prefill_attention.cu",
        "src/repro/kernels/flash_prefill_attention.py:81"),
    "nestedfp8_matmul_fused_quant": (
        "src/repro_torch/csrc/nestedfp8_matmul_fused_quant.cu",
        "src/repro/kernels/nestedfp8_matmul.py:122"),
    "nestedfp_encode": ("src/repro_torch/csrc/nestedfp_encode.cu",
                        "src/repro/kernels/nestedfp_encode.py:45"),
    # no Pallas kernel: the JAX function that XLA fuses under jit
    "quant_per_token": ("src/repro_torch/csrc/quant_per_token.cu",
                        "src/repro/core/quant.py:35"),
}
# the head-dim instances of the last families, each an entry of its own:
# (kernel, D) -> the phases whose main-path runs launch it at that D alone
INSTANCES = {("paged_planar_decode_attention", 96): ("phi3_serve",),
             ("planar_decode_attention", 80): ("zamba2_dense",),
             ("planar_decode_attention", 96): ("phi3_dense",),
             ("flash_prefill_attention", 80): ("zamba2_dense",),
             ("flash_prefill_attention", 96): ("phi3_dense",)}

# the per-token quantizer's two halves in front of K2 on a mesh's
# row-parallel layers (entry points of the quantizer's source): they
# replace GSPMD's reduction of quantize_act_per_token's amax
TP_SOURCES = {name: ("src/repro_torch/csrc/quant_per_token.cu",
                     "src/repro/core/quant.py:35")
              for name in ("row_absmax", "quant_per_token_scaled")}
# the kernels a mesh runs at per-shard shapes: an entry each
# ("nestedfp16_matmul@tp4", ...), timed at llama3.1-8b's shard of 4,
# their launches those of the tp phases
TP_INSTANCES = ("nestedfp16_matmul", "nestedfp8_matmul", "f16_matmul",
                "paged_planar_decode_attention")

# which measured calls make up each kernel's numbers in the kernels line
LINE_WEIGHTS = {
    # the seven GEMMs of one layer in one decode step (M = 8)
    **{name: (lambda r: LLAMA_KN.count((r["k"], r["n"]))
              if r["m"] == 8 and "model" not in r else 0)
       for name in ("nestedfp16_matmul", "nestedfp8_matmul", "f16_matmul",
                    "nestedfp8_matmul_fused_quant")},
    # one fp16-mode paged decode call of one llama layer
    "paged_planar_decode_attention": (
        lambda r: int(r["h"] == 32 and r["d"] == 128 and not r["fp8"]
                      and r["window"] is None)),
    # one fp16-mode dense decode call of one llama layer at the dense
    # capacity
    "planar_decode_attention": (
        lambda r: int(r["h"] == 32 and r["d"] == 128 and not r["fp8"]
                      and r["cap"] == 1056 and r["window"] is None)),
    # one llama layer's bf16 prefill attention of 8 x 1024 tokens
    "flash_prefill_attention": (
        lambda r: int((r["dtype"], r["b"], r["s"], r["h"], r["d"])
                      == ("bfloat16", 8, 1024, 32, 128))),
    # one 4096 x 14336 weight
    "nestedfp_encode": lambda r: int("model" not in r),
    # the seven quantizations of one layer in one fp8 decode step (M = 8,
    # f32 rows as the engine gives them): six of width 4096, one of 14336
    "quant_per_token": (lambda r: (r["m"] == 8 and r["dtype"] == "float32")
                        * {4096: 6, 14336: 1}[r["k"]]),
    # the instances: one fp16-mode call of one layer (K4 at phi3's serve
    # lens, K5 at the model's dense capacity) and one bf16 prefill of the
    # model's dense phase (8 x 1024, phi3 8 x 1600)
    ("paged_planar_decode_attention", 96): (
        lambda r: int(r["d"] == 96 and not r["fp8"])),
    ("planar_decode_attention", 80): (
        lambda r: int(r["d"] == 80 and not r["fp8"] and r["cap"] == 1056)),
    ("planar_decode_attention", 96): (
        lambda r: int(r["d"] == 96 and not r["fp8"] and r["cap"] == 1632)),
    ("flash_prefill_attention", 80): (
        lambda r: int((r["dtype"], r["b"], r["s"], r["d"])
                      == ("bfloat16", 8, 1024, 80))),
    ("flash_prefill_attention", 96): (
        lambda r: int((r["dtype"], r["b"], r["s"], r["d"])
                      == ("bfloat16", 8, 1600, 96))),
    # one shard's calls in one layer of a decode step at 4 shards: its
    # seven GEMMs (M = 8), its fp16-mode K4 call (8 / 2 heads), its two
    # row-parallel quantizations (wo's K = 1024, down's 3584)
    **{(name, "tp4"): (lambda r: LLAMA_TP_KN[4].count((r["k"], r["n"]))
                       if r.get("model") == "llama3.1-8b tp4" else 0)
       for name in ("nestedfp16_matmul", "nestedfp8_matmul", "f16_matmul")},
    ("paged_planar_decode_attention", "tp4"): (
        lambda r: int((r["h"], r["hkv"], r["d"]) == (8, 2, 128)
                      and not r["fp8"] and r["window"] is None)),
    **{name: (lambda r: int(r["model"] == "llama3.1-8b tp4"))
       for name in TP_SOURCES},
}


def ptxas_entries(build_log: str) -> list[dict]:
    """Registers and spill bytes of each entry function in a ptxas -v
    log (names kept to their readable part: a kernel's name and its
    template's int arguments, with K6's element type)."""
    import re
    types = {"6__half": "half", "13__nv_bfloat16": "bf16", "f": "float"}
    out, cur = [], None
    for line in build_log.splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            short = re.search(r"\d+([a-z_]+kernel)(?:ILi(\d+)ELb(\d))?", name)
            k6 = re.search(r"\d+(flash_prefill(?:_tc)?_kernel)I"
                           r"(6__half|13__nv_bfloat16|f)Li(\d+)E", name)
            if k6:
                entry = f"{k6.group(1)}<{types[k6.group(2)]},{k6.group(3)}>"
            elif short:
                entry = short.group(1) + (
                    f"<{short.group(2)},{short.group(3)}>" if short.group(2)
                    else "")
            else:
                entry = name
            cur = {"entry": entry}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def k7_sass_ops(_build) -> dict:
    """What K7's mma_kernel instances compile to: counts of the tensor-core
    (HMMA, QMMA, HGMMA, QGMMA) and e4m3 conversion (F2FP) instructions in
    cuobjdump's SASS of the build."""
    import collections
    import re
    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    lib = _build.library_path("nestedfp8_matmul_fused_quant")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    ops, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if "mma_kernel" in m.group(1) else None
            continue
        m = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?((?:[HQ]G?MMA|F2FP)[A-Z0-9_.]*)",
                      line)
        if fn and m:
            ops.setdefault(fn, collections.Counter())[m.group(1)] += 1
    for fn, c in ops.items():
        log(f"  nestedfp8_matmul_fused_quant SASS {fn[:60]}: {dict(c)}")
    return {fn: dict(c) for fn, c in ops.items()}


# depths cut to keep the whole script within its time budget, from the
# phases that spent the most seconds a layer at full depth (on an H100:
# granite_serve 2.83 s a layer of 32, spec 1.16 of 32, granite_dense 1.03
# of 32, qwen3_dense 0.72 of 36; then, to make room for the last
# families' six phases, spec 1.17 of 16, zamba2_serve 0.75 of 54,
# mamba2_serve 0.64 of 64, tiered 0.62 of 32, mamba2_dense 0.48 of 64
# and qwen3_serve 0.39 of 36; the fleet, 1.9 s a layer, keeps its depth:
# its planned faults are placed by the token stream, and ds_serve keeps
# its 62 layers: its point is the 67.6 GB load); then, to keep the whole
# script clear of its limit on a slower host (one full run took 964 s,
# the same code 1202 s on another machine), phi3_serve 1.02 s a layer of
# 32, zamba2_dense 0.68 of 54, qwen3_dense 0.64 of 18, ds_dense 0.56 of
# 62, gemma_dense 0.54 of 26 and phi3_dense 0.42 of 32; then, to make
# room for the moe, ssm and hybrid meshes' three phases (~75 s) and their
# kernel rows, the same phases cut further: phi3_serve, zamba2_serve,
# mamba2_serve, zamba2_dense, mamba2_dense, phi3_dense and qwen3_serve to
# 6 layers (zamba2's 6 hold one shared-attention application), ds_dense
# to 8, gemma_dense to 6 (its one global layer), tiered and spec to 8 and
# 4, qwen3_dense to 4; every other phase runs its model's full depth
DEPTH = {"granite_serve": 4, "granite_dense": 4, "spec": 4,
         "qwen3_dense": 4, "qwen3_serve": 6, "tiered": 8,
         "mamba2_serve": 6, "mamba2_dense": 6, "zamba2_serve": 6,
         "phi3_serve": 6, "zamba2_dense": 6, "ds_dense": 8,
         "gemma_dense": 6, "phi3_dense": 6,
         # tensor-parallel serving: the per-shard shapes are a layer's, so
         # depth buys nothing but time (tp_serve runs nine engines);
         # zamba2's 12 hold two shared-attention applications
         "tp_serve": 8, "tp_fleet": 4, "tp_moe": 4, "tp_ssm": 8,
         "tp_hybrid": 12,
         # training: f32 params, gradients and two moments of llama3.1-8b's
         # 32 layers are ~128 GB; 4 layers (1.92 B params) ~31 GB
         "train": 4}


def cut_depth(cfg, phase: str):
    """The config a phase runs: its model's, at `DEPTH[phase]` layers when
    the phase is cut."""
    return dataclasses.replace(cfg, n_layers=DEPTH[phase]) \
        if phase in DEPTH else cfg


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="card,kernels,ds_slice,ds_serve,ds_dense,"
                            "ds3_mla,ds3_serve,slice,serve,dense,"
                            "granite_slice,granite_serve,granite_dense,"
                            "gemma_slice,gemma_serve,gemma_dense,"
                            "spec,tiered,fleet,gemma_spec,qwen3_slice,"
                            "qwen3_serve,qwen3_dense,mamba2_slice,"
                            "mamba2_serve,mamba2_dense,zamba2_slice,"
                            "zamba2_serve,zamba2_dense,phi3_slice,"
                            "phi3_serve,phi3_dense,seamless_slice,"
                            "seamless_dense,tp_serve,tp_gemma,tp_fleet,"
                            "tp_moe,tp_ssm,tp_hybrid,train_slice,train,"
                            "train_serve")
    ap.add_argument("--iters", type=int, default=20,
                    help="timed calls per kernel measurement")
    ap.add_argument("--serve-layers", type=int, default=32)
    ap.add_argument("--host-tier", choices=("on", "off"), default="on",
                    help="host_offload of the serve and gemma_serve "
                         "phases' engines (the engine's default is on)")
    ap.add_argument("--k6-baseline", default="",
                    help="another checkout's csrc/flash_prefill_attention.cu:"
                         " the kernels phase builds it too and holds K6 "
                         "bitwise to it at every case whose G divides 64")
    ap.add_argument("--out", default="",
                    help="also write the full results as JSON to this file")
    args = ap.parse_args()
    phases = set(args.phases.split(","))

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check", file=sys.stderr)
        return 1
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)         # the card's name and power limit, as nvidia-smi says
    log(f"== torch {torch.__version__}, CUDA {torch.version.cuda}")
    results: dict = {"card": smi}

    t0 = time.time()
    _build.build_all()
    results["build_s"] = time.time() - t0
    log(f"== built {len(_build.KERNELS)} kernels in {results['build_s']:.1f} s")
    for name in _build.KERNELS:
        for line in _build.build_log(name).splitlines():
            # ptxas names each entry function, then its spills and registers
            if any(w in line for w in ("entry function", "registers", "spill")):
                log(f"  {name}: {line.strip()}")
    results["k7_sass"] = k7_sass_ops(_build)
    results["decode_ptxas"] = {name: ptxas_entries(_build.build_log(name))
                               for name in ("planar_decode_attention",
                                            "paged_planar_decode_attention")}
    k6_ptxas = ptxas_entries(_build.build_log("flash_prefill_attention"))
    results["prefill_ptxas"] = k6_ptxas
    for e in k6_ptxas:
        log(f"  flash_prefill_attention ptxas {e['entry']}: "
            f"{e.get('registers')} registers, spill stores "
            f"{e.get('spill_stores')} loads {e.get('spill_loads')}")
    d256 = [e for e in k6_ptxas if e["entry"].endswith(",256>")]
    check(not _build.build_log("flash_prefill_attention") or (
        len(d256) == 3 and not any(e.get("spill_stores", 0)
                                   + e.get("spill_loads", 0) for e in d256)),
          f"K6's D = 256 instances: {d256}")

    rows = {}
    if "kernels" in phases:
        t_kernels = time.time()
        log("== kernels vs plain versions (llama3.1-8b shapes)")
        rows = gemm_phase(torch, args.iters)
        rows["paged_planar_decode_attention"] = attention_phase(torch, args.iters)
        rows["planar_decode_attention"] = dense_decode_phase(torch, args.iters)
        log("== K4 and K5 at gemma3-1b's heads (D = 256)")
        rows["paged_planar_decode_attention"] += attention_phase(
            torch, args.iters, **GEMMA_K4)
        rows["planar_decode_attention"] += dense_decode_phase(
            torch, args.iters, **GEMMA_K5)
        log("== K4 and K5 at deepseek-coder-33b's heads (56 / 8, G = 7)")
        rows["paged_planar_decode_attention"] += attention_phase(
            torch, args.iters, **DS_K4)
        rows["planar_decode_attention"] += dense_decode_phase(
            torch, args.iters, **DS_K5)
        rows["flash_prefill_attention"] = prefill_attention_phase(
            torch, args.iters, baseline=k6_baseline(torch, args.k6_baseline)
            if args.k6_baseline else None)
        rows["nestedfp8_matmul_fused_quant"] = fused_quant_phase(
            torch, args.iters)
        log("== K7 at gemma3-1b's seven GEMM shapes")
        rows["nestedfp8_matmul_fused_quant"] += fused_quant_gemma(torch)
        for model, kn, ms in (("qwen3-8b", QWEN3_KN, (8, 256)),
                              ("deepseek-coder-33b", DS_KN, (8, 256)),
                              ("granite-moe-3b", GRANITE_KN, (8, 256)),
                              ("deepseek-v3", DS3_KN, (8, 256)),
                              ("mamba2-2.7b", MAMBA2_KN, (8,)),
                              ("zamba2-2.7b", ZAMBA2_KN, (8,))):
            log(f"== K1, K2, K3 and K7 at {model}'s {len(kn)} GEMM shapes")
            family_gemm_phase(torch, rows, model, kn, ms)
        log("== K4 and K5 at granite-moe-3b's heads (24 / 8, G = 3, D = 64)")
        rows["paged_planar_decode_attention"] += attention_phase(
            torch, args.iters, **GRANITE_K4)
        rows["planar_decode_attention"] += dense_decode_phase(
            torch, args.iters, **GRANITE_K5)
        log("== K4 at phi-3-vision's heads (32 / 32, D = 96); K5 at "
            "zamba2-2.7b's shared attention (32 / 32, D = 80) and phi3's")
        rows["paged_planar_decode_attention"] += attention_phase(
            torch, args.iters, **PHI3_K4)
        rows["planar_decode_attention"] += dense_decode_phase(
            torch, args.iters, **ZAMBA2_K5)
        rows["planar_decode_attention"] += dense_decode_phase(
            torch, args.iters, **PHI3_K5)
        rows["nestedfp_encode"] = encode_phase(torch, args.iters)
        rows["quant_per_token"] = quant_phase(torch, args.iters)
        log("== K1, K2, K3, K4 and the quantizer halves at the per-shard "
            "shapes of tensor-parallel serving (llama3.1-8b at 4 and 2 "
            "shards, gemma3-1b at 4)")
        tp_iters = max(5, args.iters // 4)
        label, kn = TP_GEMMS[0]
        tp_gemm_phase(torch, rows, label, kn, tp_iters)
        for label, kn in TP_GEMMS[1:]:
            family_gemm_phase(torch, rows, label, kn, (8,))
        for k4 in TP_K4 + (GRANITE_TP4_K4,):
            rows["paged_planar_decode_attention"] += attention_phase(
                torch, tp_iters, **k4)
        rows.update(tp_quant_phase(torch, tp_iters))
        log("== K1, K2 and K3 at one shard of 4 of granite-moe-3b, "
            "mamba2-2.7b, zamba2-2.7b and deepseek-v3's MLA")
        for label, (kn, _) in TP_FAMILY_GEMMS.items():
            tp_gemm_phase(torch, rows, label, kn, tp_iters)
        results["kernel_rows"] = rows
        results["kernels_s"] = time.time() - t_kernels
        log(f"  phase took {results['kernels_s']:.1f} s")
    ds = get_arch("deepseek-coder-33b")
    if "ds_slice" in phases:
        log("== ds slice: deepseek-coder-33b at full width, 2 layers (FP8 "
            "readings at 1 and 4), card vs CPU plain versions")
        results["ds_slice"] = timed_phase(
            lambda: family_slice_phase(torch, ds, "ds slice", (1, 4)))
    if "ds_serve" in phases:
        log(f"== ds serve: deepseek-coder-33b, {ds.n_layers} layers")
        results["ds_serve"] = timed_phase(lambda: serve_phase(
            torch, ds, ds.n_layers, args.host_tier == "on", label="ds serve",
            memory=True))
    if "ds_dense" in phases:
        c = cut_depth(ds, "ds_dense")
        log(f"== ds dense: deepseek-coder-33b, {c.n_layers} layers, "
            f"dense-slot prefill and decode steps")
        mem = memory_reckoning(torch, c, "ds dense")
        results["ds_dense"] = timed_phase(lambda: dense_phase(
            torch, c, "ds dense", long_ctx=False))
        results["ds_dense"]["memory"] = mem
    ds3 = get_arch("deepseek-v3-671b")
    if "ds3_mla" in phases:
        log("== ds3 mla: one deepseek-v3 MLA module at full width, card vs "
            "CPU plain versions")
        results["ds3_mla"] = timed_phase(lambda: ds3_mla_phase(torch, ds3))
    if "ds3_serve" in phases:
        log("== ds3 serve: deepseek-v3 at full width, 1 layer, paged engine, "
            "f16 latent planes")
        results["ds3_serve"] = timed_phase(
            lambda: ds3_serve_phase(torch, ds3, args.host_tier == "on"))
    cfg = get_arch("llama3.1-8b")
    if "slice" in phases:
        log("== slice: 2-layer llama3.1-8b, card vs CPU plain versions")
        results["slice"] = timed_phase(lambda: slice_phase(torch, cfg))
    if "serve" in phases:
        log(f"== serve: llama3.1-8b, {args.serve_layers} layers")
        results["serve"] = timed_phase(lambda: serve_phase(
            torch, cfg, args.serve_layers, args.host_tier == "on"))
    if "dense" in phases:
        log(f"== dense: llama3.1-8b, {cfg.n_layers} layers, dense-slot "
            f"prefill and decode steps")
        results["dense"] = timed_phase(lambda: dense_phase(torch, cfg,
                                                           reckon=True))
    granite = get_arch("granite-moe-3b-a800m")
    if "granite_slice" in phases:
        log("== granite slice: granite-moe-3b at full width, 2 layers (1 and "
            "4 as readings), card vs CPU plain versions, routing rule")
        results["granite_slice"] = timed_phase(
            lambda: granite_slice_phase(torch, granite))
    if "granite_serve" in phases:
        n = DEPTH["granite_serve"]
        log(f"== granite serve: granite-moe-3b, {n} layers, 8 x (1024 + 64)")
        results["granite_serve"] = timed_phase(lambda: serve_phase(
            torch, granite, n, args.host_tier == "on",
            label="granite serve", capacity=1088, prompt_len=1024,
            max_new=64))
    if "granite_dense" in phases:
        n = DEPTH["granite_dense"]
        log(f"== granite dense: granite-moe-3b, {n} layers, dense-slot "
            f"prefill and decode steps")
        results["granite_dense"] = timed_phase(lambda: dense_phase(
            torch, dataclasses.replace(granite, n_layers=n), "granite dense",
            long_ctx=False))
    gemma = get_arch("gemma3-1b")
    if "gemma_slice" in phases:
        log("== gemma slice: 6-layer gemma3-1b, window groups, card vs CPU "
            "plain versions")
        results["gemma_slice"] = timed_phase(
            lambda: gemma_slice_phase(torch, gemma))
    if "gemma_serve" in phases:
        log(f"== gemma serve: gemma3-1b, {gemma.n_layers} layers, window "
            f"groups")
        results["gemma_serve"] = timed_phase(lambda: gemma_serve_phase(
            torch, gemma, args.host_tier == "on"))
    if "gemma_dense" in phases:
        c = cut_depth(gemma, "gemma_dense")
        log(f"== gemma dense: gemma3-1b, {c.n_layers} layers, dense-slot "
            f"prefill and decode steps")
        results["gemma_dense"] = timed_phase(lambda: dense_phase(
            torch, c, "gemma dense", plant_layer=5))
    if {"spec", "tiered", "fleet"} & phases:
        t0 = time.time()
        sp = make_serving_params(torch, cfg, 0, "cuda", plant_layer=0)
        log(f"== llama3.1-8b params for spec, tiered and fleet on the card "
            f"in {time.time() - t0:.1f} s")
        for name, fn in (("spec", spec_phase), ("tiered", tiered_phase),
                         ("fleet", fleet_phase)):
            if name in phases:
                n = DEPTH.get(name, cfg.n_layers)
                log(f"== {name}: llama3.1-8b, {n} layers")
                t0 = time.time()
                results[name] = fn(torch, cfg, sp) if name not in DEPTH \
                    else fn(torch, dataclasses.replace(cfg, n_layers=n),
                            {**sp, "layers": sp["layers"][:n]})
                results[name]["seconds"] = time.time() - t0
                log(f"  {name} phase: {results[name]['seconds']:.1f} s")
        del sp
        torch.cuda.empty_cache()
    if "gemma_spec" in phases:
        log(f"== gemma spec: gemma3-1b, {gemma.n_layers} layers, window "
            f"groups")
        t0 = time.time()
        results["gemma_spec"] = gemma_spec_phase(torch, gemma)
        results["gemma_spec"]["seconds"] = time.time() - t0
        log(f"  gemma_spec phase: {results['gemma_spec']['seconds']:.1f} s")
    qwen3 = get_arch("qwen3-8b")
    if "qwen3_slice" in phases:
        log("== qwen3 slice: qwen3-8b at full width, 2 layers (FP8 "
            "readings at 1 and 4), card vs CPU plain versions")
        results["qwen3_slice"] = timed_phase(
            lambda: family_slice_phase(torch, qwen3, "qwen3 slice", (1, 4)))
    if "qwen3_serve" in phases:
        n = DEPTH["qwen3_serve"]
        log(f"== qwen3 serve: qwen3-8b, {n} layers")
        results["qwen3_serve"] = timed_phase(lambda: serve_phase(
            torch, qwen3, n, args.host_tier == "on", label="qwen3 serve"))
    if "qwen3_dense" in phases:
        c = cut_depth(qwen3, "qwen3_dense")
        log(f"== qwen3 dense: qwen3-8b, {c.n_layers} layers, dense-slot "
            f"prefill and decode steps")
        results["qwen3_dense"] = timed_phase(lambda: dense_phase(
            torch, c, "qwen3 dense"))
    mamba2 = get_arch("mamba2-2.7b")
    if "mamba2_slice" in phases:
        log("== mamba2 slice: mamba2-2.7b at full width, 2 layers, card vs "
            "CPU plain versions; the SSD alone")
        results["mamba2_slice"] = timed_phase(lambda: recurrent_slice_phase(
            torch, mamba2, "mamba2 slice", 2))
    if "mamba2_serve" in phases:
        c = cut_depth(mamba2, "mamba2_serve")
        log(f"== mamba2 serve: mamba2-2.7b, {c.n_layers} layers, 8 x "
            f"(1024 + 64), slot-resident state")
        results["mamba2_serve"] = timed_phase(lambda: recurrent_serve_phase(
            torch, c, "mamba2 serve"))
    if "mamba2_dense" in phases:
        c = cut_depth(mamba2, "mamba2_dense")
        log(f"== mamba2 dense: mamba2-2.7b, {c.n_layers} layers, "
            f"dense-slot prefill and decode steps")
        results["mamba2_dense"] = timed_phase(lambda: recurrent_dense_phase(
            torch, c, "mamba2 dense"))
    zamba2 = get_arch("zamba2-2.7b")
    if "zamba2_slice" in phases:
        log("== zamba2 slice: zamba2-2.7b at full width, 6 layers (one "
            "shared-attention application), card vs CPU plain versions")
        results["zamba2_slice"] = timed_phase(lambda: recurrent_slice_phase(
            torch, zamba2, "zamba2 slice", 6))
    if "zamba2_serve" in phases:
        c = cut_depth(zamba2, "zamba2_serve")
        log(f"== zamba2 serve: zamba2-2.7b, {c.n_layers} layers, 8 x "
            f"(1024 + 64), f16 shared-attention pools")
        results["zamba2_serve"] = timed_phase(lambda: recurrent_serve_phase(
            torch, c, "zamba2 serve"))
    if "zamba2_dense" in phases:
        c = cut_depth(zamba2, "zamba2_dense")
        log(f"== zamba2 dense: zamba2-2.7b, {c.n_layers} layers, "
            f"dense-slot prefill and decode steps (K6 and K5 at D = 80)")
        results["zamba2_dense"] = timed_phase(lambda: dense_phase(
            torch, c, "zamba2 dense"))
    phi3 = get_arch("phi-3-vision-4.2b")
    if "phi3_slice" in phases:
        log("== phi3 slice: phi-3-vision-4.2b at full width, 2 layers (FP8 "
            "at 4 gated at DEEP_FP8_TOL), card vs CPU plain versions")
        results["phi3_slice"] = timed_phase(
            lambda: family_slice_phase(torch, phi3, "phi3 slice", (4,)))
    if "phi3_serve" in phases:
        n = DEPTH["phi3_serve"]
        log(f"== phi3 serve: phi-3-vision-4.2b, {n} layers, "
            f"text only, 8 x (1024 + 64)")
        results["phi3_serve"] = timed_phase(lambda: serve_phase(
            torch, phi3, n, args.host_tier == "on",
            label="phi3 serve", capacity=1088, prompt_len=1024, max_new=64))
    if "phi3_dense" in phases:
        c = cut_depth(phi3, "phi3_dense")
        log(f"== phi3 dense: phi-3-vision-4.2b, {c.n_layers} layers, "
            f"dense-slot prefill of 8 x (576 patches + 1024 tokens) and "
            f"decode steps (K6 and K5 at D = 96)")
        results["phi3_dense"] = timed_phase(lambda: dense_phase(
            torch, c, "phi3 dense", long_ctx=False))
    seamless = get_arch("seamless-m4t-large-v2")
    if "seamless_slice" in phases:
        log("== seamless slice: seamless-m4t-v2 at full width, 2 encoder + 2 "
            "decoder layers, card vs CPU plain versions")
        results["seamless_slice"] = timed_phase(
            lambda: seamless_slice_phase(torch, seamless))
    if "seamless_dense" in phases:
        log(f"== seamless dense: seamless-m4t-v2, {seamless.n_enc_layers} + "
            f"{seamless.n_layers} layers, 8 x 1024 tokens over 128 frames a "
            f"row, 64 replayed decode steps")
        results["seamless_dense"] = timed_phase(lambda: dense_phase(
            torch, seamless, "seamless dense", n_dec=64, long_ctx=False))
    for name, fn, model in (
            ("tp_serve", tp_serve_phase, cfg),
            ("tp_gemma", tp_gemma_phase, gemma),
            ("tp_fleet", tp_fleet_phase, cfg),
            # granite's 48 padded experts split on 2 and 4 shards
            # (expert-parallel); mamba2 and zamba2 on 4 shards, 2 for the
            # logits alone
            ("tp_moe", functools.partial(tp_family_phase, label="tp moe"),
             granite),
            ("tp_ssm", functools.partial(tp_family_phase, label="tp ssm",
                                         engine_shards=(4,)), mamba2),
            ("tp_hybrid", functools.partial(tp_family_phase,
                                            label="tp hybrid",
                                            engine_shards=(4,)), zamba2)):
        if name in phases:
            c = cut_depth(model, name)
            log(f"== {name}: {c.arch_id}, {c.n_layers} layers, serving "
                f"meshes ({TP_LABEL})")
            results[name] = timed_phase(lambda: fn(torch, c))
    qwen = get_arch("qwen1.5-0.5b")
    if "train_slice" in phases:
        log("== train slice: qwen1.5-0.5b at full width, 2 layers, train_loss"
            " + backward and apply_updates, card vs CPU plain versions")
        results["train_slice"] = timed_phase(
            lambda: train_slice_phase(torch, qwen))
    if "train" in phases:
        c = cut_depth(cfg, "train")
        log(f"== train: llama3.1-8b at full width, {c.n_layers} layers, 10 "
            f"make_train_step steps of 4 x 2048 tokens (2 microbatches)")
        results["train"] = timed_phase(lambda: train_phase(torch, c))
    if "train_serve" in phases:
        log(f"== train serve: qwen1.5-0.5b, {qwen.n_layers} layers, trained "
            f"by launch/train.py, checkpointed, restored nested and served")
        results["train_serve"] = timed_phase(
            lambda: train_serve_phase(torch, qwen))
    results["total_s"] = time.time() - t_start
    seconds = {"build": results["build_s"], "kernels": results.get("kernels_s"),
               **{k: round(v["seconds"], 1) for k, v in results.items()
                  if isinstance(v, dict) and "seconds" in v}}
    log(f"== seconds a phase: {json.dumps(seconds)}")
    log(f"== done in {results['total_s']:.1f} s (the previous full runs took "
        f"906.8-975.3 s)")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))

    if rows:
        # launches over the main paths' runs: the paged serve, the
        # dense-slot steps, the sliding-window serve, gemma3-1b's
        # dense-slot steps, speculation (llama3.1-8b, gemma3-1b), the
        # tiered KV cache, the fleet, deepseek-coder-33b's and qwen3-8b's
        # serve and dense-slot steps, the MoE family's, mamba2-2.7b's and
        # zamba2-2.7b's, phi-3-vision's and seamless-m4t-v2's, each
        # counted from 0 at its start; an instance's launches are those of
        # the phases whose model has that head dim alone
        paths = [results.get(p, {}).get("launches_total", {})
                 for p in ("serve", "dense", "gemma_serve", "gemma_dense",
                           "spec", "gemma_spec", "tiered", "fleet",
                           "ds_serve", "ds_dense", "qwen3_serve",
                           "qwen3_dense", "ds3_serve", "granite_serve",
                           "granite_dense", "mamba2_serve", "mamba2_dense",
                           "zamba2_serve", "zamba2_dense", "phi3_serve",
                           "phi3_dense", "seamless_dense",
                           *TP_PHASES, *TP_FAMILY_PHASES, "ds3_mla",
                           "train_serve")]
        kernels = []
        for name, (src, replaces) in SOURCES.items():
            kernels.append({"name": name, "route": "cuda", "source": src,
                            "replaces": replaces,
                            "launches": sum(p.get(name, 0) for p in paths),
                            **summarize(rows[name], LINE_WEIGHTS[name])})
        for name, (src, replaces) in TP_SOURCES.items():
            kernels.append({"name": name, "route": "cuda", "source": src,
                            "replaces": replaces,
                            "launches": sum(p.get(name, 0) for p in paths),
                            **summarize(rows[name], LINE_WEIGHTS[name])})
        for name in TP_INSTANCES:
            src, replaces = SOURCES[name]
            kernels.append({
                "name": f"{name}@tp4", "route": "cuda", "source": src,
                "replaces": replaces,
                "launches": sum(results.get(o, {}).get("launches_total", {})
                                .get(name, 0) for o in TP_PHASES),
                **summarize(rows[name], LINE_WEIGHTS[name, "tp4"])})
        for label, (kn, owners) in TP_FAMILY_GEMMS.items():
            for name in TP_INSTANCES[:3]:
                n = sum(results.get(o, {}).get("launches_total", {})
                        .get(name, 0) for o in owners)
                if not n:
                    continue                 # ds3's module has no exception
                kernels.append({
                    "name": f"{name}@{label.replace(' ', '-')}",
                    "route": "cuda", "source": SOURCES[name][0],
                    "replaces": SOURCES[name][1], "launches": n,
                    **summarize(rows[name], lambda r, kn=kn, label=label:
                                kn.count((r["k"], r["n"]))
                                if r.get("model") == label else 0)})
        name = "paged_planar_decode_attention"
        kernels.append({
            "name": f"{name}@granite-tp4", "route": "cuda",
            "source": SOURCES[name][0], "replaces": SOURCES[name][1],
            "launches": results.get("tp_moe", {}).get(
                "launches_total", {}).get(name, 0),
            **summarize(rows[name], lambda r: int(
                (r["h"], r["hkv"], r["d"]) == (6, 2, 64) and not r["fp8"]
                and r["window"] is None))})
        for (name, d), owners in INSTANCES.items():
            src, replaces = SOURCES[name]
            kernels.append({
                "name": f"{name}@D{d}", "route": "cuda", "source": src,
                "replaces": replaces,
                "launches": sum(results.get(o, {}).get("launches_total", {})
                                .get(name, 0) for o in owners),
                **summarize([r for r in rows[name] if r["d"] == d],
                            LINE_WEIGHTS[name, d])})
        print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
