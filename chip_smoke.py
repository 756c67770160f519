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
              capacity 1056, 32 greedy decode steps, fp16 and fp8; every
              kernel of the path must launch; then the decode step at
              long context: planar caches of capacity 32768 filled with
              random planes, ragged lens up to 32767, fp16 and fp8
The second-to-last line is the kernels JSON, the last line
{"ok": true, "device": {...}}. Exits non-zero without a result when no
GPU is present or the port is missing.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

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


def attention_phase(torch, iters: int) -> list[dict]:
    import torch.nn.functional as F

    from repro_torch.core import nestedfp as nf
    from repro_torch.kernels import ref
    from repro_torch.kernels.planar_decode_attention import (
        paged_planar_decode_attention)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    b, h, hkv, d, bs, mb = 8, 32, 8, 128, 16, 16
    nb = 1 + b * mb
    lens = torch.tensor([160, 129, 17, 1, 256, 0, 100, 33], dtype=torch.int32,
                        device=dev)
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
        for window in (None, 0, 40):
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
            row = {"fp8": fp8, "window": window, "max_abs_err": err,
                   "ms": time_ms(torch, kern, n_sets, iters),
                   "plain_ms": time_ms(torch, plain, n_sets, iters),
                   "library_ms": time_ms(torch, lib, n_sets, iters),
                   "bound_ms": b_ms, "bound_by": b_kind,
                   **device_times(torch, kern, lib, n_sets, b_ms)}
            rows.append(row)
            log(f"  paged_planar_decode_attention fp8={fp8} window={window} "
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


def dense_decode_phase(torch, iters: int) -> list[dict]:
    """K5 over dense per-slot planes: llama3.1-8b's heads, 8 rows, ragged
    lens up to 1056 (the dense phase's capacity) and up to 32768 (the
    decode_32k length, also with a window of 4096), fp16 and fp8; host
    and device (graph replay) ms of K5 and of SDPA over joined planes."""
    import torch.nn.functional as F

    from repro_torch.core import nestedfp as nf
    from repro_torch.kernels import ref
    from repro_torch.kernels.planar_decode_attention import (
        planar_decode_attention)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    b, h, hkv, d = 8, 32, 8, 128
    q = torch.randn((b, h, d), generator=gen, device=dev)
    rows = []
    for cap, lens_l in ((1056, [1056, 1040, 17, 1, 700, 1056, 333, 1024]),
                        (32768, [32768, 30001, 1, 20000, 32768, 5, 16384,
                                 32000])):
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
        for fp8, window in [(f, w) for w in ((None, 4096) if cap == 32768
                                             else (None,))
                            for f in (False, True)]:
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
            row = {"cap": cap, "fp8": fp8, "window": window,
                   "max_abs_err": err,
                   "ms": time_ms(torch, kern, n_sets, iters),
                   "plain_ms": time_ms(torch, plain, n_sets, iters),
                   "library_ms": time_ms(torch, lib, n_sets, iters),
                   "bound_ms": b_ms, "bound_by": b_kind,
                   **device_times(torch, kern, lib, n_sets, b_ms)}
            rows.append(row)
            log(f"  planar_decode_attention cap={cap} fp8={fp8} "
                f"window={window} kept keys={keys} err={err:.2e} "
                f"ms={row['ms']:.4f} plain={row['plain_ms']:.4f} "
                f"lib={row['library_ms']:.4f} bound={b_ms:.5f} ({b_kind}) "
                f"device={row['device_ms']:.4f} lib_device="
                f"{row['library_device_ms']:.4f} share={row['bound_share']:.3f}")
            del kv
        del pools
    return rows


def prefill_attention_phase(torch, iters: int) -> list[dict]:
    """K6 at llama3.1-8b's heads on bf16 q/k/v (the serving runtime's):
    (B, S) = (8, 1024) as the dense phase prefills, (1, 8192), and a
    ragged S = 1000; and on f16 at (8, 1024)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_prefill_attention import (
        flash_prefill_attention)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    h, hkv, d = 32, 8, 128
    rows = []
    for dtype, b, s in ((torch.bfloat16, 8, 1024), (torch.bfloat16, 1, 8192),
                        (torch.bfloat16, 8, 1000), (torch.float16, 8, 1024)):
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
        nbytes = 2 * (b * s * h * d + 2 * b * s * hkv * d) + b * s * h * d * 4
        b_ms, b_kind = bound(nbytes, 4.0 * b * h * s * s * d / 2, "f16")
        row = {"dtype": str(dtype).removeprefix("torch."), "b": b, "s": s,
               "max_abs_err": err,
               "ms": time_ms(torch, kern, n_sets, iters),
               "plain_ms": time_ms(torch, plain, n_sets, iters),
               "library_ms": time_ms(torch, lib, n_sets, iters),
               "bound_ms": b_ms, "bound_by": b_kind}
        rows.append(row)
        log(f"  flash_prefill_attention {row['dtype']} B={b} S={s} "
            f"err={err:.2e} "
            f"ms={row['ms']:.4f} plain={row['plain_ms']:.4f} "
            f"lib={row['library_ms']:.4f} bound={b_ms:.4f} ({b_kind})")
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
    return [row]


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

def make_serving_params(torch, cfg, seed, device, plant_layer):
    """Random llama params from a seeded generator on `device`, nested
    layer by layer (keeps the f32 originals of one layer at a time), with
    one exception tensor planted: wo[0, 0] = 2.0 in layer `plant_layer`."""
    from repro_torch.models import model as M
    from repro_torch.models.convert import to_serving
    params = M.init_params(cfg, seed=seed, device=device)
    params["layers"][plant_layer]["attn"]["wo"]["w"][0, 0] = 2.0
    for i, layer in enumerate(params["layers"]):
        params["layers"][i] = to_serving(layer, path="layers")
    sp = to_serving(params)
    check(sp["layers"][plant_layer]["attn"]["wo"].weight.is_exception,
          "planted exception tensor was nested")
    return sp


def slice_phase(torch, cfg) -> dict:
    import dataclasses

    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models.convert import params_to
    from repro_torch.models.layers import Runtime

    cfg2 = dataclasses.replace(cfg, n_layers=2)
    t0 = time.time()
    sp_cpu = make_serving_params(torch, cfg2, 0, "cpu", plant_layer=1)
    sp_gpu = params_to(sp_cpu, "cuda")
    log(f"  2-layer full-width params made on the CPU in "
        f"{time.time() - t0:.1f} s")
    bs, mb = 16, 4
    tables = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32)
    rng = torch.Generator().manual_seed(3)
    plens = [32, 20]
    prompt = torch.randint(1, cfg.vocab_size, (2, 32), generator=rng,
                           dtype=torch.int32)
    prompt[1, plens[1]:] = 0
    out = {}
    for mode in ("fp16", "fp8"):
        rt = Runtime(mode=mode, dtype=torch.float32, act_quant="per_token")
        caches = {dev: M.init_paged_cache(cfg2, 9, bs, planar=True, device=dev)
                  for dev in ("cpu", "cuda")}
        params = {"cpu": sp_cpu, "cuda": sp_gpu}

        def step(dev, toks, qo, kvl, lp=None):
            return M.paged_step(
                rt, params[dev], cfg2, toks.to(dev), caches[dev],
                tables.to(dev), q_offset=qo.to(dev), kv_len=kvl.to(dev),
                block_size=bs, return_logits=True,
                logit_position=None if lp is None else lp.to(dev))

        lens = torch.tensor(plens, dtype=torch.int32)
        args = (prompt, torch.zeros(2, dtype=torch.int32), lens,
                lens - 1)
        cmp = LogitCheck(torch, mode, SLICE_TOL[mode])
        for s in range(5):
            before = ops.all_launch_counters()
            want = step("cpu", *args)
            got = step("cuda", *args)
            after = ops.all_launch_counters()
            cmp.add(got, want, f"paged step {s}")
            if s > 0:   # decode steps go through K4
                check(after["paged_planar_decode_attention"]
                      > before["paged_planar_decode_attention"],
                      "decode step did not launch K4")
            nxt = want.argmax(-1).to(torch.int32)[:, None]  # teacher forcing
            args = (nxt, lens.clone(), lens + 1)
            lens = lens + 1
        out[mode] = cmp.done("slice")
    out["dense"] = dense_slice(torch, cfg2, {"cpu": sp_cpu, "cuda": sp_gpu})
    return out


class LogitCheck:
    """Card logits against the CPU plain versions', step after step: the
    error within `tol`, and the same greedy token wherever the CPU's
    top-2 margin is above twice the error."""

    def __init__(self, torch, mode, tol):
        self.torch, self.mode, self.tol = torch, mode, tol
        self.errs, self.agree, self.n = [], 0, 0

    def add(self, got, want, what):
        self.torch.cuda.synchronize()
        got = got.float().cpu()
        check(bool(self.torch.isfinite(got).all()), f"{what}: non-finite logits")
        self.errs.append(float((got - want).abs().max()))
        top2 = want.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        same = got.argmax(-1) == want.argmax(-1)
        check(bool((same | (margin <= 2 * self.errs[-1])).all()),
              f"{self.mode} {what}: greedy token differs with a clear margin")
        self.agree += int(same.sum())
        self.n += same.numel()

    def done(self, label) -> dict:
        tol = self.tol
        log(f"  {label} {self.mode}: max |logit err| per step "
            f"{[f'{e:.2e}' for e in self.errs]} (tol {tol}); greedy agree "
            f"{self.agree}/{self.n}")
        check(max(self.errs) <= tol, f"{label} {self.mode} logits beyond "
              f"tolerance {tol}")
        return {"max_logit_err": max(self.errs), "tol": tol,
                "greedy_agree": self.agree, "greedy_total": self.n}


def dense_slice(torch, cfg2, params) -> dict:
    """The dense-slot path on the 2-layer model, card against CPU: prefill
    of 2 x 48 tokens (K6; K1 or K7), planarize, 4 decode steps (K5), with
    the per-tensor FP8 scale: in f32 activations at SLICE_TOL, then under
    `steps.serve_rt` (bf16 activations, bf16-rounded GEMM outputs) at
    BF16_TOL."""
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.models.layers import Runtime

    prompt = torch.randint(1, cfg2.vocab_size, (2, 48),
                           generator=torch.Generator().manual_seed(5),
                           dtype=torch.int32)
    need = {"fp16": ("flash_prefill_attention", "nestedfp16_matmul"),
            "fp8": ("flash_prefill_attention", "nestedfp8_matmul_fused_quant")}
    out = {}
    for mode, act in [(m, a) for a in ("f32", "bf16") for m in ("fp16", "fp8")]:
        if act == "f32":
            rt, tol = Runtime(mode=mode, dtype=torch.float32), SLICE_TOL[mode]
        else:
            rt, tol = steps.serve_rt(mode), BF16_TOL[mode]
        cmp = LogitCheck(torch, mode, tol)
        before = ops.all_launch_counters()
        res = {d: M.prefill(rt, params[d], cfg2, {"tokens": prompt.to(d)},
                            capacity=56) for d in ("cpu", "cuda")}
        after = ops.all_launch_counters()
        for name in need[mode]:
            check(after[name] > before[name], f"dense prefill: no {name}")
        cmp.add(res["cuda"][0], res["cpu"][0], "dense prefill")
        want = res["cpu"][0]
        caches = {d: M.planarize_cache(res[d][1]) for d in res}
        for i in range(4):
            nxt = want.argmax(-1).to(torch.int32)[:, None]  # teacher forcing
            before = ops.all_launch_counters()
            want, _ = M.decode_step(rt, params["cpu"], cfg2, nxt,
                                    caches["cpu"], 48 + i)
            got, _ = M.decode_step(rt, params["cuda"], cfg2, nxt.cuda(),
                                   caches["cuda"], 48 + i)
            after = ops.all_launch_counters()
            check(after["planar_decode_attention"]
                  > before["planar_decode_attention"],
                  "dense decode step did not launch K5")
            cmp.add(got, want, f"dense decode {i}")
        out[f"{mode}_{act}"] = cmp.done(f"dense slice {act}")
    return out


# logits of a 2-layer full-width llama, card vs CPU plain versions. The
# f32 sums run in other orders on the two devices, and each nested GEMM
# re-rounds its input activations to f16 (fp16 mode) or e4m3 (fp8 mode),
# so values next to a rounding boundary land on neighbouring codes:
# frequent one-ulp f16 steps move logits by a few 1e-3; a rare e4m3 step
# (1/16 of one value) moves a row by up to ~0.1. Greedy tokens must agree
# wherever the CPU top-2 margin is above twice the error.
SLICE_TOL = {"fp16": 1e-2, "fp8": 0.25}
# the same under bf16 activations with bf16-rounded GEMM outputs: a sum
# that differs in its last f32 bit can round to the neighbouring bf16
# value (2^-8 relative), so the tolerance is tests/test_torch_dense.py's
# for the JAX package's serve_rt against the port's
BF16_TOL = {"fp16": 0.1, "fp8": 0.5}


def serve_phase(torch, cfg, n_layers: int) -> dict:
    """The paged engine at full width and depth, forced FP16, forced FP8
    and dual. Each engine first serves 8 other prompts of the same
    shapes (the warm pass: it captures every step key and holds each
    key's replay bitwise against an eager call; in dual mode a pass for
    each mode), then the 8 timed prompts; then the engine is freed with
    its graphs."""
    import dataclasses

    from repro_torch.core.policy import DualPrecisionController, SLOConfig
    from repro_torch.kernels import ops
    from repro_torch.models.convert import serving_memory_bytes
    from repro_torch.serving.engine import Engine, Request

    cfgn = dataclasses.replace(cfg, n_layers=n_layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    sp = make_serving_params(torch, cfgn, 0, "cuda", plant_layer=0)
    torch.cuda.synchronize()
    mem = serving_memory_bytes(sp)
    log(f"  {n_layers}-layer params on the card in {time.time() - t0:.1f} s: "
        f"{mem['nested_bytes'] / 1e9:.2f} GB nested, "
        f"{mem['other_bytes'] / 1e9:.2f} GB other")
    rng = torch.Generator().manual_seed(7)
    prompts = [torch.randint(1, cfg.vocab_size, (128,), generator=rng).tolist()
               for _ in range(24)]
    warm, prompts = [prompts[8:16], prompts[16:]], prompts[:8]
    results = {}
    ops.reset_launch_counters()          # the main path's run starts here
    for policy in ("fp16", "fp8", "dual"):
        ctrl = None
        if policy == "dual":
            ctrl = DualPrecisionController(SLOConfig(), fp16_ms_per_token=0.5,
                                           fp8_ms_per_token=0.25)
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        eng = Engine(cfgn, sp, n_slots=8, capacity=256, kv_planar=True,
                     controller=ctrl,
                     forced_mode=None if policy == "dual" else policy,
                     device="cuda")
        # warm pass: 8 other prompts of the same shapes (in dual mode one
        # set forced to each mode), so that the timed run finds every key
        # captured; each key's first replay is held against an eager call
        t0 = time.monotonic()
        n_checked = 0
        for w, mode in enumerate(["fp16", "fp8"] if ctrl else [policy]):
            eng.forced_mode = mode
            for i, p in enumerate(warm[w]):
                eng.submit(Request(f"w{w}.{i}", list(p), max_new=32))
            n_checked += serve_checked(eng, policy)
        eng.forced_mode = None if ctrl else policy
        torch.cuda.synchronize()
        warm_s = time.monotonic() - t0
        check(n_checked == len(eng.graphs.keys()) == eng.graphs.n_captured,
              f"{policy}: {n_checked} keys checked of "
              f"{len(eng.graphs.keys())}")
        n_graphs = eng.graphs.n_captured
        stats0, n_warm = dict(eng.stats), len(eng.finished)
        for i, p in enumerate(prompts):
            eng.submit(Request(f"r{i}", list(p), max_new=32))
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
        check(all(len(r.output) == 32 and all(0 <= t < cfg.vocab_size
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
               "graphs": n_graphs, "keys": sorted(map(str, eng.graphs.keys())),
               "graph_pool_bytes": eng.graphs.pool_bytes(),
               "launches": launches,
               "stats": {k: v - stats0[k] if isinstance(v, int) else v
                         for k, v in eng.stats.items()}}
        log(f"  serve {policy}: {n_tok} tokens in {wall:.3f} s "
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
            f"{warm_s:.2f} s; launches {launches}")
        res["replays_bitwise"] = n_checked
        pool = tuple(eng.graphs._pool)
        del eng
        torch.cuda.synchronize()
        left = torch.cuda.memory_allocated() - mem0
        torch.cuda.empty_cache()
        check(not [s for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == pool],
              f"{policy}: the graphs' pool outlived its engine")
        log(f"  serve {policy}: engine freed, {left / 2**20:.1f} MiB left "
            f"allocated against before it (the capture stream's cuBLAS "
            f"workspace stays after the first engine)")
        check(left <= 128 * 2**20, f"{policy}: {left} bytes outlived the engine")
        res["bytes_left_after_engine"] = left
        results[policy] = res
    need = {"fp16": ("nestedfp16_matmul", "f16_matmul",
                     "paged_planar_decode_attention"),
            "fp8": ("nestedfp8_matmul", "quant_per_token", "f16_matmul",
                    "paged_planar_decode_attention")}
    for policy, names in need.items():
        for name in names:
            check(results[policy]["launches"][name] > 0,
                  f"serve {policy}: {name} never launched")
    results["launches_total"] = ops.all_launch_counters()
    for mode in ("fp16", "fp8"):
        results[f"profile_{mode}"] = profile_decode(
            torch, Engine, Request, cfgn, sp, prompts, mode,
            results[mode]["decode_step_ms_median"])
    results["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"  peak device memory {results['peak_mem_gb']:.1f} GB")
    return results


def serve_checked(eng, policy: str) -> int:
    """Run the engine to the end of its queue; right after the step that
    captures a key (while the block table still holds that step's rows),
    hold one replay of it bitwise against an eager call of the same step
    on clones of its inputs and the pool (launches not counted). Returns
    the number of keys checked."""
    g, checked = eng.graphs, set(eng.graphs.keys())
    n = 0
    while eng.queue or eng.active or eng.prefilling:
        eng.step()
        for key in sorted(g.keys() - checked):
            same = g.check_replay(key)
            check(all(same.values()),
                  f"{policy} {key}: replay differs from the eager call {same}")
            log(f"  serve {policy}: {key} captured; its replay is bitwise "
                f"the eager call (ids of live rows, pool planes)")
            checked.add(key)
            n += 1
    return n


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
                   step_ms: float, n_steps: int = 4) -> dict:
    """Device time by kernel over `n_steps` decode-only steps (the torch
    profiler lists the kernels inside each graph replay), after the
    run's prefill is done; run after the main path's launch counts were
    read, and outside the timed runs. The idle share is taken against
    `step_ms`, the unprofiled decode-only step time."""
    eng = Engine(cfg, sp, n_slots=8, capacity=256, kv_planar=True,
                 forced_mode=mode, device="cuda")
    for i, p in enumerate(prompts):
        eng.submit(Request(f"p{i}", list(p), max_new=32))
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
    log(f"  profile {mode}: K2 {res['k2_device_ms_per_step']:.3f} ms, "
        f"per-token quantizer {res['quant_device_ms_per_step']:.3f} ms of "
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


def dense_phase(torch, cfg) -> dict:
    """The dense-slot serving steps at full width and depth: weights
    nested on the card (K8), 8 x 1024-token prefill (K6, K1 / K7, K3),
    planarize at capacity 1056, 32 greedy decode steps (K5) — fp16, then
    fp8. Launch counts are read over this whole run."""
    from repro_torch.core.linear import NestedLinearParams
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.models.convert import serving_memory_bytes

    b, s, cap, n_dec = 8, 1024, 1056, 32
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counters()          # the dense path's run starts here
    t0 = time.time()
    sp = make_serving_params(torch, cfg, 0, "cuda", plant_layer=0)
    torch.cuda.synchronize()
    mem = serving_memory_bytes(sp)
    nested = sum(not p.weight.is_exception for layer in sp["layers"]
                 for p in _linears(layer, NestedLinearParams))
    log(f"  {cfg.n_layers}-layer params nested on the card in "
        f"{time.time() - t0:.1f} s: {mem['nested_bytes'] / 1e9:.2f} GB "
        f"nested, {mem['other_bytes'] / 1e9:.2f} GB other; {nested} "
        f"applicable tensors")
    check(ops.all_launch_counters()["nestedfp_encode"] == nested,
          "to_serving did not encode each applicable tensor through K8")
    prompts = torch.randint(1, cfg.vocab_size, (b, s),
                            generator=torch.Generator().manual_seed(11),
                            dtype=torch.int32).cuda()
    res = {"layers": cfg.n_layers, "batch": b, "prompt_len": s, "capacity": cap,
           "decode_steps": n_dec}
    need = {"fp16": ("flash_prefill_attention", "planar_decode_attention",
                     "nestedfp16_matmul", "f16_matmul"),
            "fp8": ("flash_prefill_attention", "planar_decode_attention",
                    "nestedfp8_matmul_fused_quant", "f16_matmul")}
    for mode in ("fp16", "fp8"):
        before = ops.all_launch_counters()
        prefill = steps.make_prefill_step(cfg, mode, capacity=cap)
        decode = steps.make_decode_step(cfg, mode)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        logits, caches = prefill(sp, {"tokens": prompts})
        torch.cuda.synchronize()
        prefill_ms = (time.monotonic() - t0) * 1e3
        check(tuple(logits.shape) == (b, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()),
              f"dense {mode}: prefill logits not finite or mis-shaped")
        t0 = time.monotonic()
        caches = M.planarize_cache(caches)
        torch.cuda.synchronize()
        planarize_ms = (time.monotonic() - t0) * 1e3
        nxt = logits.argmax(-1).to(torch.int32)[:, None]
        step_ms, out = [], []
        for i in range(n_dec):
            t0 = time.monotonic()
            logits, caches = decode(sp, caches, nxt, s + i)
            nxt = logits.argmax(-1).to(torch.int32)[:, None]
            torch.cuda.synchronize()
            step_ms.append((time.monotonic() - t0) * 1e3)
            out.append(nxt)
        check(bool(torch.isfinite(logits).all()),
              f"dense {mode}: decode logits not finite")
        toks = torch.cat(out, 1)
        check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
              f"dense {mode}: tokens out of vocab")
        launches = {k: v - before[k] for k, v in ops.all_launch_counters().items()}
        for name in need[mode]:
            check(launches[name] > 0, f"dense {mode}: {name} never launched")
        med = sorted(step_ms)[n_dec // 2]
        r = {"prefill_ms": prefill_ms, "planarize_ms": planarize_ms,
             "decode_ms_per_step_median": med,
             "decode_ms_per_step_mean": sum(step_ms) / n_dec,
             "decode_tokens_per_s": b * n_dec / (sum(step_ms) / 1e3),
             "prefill_tokens_per_s": b * s / (prefill_ms / 1e3),
             "launches": launches}
        log(f"  dense {mode}: prefill {b}x{s} in {prefill_ms:.1f} ms "
            f"({r['prefill_tokens_per_s']:.0f} tok/s), planarize "
            f"{planarize_ms:.1f} ms, decode step median {med:.1f} ms mean "
            f"{r['decode_ms_per_step_mean']:.1f} ms "
            f"({r['decode_tokens_per_s']:.1f} tok/s), launches {launches}")
        res[mode] = r
        del caches
    res["launches_total"] = ops.all_launch_counters()   # read: the run ends
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"  dense peak device memory {res['peak_mem_gb']:.1f} GB")
    for mode in ("fp16", "fp8"):
        prefill = steps.make_prefill_step(cfg, mode, capacity=cap)
        decode = steps.make_decode_step(cfg, mode)
        wall, by_name = device_ms_by_kernel(
            torch, lambda: prefill(sp, {"tokens": prompts}), 1)
        res[f"profile_prefill_{mode}"] = profile_summary(
            f"profile dense prefill {mode}", wall, res[mode]["prefill_ms"],
            by_name)
        _, caches = prefill(sp, {"tokens": prompts})
        caches = M.planarize_cache(caches)
        nxt = prompts[:, -1:]
        wall, by_name = device_ms_by_kernel(
            torch, lambda: decode(sp, caches, nxt, s), 4)
        res[f"profile_decode_{mode}"] = profile_summary(
            f"profile dense decode {mode}: 4 steps", wall,
            res[mode]["decode_ms_per_step_median"], by_name)
        del caches
    res["long_decode"] = long_decode(torch, cfg, sp)
    return res


def long_decode(torch, cfg, sp, n_steps: int = 5, n_prof: int = 3) -> dict:
    """The dense decode step at long context, through `make_decode_step`:
    8 rows, all layers, planar caches of capacity 32768 from
    `init_cache(planar=True)` filled one layer at a time with the planes
    of random f16 (a 32k prefill would not fit the time limit), ragged
    cache lengths up to 32766 (kv lengths up to 32767); fp16, then fp8.
    Each mode runs 1 + n_steps steps (median step ms of the last n_steps,
    host clock), then n_prof steps under the torch profiler (device busy
    ms and K5's ms a step), rewriting the same positions."""
    from repro_torch.core import nestedfp as nf
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import model as M

    b, cap = 8, 32768
    top = cap - 3 - n_steps          # the profiled steps' kv length: cap - 1
    lens0 = [top, 30001, 1, 20000, top, 5, 16384, 32000]
    torch.cuda.empty_cache()
    t_start = t0 = time.time()
    caches = M.init_cache(cfg, b, cap, planar=True, device="cuda")
    planes = caches["attn"]
    gen = torch.Generator(device="cuda").manual_seed(13)
    for layer in range(cfg.n_layers):
        for kind in ("k", "v"):
            x = torch.randn(planes["k_hi"].shape[1:], generator=gen,
                            device="cuda", dtype=torch.float16)
            hi, lo = nf.split_bytes(x)
            planes[f"{kind}_hi"][layer].copy_(hi)
            planes[f"{kind}_lo"][layer].copy_(lo)
            del x, hi, lo
    torch.cuda.synchronize()
    cache_gb = sum(p.numel() for p in planes.values()) / 1e9
    log(f"  long decode: {cache_gb:.1f} GB of planar caches (capacity {cap}, "
        f"{cfg.n_layers} layers) filled in {time.time() - t0:.1f} s")
    tokens = torch.randint(1, cfg.vocab_size, (b, 1), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(14),
                           dtype=torch.int32)
    res = {"batch": b, "capacity": cap, "cache_gb": cache_gb}
    k5 = ("planar_split_kernel", "combine_kernel")
    for mode in ("fp16", "fp8"):
        decode = steps.make_decode_step(cfg, mode)
        lens = torch.tensor(lens0, dtype=torch.int32, device="cuda")
        before = ops.all_launch_counters()["planar_decode_attention"]
        step_ms, nxt = [], tokens
        for _ in range(1 + n_steps):
            t0 = time.monotonic()
            logits, caches = decode(sp, caches, nxt, lens)
            nxt = logits.argmax(-1).to(torch.int32)[:, None]
            torch.cuda.synchronize()
            step_ms.append((time.monotonic() - t0) * 1e3)
            lens = lens + 1
        check(tuple(logits.shape) == (b, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()),
              f"long decode {mode}: logits not finite or mis-shaped")
        launched = ops.all_launch_counters()["planar_decode_attention"] - before
        check(launched == cfg.n_layers * (1 + n_steps),
              f"long decode {mode}: K5 launched {launched} times")
        med = sorted(step_ms[1:])[n_steps // 2]
        wall, by_name = device_ms_by_kernel(
            torch, lambda: decode(sp, caches, nxt, lens), n_prof)
        prof = profile_summary(f"profile long decode {mode}: {n_prof} steps",
                               wall, med, by_name)
        k5_ms = sum(v for k, v in by_name.items() if any(n in k for n in k5))
        res[mode] = {"step_ms_median": med, "step_ms": step_ms,
                     "max_kv_len": int(lens.max()) + 1,
                     "k5_launches": launched,
                     "k5_device_ms_per_step": k5_ms, **prof}
        log(f"  long decode {mode}: step median {med:.1f} ms (host), device "
            f"busy {prof['device_ms_per_step']:.2f} ms a step, K5 "
            f"{k5_ms:.3f} ms a step ({cfg.n_layers} calls)")
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["seconds"] = time.time() - t_start
    log(f"  long decode peak device memory {res['peak_mem_gb']:.1f} GB, "
        f"{res['seconds']:.1f} s in all")
    del caches, planes
    torch.cuda.empty_cache()
    return res


def _linears(tree, cls):
    if isinstance(tree, cls):
        return [tree]
    if isinstance(tree, dict):
        return [p for v in tree.values() for p in _linears(v, cls)]
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

# which measured calls make up each kernel's numbers in the kernels line
LINE_WEIGHTS = {
    # the seven GEMMs of one layer in one decode step (M = 8)
    **{name: (lambda r: LLAMA_KN.count((r["k"], r["n"])) if r["m"] == 8
              else 0)
       for name in ("nestedfp16_matmul", "nestedfp8_matmul", "f16_matmul",
                    "nestedfp8_matmul_fused_quant")},
    # one fp16-mode paged decode call of one layer
    "paged_planar_decode_attention": (
        lambda r: int(not r["fp8"] and r["window"] is None)),
    # one fp16-mode dense decode call of one layer at the dense capacity
    "planar_decode_attention": (
        lambda r: int(not r["fp8"] and r["cap"] == 1056
                      and r["window"] is None)),
    # one layer's bf16 prefill attention of 8 x 1024 tokens
    "flash_prefill_attention": (
        lambda r: int((r["dtype"], r["b"], r["s"]) == ("bfloat16", 8, 1024))),
    # one 4096 x 14336 weight
    "nestedfp_encode": lambda r: 1,
    # the seven quantizations of one layer in one fp8 decode step (M = 8,
    # f32 rows as the engine gives them): six of width 4096, one of 14336
    "quant_per_token": (lambda r: (r["m"] == 8 and r["dtype"] == "float32")
                        * {4096: 6, 14336: 1}[r["k"]]),
}


def ptxas_entries(build_log: str) -> list[dict]:
    """Registers and spill bytes of each entry function in a ptxas -v
    log (names kept to their readable part)."""
    import re
    out, cur = [], None
    for line in build_log.splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            short = re.search(r"\d+([a-z_]+kernel)(?:ILi(\d+)ELb(\d))?", name)
            cur = {"entry": name if not short else short.group(1) + (
                f"<{short.group(2)},{short.group(3)}>" if short.group(2)
                else "")}
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="card,kernels,slice,serve,dense")
    ap.add_argument("--iters", type=int, default=20,
                    help="timed calls per kernel measurement")
    ap.add_argument("--serve-layers", type=int, default=32)
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

    rows = {}
    if "kernels" in phases:
        log("== kernels vs plain versions (llama3.1-8b shapes)")
        rows = gemm_phase(torch, args.iters)
        rows["paged_planar_decode_attention"] = attention_phase(torch, args.iters)
        rows["planar_decode_attention"] = dense_decode_phase(torch, args.iters)
        rows["flash_prefill_attention"] = prefill_attention_phase(
            torch, args.iters)
        rows["nestedfp8_matmul_fused_quant"] = fused_quant_phase(
            torch, args.iters)
        rows["nestedfp_encode"] = encode_phase(torch, args.iters)
        rows["quant_per_token"] = quant_phase(torch, args.iters)
        results["kernel_rows"] = rows
    cfg = get_arch("llama3.1-8b")
    if "slice" in phases:
        log("== slice: 2-layer llama3.1-8b, card vs CPU plain versions")
        results["slice"] = slice_phase(torch, cfg)
    if "serve" in phases:
        log(f"== serve: llama3.1-8b, {args.serve_layers} layers")
        results["serve"] = serve_phase(torch, cfg, args.serve_layers)
    if "dense" in phases:
        log(f"== dense: llama3.1-8b, {cfg.n_layers} layers, dense-slot "
            f"prefill and decode steps")
        results["dense"] = dense_phase(torch, cfg)
    results["total_s"] = time.time() - t_start
    log(f"== done in {results['total_s']:.1f} s")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))

    if rows:
        # launches over the main paths' runs: the paged serve and the
        # dense-slot steps, each counted from 0 at its start
        paths = [results.get(p, {}).get("launches_total", {})
                 for p in ("serve", "dense")]
        kernels = []
        for name, (src, replaces) in SOURCES.items():
            kernels.append({"name": name, "route": "cuda", "source": src,
                            "replaces": replaces,
                            "launches": sum(p.get(name, 0) for p in paths),
                            **summarize(rows[name], LINE_WEIGHTS[name])})
        print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
