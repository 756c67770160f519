"""Run one cell of the port's benchmark:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. One process:

1. sets `TEARDOWN_CUPTI=1` before torch is imported (a profiler session
   otherwise slows every later CUDA-graph launch), keeps the kernel
   caches inside the checkout, turns TF32 off, and fails with no result
   when there is no card;
2. builds (first run in a checkout) or loads the port's kernels;
3. plans the run's step keys on a CPU copy of the engine's scheduler
   (`program.schedule_engine`): the closed loop's schedule depends on
   the seed alone, so the keys it makes are the keys the run reaches;
4. draws the weights on the card from the seed, layer by layer, and
   nests them through the port (`to_serving`, K8);
5. builds the port's paged engine as the cell deploys it, captures each
   planned key, and runs the closed loop until as many requests as
   there are clients have finished (all of this is `setup_s`);
6. measures for `--seconds`, and with `--trace 1` profiles a stretch of
   `TRACE_STEPS` steps from 40 % into the window, a quarter of them
   or more with a prefill dispatch;
7. reads the metrics, frees the engine, and checks the served tokens of
   a sample of the window's finished requests against the plain
   reference (`reference.py`);
8. prints a set-up line, a window line, the numbers compared beside
   their limits (also as the last lines of standard error), and the
   result as the last line of standard output.

`--policy` serves the cell in another precision (the FP16 cell's
control: the program's own FP8 path, judged by the same comparison); the
benchmark's own runs never set it.
"""

from __future__ import annotations

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
CACHE = CHECKOUT / ".portbench_cache"
os.environ["TEARDOWN_CUPTI"] = "1"
os.environ["USE_FLAX"] = "0"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
for _p in (CHECKOUT / "src", CHECKOUT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import program, reference, spec  # noqa: E402
from portbench import trace as TR  # noqa: E402
from portbench.loop import Loop  # noqa: E402
from portbench.record import Window  # noqa: E402
from portbench.reckon import decode_floor_s, prompt_flops, token_flops  # noqa: E402,E501

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
TRACE_FROM = 0.4
TRACE_STEPS = 16
SAMPLE_TOKENS = 300


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's, the JAX
    package's or its old benchmarks' (compared whole: `repro_torch` is
    not `repro`)."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def plan(cell: spec.Cell, arch, seed: int, seconds: float, policy: str):
    """(step keys, warm-up steps): the keys the run reaches and the steps
    until as many requests as there are clients have finished (each
    client has turned over once, on average), walked on the
    CPU copy of the scheduler over the warm-up and as many steps as a
    window of `seconds` could hold: every step runs a dispatch, which
    takes at least the least time of a decode dispatch at one row
    (`reckon.decode_floor_s`)."""
    b = cell.body
    src = spec.load_module("traffic", cell.traffic["kind"]).make(
        cell.traffic, seed, cell.model.vocab, b["clients"])
    eng = program.schedule_engine(arch, b["engine"], policy)
    loop = Loop(eng, src, program.request)
    while len(loop.done) < b["clients"]:
        loop.step()
    warm = len(loop.steps)
    for _ in range(math.ceil(seconds / decode_floor_s(cell.model, 1))):
        loop.step()
    return program.step_keys(eng), warm


def _capture_order(key) -> tuple:
    """Prefill keys by rows x chunk bucket, largest first, then the rest."""
    size = key[2] * key[3] if key[0] == "prefill" else 0
    return (-size, repr(key))


def sample(tracks, n_tokens: int, seed: int):
    """The requests the check compares: the longest that finished in the
    window, then others in an order drawn from the seed, until they hold
    `n_tokens` served tokens."""
    if not tracks:
        return []
    longest = max(tracks, key=lambda t: t.prompt_len + t.seen)
    rest = [t for t in tracks if t is not longest]
    order = np.random.default_rng([seed % 2**64, 3]).permutation(len(rest))
    out, n = [longest], longest.seen
    for i in order:
        if n >= n_tokens:
            break
        out.append(rest[i])
        n += rest[i].seen
    return out


def check(cell: spec.Cell, seed: int, tracks, device) -> dict[str, float]:
    """The widest and the mean gap by which a served token's logit lies
    below the best of the reference at the cell's precision (its
    `policy`, whatever `--policy` served), over the sample."""
    picked = sample(tracks, SAMPLE_TOKENS, seed)
    seqs = [t.req.tokens + t.req.output[:-1] for t in picked]
    rows = [list(range(t.prompt_len - 1, t.prompt_len - 1 + t.seen))
            for t in picked]
    served = torch.tensor([x for t in picked for x in t.req.output],
                          device=device)
    lg = reference.logits_at(cell.model, seed, seqs, rows,
                             cell.body["policy"], device)
    gap = reference.gaps(lg, served)
    return {"max_gap": float(gap.max()), "mean_gap": float(gap.mean()),
            "served_tokens": int(served.numel()),
            "sampled_requests": len(picked)}


def run_cell(cell: spec.Cell, bench: dict, seed: int, seconds: float,
             trace: bool, device, policy: str | None = None,
             t_process: float = T_PROCESS) -> dict:
    """One run of `cell`: returns the result line's object, with the
    set-up and window lines under "setup" and "window"."""
    b = cell.body
    policy = policy or b["policy"]
    m = cell.model
    on_card = torch.device(device).type == "cuda"
    t = time.time()
    if on_card:
        program.build_kernels()
    compile_s = time.time() - t
    arch = program.port_config(cell.config)

    t = time.time()
    keys, warm_steps = plan(cell, arch, seed, seconds, policy)
    plan_s = time.time() - t

    t = time.time()
    params = program.serving_params(m, seed, device)
    _sync(device)
    if on_card:
        # the draws' cached blocks back to the card: the graphs' private
        # pool cannot use them
        torch.cuda.empty_cache()
    load_s = time.time() - t

    t = time.time()
    eng = program.engine(arch, params, b["engine"], policy, device)
    del params
    # largest prefill key first, so later keys reuse its share of the
    # graphs' pool; each key's eager run leaves temporaries in the
    # ordinary cache, which the private pool cannot use: hand them back
    for key in sorted(keys, key=_capture_order):
        program.capture(eng, key)
        if on_card:
            torch.cuda.empty_cache()
    _sync(device)
    capture_s = time.time() - t
    captured = program.n_captured(eng)
    free_b, total_b = torch.cuda.mem_get_info() if on_card else (0, 0)

    def flops(tr, a, n):
        f = 0.0
        if a == 0:
            f += prompt_flops(m, tr.prompt_len)
            a = 1
        return f + sum(token_flops(m, tr.prompt_len + j - 1)
                       for j in range(a, n))

    src = spec.load_module("traffic", cell.traffic["kind"]).make(
        cell.traffic, seed, m.vocab, b["clients"])
    t = time.time()
    loop = Loop(eng, src, program.request, flops=flops)
    for _ in range(warm_steps):
        loop.step()
    _sync(device)
    warm_s = time.time() - t
    setup = {"compile_s": compile_s, "plan_s": plan_s, "load_s": load_s,
             "capture_s": capture_s, "warm_s": warm_s,
             "keys_planned": len(keys), "keys_captured": captured,
             "warm_steps": warm_steps,
             "warm_completions": len(loop.done),
             "graph_pool_bytes": program.pool_bytes(eng) if on_card else 0,
             "n_blocks": eng.blocks.n_blocks,
             "kv_pool_bytes": sum(p.numel() * p.element_size()
                                  for p in eng.caches["attn"].values()),
             "free_bytes_after_capture": free_b, "card_bytes": total_b}

    stats0 = dict(eng.stats)
    first = len(loop.steps)
    t_w0 = time.perf_counter()
    setup_s = time.time() - t_process
    prof, done_prof, traced, launches0, launches = None, None, [], None, None
    while True:
        if trace and prof is None and not traced \
                and time.perf_counter() - t_w0 >= TRACE_FROM * seconds:
            from torch.profiler import ProfilerActivity, profile
            _sync(device)
            launches0 = program.launch_counts()
            prof = profile(activities=[ProfilerActivity.CPU]
                           + ([ProfilerActivity.CUDA] if on_card else []))
            prof.start()
        rec = loop.step()
        if prof is not None:
            traced.append(len(loop.steps) - 1 - first)
            mixed = sum(1 for i in traced if loop.steps[first + i]
                        .prefill_dispatches)
        closed = rec.t1 - t_w0 >= seconds
        if prof is not None and (closed or len(traced) >= TRACE_STEPS
                                 and 4 * mixed >= TRACE_STEPS):
            _sync(device)
            prof.stop()
            after = program.launch_counts()
            launches = {k: after[k] - launches0[k] for k in after}
            done_prof, prof = prof, None
        if closed:
            break
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    steps = loop.steps[first:]
    ends = [t_w0] + [s.t1 for s in steps]
    w = Window(model=m, policy=policy, t0=t_w0, t1=steps[-1].t1,
               steps=steps, step_dt=[b2 - a2 for a2, b2 in zip(ends, ends[1:])],
               traced=traced, tracks=loop.done + list(loop.live.values()),
               stats={k: eng.stats[k] - stats0[k] for k in stats0},
               setup_s=setup_s, peak_bytes=peak, launches=launches)
    window = {"steps": len(steps), "seconds": w.window_s,
              "finished": len(w.finished()),
              "first_tokens": len(w.first_tokens()),
              "captured_in_window": program.n_captured(eng) - captured,
              "prefill_steps": sum(1 for s in steps if s.prefill_dispatches),
              "preemptions": w.stats["preemptions"],
              "tokens": sum(s.emitted for s in steps)}
    if done_prof is not None:
        w.trace = TR.from_profiler(done_prof)
        del done_prof
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for entry in spec.metric_entries(bench, section, cell.name):
        v = spec.load_module("metrics", entry["name"]).read(w)
        if v is not None:
            metrics[entry["name"]] = {"value": v, "unit": entry["unit"]}
    attempted = sum(1 for tr in w.tracks
                    if tr.t_finish is None or tr.t_finish > w.t0)
    result = {"correct": False, "attempted": attempted, "failed": 0,
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": torch.cuda.get_device_name(0) if on_card
                         else "cpu",
                         "count": 1, "memory_peak_bytes": peak}}
    if w.trace is not None:
        result["device"].update(busy_s=w.trace.busy_s(),
                                window_s=w.trace.window_s)
        result["breakdown"] = TR.breakdown(w.trace)

    finished = w.finished()
    del eng, loop.eng, w.trace
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = time.time()
    readings = check(cell, seed, finished, device)
    readings["check_s"] = time.time() - t
    limits = b["check"]["limits"]
    result["correct"] = bool(limits) and all(
        readings[k] <= v for k, v in limits.items())
    result["check"] = {k: {"value": readings[k], "limit": v}
                       for k, v in limits.items()}
    result["setup"], result["window"], result["readings"] = \
        setup, window, readings
    return result


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--policy", choices=("fp16", "fp8"), default=None)
    args = ap.parse_args(argv)

    bench_path = CHECKOUT / "BENCHMARK.json"
    if not (CHECKOUT / "src" / "repro_torch").is_dir():
        log(f"no program under test: {CHECKOUT / 'src' / 'repro_torch'} "
            f"is missing")
        return 2
    bench = spec.load_benchmark(bench_path)
    entry = next((c for c in bench["workloads"]
                  if c["name"] == args.workload), None)
    if entry is None:
        log(f"no workload {args.workload!r} in {bench_path}")
        return 2
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < entry["chips"]:
        log(f"needs {entry['chips']} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)
    cell = spec.load_cell(args.workload)
    res = run_cell(cell, bench, args.seed, args.seconds, bool(args.trace),
                   "cuda", policy=args.policy)
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {bad}")
        return 3
    setup, window, readings = (res.pop(k) for k in
                               ("setup", "window", "readings"))
    print("card " + card_line() + " | peaks: 989 TFLOP/s f16, 1979 e4m3, "
          "3.35 TB/s")
    print("setup " + json.dumps(setup))
    print("window " + json.dumps(window))
    print("readings " + json.dumps(readings))
    for name, v in res["check"].items():
        log(f"check {name} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
