"""Continuous-batching serving engine with per-iteration dual precision.

The port of the JAX package's `serving/engine.py` for dense GQA models.
Each engine step (a) schedules prompt-prefill CHUNKS up to a token
budget, interleaved with decode, and (b) advances every active slot by one
token (batched decode) over a BLOCK-PAGED KV cache. Admission is driven
by free KV blocks; when decode growth exhausts the pool the youngest
sequence is preempted and requeued for recompute. The
DualPrecisionController picks FP16 or FP8 per iteration from the measured
wall time of the previous steps; NestedFP serves both precisions from the
same weight buffers, so the switch costs nothing.

One step is at most two model dispatches plus small bookkeeping ops:
* every planned prompt chunk runs as ONE batched ragged `paged_step`
  (rows bucketed to a power of two, chunks to a shared bucket, per-row
  q_offset/kv_len/logit_position carry the raggedness; pad rows with
  kv_len=0 write to the trash block);
* the batched decode runs as one C=1 `paged_step` over all slots.
Block tables live on the device (`BlockManager.device_tables`), sampling
(argmax) happens on the device, and the step's results come back to the
host ONCE, in `_finalize_step`: nothing earlier in the step calls
`.item()`, `.cpu()` or `.tolist()` on a live device tensor. A prefill that
completes mid-step hands its first token to the same step's decode with
an on-device overlay.

The JAX package jit-compiled one executable per (mode, bucket) and donated
the pool to it; here each key — the decode per mode, the fused prefill
per (mode, rows bucket, chunk bucket) — is one CUDA graph on the card,
captured at its first use and replayed after (`serving/graphs.py`), and
the pool is updated in place. A step stages its inputs into the key's
static buffers with one host->device copy; COW block copies, the block
table flush and the first-token overlay run eagerly on the same stream
before the replay. On the CPU the same buffers are staged and the step
runs eagerly. Copy-on-write prefix caching is on by default
(`prefix_cache=True`): shared blocks are forked by an in-place block
copy in the pool before any write lands.

Sliding-window stacks (gemma3) keep one block table per window group
over the same pool (`kvcache.BlockManager(group_windows=...)`): blocks
of the local layers whose keys have left every future query's window
are freed mid-generation and counted in `stats["window_reclaimed_blocks"]`;
`window_reclaim=False` keeps the groups but never slides them.

Not ported yet, and refused with NotImplementedError when asked for:
speculative decoding, the host KV tier and its persistence, serving
meshes and the fault-injection hook.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import DualPrecisionController, StepObservation
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.convert import params_to
from repro_torch.models.layers import Runtime
from repro_torch.serving.graphs import StepGraphs
from repro_torch.serving.kvcache import BlockManager


@dataclasses.dataclass
class Request:
    request_id: str
    tokens: list[int]
    max_new: int
    # generation stops right after one of these ids is emitted (the stop
    # token itself is kept in `output`, EOS-style)
    stop_tokens: tuple[int, ...] = ()
    # filled by the engine:
    output: list[int] = dataclasses.field(default_factory=list)
    first_token_s: float | None = None
    finished_s: float | None = None
    token_times: list[float] = dataclasses.field(default_factory=list)
    modes: list[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _Prefill:
    """In-flight chunked prefill. seq_tokens is the full token stream to
    re-establish in the cache — prompt plus any output generated before a
    preemption (greedy decoding makes the recompute continuation exact)."""
    req: Request
    seq_tokens: list[int]
    done: int = 0


def _bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


# placeholder for a token whose value still lives on the device; patched
# by `_finalize_step`'s single end-of-step sync before anything reads it
_PENDING = -1


class Engine:
    def __init__(self, cfg: ArchConfig, serving_params, *, n_slots: int,
                 capacity: int,
                 controller: DualPrecisionController | None = None,
                 forced_mode: str | None = None, kv_planar: bool = False,
                 clock: Callable[[], float] = time.monotonic,
                 block_size: int = 16, n_blocks: int | None = None,
                 chunk_tokens: int = 256, prefix_cache: bool = True,
                 window_reclaim: bool = True,
                 debug_invariants: bool = False, device=None,
                 speculate=None, mesh=None, persist_dir: str | None = None,
                 host_offload: bool = False,
                 fault_hook: Callable[["Engine"], None] | None = None):
        for name, val in (("speculate", speculate), ("mesh", mesh),
                          ("persist_dir", persist_dir),
                          ("host_offload", host_offload),
                          ("fault_hook", fault_hook)):
            if val:
                raise NotImplementedError(
                    f"Engine({name}=...) is not ported to repro_torch yet")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params_to(serving_params, self.device)
        self.controller = controller
        self.forced_mode = forced_mode
        self.clock = clock
        self.n_slots = n_slots
        self.capacity = capacity
        self.chunk_tokens = chunk_tokens
        # opt-in runtime sanitizer: audit the BlockManager after every step
        self.debug_invariants = debug_invariants \
            or os.environ.get("NFP_DEBUG") == "1"
        self.kv_planar = kv_planar
        self.queue: collections.deque[Request] = collections.deque()
        self.active: dict[int, Request] = {}
        self.prefilling: dict[int, _Prefill] = {}
        self.finished: list[Request] = []
        self.lens = np.zeros(n_slots, np.int32)
        self.stats = {"preemptions": 0, "chunks": 0, "chunk_tokens": 0,
                      "peak_block_util": 0.0, "window_reclaimed_blocks": 0,
                      # model calls per phase, small auxiliary device ops
                      # (COW block copies, first-token overlays) and
                      # host->device bytes of step inputs (block-table
                      # flushes are counted by the BlockManager)
                      "prefill_dispatches": 0, "decode_dispatches": 0,
                      "aux_dispatches": 0, "h2d_bytes": 0,
                      "decode_rows": 0, "decode_tokens": 0,
                      "iters_exhausted": 0}
        self._last_step_ms: float | None = None
        # act_quant="per_token": fp8 generation must not depend on what
        # shares the batch (a per-tensor scale couples co-batched tokens)
        self._rts = {m: Runtime(mode=m, dtype=torch.float32,
                                act_quant="per_token")
                     for m in ("fp16", "fp8")}
        self.block_size = block_size
        mbs = -(-capacity // block_size)
        # one block table per window group, each its own id space over the
        # same pool (a layer touches only its group's rows of a block)
        desc = M.cache_descriptor(cfg, planar=kv_planar)
        gw = desc.group_windows
        if not window_reclaim:
            gw = (None,) * len(gw)
        if n_blocks is None:
            n_blocks = n_slots * mbs         # dense-equivalent pool by default
        self.blocks = BlockManager(n_slots, block_size, n_blocks, mbs,
                                   prefix_cache=prefix_cache,
                                   group_windows=gw, device=self.device)
        # the layers whose pool rows a COW fork of each group copies
        self._group_layers = {
            gi: torch.tensor(g.layers, dtype=torch.long, device=self.device)
            for gi, g in enumerate(desc.groups)} or {0: slice(None)}
        self.caches = M.init_paged_cache(
            cfg, self.blocks.n_total_blocks, block_size, planar=kv_planar,
            device=self.device)
        # the device block table exists from here on and is only ever
        # written in place: the captured steps read it at a fixed address
        self.graphs = StepGraphs(self._rts, self.params, cfg, self.caches,
                                 self.blocks.device_tables(), block_size)
        self.iteration = 0

    # -- public API -----------------------------------------------------------
    def submit(self, req: Request) -> None:
        """Enqueue one request, validating it up front."""
        if not req.tokens:
            raise ValueError(f"request {req.request_id}: empty prompt")
        if req.max_new <= 0:
            raise ValueError(
                f"request {req.request_id}: max_new={req.max_new} must be "
                f"positive — a request that may emit nothing can never "
                f"retire")
        total = len(req.tokens) + req.max_new
        if total > self.capacity:
            raise ValueError(
                f"request {req.request_id}: prompt ({len(req.tokens)}) + "
                f"max_new ({req.max_new}) = {total} exceeds per-sequence "
                f"capacity {self.capacity}")
        bm = self.blocks
        if any(bm._group_need(total, w) > bm.n_blocks
               for w in bm.group_windows):
            raise ValueError(
                f"request {req.request_id}: needs more KV blocks than a "
                f"whole group pool holds ({bm.n_blocks}) — the pool can "
                f"never cover it")
        self.queue.append(req)

    def run(self, max_iters: int = 10_000,
            allow_partial: bool = False) -> list[Request]:
        """Step until every submitted request finishes. Hitting
        `max_iters` with work left is an error unless allow_partial."""
        while (self.queue or self.active or self.prefilling) \
                and self.iteration < max_iters:
            self.step()
        leftover = len(self.queue) + len(self.active) + len(self.prefilling)
        if leftover:
            self.stats["iters_exhausted"] = leftover
            if not allow_partial:
                raise RuntimeError(
                    f"run(max_iters={max_iters}) exhausted its iteration "
                    f"cap with {leftover} requests unfinished; pass "
                    f"allow_partial=True to accept a partially-served "
                    f"trace")
        return self.finished

    def prefix_cache_stats(self) -> dict:
        """Hit rate over prompt tokens looked up at admission, blocks
        saved by sharing, COW forks, LRU churn."""
        ps = self.blocks.prefix_stats
        denom = ps["lookup_tokens"]
        return {"hit_rate": ps["hit_tokens"] / denom if denom else 0.0,
                "hit_tokens": ps["hit_tokens"],
                "blocks_saved": ps["blocks_shared"],
                "cached_blocks": self.blocks.n_cached_blocks(),
                "cow_forks": ps["cow_forks"],
                "evictions": ps["evictions"]}

    # -- mode selection -------------------------------------------------------
    def _mode(self, decode_tokens: int, prefill_tokens: int,
              free_block_frac: float | None = None) -> str:
        if self.forced_mode:
            return self.forced_mode
        if self.controller is None:
            return "fp16"
        obs = StepObservation(batch_tokens=max(decode_tokens, 1),
                              queue_depth=len(self.queue),
                              measured_step_ms=self._last_step_ms,
                              prefill_tokens=prefill_tokens,
                              free_block_frac=free_block_frac)
        return self.controller.decide(obs)

    # -- step -----------------------------------------------------------------
    def step(self) -> None:
        """One engine iteration, synced to the host exactly once at the
        end; its wall time feeds the controller's next decision."""
        self.iteration += 1
        t0 = self.clock()
        plan = self._plan_chunks()
        mode = self._mode(len(self.active),
                          sum(take for _, _, take in plan),
                          free_block_frac=self.blocks.free_block_frac())
        # pending: (req, output index, device ids, row, slot) patched at
        # the end-of-step sync; fresh: (slot, device ids, row) prefills
        # that completed this step and decode below with a device token
        pending: list[tuple[Request, int, Any, int, int]] = []
        fresh: list[tuple[int, Any, int]] = []
        chunk_ids = self._run_chunks_fused(mode, plan, pending, fresh)
        decode_ids = self._decode_paged(mode, chunk_ids, fresh)
        self._finalize_step(mode, pending, decode_ids, chunk_ids)
        self._sample_peak()
        self._last_step_ms = (self.clock() - t0) * 1e3
        if self.debug_invariants:
            self.blocks.check_invariants()

    def _ensure_take(self, idx: int, start: int, want: int) -> int:
        """Largest chunk <= want coverable by owned + free blocks across
        every window group (dead local blocks slide back into the pool
        first)."""
        bm = self.blocks
        take = bm.max_coverable(idx, start, want)
        if take <= 0 or not bm.ensure(idx, start + take):
            return 0
        return take

    def _plan_chunks(self) -> list[tuple[int, int, int]]:
        """Schedule this step's prefill work: continue in-flight prefills
        (oldest first), then admit queued requests while the chunk-token
        budget, a slot, and enough free blocks for their WHOLE prompt are
        available (the admission watermark)."""
        plan: list[tuple[int, int, int]] = []
        budget = self.chunk_tokens
        order = sorted(self.prefilling,
                       key=lambda i: self.blocks.seqs[i].admitted)
        for idx in order:
            if budget <= 0:
                break
            st = self.prefilling[idx]
            want = min(len(st.seq_tokens) - st.done, budget)
            take = self._ensure_take(idx, st.done, want)
            if take > 0:
                plan.append((idx, st.done, take))
                budget -= take
        while budget > 0 and self.queue:
            req = self.queue[0]
            seq_tokens = req.tokens + req.output
            idx = self.blocks.try_allocate(
                req.request_id, len(seq_tokens),
                req.max_new - len(req.output),
                cached_blocks=self.blocks.prefix_admit_discount(seq_tokens))
            if idx is None:
                break
            self.queue.popleft()
            # the longest cached full-block prefix is shared; prefill
            # starts at the matched offset but always recomputes >= 1
            # token so the first-token logit is produced
            matched = self.blocks.attach_prefix(idx, seq_tokens)
            start = min(matched, len(seq_tokens) - 1)
            self.blocks.set_length(idx, start)
            self.prefilling[idx] = _Prefill(req, seq_tokens, done=start)
            take = self._ensure_take(
                idx, start, min(len(seq_tokens) - start, budget))
            if take > 0:
                plan.append((idx, start, take))
                budget -= take
        return plan

    def _h2d(self, a: np.ndarray) -> torch.Tensor:
        """Host->device upload of a small auxiliary input, with byte
        accounting."""
        self.stats["h2d_bytes"] += a.nbytes
        return torch.from_numpy(a).to(self.device)

    def _upload(self, key: tuple) -> dict[str, torch.Tensor]:
        """Copy a step key's staged inputs to its static device buffers
        (one copy), with byte accounting."""
        views, nbytes = self.graphs.upload(key)
        self.stats["h2d_bytes"] += nbytes
        return views

    def _apply_cow(self, triples: list[tuple[int, int, int]]) -> None:
        """Materialize COW forks: copy each forked block's bytes in the
        pool, in place, for every plane and the owning group's layers
        only (the same id may be live in another group with other
        content)."""
        for g, src, dst in triples:
            layers = self._group_layers[g]
            for plane in self.caches["attn"].values():
                plane[layers, dst] = plane[layers, src]
            self.stats["aux_dispatches"] += 1

    def _cow_or_preempt(self, idx: int, start: int, end: int) -> bool:
        """Fork shared blocks covering the write range [start, end);
        preempt youngest sequences while the pool is too exhausted to
        fork. False when `idx` itself got preempted."""
        pairs = self.blocks.cow_for_write(idx, start, end)
        while pairs is None:
            victim = self.blocks.youngest()
            if victim is None:
                raise RuntimeError("KV pool exhausted with nothing "
                                   "preemptible")
            self._preempt(victim)
            if idx not in self.prefilling and idx not in self.active:
                return False                 # preempted ourselves
            pairs = self.blocks.cow_for_write(idx, start, end)
        self._apply_cow(pairs)
        return True

    def _sample_peak(self) -> None:
        self.stats["peak_block_util"] = max(
            self.stats["peak_block_util"], self.blocks.utilization())
        self.stats["window_reclaimed_blocks"] = \
            self.blocks.window_freed_blocks

    def _run_chunks_fused(self, mode: str, plan, pending, fresh):
        """ONE ragged `paged_step` covers the whole chunk budget: rows
        bucketed to a power of two, chunk lengths to the max take's
        bucket; pad rows are disabled via kv_len=0. Returns the device
        array of sampled ids (None when nothing was planned)."""
        entries = []
        for idx, start, take in plan:
            if idx not in self.prefilling:
                continue                     # preempted by an earlier COW
            if not self._cow_or_preempt(idx, start, start + take):
                continue
            entries.append((idx, start, take))
        # a later COW fork may have preempted an earlier surviving entry
        entries = [e for e in entries if e[0] in self.prefilling]
        if not entries:
            return None
        key = ("prefill", mode, _bucket(len(entries), 1),
               _bucket(max(take for _, _, take in entries)))
        # zeroed: pad rows alias slot 0, and kv_len=0 masks their reads
        # and trashes their writes
        x = self.graphs.inputs(key)
        for r, (idx, start, take) in enumerate(entries):
            st = self.prefilling[idx]
            x["tokens"][r, :take] = st.seq_tokens[start: start + take]
            x["rows"][r] = idx
            x["q_offset"][r] = start
            x["kv_len"][r] = start + take
            x["logit_position"][r] = take - 1
        self._upload(key)
        self.blocks.device_tables()          # flush table edits first
        ids = self.graphs.run(key)
        self.stats["prefill_dispatches"] += 1
        for idx, start, take in entries:
            self._commit_chunk(idx, start, take)
        # sample pool pressure BEFORE _finish_chunk can retire+release
        self._sample_peak()
        for r, (idx, start, take) in enumerate(entries):
            self._finish_chunk(mode, idx, ids, r, pending, fresh)
        return ids

    def _commit_chunk(self, idx: int, start: int, take: int) -> None:
        st = self.prefilling[idx]
        st.done = start + take
        self.blocks.commit(idx, st.done, st.seq_tokens)
        self.stats["chunks"] += 1
        self.stats["chunk_tokens"] += take

    def _finish_chunk(self, mode: str, idx: int, ids, row: int,
                      pending, fresh) -> None:
        """Promote a prefill whose final chunk just ran to active. Its
        first generated token is still ON DEVICE (`ids[row]`)."""
        st = self.prefilling[idx]
        if st.done < len(st.seq_tokens):
            return
        req = st.req
        req.output.append(_PENDING)
        pending.append((req, len(req.output) - 1, ids, row, idx))
        now = self.clock()
        if req.first_token_s is None:
            req.first_token_s = now
        req.token_times.append(now)
        req.modes.append(mode)
        self.lens[idx] = len(st.seq_tokens)
        self.active[idx] = req
        del self.prefilling[idx]
        self._maybe_retire(idx, now)
        if idx in self.active:
            fresh.append((idx, ids, row))

    def _preempt(self, victim: int) -> None:
        """Recompute preemption: drop the victim's blocks and requeue its
        request at the FRONT of the queue; on re-admission it prefills
        prompt+generated-so-far and continues exactly."""
        self.stats["preemptions"] += 1
        if victim in self.active:
            req = self.active.pop(victim)
        else:
            req = self.prefilling.pop(victim).req
        self.blocks.release(victim)
        self.lens[victim] = 0
        self.queue.appendleft(req)

    def _retire(self, idx: int, now: float) -> None:
        req = self.active.pop(idx)
        req.finished_s = now
        self.finished.append(req)
        self.blocks.release(idx)
        self.lens[idx] = 0

    def _maybe_retire(self, idx: int, now: float) -> None:
        req = self.active[idx]
        # a row is live while length < capacity (position `length` is the
        # next write target); stop tokens are read from the LAST emitted
        # token only (_PENDING placeholders never match)
        eos = bool(req.stop_tokens) and bool(req.output) \
            and req.output[-1] != _PENDING \
            and req.output[-1] in req.stop_tokens
        if eos or len(req.output) >= req.max_new \
                or self.lens[idx] >= self.capacity:
            self._retire(idx, now)

    def _decode_paged(self, mode: str, chunk_ids, fresh):
        """Dispatch the batched decode over all slots; returns the device
        ids (None when nothing is active). Host bookkeeping for the
        decoded tokens happens in `_finalize_step`."""
        # grow each active row's table to cover the write at lens[idx],
        # COW-forking it if shared; preempt the youngest on exhaustion
        for idx in sorted(self.active):
            while idx in self.active:
                if self.blocks.ensure(idx, int(self.lens[idx]) + 1):
                    if self._cow_or_preempt(idx, int(self.lens[idx]),
                                            int(self.lens[idx]) + 1):
                        break
                    continue                 # preempted (maybe ourselves)
                victim = self.blocks.youngest()
                if victim is None:
                    raise RuntimeError("KV pool exhausted with nothing "
                                       "preemptible")
                self._preempt(victim)
        self._sample_peak()                  # allocation peak, pre-retire
        if not self.active:
            return None
        key = ("decode", mode)
        x = self.graphs.inputs(key)          # kv_len 0 disables idle rows
        for idx, req in self.active.items():
            if req.output[-1] != _PENDING:
                x["tokens"][idx, 0] = req.output[-1]
            x["q_offset"][idx] = self.lens[idx]
            x["kv_len"][idx] = self.lens[idx] + 1
        toks = self._upload(key)["tokens"]
        fresh = [(s, a, r) for s, a, r in fresh if s in self.active]
        if fresh:
            # every completing prefill's first token lives in ONE device
            # array: overlay them with a single device write, no sync
            slots = np.asarray([s for s, _, _ in fresh], np.int32)
            rows = np.asarray([r for _, _, r in fresh], np.int32)
            toks[self._h2d(slots).long(), 0] = \
                chunk_ids[self._h2d(rows).long()]
            self.stats["aux_dispatches"] += 1
        self.blocks.device_tables()          # flush table edits first
        ids = self.graphs.run(key)
        self.stats["decode_dispatches"] += 1
        return ids

    def _finalize_step(self, mode: str, pending, decode_ids,
                       chunk_ids) -> None:
        """The step's ONLY device->host sync: pull the sampled token ids
        of the decode and of the fused prefill as ONE transfer, patch
        pending prefill outputs, then run decode bookkeeping
        (commit() must hash REAL token values, so it comes after the
        patch). A patched first token that is a stop token retires its
        row here, and that row's same-step decode result is dropped."""
        parts = [t for t in (decode_ids, chunk_ids) if t is not None]
        host = torch.cat(parts).cpu().numpy() if parts else None
        nxt = None
        if decode_ids is not None:
            nxt = host[:decode_ids.shape[0]]
            host = host[decode_ids.shape[0]:]
        now = self.clock()
        for req, pos, _ids, row, idx in pending:
            req.output[pos] = int(host[row])
            if req.output[pos] in req.stop_tokens \
                    and self.active.get(idx) is req:
                self._retire(idx, now)
        if nxt is None:
            return
        for idx, req in list(self.active.items()):
            self.lens[idx] += 1
            n = int(self.lens[idx])
            if n % self.block_size == 0:
                # tail block just filled: register it in the prefix index
                self.blocks.commit(idx, n, (req.tokens + req.output)[:n])
            else:
                self.blocks.set_length(idx, n)
            req.output.append(int(nxt[idx]))
            req.token_times.append(now)
            req.modes.append(mode)
            self.stats["decode_rows"] += 1
            self.stats["decode_tokens"] += 1
            self._maybe_retire(idx, now)
