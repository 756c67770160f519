"""Continuous-batching serving engine with per-iteration dual precision.

The port of the JAX package's `serving/engine.py` for every decoder-only
family: GQA K/V planes (f16 or byte-planar; a vlm is served as a
text-only GQA decoder, as the JAX engine serves it), or MLA's f16 latent
planes (`c_kv`, `k_rope`) through the same block pool, prefix cache and
host tier; and, for a recurrent stack, its slot-resident state (below).
An encdec is refused (NotImplementedError from `model.cache_descriptor`,
as in the JAX engine): the dense-slot steps serve it.
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

N-gram speculative decoding (`speculate=`): each decode row may carry up
to K drafts proposed on the host from the request's own token history
(serving/speculate.py). The batched decode then runs as one ragged
C=K+1 verification chunk (the "spec" step keys) with the greedy argmax
at every column and the longest accepted draft prefix selected on the
device beside it, so the end-of-step sync still pulls one packed int32
array. Rejected positions are rolled back by block bookkeeping
(`BlockManager.truncate`), and K adapts to the acceptance rate
(`core.policy.AdaptiveKController`). Drafting never preempts: drafts
are clamped to `max_coverable` and given back if their COW fork cannot
complete. Drafts decide how many tokens a dispatch confirms, never
which.

Tiered KV (`host_offload=True`, the default): registered prefix blocks
the LRU evicts are captured to a host pool (`kvcache.HostPool`) instead
of dropped, a later prefix match restores them by an upload into the
pool under the `RestorePolicy` SLO guard, and `persist_dir` /
`save_prefix_store` keep the prefix store across engine restarts, in
the JAX package's file format. Planar pools restore the hi planes
eagerly and the lo planes on the first FP16 step. Every write into the
pool (restores, COW copies) is in place: the captured steps read the
planes at fixed addresses.

Recurrent stacks (the ssm and hybrid descriptors, mamba2 and zamba2):
each sequence's state lives in its slot's row of the slot-resident
planes, claimed in `SlotManager` in lockstep with the block manager's
slot and zeroed at every (re-)admission (a preempted request restarts
its recurrence from scratch). Pads would be absorbed into the state, so
a prompt chunk runs at its exact length, one chunk a dispatch routed to
its slot (the "chunk" step keys, one per (mode, length), the JAX
engine's exact-length compiles); the batched decode keeps every idle
row's state as it was. A cached KV prefix cannot stand in for the state,
so the prefix cache and the host tier are off, and speculation is
refused: a recurrence cannot roll back rejected drafts. A pure SSM has
no paged plane: its block tables only account tokens.

Fleet hooks (`serving/router.py`): `fault_hook(engine)` is called at the
very top of `step()`, before anything mutates, so a raise there leaves
the engine drainable; `inject_stall_ms` is added to the step's measured
time (the controller reacts to it) and reported as `last_stall_ms`, and
`last_mode` is the step's precision. `drain_requests()` exports every
in-flight request for failover, releasing its blocks and slot.

Serving meshes (`mesh=`, `launch.mesh.make_serving_mesh`): the engine
drives a ("model",) mesh as one logical device. Weights are cut one
piece a shard at construction (`shard.shard_serving_params`), each shard
has its own pool (`model.init_paged_cache(mesh=)`), the block tables are
replicated (one device copy a distinct device) and every dispatch is one
call of `shard.sharded_paged_step`, captured as one CUDA graph where the
shards share a card. The host scheduler is untouched, so `stats` count
logical steps: dispatches, h2d bytes and every counter equal the
unsharded engine's on the same requests. A host-tier entry is the
logical block, every shard's planes put together (a pool kept whole is
read from the first shard and written to all), so its checksum and the
prefix store's format are the unsharded engine's. Every family the
engine serves is served on a mesh: a recurrent stack's slot-resident
state is one dict a shard (the SSM state cut by heads), zeroed on every
shard at (re-)admission, and its exact-length chunk keys are captured
as unsharded.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import json
import os
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import (AdaptiveKController,
                                     DualPrecisionController, RestorePolicy,
                                     SpeculationConfig, StepObservation)
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as M
from repro_torch.models.convert import params_to
from repro_torch.models.layers import Runtime
from repro_torch.serving import shard as SHARD
from repro_torch.serving.graphs import StepGraphs
from repro_torch.serving.kvcache import (TRASH_BLOCK, BlockManager,
                                         HostPool, SlotManager)
from repro_torch.serving.speculate import NgramProposer


@dataclasses.dataclass
class Request:
    request_id: str
    tokens: list[int]
    max_new: int
    # generation stops right after one of these ids is emitted (the stop
    # token itself is kept in `output`, EOS-style); an accepted
    # speculative run is cut at its first stop token
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


def _strip_pending(req: Request) -> Request:
    """Drop an interrupted step's trailing `_PENDING` placeholder with its
    time and mode entries, so the request can be resubmitted as it is."""
    while req.output and req.output[-1] == _PENDING:
        req.output.pop()
        if req.token_times:
            req.token_times.pop()
        if req.modes:
            req.modes.pop()
    if not req.output:
        req.first_token_s = None         # the dropped placeholder was the
                                         # first token
    return req


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
                 speculate: SpeculationConfig | bool | None = None,
                 host_offload: bool = True, host_bytes: int | None = None,
                 restore_policy: RestorePolicy | None = None,
                 persist_dir: str | None = None, mesh=None,
                 fault_hook: Callable[["Engine"], None] | None = None):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh: a launch.mesh.Mesh, not "
                            f"{type(mesh).__name__}")
        self.mesh = mesh
        self.cfg = cfg
        if mesh is None:
            self.device = resolve_device(device)
            self.params = params_to(serving_params, self.device)
        else:
            # the first shard's device holds the step's inputs, the
            # primary block table and the host tier's staging buffers
            self.device = mesh.devices[0]
            self.params = SHARD.shard_serving_params(serving_params, cfg,
                                                     mesh)
        self.controller = controller
        self.forced_mode = forced_mode
        self.clock = clock
        self.n_slots = n_slots
        self.capacity = capacity
        self.chunk_tokens = chunk_tokens
        # opt-in runtime sanitizer: audit the BlockManager after every step
        self.debug_invariants = debug_invariants \
            or os.environ.get("NFP_DEBUG") == "1"
        # byte-planar NestedKV applies to GQA K/V planes only: an MLA
        # engine asked for it keeps f16 latent planes, as the JAX engine
        self.kv_planar = kv_planar and cfg.cache_kind == "gqa"
        desc = M.cache_descriptor(cfg, planar=self.kv_planar)
        self.desc = desc
        # recurrent state cannot be re-attached from cached KV blocks
        prefix_cache = prefix_cache and desc.prefix_cacheable
        # pads are invisible to attention (causal mask, trash block) but
        # would be absorbed into a recurrent state: such stacks prefill
        # in exact-length chunks, one a dispatch
        self._pad_chunks = not desc.slot_planes
        # speculation: True picks the default SpeculationConfig. Rejected
        # drafts are rolled back by block bookkeeping, which slot-resident
        # state cannot provide: advancing a recurrence is irreversible
        if speculate and desc.slot_planes:
            raise ValueError(
                "speculative decoding requires rolling back rejected "
                "positions; slot-resident recurrent state (ssm/hybrid "
                "descriptors) cannot be truncated")
        if speculate:
            self._spec = speculate if isinstance(speculate, SpeculationConfig) \
                else SpeculationConfig()
            self._proposer = NgramProposer(self._spec)
            self._spec_k = AdaptiveKController(self._spec)
        else:
            self._spec = self._proposer = self._spec_k = None
        self._last_spec = (0, 0)     # (drafted, accepted) of the last step
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
                      # speculation (spec_stats()): decode_rows counts
                      # row-dispatches, decode_tokens the tokens they
                      # emitted (their ratio is 1.0 without speculation)
                      "spec_dispatches": 0, "spec_drafted": 0,
                      "spec_accepted": 0, "decode_rows": 0,
                      "decode_tokens": 0,
                      # tiered KV (tiered_stats()): blocks and bytes
                      # captured to the host tier, restored, lazily
                      # lo-completed, admissions the SLO guard sent to
                      # recompute, and host entries whose checksum failed
                      # (their rows recompute)
                      "spilled_blocks": 0, "spilled_bytes": 0,
                      "restored_blocks": 0, "restored_bytes": 0,
                      "lo_lazy_blocks": 0, "lo_lazy_bytes": 0,
                      "restore_fallbacks": 0, "iters_exhausted": 0,
                      "corrupt_fallbacks": 0}
        self._last_step_ms: float | None = None
        # fault injection (serving/faults.py): the hook runs at the top of
        # every step; inject_stall_ms is consumed into _last_step_ms (so
        # the controller reacts) and reported as last_stall_ms
        self.fault_hook = fault_hook
        self.inject_stall_ms = 0.0
        self.last_stall_ms = 0.0
        self.last_mode: str | None = None
        # act_quant="per_token": fp8 generation must not depend on what
        # shares the batch (a per-tensor scale couples co-batched tokens)
        self._rts = {m: Runtime(mode=m, dtype=torch.float32,
                                act_quant="per_token")
                     for m in ("fp16", "fp8")}
        self.block_size = block_size
        mbs = -(-capacity // block_size)
        # one block table per window group, each its own id space over the
        # same pool (a layer touches only its group's rows of a block)
        gw = desc.group_windows
        if not window_reclaim:
            gw = (None,) * len(gw)
        if n_blocks is None:
            n_blocks = n_slots * mbs         # dense-equivalent pool by default
        # the host tier holds evicted prefix blocks: prefix-cacheable
        # paged descriptors only
        self._host_tier = bool(host_offload and prefix_cache and desc.paged
                               and not desc.slot_planes)
        self._restore_policy = restore_policy or RestorePolicy()
        self.persist_dir = persist_dir
        # spill captures enqueued on the device, stored by
        # `_settle_captures` (group, [(block, hash)], host buffer, event)
        self._captures: list[tuple[int, list, torch.Tensor, Any]] = []
        self.blocks = BlockManager(n_slots, block_size, n_blocks, mbs,
                                   prefix_cache=prefix_cache,
                                   group_windows=gw, device=self.device,
                                   host_pool=HostPool(host_bytes)
                                   if self._host_tier else None,
                                   mirror_devices=() if mesh is None
                                   else SHARD.replicated(mesh))
        # the layers whose pool rows each group's block ids address (the
        # same id may be live in another group with other content)
        glayers = [g.layers for g in desc.groups] \
            or [tuple(range(cfg.n_layers))]
        self._group_layers = {
            gi: torch.tensor(ls, dtype=torch.long, device=self.device)
            for gi, ls in enumerate(glayers)}
        # the slot-resident state side (ssm, hybrid): occupancy tracked in
        # lockstep with the block manager's slots
        self.slot_state = SlotManager(n_slots) if desc.slot_planes else None
        self.caches = M.init_paged_cache(
            cfg, self.blocks.n_total_blocks, block_size,
            planar=self.kv_planar, device=self.device, n_slots=n_slots,
            mesh=mesh)
        self._pool_key = M.paged_key(desc)
        self._plane_dtypes = {p.name: M.TORCH_DTYPES[p.dtype]
                              for p in desc.planes}
        # tiered KV: a host entry holds, for each plane, the group's layer
        # rows of one block, (group layers, block_size, *token_shape), as
        # in the JAX package. Planar pools upload the hi planes at restore
        # and the lo planes lazily on the first FP16 touch.
        names = tuple(p.name for p in desc.planes)
        self._lo_planes = tuple(n for n in names if n.endswith("_lo")) \
            if self.kv_planar and self._host_tier else ()
        self._hi_planes = tuple(n for n in names if n not in self._lo_planes)
        self._entry_shapes = {
            gi: {p.name: (len(ls), block_size) + p.token_shape
                 for p in desc.planes}
            for gi, ls in enumerate(glayers)}
        # the restore backlog the SLO guard reads counts hi-plane bytes
        self._eager_block_bytes = {gi: self._record_bytes(gi, self._hi_planes)
                                   for gi in self._entry_shapes}
        # the device block table exists from here on and is only ever
        # written in place: the captured steps read it at a fixed address
        tables, step = self.blocks.device_tables(), M.paged_step
        if mesh is not None:
            # a table copy a shard (one a device) and the mesh's step; a
            # mesh across cards runs eagerly (serving/graphs.py)
            tables = [self.blocks.device_tables(d) for d in mesh.devices]
            step = functools.partial(SHARD.sharded_paged_step, mesh)
        self.graphs = StepGraphs(self._rts, self.params, cfg, self.caches,
                                 tables, block_size, step=step,
                                 capture=mesh is None or mesh.colocated)
        self.iteration = 0
        if self._host_tier and persist_dir:
            self._load_prefix_store(persist_dir)

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

    def drain_requests(self) -> list[Request]:
        """Export every in-flight request (admission order, then queue
        order), releasing all KV blocks and slots: the router's failover
        export. A trailing `_PENDING` placeholder of an interrupted step is
        dropped with its time and mode entries, so a survivor can resubmit
        each request as it is: re-prefilling prompt + output continues
        greedy generation exactly.

        What the released rows leave behind is settled too: spill captures
        an interrupted step enqueued are stored (their blocks stay
        servable by the prefix index), queued restores die with their
        tickets, and blocks whose lo planes were never landed are purged
        from the device index with their host entries unpinned (the entry
        stays in the tier), so afterwards no capture is pending and no
        host entry is pinned."""
        self._settle_captures()
        bm = self.blocks
        order = sorted(set(self.active) | set(self.prefilling),
                       key=lambda i: bm.seqs[i].admitted)
        out: list[Request] = []
        for idx in order:
            if idx in self.active:
                out.append(self.active.pop(idx))
            else:
                out.append(self.prefilling.pop(idx).req)
            self._release(idx)
        out.extend(self.queue)
        self.queue.clear()
        if bm.host is not None:
            bm.abandon_restores()
        # the last step's draft counts describe rows that left
        self._last_spec = (0, 0)
        return [_strip_pending(req) for req in out]

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

    def spec_stats(self) -> dict:
        """Speculation effectiveness: `tokens_accepted_per_dispatch` is
        the mean tokens one decode dispatch confirms for a row (1.0
        without speculation, > 1 iff drafts were accepted). A trace that
        never decoded or never drafted reports 0.0."""
        s = self.stats
        return {"enabled": self._spec is not None,
                "spec_dispatches": s["spec_dispatches"],
                "drafted": s["spec_drafted"],
                "accepted": s["spec_accepted"],
                "acceptance_rate": s["spec_accepted"] / s["spec_drafted"]
                if s["spec_drafted"] else 0.0,
                "tokens_accepted_per_dispatch":
                s["decode_tokens"] / s["decode_rows"]
                if s["decode_rows"] else 0.0,
                "k": self._spec_k.k if self._spec_k else 0}

    @property
    def restore_policy(self) -> RestorePolicy:
        """The live SLO guard on the tiered-KV restore path (swappable at
        run time)."""
        return self._restore_policy

    @restore_policy.setter
    def restore_policy(self, policy: RestorePolicy) -> None:
        self._restore_policy = policy

    # -- tiered KV: spill / restore / persist ---------------------------------
    def tiered_stats(self) -> dict:
        """Host-tier effectiveness: blocks spilled, restored, lazily
        lo-completed, admissions the SLO guard sent to recompute, and the
        tier's occupancy."""
        s, bm = self.stats, self.blocks
        host = bm.host
        return {"enabled": self._host_tier,
                "host_blocks": len(host) if host is not None else 0,
                "host_bytes": host.bytes if host is not None else 0,
                "spilled_blocks": s["spilled_blocks"],
                "spilled_bytes": s["spilled_bytes"],
                "restored_blocks": s["restored_blocks"],
                "restored_bytes": s["restored_bytes"],
                "lo_lazy_blocks": s["lo_lazy_blocks"],
                "lo_lazy_bytes": s["lo_lazy_bytes"],
                "restore_fallbacks": s["restore_fallbacks"],
                "host_hit_blocks": bm.prefix_stats["host_hit_blocks"],
                "queued_restores": len(bm.restore_jobs)}

    def _record_bytes(self, g: int, names) -> int:
        """Bytes of one block's host entry for planes `names` of group g."""
        return sum(int(np.prod(self._entry_shapes[g][n]))
                   * self._plane_dtypes[n].itemsize for n in names)

    def _planes_of(self, g: int, names, rows: torch.Tensor):
        """For each plane of `names`, in order: (name, byte offset and
        bytes of its part of one block's record, that part of `rows` — a
        (blocks, record bytes) uint8 staging buffer — viewed as (blocks,
        *entry shape) in the plane's dtype)."""
        off = 0
        for n in names:
            shape = self._entry_shapes[g][n]
            dt = self._plane_dtypes[n]
            nb = int(np.prod(shape)) * dt.itemsize
            region = rows[:, off: off + nb].view(dt).view(rows.shape[0],
                                                          *shape)
            yield n, off, nb, region
            off += nb

    def _pool_parts(self, name: str, write: bool):
        """Where plane `name` of the logical pool lives: (a pool plane,
        the slice of a record's kv-head axis it holds, None for all of
        it). Unsharded, the one plane. On a mesh, each shard's plane: its
        kv heads' slice, or the whole record where the pool is kept whole
        on every shard (read from the first shard, written to all)."""
        whole = self._entry_shapes[0][name][2]
        parts = []
        for c in self._shard_caches():
            plane = c[self._pool_key][name]
            h = plane.shape[3]
            if h == whole:
                parts.append((plane, None))
                if not write:
                    break
            else:
                i = len(parts)
                parts.append((plane, slice(i * h, (i + 1) * h)))
        return parts

    def _host_buffer(self, nbytes: int) -> torch.Tensor:
        """A host uint8 buffer for one tier transfer: page-locked on a card,
        from PyTorch's caching host allocator, so that a buffer freed after
        its transfer is reused by the next transfer of its size rather
        than pinned anew."""
        return torch.empty(nbytes, dtype=torch.uint8,
                           pin_memory=self.device.type == "cuda")

    def _capture_blocks(self, jobs: list[tuple[int, int, int]],
                        defer: bool = False) -> None:
        """Copy (group, block, hash) pool bytes into the host tier: a
        group's blocks (padded to a power of two by repeating the last
        id) are gathered on the device into one staging buffer, their
        layer rows only, then copied to a host buffer (`_host_buffer`) in
        one transfer; `_settle_captures` then copies each block's row out
        into memory of its own (as the JAX package's entries do, so the
        tier holds, and frees, exactly its entries' bytes), checksums and
        stores it. With `defer`, only the device work is enqueued: the
        caller launches its step next and settles after the launch, so
        the host work overlaps the step on the card (the copy reads the
        blocks before the step's writes land: one stream). Used by
        `_flush_spills` (evicted blocks) and `save_prefix_store` (a
        mirror that evicts nothing)."""
        by_g: dict[int, list[tuple[int, int]]] = {}
        for g, b, h in jobs:
            by_g.setdefault(g, []).append((b, h))
        names = tuple(p.name for p in self.desc.planes)
        on_card = self.device.type == "cuda"
        for g, items in sorted(by_g.items()):
            kb = _bucket(len(items), 1)
            # the ids go up without a host wait: a flush may find the
            # step's prefill graph still running ahead of it
            ids = self._host_buffer(kb * 8).view(torch.int64)
            ids.numpy()[:] = [b for b, _h in items] \
                + [items[-1][0]] * (kb - len(items))
            ids_dev = ids.to(self.device, non_blocking=on_card)
            li = self._group_layers[g]
            rec = self._record_bytes(g, names)
            stage = torch.empty((kb, rec), dtype=torch.uint8,
                                device=self.device)
            for n, _off, _nb, region in self._planes_of(g, names, stage):
                for plane, heads in self._pool_parts(n, write=False):
                    d = plane.device
                    got = plane[li.to(d)[:, None], ids_dev.to(d)[None, :]]
                    dst = region if heads is None else region[..., heads, :]
                    dst.copy_(got.transpose(0, 1))
            host = self._host_buffer(kb * rec).view(kb, rec)
            host.copy_(stage, non_blocking=on_card)
            done = None
            if on_card:
                done = torch.cuda.Event()
                done.record()
            self._captures.append((g, items, host, done))
            self.stats["aux_dispatches"] += 1
        if not defer:
            self._settle_captures()

    def _settle_captures(self) -> None:
        """Store the captures `_capture_blocks` enqueued, in order: each
        block's row is copied out of the host buffer, checksummed (on
        worker threads) and put in the host tier."""
        bm = self.blocks
        names = tuple(p.name for p in self.desc.planes)
        while self._captures:
            g, items, host, done = self._captures.pop(0)
            if done is not None:
                # tiered-KV spill capture: the one host sync besides the
                # step's end; it waits for cold evicted blocks' bytes
                # (work enqueued before the step's graph), never for the
                # step's sampled ids. The copies and checksums below must
                # read landed bytes.
                # nfp: ignore[NFP001] tiered-KV spill capture: waits for the evicted cold blocks' copy, enqueued before the step's graph, never for the step's ids
                done.synchronize()
            layout = [(n, off, nb, r.numpy().dtype, r.shape[1:])
                      for n, off, nb, r in self._planes_of(g, names, host)]
            rows = host.numpy()
            entries = []
            for i in range(len(items)):
                own = rows[i].copy()
                entries.append({n: own[off: off + nb].view(dt).reshape(shape)
                                for n, off, nb, dt, shape in layout})
            for entry, digest, (_b, h) in zip(
                    entries, bm.host.checksums(entries), items):
                bm.store_spill(g, h, entry, digest)
                self.stats["spilled_blocks"] += 1
                self.stats["spilled_bytes"] += sum(
                    a.nbytes for a in entry.values())

    def _flush_spills(self, defer: bool = False) -> None:
        """Capture every queued evicted-block spill (captures still in
        flight are stored first, so entries land in eviction order). MUST
        run before any cache-writing step: the evicted ids are already
        reallocated, so their bytes are intact only until the next write
        lands. `defer`: see `_capture_blocks`."""
        if not self._host_tier:
            return
        self._settle_captures()
        jobs = self.blocks.take_spills()
        if jobs:
            self._capture_blocks(jobs, defer)

    def _tier_upload(self, g: int, items: list[tuple[int, int]],
                     names: tuple[str, ...]) -> int:
        """Write the host-tier bytes of planes `names` of [(block, hash)]
        `items` into group g's pool rows: the entries and the block ids
        are stacked in one host buffer (`_host_buffer`) and sent in one
        copy, then each plane takes one in-place scatter on the same
        stream, ahead of any later step. Block counts are padded to a
        power of two; pads aim at the trash block. Returns bytes sent."""
        bm = self.blocks
        kb = _bucket(len(items), 1)
        rec = self._record_bytes(g, names)
        on_card = self.device.type == "cuda"
        host = self._host_buffer(kb * (8 + rec))
        ids = host[:kb * 8].view(torch.int64).numpy()
        ids[:] = TRASH_BLOCK
        ids[:len(items)] = [b for b, _h in items]
        rows = host[kb * 8:].view(kb, rec)
        hv = rows.numpy()
        # pad rows land in the trash block, which masked reads still
        # multiply by zero: they must hold finite values
        hv[len(items):] = 0
        nbytes = 0
        for i, (_b, h) in enumerate(items):
            entry = bm.host.get((g, h))
            for n, off, nb, _r in self._planes_of(g, names, rows):
                hv[i, off: off + nb] = entry[n].reshape(-1).view(np.uint8)
                nbytes += nb
        dev = host.to(self.device, non_blocking=on_card)
        ids_dev = dev[:kb * 8].view(torch.int64)
        li = self._group_layers[g]
        for n, _o, _nb, region in self._planes_of(
                g, names, dev[kb * 8:].view(kb, rec)):
            for plane, heads in self._pool_parts(n, write=True):
                d = plane.device
                src = region if heads is None else region[..., heads, :]
                plane.index_put_((li.to(d)[:, None], ids_dev.to(d)[None, :]),
                                 src.transpose(0, 1).to(d))
        self.stats["aux_dispatches"] += 1
        return nbytes

    def _restore_queued_bytes(self) -> int:
        """Eager (hi-plane) bytes waiting in the restore queue: the
        backlog the RestorePolicy's admission gate reads."""
        return sum(self._eager_block_bytes[g]
                   for g, _b, _h, _t in self.blocks.restore_jobs)

    def _host_admit(self) -> bool:
        """May this admission match host-tier blocks? The SLO guard sends
        it to recompute when the restore backlog is too long
        (`stats["restore_fallbacks"]`)."""
        if not self._host_tier:
            return False
        bm = self.blocks
        if not (len(bm.host) or bm._spill_pending):
            return True                      # nothing to restore anyway
        if self._restore_policy.admit(self._restore_queued_bytes()):
            return True
        self.stats["restore_fallbacks"] += 1
        return False

    def _drain_restores(self) -> None:
        """Upload queued restores at the top of the step, within the
        RestorePolicy's per-step byte grant (at least one block, so gated
        rows make progress). Spill captures run first: a restore may
        target an entry still queued for capture."""
        bm = self.blocks
        if not self._host_tier or not bm.restore_jobs:
            return
        self._flush_spills()
        budget = self._restore_policy.grant(self._restore_queued_bytes())
        taken: dict[int, list[tuple[int, int]]] = {}
        spent = 0
        while bm.restore_jobs:
            g, b, h, t = bm.restore_jobs[0]
            if not bm.claim_restore(g, b, h, t):
                bm.restore_jobs.popleft()    # voided by release/preempt
                continue
            if not bm.host_ok(g, h):
                # checksum mismatch: never upload these bytes; the owners
                # recompute and the entry is dropped
                bm.restore_jobs.popleft()
                self._corrupt_fallback(g, b, h)
                continue
            cost = self._eager_block_bytes[g]
            if spent and spent + cost > budget:
                break
            bm.restore_jobs.popleft()
            taken.setdefault(g, []).append((b, h))
            spent += cost
        lazy = bool(self._lo_planes)
        for g, items in sorted(taken.items()):
            nbytes = self._tier_upload(g, items, self._hi_planes)
            for b, h in items:
                bm.finish_restore(g, b, h, lo_pending=lazy)
            self.stats["restored_blocks"] += len(items)
            self.stats["restored_bytes"] += nbytes

    def _corrupt_fallback(self, g: int, b: int, h: int) -> None:
        """A claimed restore's host bytes failed their checksum: preempt
        every row holding the block (they re-prefill exactly), then drop
        the entry so later matches recompute too. Counted, never raised,
        and the bytes are never uploaded."""
        bm = self.blocks
        for idx in bm.rows_holding(g, b):
            self._preempt(idx)
        if (g, h) in bm.host and not bm.host.pinned((g, h)):
            bm.host.discard((g, h))
        self.stats["corrupt_fallbacks"] += 1

    def _sweep_corrupt_lo(self) -> None:
        """Check the deferred lo-plane sources at the top of the step,
        before planning, where preemption is safe: a corrupt entry's
        block is purged, its owner rows recompute and the entry is
        dropped, so the mid-step lo uploads may trust what they drain."""
        bm = self.blocks
        if not (self._host_tier and self._lo_planes and bm._lo_pending):
            return
        for (g, b), h in list(bm._lo_pending.items()):
            if bm.host.verify((g, h)):
                continue
            del bm._lo_pending[(g, b)]
            bm.host.unpin((g, h))
            for idx in bm.rows_holding(g, b):
                self._preempt(idx)
            bm.purge_block(g, b)
            if not bm.host.pinned((g, h)):
                bm.host.discard((g, h))
            self.stats["corrupt_fallbacks"] += 1

    def _upload_lo(self, triples: list[tuple[int, int, int]]) -> None:
        """Complete the deferred lo planes of (group, block, hash) triples
        (the host-entry pins pass here and are released after)."""
        if not triples:
            return
        bm = self.blocks
        self._flush_spills()
        by_g: dict[int, list[tuple[int, int]]] = {}
        for g, b, h in triples:
            by_g.setdefault(g, []).append((b, h))
        for g, items in sorted(by_g.items()):
            nbytes = self._tier_upload(g, items, self._lo_planes)
            for _b, h in items:
                bm.host.unpin((g, h))
            self.stats["lo_lazy_blocks"] += len(items)
            self.stats["lo_lazy_bytes"] += nbytes

    def _ensure_lo(self, mode: str) -> None:
        """FP16 joins hi and lo planes everywhere, so the first FP16 step
        after a planar restore lands every deferred lo plane first."""
        if mode == "fp16" and self._host_tier and self._lo_planes:
            self._upload_lo(self.blocks.take_lo_pending())

    def _store_meta(self) -> dict:
        """Layout fingerprint of the persisted prefix store (the JAX
        package's): a store loads only into an engine whose chain hashes
        and pool planes mean the same thing."""
        return {"version": 1, "arch_id": self.cfg.arch_id,
                "kind": self.desc.kind, "planar": bool(self.kv_planar),
                "block_size": self.block_size,
                "group_windows": [w if w is None else int(w)
                                  for w in self.blocks.group_windows],
                "planes": {p.name: [list(p.token_shape), p.dtype]
                           for p in self.desc.planes}}

    def save_prefix_store(self, path: str | None = None) -> int:
        """Mirror the whole prefix index into the host tier (a capture
        that evicts nothing) and write it, chain-hash keys and block
        bytes, to `path` (default `persist_dir`) as `prefix_store.npz` +
        `prefix_store.json`. Chain hashes are stable content digests, so
        a new `Engine(persist_dir=...)`, of either package, re-admits
        these prefixes without recomputing them. Returns entries
        written."""
        path = path or self.persist_dir
        if not self._host_tier or not path:
            raise ValueError("save_prefix_store needs host_offload and a "
                             "persist_dir/path")
        self._flush_spills()
        self._capture_blocks(self.blocks.mirror_jobs())
        os.makedirs(path, exist_ok=True)
        arrs = {f"{g}|{h}|{p}": a
                for (g, h), planes in self.blocks.host.entries.items()
                for p, a in planes.items()}
        np.savez(os.path.join(path, "prefix_store.npz"), **arrs)
        with open(os.path.join(path, "prefix_store.json"), "w") as f:
            json.dump(self._store_meta(), f)
        return len(self.blocks.host)

    def _load_prefix_store(self, path: str) -> int:
        """Load a persisted prefix store into the host tier. A missing
        store or a fingerprint mismatch loads nothing."""
        meta_p = os.path.join(path, "prefix_store.json")
        npz_p = os.path.join(path, "prefix_store.npz")
        if not (os.path.exists(meta_p) and os.path.exists(npz_p)):
            return 0
        with open(meta_p) as f:
            if json.load(f) != self._store_meta():
                return 0
        entries: dict[tuple[int, int], dict[str, np.ndarray]] = {}
        with np.load(npz_p) as data:
            for key in data.files:
                g, h, p = key.split("|", 2)
                entries.setdefault((int(g), int(h)), {})[p] = data[key]
        for key, planes in entries.items():
            self.blocks.host.put(key, planes, loaded=True)
        return len(entries)

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
        end; its wall time, plus any injected stall, feeds the
        controller's next decision."""
        if self.fault_hook is not None:
            # containment point: nothing has mutated yet, so a raise here
            # leaves the engine fully drainable
            self.fault_hook(self)
        self.iteration += 1
        t0 = self.clock()
        # land queued restores first (within the SLO grant): rows whose
        # blocks arrive here are schedulable this very step
        self._sweep_corrupt_lo()
        self._drain_restores()
        plan = self._plan_chunks()
        mode = self._mode(len(self.active),
                          sum(take for _, _, take in plan),
                          free_block_frac=self.blocks.free_block_frac())
        # the first FP16 step after a planar restore lands the lo planes
        self._ensure_lo(mode)
        # pending: (req, output index, device ids, row, slot) patched at
        # the end-of-step sync; fresh: (slot, device ids, row) prefills
        # that completed this step and decode below with a device token
        pending: list[tuple[Request, int, Any, int, int]] = []
        fresh: list[tuple[int, Any, int]] = []
        chunk_ids = self._run_chunks(mode, plan, pending, fresh)
        decode_ids, drafts = self._decode_paged(mode, chunk_ids, fresh)
        self._finalize_step(mode, pending, decode_ids, chunk_ids, drafts)
        self._sample_peak()
        self.last_mode = mode
        self.last_stall_ms, self.inject_stall_ms = self.inject_stall_ms, 0.0
        self._last_step_ms = (self.clock() - t0) * 1e3 + self.last_stall_ms
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
            if self.blocks.row_unrestored(idx):
                continue    # a restore is in flight: its reads would be
                            # garbage; _drain_restores ungates the row
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
            if self.slot_state is not None:
                # the state side claims the same slot, zeroed: a recompute
                # after preemption restarts the recurrence from scratch
                self.slot_state.claim(idx, req.request_id, len(seq_tokens),
                                      req.max_new - len(req.output))
                self._zero_slot(idx)
            # the longest cached full-block prefix is shared; prefill
            # starts at the matched offset but always recomputes >= 1
            # token so the first-token logit is produced
            matched = self.blocks.attach_prefix(
                idx, seq_tokens, allow_host=self._host_admit())
            start = min(matched, len(seq_tokens) - 1)
            self.blocks.set_length(idx, start)
            self.prefilling[idx] = _Prefill(req, seq_tokens, done=start)
            if self.blocks.row_unrestored(idx):
                continue    # the first chunk waits for the restores
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
        if self._host_tier and triples:
            # copies write the pool: capture queued spills first, and
            # complete a fork source's deferred lo planes (the copy clones
            # every plane, and the destination keeps no lo_pending record)
            self._flush_spills()
            self._upload_lo(self.blocks.take_lo_pending_for(
                [(g, src) for g, src, _dst in triples]))
        for g, src, dst in triples:
            for c in self._shard_caches():
                for plane in c[self._pool_key].values():
                    layers = self._group_layers[g].to(plane.device)
                    plane[layers, dst] = plane[layers, src]
            self.stats["aux_dispatches"] += 1

    def _shard_caches(self) -> list[dict]:
        """The caches, one dict a shard (one in all without a mesh)."""
        return [self.caches] if self.mesh is None else self.caches

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

    def _zero_slot(self, idx: int) -> None:
        """Zero one slot's recurrent state, in place, at (re-)admission."""
        for c in self._shard_caches():
            for plane in c["ssm"].values():
                plane[:, idx].zero_()
        self.stats["aux_dispatches"] += 1

    def _run_chunks(self, mode: str, plan, pending, fresh):
        """Run this step's planned prompt chunks: attention families fuse
        every chunk into one ragged dispatch (`_run_chunks_fused`),
        recurrent stacks dispatch one exact-length chunk after another
        (`_run_chunk`). Returns the device ids of the step's chunks, one
        row per chunk (None when nothing ran); completing rows are
        recorded in `pending` / `fresh` with their row."""
        if self._pad_chunks:
            return self._run_chunks_fused(mode, plan, pending, fresh)
        ids = []
        for idx, start, take in plan:
            # a preemption in an earlier chunk's COW may have taken a
            # later plan entry
            if idx in self.prefilling:
                self._run_chunk(mode, idx, start, take, ids, pending, fresh)
        return torch.cat(ids) if ids else None

    def _run_chunk(self, mode: str, idx: int, start: int, take: int, ids,
                   pending, fresh) -> None:
        """One recurrent chunk, exact-length, as its own dispatch of the
        ("chunk", mode, take) key, routed to slot idx (its block-table
        row and its state row). Its sampled id is copied out of the key's
        static buffer (a later chunk of the same length overwrites it)
        and appended to `ids`, whose index is the chunk's row."""
        st = self.prefilling[idx]
        if not self._cow_or_preempt(idx, start, start + take):
            return
        key = ("chunk", mode, take)
        x = self.graphs.inputs(key)
        x["tokens"][0] = st.seq_tokens[start: start + take]
        x["rows"][0] = idx
        x["q_offset"][0] = start
        x["kv_len"][0] = start + take
        x["logit_position"][0] = take - 1
        self._upload(key)
        self.blocks.device_tables()          # flush table edits first
        ids.append(self.graphs.run(key).clone())
        self.stats["prefill_dispatches"] += 1
        self._commit_chunk(idx, start, take)
        self._sample_peak()                  # pre-retire, as below
        self._finish_chunk(mode, idx, None, len(ids) - 1, pending, fresh)

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
        if self._host_tier:
            # the step writes the pool: queued spill captures go first,
            # and a lo-pending block the write ranges touch completes its
            # lo planes now (a later whole-block lo upload would clobber
            # the fresh bytes)
            self._flush_spills(defer=True)
            touched = [p for idx, start, take in entries
                       for p in self.blocks.lo_pending_in_range(
                           idx, start, start + take)]
            self._upload_lo(self.blocks.take_lo_pending_for(touched))
        self._upload(key)
        self.blocks.device_tables()          # flush table edits first
        ids = self.graphs.run(key)
        self._settle_captures()              # while the step runs
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
        self._release(victim)
        self.queue.appendleft(req)

    def _retire(self, idx: int, now: float) -> None:
        req = self.active.pop(idx)
        req.finished_s = now
        self.finished.append(req)
        self._release(idx)

    def _release(self, idx: int) -> None:
        """Give back a row's blocks and its slot-resident state slot."""
        self.blocks.release(idx)
        if self.slot_state is not None:
            self.slot_state.release(idx)
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

    def _draft(self) -> dict[int, list[int]]:
        """Propose n-gram drafts for the active rows and secure KV
        coverage for their writes at positions L+1..L+K. Drafting never
        preempts: a draft is clamped to what the pool covers without
        evicting anyone (`max_coverable`), and if the COW fork of the
        extension cannot complete, the extension is given back
        (`truncate`) and the row decodes one token. A row whose input
        token is still on the device (a fresh prefill) drafts nothing."""
        k = self._spec_k.decide(StepObservation(
            batch_tokens=max(len(self.active), 1),
            queue_depth=len(self.queue),
            measured_step_ms=self._last_step_ms,
            spec_drafted=self._last_spec[0],
            spec_accepted=self._last_spec[1]))
        drafts: dict[int, list[int]] = {}
        bm = self.blocks
        for idx, req in self.active.items():
            if req.output[-1] == _PENDING:
                continue
            L = int(self.lens[idx])
            # position L's write and this step's own token are budgeted
            # already: drafts get what is left of max_new and capacity
            budget = min(k, req.max_new - len(req.output) - 1,
                         self.capacity - L - 1)
            if budget <= 0:
                continue
            d = self._proposer.propose(req.tokens + req.output, budget)
            if d:
                d = d[:bm.max_coverable(idx, L + 1, len(d))]
            if not d:
                continue
            ok = bm.ensure(idx, L + 1 + len(d))
            assert ok, idx           # max_coverable guarantees coverage
            pairs = bm.cow_for_write(idx, L + 1, L + 1 + len(d))
            if pairs is None:
                bm.truncate(idx, L + 1)
                continue
            self._apply_cow(pairs)
            drafts[idx] = d
        return drafts

    def _decode_paged(self, mode: str, chunk_ids, fresh):
        """Dispatch the batched decode over all slots; returns (device
        ids, drafts): ids None when nothing is active, drafts None for a
        plain one-token step. When a row drafted, the decode runs as the
        "spec" key's ragged C=cb chunk instead, whose ids pack
        [ids | n_accepted]. Host bookkeeping for the decoded tokens
        happens in `_finalize_step`."""
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
            return None, None
        drafts = self._draft() if self._spec is not None else {}
        kmax = max(map(len, drafts.values()), default=0)
        # no row drafted: the plain C=1 decode, the same step as with
        # speculation off (on planar KV it keeps K4, which a C>1 chunk
        # does not use)
        key = ("spec", mode, _bucket(kmax + 1, 1)) if kmax \
            else ("decode", mode)
        x = self.graphs.inputs(key)          # kv_len 0 disables idle rows
        for idx, req in self.active.items():
            if req.output[-1] != _PENDING:
                x["tokens"][idx, 0] = req.output[-1]
            d = drafts.get(idx, ())
            if d:
                x["tokens"][idx, 1:1 + len(d)] = d
                x["dlen"][idx] = len(d)
            x["q_offset"][idx] = self.lens[idx]
            x["kv_len"][idx] = self.lens[idx] + 1 + len(d)
        toks = self._upload(key)["tokens"]
        fresh = [(s, a, r) for s, a, r in fresh if s in self.active]
        if fresh and self._pad_chunks:
            # every completing prefill's first token lives in ONE device
            # array: overlay them with a single device write, no sync
            slots = np.asarray([s for s, _, _ in fresh], np.int32)
            rows = np.asarray([r for _, _, r in fresh], np.int32)
            toks[self._h2d(slots).long(), 0] = \
                chunk_ids[self._h2d(rows).long()]
            self.stats["aux_dispatches"] += 1
        else:
            # recurrent chunks: one overlay a completing chunk, as the JAX
            # engine writes each chunk's ids array in on its own
            for s, _a, r in fresh:
                toks[self._h2d(np.asarray([s], np.int32)).long(), 0] = \
                    chunk_ids[self._h2d(np.asarray([r], np.int32)).long()]
                self.stats["aux_dispatches"] += 1
        # the decode writes the pool: capture queued spills (ensure() may
        # have evicted LRU blocks above) before the write lands. Decode
        # and draft writes land only in partly filled or COW-exclusive
        # tail blocks, never in a restored one, so no lo guard here.
        self._flush_spills(defer=True)
        self.blocks.device_tables()          # flush table edits first
        ids = self.graphs.run(key)
        self._settle_captures()              # while the step runs
        self.stats["decode_dispatches"] += 1
        if kmax:
            self.stats["spec_dispatches"] += 1
            return ids, drafts
        return ids, None

    # nfp: sync-point
    def _finalize_step(self, mode: str, pending, decode_ids, chunk_ids,
                       drafts=None) -> None:
        """The step's ONLY device->host sync: pull the sampled token ids
        of the decode and of the fused prefill as ONE transfer, patch
        pending prefill outputs, then run decode bookkeeping
        (commit() must hash REAL token values, so it comes after the
        patch). A patched first token that is a stop token retires its
        row here, and that row's same-step decode result is dropped.

        A speculative step (`drafts` not None) emits for each row the
        accepted draft prefix plus the model's next token, cut at the
        first stop token and at max_new; `truncate` gives back the blocks
        of rejected positions, and one commit() registers any newly
        filled blocks and advances the length. The last emitted token is
        never in the cache: it is the next step's input."""
        parts = [t.reshape(-1) for t in (decode_ids, chunk_ids)
                 if t is not None]
        host = torch.cat(parts).cpu().numpy() if parts else None
        nxt = None
        if decode_ids is not None:
            n = decode_ids.numel()
            nxt = host[:n].reshape(decode_ids.shape)
            host = host[n:]
        now = self.clock()
        for req, pos, _ids, row, idx in pending:
            req.output[pos] = int(host[row])
            if req.output[pos] in req.stop_tokens \
                    and self.active.get(idx) is req:
                self._retire(idx, now)
        if nxt is None:
            return
        if drafts is None:
            for idx, req in list(self.active.items()):
                self.lens[idx] += 1
                n = int(self.lens[idx])
                if n % self.block_size == 0:
                    # tail block just filled: register it in the index
                    self.blocks.commit(idx, n, (req.tokens + req.output)[:n])
                else:
                    self.blocks.set_length(idx, n)
                req.output.append(int(nxt[idx]))
                req.token_times.append(now)
                req.modes.append(mode)
                self.stats["decode_rows"] += 1
                self.stats["decode_tokens"] += 1
                self._maybe_retire(idx, now)
            if self._spec is not None:
                self._last_spec = (0, 0)
            return
        drafted_total = accepted_total = 0
        for idx, req in list(self.active.items()):
            d = drafts.get(idx, ())
            n_acc = int(nxt[idx, -1]) if d else 0
            out = [int(t) for t in nxt[idx, :n_acc + 1]]
            drafted_total += len(d)
            accepted_total += n_acc
            # a stop token ends an accepted run mid-run (what follows it
            # is never emitted), and max_new bounds it the same way
            for j, t in enumerate(out):
                if t in req.stop_tokens:
                    out = out[:j + 1]
                    break
            out = out[:req.max_new - len(req.output)]
            new_n = int(self.lens[idx]) + len(out)
            # rollback: drop the blocks of rejected positions (their
            # writes landed in COW-exclusive unregistered blocks; what is
            # left past new_n in the kept tail block is masked by kv_len
            # and overwritten before it is read)
            self.blocks.truncate(idx, new_n)
            self.blocks.commit(idx, new_n,
                               (req.tokens + req.output + out)[:new_n])
            self.lens[idx] = new_n
            req.output.extend(out)
            req.token_times.extend([now] * len(out))
            req.modes.extend([mode] * len(out))
            self.stats["decode_rows"] += 1
            self.stats["decode_tokens"] += len(out)
            self._maybe_retire(idx, now)
        self.stats["spec_drafted"] += drafted_total
        self.stats["spec_accepted"] += accepted_total
        self._last_spec = (drafted_total, accepted_total)
