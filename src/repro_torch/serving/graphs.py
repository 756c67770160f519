"""The serving engine's captured steps: one CUDA graph per step key.

The port's counterpart of the JAX engine's jit caches, with the same
keys, each made at its first use:

- `("decode", mode)`: the batched decode, `(n_slots, 1)` tokens over the
  whole device block table (the JAX engine's `_decode[mode]`);
- `("prefill", mode, rows_bucket, chunk_bucket)`: the fused ragged
  prefill, whose rows gather their block-table rows of every window
  group inside the step (the JAX engine's `_fused_cache`);
- `("spec", mode, chunk_bucket)`: the batched decode as a ragged C=cb
  verification chunk (column 0 the pending token, then the drafts), the
  greedy argmax at every column and the accept selection fused after it
  (the JAX engine's `_spec_cache`); its output packs `[ids | n_accepted]`
  as one (n_slots, cb + 1) int32 buffer, so the engine's end-of-step
  sync stays one transfer;
- `("chunk", mode, length)`: one exact-length prompt chunk of a recurrent
  stack (ssm, hybrid), `(1, length)` tokens routed to one slot (its
  block-table row and its state row), the JAX engine's `_chunk_cache`,
  which compiles once per exact length; the graph is reused whenever a
  chunk of that length comes again (a full chunk budget, a prompt
  length that repeats).

Each key owns static buffers: one int32 device buffer that packs the
step's inputs (tokens, rows, q_offset, kv_len, logit_position, dlen), a
host buffer of the same layout (pinned on a card) from which one copy a
step fills it, and the sampled ids. The step reads the engine's persistent
pool planes, slot-resident state planes and device block table in place,
and writes the new state into the state planes in place (`copy_`,
`index_copy_`: the JAX engine's step returned new arrays); none of
these, the params or the static buffers is ever reallocated, so a
graph's baked-in addresses stay valid.

On a CUDA device the first use of a key runs the step eagerly on a side
stream (that call is the step's own run: it builds the kernels, sets
their first-call attributes and warms the allocator), then captures it
into a `torch.cuda.CUDAGraph`; every later use replays the graph. All
of an engine's graphs share one memory pool. The kernel wrappers count
launches only when called, so a capture records the counts it made,
takes them back (a capture runs nothing) and every replay adds them:
`ops.all_launch_counters()` keeps counting kernel launches that ran. A
capture that fails raises; nothing runs the eager step in its place.

On the CPU the same object stages the same buffers and calls the same
function eagerly on them, so the keys, the staging and the buffers'
lifetimes are those of the card.

`capture` and `replay` are that discipline on its own, for any step
function; the dense-slot decode step (`launch/steps.py`) uses them too.

Under a serving mesh (`Engine(mesh=...)`) the step is
`shard.sharded_paged_step` over one entry a shard of params, pools and
block tables. A mesh whose shards share one card is captured as one CUDA
graph per key, like an unsharded engine, and its first replays are held
bitwise against eager calls the same way. A mesh across several cards
runs its steps eagerly (`capture=False`): a graph is captured on one
device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models import model as M
from repro_torch.serving.kvcache import TRASH_BLOCK


def capture(fn, pool, device) -> tuple[torch.cuda.CUDAGraph, dict[str, int]]:
    """Run `fn()` once eagerly, then capture it into a CUDA graph that
    allocates from `pool`. Both happen on PyTorch's capture stream, one
    for the process, so the per-stream state made at first use (cuBLAS
    workspaces) is made once, before any capture; the eager call is the
    step's own run (it builds the kernels, sets their first-call
    attributes and warms the allocator). Returns the graph and the launch
    counts the capture recorded, which are taken back from the counters
    (a capture runs nothing) for `replay` to add. A capture that fails
    raises."""
    graph = torch.cuda.CUDAGraph()
    ctx = torch.cuda.graph(graph, pool=pool)
    cur = torch.cuda.current_stream(device)
    side = ctx.capture_stream
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        fn()
    before = ops.all_launch_counters()
    with ctx:
        fn()
    after = ops.all_launch_counters()
    launches = {k: after[k] - before[k] for k in after}
    ops.add_launches({k: -v for k, v in launches.items()})
    cur.wait_stream(side)
    return graph, launches


def replay(graph: torch.cuda.CUDAGraph, launches: dict[str, int]) -> None:
    """Replay a graph from `capture`, counting the launches it runs."""
    graph.replay()
    ops.add_launches(launches)


def pool_bytes(pool) -> int:
    """Bytes the card's allocator holds in a graph pool (0 for None)."""
    if pool is None:
        return 0
    pool = tuple(pool)
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool)


@dataclasses.dataclass
class _Step:
    """One key's static buffers, and its graph once captured."""
    key: tuple
    dev: torch.Tensor                    # packed int32 inputs
    host: torch.Tensor                   # the same layout on the host
    views: dict[str, torch.Tensor]       # name -> view into `dev`
    host_views: dict[str, np.ndarray]    # name -> view into `host`
    ids: torch.Tensor                    # int32 sampled ids (_layout's out)
    graph: torch.cuda.CUDAGraph | None = None
    launches: dict[str, int] | None = None   # recorded at capture
    uploaded: torch.cuda.Event | None = None


def _layout(key: tuple, n_slots: int
            ) -> tuple[list[tuple[str, tuple[int, ...]]], tuple[int, ...]]:
    """(name, shape) of each int32 input of a key, in packing order, and
    the shape of its int32 output."""
    if key[0] == "decode":
        return [("tokens", (n_slots, 1)), ("q_offset", (n_slots,)),
                ("kv_len", (n_slots,))], (n_slots,)
    if key[0] == "spec":
        cb = key[2]
        return [("tokens", (n_slots, cb)), ("q_offset", (n_slots,)),
                ("kv_len", (n_slots,)), ("dlen", (n_slots,))], \
            (n_slots, cb + 1)
    if key[0] == "chunk":
        rb, cb = 1, key[2]
    else:
        _, _, rb, cb = key
    return [("tokens", (rb, cb)), ("rows", (rb,)), ("q_offset", (rb,)),
            ("kv_len", (rb,)), ("logit_position", (rb,))], (rb,)


def _shards(x) -> list:
    """A mesh's one-entry-a-shard list, or an unsharded value as one."""
    return list(x) if isinstance(x, (list, tuple)) else [x]


class StepGraphs:
    """The engine's step keys: static buffers, capture, replay, one pool.

    rts: mode -> Runtime; params, cfg, block_size: as `paged_step` takes
    them; caches: the engine's pool planes and slot-resident state;
    tables: its persistent
    (G, n_slots, MB) device block tables, one per window group
    (`BlockManager.device_tables()`). step: the step function,
    `model.paged_step` or a mesh's (`functools.partial(
    shard.sharded_paged_step, mesh)`, with params, caches and tables one
    entry a shard); capture: False runs a card's steps eagerly."""

    def __init__(self, rts: dict, params, cfg, caches, tables, block_size: int,
                 step=M.paged_step, capture: bool = True):
        self.rts, self.params, self.cfg = rts, params, cfg
        self.caches, self.tables = caches, tables
        self.step_fn = step
        self.block_size = block_size
        first = _shards(tables)[0]
        self.n_slots = first.shape[1]
        self.device = first.device
        self.on_card = self.device.type == "cuda"
        self.capturing = self.on_card and capture
        self._steps: dict[tuple, _Step] = {}
        self._pool = torch.cuda.graph_pool_handle() if self.capturing \
            else None
        # with check_first_runs set, `run` holds each key's first run
        # against an eager call (`check_replay`) right after it, while
        # the tables are those the run read; results go to `checks`
        self.check_first_runs = False
        self.checks: dict[tuple, dict[str, bool]] = {}

    # -- keys and buffers ------------------------------------------------------
    def keys(self, kind: str | None = None) -> set:
        """Every key made so far; with a kind, that kind's keys without
        it: modes for "decode", (mode, rows_bucket, chunk_bucket) for
        "prefill", (mode, chunk_bucket) for "spec", (mode, length) for
        "chunk" (the JAX engine's cache keys)."""
        if kind is None:
            return set(self._steps)
        return {k[1] if kind == "decode" else k[1:]
                for k in self._steps if k[0] == kind}

    def graph(self, key: tuple) -> torch.cuda.CUDAGraph | None:
        """The key's captured graph (None before its capture, and on the
        CPU)."""
        return self._steps[key].graph

    @property
    def n_captured(self) -> int:
        """Keys whose graph has been captured."""
        return sum(st.graph is not None for st in self._steps.values())

    def _entry(self, key: tuple) -> _Step:
        st = self._steps.get(key)
        if st is None:
            layout, out = _layout(key, self.n_slots)
            n = sum(int(np.prod(shape)) for _, shape in layout)
            dev = torch.zeros(n, dtype=torch.int32, device=self.device)
            host = torch.zeros(n, dtype=torch.int32, pin_memory=self.on_card)
            views, host_views, at = {}, {}, 0
            for name, shape in layout:
                size = int(np.prod(shape))
                views[name] = dev[at: at + size].view(shape)
                host_views[name] = host.numpy()[at: at + size].reshape(shape)
                at += size
            st = _Step(key, dev, host, views, host_views,
                       torch.zeros(out, dtype=torch.int32,
                                   device=self.device))
            self._steps[key] = st
        return st

    def inputs(self, key: tuple) -> dict[str, np.ndarray]:
        """The key's host inputs, zeroed, for the caller to fill before
        `upload`. Waits for the key's previous upload to have left the
        host buffer."""
        st = self._entry(key)
        if st.uploaded is not None:
            st.uploaded.synchronize()
        st.host.zero_()
        return st.host_views

    def upload(self, key: tuple) -> tuple[dict[str, torch.Tensor], int]:
        """Copy the key's host inputs to its device buffer, one copy on
        the current stream; returns the device views and the bytes."""
        st = self._steps[key]
        st.dev.copy_(st.host, non_blocking=self.on_card)
        if self.on_card:
            st.uploaded = torch.cuda.Event()
            st.uploaded.record()
        return st.views, st.host.numel() * st.host.element_size()

    # -- the step --------------------------------------------------------------
    def _step(self, st: _Step, caches: dict, tables: torch.Tensor,
              inputs: dict[str, torch.Tensor]) -> torch.Tensor:
        mode = st.key[1]
        if st.key[0] == "spec":
            return self._verify(mode, caches, tables, inputs)
        return self.step_fn(
            self.rts[mode], self.params, self.cfg, inputs["tokens"], caches,
            tables, q_offset=inputs["q_offset"], kv_len=inputs["kv_len"],
            block_size=self.block_size,
            logit_position=inputs.get("logit_position"),
            rows=inputs.get("rows"),
            slot=inputs["rows"] if st.key[0] == "chunk" else None)

    def _verify(self, mode: str, caches: dict, tables: torch.Tensor,
                inputs: dict[str, torch.Tensor]) -> torch.Tensor:
        """The speculative verification step: greedy ids at every column,
        then draft j (the input at column j) survives iff it equals the
        argmax after column j - 1, lies within the row's dlen, and every
        earlier draft survived (the cumprod). Returns [ids | n_accepted],
        (n_slots, cb + 1) int32."""
        toks, dlen = inputs["tokens"], inputs["dlen"]
        ids = self.step_fn(
            self.rts[mode], self.params, self.cfg, toks, caches, tables,
            q_offset=inputs["q_offset"], kv_len=inputs["kv_len"],
            block_size=self.block_size, sample_all=True)
        cb = toks.shape[1]
        cols = torch.arange(1, cb, device=toks.device)
        m = (ids[:, :-1] == toks[:, 1:]) & (cols[None, :] <= dlen[:, None])
        n_acc = torch.cumprod(m.to(torch.int32), dim=1).sum(dim=1)
        return torch.cat([ids, n_acc[:, None].to(torch.int32)], dim=1)

    def _call(self, st: _Step) -> None:
        st.ids.copy_(self._step(st, self.caches, self.tables, st.views))

    def run(self, key: tuple) -> torch.Tensor:
        """Run the key's step on its static inputs (as last uploaded):
        replay its graph, capturing it first at the key's first use on a
        card; eager on the CPU. Returns the static ids, which the key's
        next run overwrites."""
        st = self._steps[key]
        if not self.capturing:
            self._call(st)
        elif st.graph is None:
            self._capture(st)
        else:
            replay(st.graph, st.launches)
        if self.check_first_runs and key not in self.checks:
            self.checks[key] = {}            # check_replay runs the key too
            self.checks[key] = self.check_replay(key)
        return st.ids

    def capture(self, key: tuple) -> None:
        """Capture `key` ahead of its first use, on zeroed inputs: every
        row has kv_len 0, so the warm-up call writes only to the trash
        block. A key already captured is left as it is."""
        st = self._entry(key)
        if self.capturing and st.graph is None:
            self.inputs(key)
            self.upload(key)
            self._capture(st)

    def _capture(self, st: _Step) -> None:
        st.graph, st.launches = capture(lambda: self._call(st), self._pool,
                                        self.device)

    # -- checks and accounting ---------------------------------------------------
    def check_replay(self, key: tuple) -> dict[str, bool]:
        """Run `key` once as `run` does and once eagerly on clones of the
        same inputs, block table and pool; compare the ids and every
        pool plane bitwise. The pool and the launch counters are left as
        they were. Returns {"ids": equal, plane name: equal, ...}.

        Call it right after a run of `key`, while the device block tables
        still hold the rows that run read: the engine flushes table
        edits before its next dispatch, and a sliding-window stack's
        decode slides blocks that the same step's prefill wrote, so a
        prefill key is checked inside its step (`check_first_runs`). A
        row whose slot was released since reads and writes only the
        trash block. Re-running the step writes the values it wrote
        before into the pool; a recurrent state advances again from
        where the run left it, on both sides alike. Only rows with
        kv_len > 0 are compared, and the pool planes past the trash
        block: pad and idle rows all write there, colliding writes land
        in no fixed order, and only those rows' discarded ids read it.
        The state planes ("ssm") are compared whole: an idle row keeps
        its state. The pool, the state and the key's ids are restored
        afterwards."""
        st = self._steps[key]
        before = ops.all_launch_counters()
        shards = _shards(self.caches)
        saved = [{sub: {n: p.clone() for n, p in planes.items()}
                  for sub, planes in c.items()} for c in shards]
        saved_ids = st.ids.clone()
        clones = [{sub: {n: p.clone() for n, p in planes.items()}
                   for sub, planes in c.items()} for c in saved]
        tables = [t.clone() for t in _shards(self.tables)]
        if not isinstance(self.caches, (list, tuple)):
            clones, tables = clones[0], tables[0]
        want = self._step(st, clones, tables,
                          {n: v.clone() for n, v in st.views.items()})
        got = self.run(key)
        live = st.views["kv_len"] > 0
        same = {"ids": bool(torch.equal(got[live], want[live]))}
        for i, c in enumerate(shards):
            tag = f"shard{i}/" if len(shards) > 1 else ""
            for sub, planes in c.items():
                cut = slice(None) if sub == "ssm" \
                    else slice(TRASH_BLOCK + 1, None)
                for n, p in planes.items():
                    same[tag + n] = bool(torch.equal(
                        p[:, cut], _shards(clones)[i][sub][n][:, cut]))
                    p.copy_(saved[i][sub][n])
        st.ids.copy_(saved_ids)
        after = ops.all_launch_counters()
        ops.add_launches({k: before[k] - after[k] for k in after})
        return same

    def pool_bytes(self) -> int:
        """Bytes the card's allocator holds in the graphs' shared pool
        (0 on the CPU)."""
        return pool_bytes(self._pool)
