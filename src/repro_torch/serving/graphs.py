"""The serving engine's captured steps: one CUDA graph per step key.

The port's counterpart of the JAX engine's jit caches, with the same
keys, each made at its first use:

- `("decode", mode)`: the batched decode, `(n_slots, 1)` tokens over the
  whole device block table (the JAX engine's `_decode[mode]`);
- `("prefill", mode, rows_bucket, chunk_bucket)`: the fused ragged
  prefill, whose rows gather their block-table rows inside the step
  (the JAX engine's `_fused_cache`).

Each key owns static buffers: one int32 device buffer that packs the
step's inputs (tokens, rows, q_offset, kv_len, logit_position), a host
buffer of the same layout (pinned on a card) from which one copy a step
fills it, and the sampled ids. The step reads the engine's persistent
pool planes and device block table in place; none of these, the
params or the static buffers is ever reallocated, so a graph's baked-in
addresses stay valid.

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
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models import model as M
from repro_torch.serving.kvcache import TRASH_BLOCK


@dataclasses.dataclass
class _Step:
    """One key's static buffers, and its graph once captured."""
    key: tuple
    dev: torch.Tensor                    # packed int32 inputs
    host: torch.Tensor                   # the same layout on the host
    views: dict[str, torch.Tensor]       # name -> view into `dev`
    host_views: dict[str, np.ndarray]    # name -> view into `host`
    ids: torch.Tensor                    # (rows,) int32 sampled ids
    graph: torch.cuda.CUDAGraph | None = None
    launches: dict[str, int] | None = None   # recorded at capture
    uploaded: torch.cuda.Event | None = None


def _layout(key: tuple, n_slots: int) -> list[tuple[str, tuple[int, ...]]]:
    """(name, shape) of each int32 input of a key, in packing order."""
    if key[0] == "decode":
        return [("tokens", (n_slots, 1)), ("q_offset", (n_slots,)),
                ("kv_len", (n_slots,))]
    _, _, rb, cb = key
    return [("tokens", (rb, cb)), ("rows", (rb,)), ("q_offset", (rb,)),
            ("kv_len", (rb,)), ("logit_position", (rb,))]


class StepGraphs:
    """The engine's step keys: static buffers, capture, replay, one pool.

    rts: mode -> Runtime; params, cfg, block_size: as `paged_step` takes
    them; caches: the engine's pool planes; tables: its persistent
    (n_slots, MB) device block table (`BlockManager.device_tables()`)."""

    def __init__(self, rts: dict, params, cfg, caches: dict,
                 tables: torch.Tensor, block_size: int):
        self.rts, self.params, self.cfg = rts, params, cfg
        self.caches, self.tables = caches, tables
        self.block_size = block_size
        self.n_slots = tables.shape[0]
        self.device = tables.device
        self.on_card = self.device.type == "cuda"
        self._steps: dict[tuple, _Step] = {}
        self._pool = torch.cuda.graph_pool_handle() if self.on_card else None

    # -- keys and buffers ------------------------------------------------------
    def keys(self, kind: str | None = None) -> set:
        """Every key made so far; with a kind, that kind's keys without
        it: modes for "decode", (mode, rows_bucket, chunk_bucket) for
        "prefill"."""
        if kind is None:
            return set(self._steps)
        return {k[1:] if kind == "prefill" else k[1]
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
            layout = _layout(key, self.n_slots)
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
                       torch.zeros(layout[0][1][0], dtype=torch.int32,
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
        return M.paged_step(
            self.rts[mode], self.params, self.cfg, inputs["tokens"], caches,
            tables, q_offset=inputs["q_offset"], kv_len=inputs["kv_len"],
            block_size=self.block_size,
            logit_position=inputs.get("logit_position"),
            rows=inputs.get("rows"))

    def _call(self, st: _Step) -> None:
        st.ids.copy_(self._step(st, self.caches, self.tables, st.views))

    def run(self, key: tuple) -> torch.Tensor:
        """Run the key's step on its static inputs (as last uploaded):
        replay its graph, capturing it first at the key's first use on a
        card; eager on the CPU. Returns the static ids, which the key's
        next run overwrites."""
        st = self._steps[key]
        if not self.on_card:
            self._call(st)
        elif st.graph is None:
            self._capture(st)
        else:
            st.graph.replay()
            ops.add_launches(st.launches)
        return st.ids

    def capture(self, key: tuple) -> None:
        """Capture `key` ahead of its first use, on zeroed inputs: every
        row has kv_len 0, so the warm-up call writes only to the trash
        block. A key already captured is left as it is."""
        st = self._entry(key)
        if self.on_card and st.graph is None:
            self.inputs(key)
            self.upload(key)
            self._capture(st)

    def _capture(self, st: _Step) -> None:
        """Warm up and capture on PyTorch's capture stream, one for the
        process, so that the per-stream state made at first use (cuBLAS
        workspaces) is made once, before any capture."""
        graph = torch.cuda.CUDAGraph()
        capture = torch.cuda.graph(graph, pool=self._pool)
        cur = torch.cuda.current_stream(self.device)
        side = capture.capture_stream
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self._call(st)               # this step's own run, eager
        before = ops.all_launch_counters()
        with capture:
            self._call(st)
        after = ops.all_launch_counters()
        st.launches = {k: after[k] - before[k] for k in after}
        ops.add_launches({k: -v for k, v in st.launches.items()})
        cur.wait_stream(side)
        st.graph = graph

    # -- checks and accounting ---------------------------------------------------
    def check_replay(self, key: tuple) -> dict[str, bool]:
        """Run `key` once as `run` does and once eagerly on clones of the
        same inputs, block table and pool; compare the ids and every
        pool plane bitwise. The pool and the launch counters are left as
        they were. Returns {"ids": equal, plane name: equal, ...}.

        Call it right after a step that ran `key`, while the device block
        table still holds that step's rows (the engine flushes table
        edits at the start of the next step): a row whose slot was
        released since reads and writes only the trash block. Re-running
        the step writes the values it wrote before. Only rows with
        kv_len > 0 are compared, and the planes past the trash block:
        pad and idle rows all write there, colliding writes land in no
        fixed order, and only those rows' discarded ids read it."""
        st = self._steps[key]
        before = ops.all_launch_counters()
        saved = {n: p.clone() for n, p in self.caches["attn"].items()}
        clones = {"attn": {n: p.clone() for n, p in saved.items()}}
        want = self._step(st, clones, self.tables.clone(),
                          {n: v.clone() for n, v in st.views.items()})
        got = self.run(key)
        live = st.views["kv_len"] > 0
        same = {"ids": bool(torch.equal(got[live], want[live]))}
        for n, p in self.caches["attn"].items():
            same[n] = bool(torch.equal(p[:, TRASH_BLOCK + 1:],
                                       clones["attn"][n][:, TRASH_BLOCK + 1:]))
            p.copy_(saved[n])
        after = ops.all_launch_counters()
        ops.add_launches({k: before[k] - after[k] for k in after})
        return same

    def pool_bytes(self) -> int:
        """Bytes the card's allocator holds in the graphs' shared pool
        (0 on the CPU)."""
        if self._pool is None:
            return 0
        pool = tuple(self._pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)
