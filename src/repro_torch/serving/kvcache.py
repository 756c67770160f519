"""Paged KV-cache bookkeeping for the engine, and the slot-resident state
of recurrent stacks.

Physical KV lives in a pool of fixed-size token blocks; each sequence
owns an ordered block table and grows one block at a time. Admission is
driven by free blocks, and when blocks run out the youngest sequence is
preempted (blocks released, request recomputed later). Physical block 0
is the trash block: pad and inactive-row writes are pointed at it.

Window groups (gemma3-style sliding-window stacks): the descriptor splits
the layers into a global group (window None) and a local group (a window
in tokens), and the manager keeps one block table per group, each
allocating from its own id space over the same pool array (a layer only
touches its own group's rows of a block). Local blocks whose keys have
slid out of every future query's window are freed mid-generation
(`slide_window`), while global blocks stay pinned.

Copy-on-write prefix caching (`prefix_cache=True`): every physical block
carries a refcount per group, and every FULL committed block is
registered in a content-hash index keyed by (group, prefix chain hash)
`h_i = blake2b(h_{i-1}, tokens_of_block_i)`, so identical prefixes map
to identical chains. `attach_prefix` shares the longest cached run at
admission (a windowed group only the resume position's lookback window);
`cow_for_write` forks any shared write target before the write lands;
released registered blocks park in a per-group LRU pool that is
reclaimed before preemption ever triggers.

Speculative decoding rolls rejected draft positions back with
`truncate`: pure block bookkeeping, no cache bytes are touched.

Tiered KV (`host_pool=HostPool(...)`): a registered block evicted from
the LRU is queued for capture to a host pool instead of being dropped,
and a later prefix match may re-admit host-resident blocks, which the
engine restores by an upload into freshly allocated device blocks (rows
holding an unrestored block wait). Host entries are keyed by (group,
chain hash), each holding one block's bytes per plane in the JAX
package's layout, so stores and checksums agree across the two.

Recurrent stacks (ssm, hybrid descriptors) also keep slot-resident
state: one fixed-shape entry a sequence slot, with no token axis
(`SlotPlaneSpec`), whose occupancy `SlotManager` tracks in lockstep with
the block manager's slots. A pure SSM has no paged plane at all: its
block tables then only account tokens.

This is the host side of the JAX package's `serving/kvcache.py`. The
block tables keep a DEVICE mirror of shape (G, n_slots, MB): table
mutations are recorded in a dirty set and flushed by one small in-place
index write per step (`device_tables`), not by a re-upload of the whole
table. Under a serving mesh (the JAX package's `mirror_sharding`) the
table is replicated: one device copy a distinct device of the mesh
(`mirror_devices`), shared by the shards on it, every copy written by the
same one logical flush.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import hashlib
import os

import numpy as np
import torch

TRASH_BLOCK = 0
# worker threads of `HostPool.checksums`, made at their first use
_HASHERS: concurrent.futures.ThreadPoolExecutor | None = None


@dataclasses.dataclass(frozen=True)
class PlaneSpec:
    """One token-granular cache plane, paged into fixed-size blocks; a
    pool leaf is shaped (n_layers, n_total_blocks, block_size,
    *token_shape)."""
    name: str
    n_layers: int
    token_shape: tuple[int, ...]
    dtype: str                          # numpy dtype name

    @property
    def bytes_per_token(self) -> int:
        return int(self.n_layers * np.prod(self.token_shape, dtype=np.int64)
                   * np.dtype(self.dtype).itemsize)


@dataclasses.dataclass(frozen=True)
class SlotPlaneSpec:
    """Slot-resident (non-paged) state: one fixed-shape entry a sequence
    slot, no token axis. A pool leaf is shaped (shape[0], n_slots,
    *shape[1:]): the slot rides axis 1, after the layers."""
    name: str
    shape: tuple[int, ...]              # per-slot shape incl. the layer dim
    dtype: str

    @property
    def bytes_per_slot(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)
                   * np.dtype(self.dtype).itemsize)


@dataclasses.dataclass(frozen=True)
class LayerGroup:
    """One attention-window group of the paged planes' layer axis: a
    "global" group (window None: keys live for the whole sequence) or a
    "local" one (a sliding window in tokens: keys die once they fall out
    of every future query's lookback). Each group gets its own
    per-sequence block table in `BlockManager`."""
    name: str
    window: int | None                  # tokens; None = full attention
    layers: tuple[int, ...]             # indices into the planes' layer axis


@dataclasses.dataclass(frozen=True)
class CacheDescriptor:
    """Cache layout of one model: its paged planes (BlockManager), its
    slot-resident planes (SlotManager), and its window groups (empty =
    one implicit global group). `prefix_cacheable` is False for
    recurrent stacks: cached KV blocks cannot stand in for slot-resident
    state, so sharing them would skip recomputing it."""
    kind: str                           # "gqa" | "mla" | "hybrid" | "ssm"
    planes: tuple[PlaneSpec, ...] = ()
    slot_planes: tuple[SlotPlaneSpec, ...] = ()
    prefix_cacheable: bool = True
    groups: tuple[LayerGroup, ...] = ()

    @property
    def group_windows(self) -> tuple[int | None, ...]:
        """Per-group sliding window (None = global): the BlockManager's
        `group_windows` argument."""
        if not self.groups:
            return (None,)
        return tuple(g.window for g in self.groups)

    def layer_group_map(self, n_layers: int) -> np.ndarray:
        """(n_layers,) int32 map from plane layer index to group index
        (all zeros for the implicit single global group)."""
        out = np.zeros(n_layers, np.int32)
        if self.groups:
            seen: set[int] = set()
            for gi, g in enumerate(self.groups):
                for li in g.layers:
                    assert 0 <= li < n_layers and li not in seen, (gi, li)
                    seen.add(li)
                    out[li] = gi
            assert len(seen) == n_layers, "layer groups must cover the stack"
        return out

    @property
    def paged(self) -> bool:
        return bool(self.planes)

    @property
    def bytes_per_token(self) -> int:
        """Paged-plane bytes a cached token (0 for a pure SSM)."""
        return sum(p.bytes_per_token for p in self.planes)

    @property
    def bytes_per_slot(self) -> int:
        """Slot-resident state bytes a sequence (0 for gqa and mla)."""
        return sum(p.bytes_per_slot for p in self.slot_planes)


@dataclasses.dataclass
class Slot:
    request_id: str | None = None
    length: int = 0
    max_new: int = 0

    @property
    def free(self) -> bool:
        return self.request_id is None


class SlotManager:
    """Occupancy of the slot-resident state side of a recurrent
    descriptor. The engine claims the slot index the BlockManager
    assigned (`claim`), so the two stay in lockstep (the engine's
    admission checks capacity and free blocks)."""

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self.slots = [Slot() for _ in range(n_slots)]

    def claim(self, idx: int, request_id: str, prompt_len: int,
              max_new: int) -> None:
        """Claim a SPECIFIC slot (the one the BlockManager assigned)."""
        assert self.slots[idx].free, f"slot {idx} already claimed"
        self.slots[idx] = Slot(request_id, prompt_len, max_new)

    def release(self, idx: int) -> None:
        self.slots[idx] = Slot()

    def active(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if not s.free]

    def n_free(self) -> int:
        return sum(1 for s in self.slots if s.free)


def _chain_hash(parent: int, tokens: tuple[int, ...]) -> int:
    """Stable content digest of one block's prefix chain link: blake2b over
    the parent digest and the block's tokens as int64 LE bytes (the same
    digest as the JAX package, so keys agree across processes)."""
    h = hashlib.blake2b(int(parent).to_bytes(8, "little", signed=True),
                        digest_size=8)
    for t in tokens:
        h.update(int(t).to_bytes(8, "little", signed=True))
    return int.from_bytes(h.digest(), "little", signed=True)


_ROOT_HASH = int.from_bytes(
    hashlib.blake2b(b"prefix-root", digest_size=8).digest(),
    "little", signed=True)


class HostPool:
    """Second KV tier: host memory holding evicted prefix blocks.

    Entries are keyed by (group, chain hash), the identity the device
    prefix index uses, and each holds one block's bytes per plane as a
    numpy array shaped (group_layers, block_size, *token_shape) (a
    spilled entry's planes view one host buffer of its own, so dropping
    the entry frees its bytes). The tier is INCLUSIVE: restoring
    an entry keeps the host copy, so a restored-then-re-evicted block
    (registered blocks are immutable under COW) needs no second capture,
    and lazily restored lo planes always have a source.

    `max_bytes` bounds the tier with drop-oldest LRU eviction; entries a
    device block still depends on (a queued restore, or a pending lazy
    lo-plane upload) are PINNED and skipped by the eviction scan. Every
    entry carries a blake2b checksum taken at `put`; `verify` re-derives
    it before a restore."""

    def __init__(self, max_bytes: int | None = None):
        self.entries: collections.OrderedDict[
            tuple[int, int], dict[str, np.ndarray]] = collections.OrderedDict()
        self.max_bytes = max_bytes
        self.bytes = 0
        self._pins: collections.Counter = collections.Counter()
        self._sums: dict[tuple[int, int], bytes] = {}
        self._corrupt: set[tuple[int, int]] = set()
        self.stats = {"spilled_blocks": 0, "spilled_bytes": 0,
                      "restored_blocks": 0, "restored_bytes": 0,
                      "dropped_blocks": 0, "loaded_blocks": 0,
                      "corrupt_blocks": 0}

    def __contains__(self, key: tuple[int, int]) -> bool:
        return key in self.entries

    def __len__(self) -> int:
        return len(self.entries)

    @staticmethod
    def entry_bytes(planes: dict[str, np.ndarray]) -> int:
        return sum(a.nbytes for a in planes.values())

    def pin(self, key: tuple[int, int]) -> None:
        assert key in self.entries, key
        self._pins[key] += 1

    def unpin(self, key: tuple[int, int]) -> None:
        assert self._pins[key] > 0, key
        self._pins[key] -= 1
        if self._pins[key] == 0:
            del self._pins[key]

    def pinned(self, key: tuple[int, int]) -> bool:
        return self._pins.get(key, 0) > 0

    @staticmethod
    def checksum(planes: dict[str, np.ndarray]) -> bytes:
        """blake2b digest over a block's plane bytes (names sorted), the
        JAX package's digest."""
        h = hashlib.blake2b(digest_size=16)
        for name in sorted(planes):
            h.update(name.encode())
            h.update(np.ascontiguousarray(planes[name]))   # no copy
        return h.digest()

    @staticmethod
    def checksums(entries: list[dict[str, np.ndarray]]) -> list[bytes]:
        """`checksum` of each entry, taken on worker threads (blake2b
        releases the GIL while it hashes a large buffer): a spill capture
        hashes its blocks at once rather than one after another."""
        global _HASHERS
        if len(entries) < 2:
            return [HostPool.checksum(e) for e in entries]
        if _HASHERS is None:
            _HASHERS = concurrent.futures.ThreadPoolExecutor(
                max_workers=min(8, os.cpu_count() or 1),
                thread_name_prefix="host-tier-checksum")
        return list(_HASHERS.map(HostPool.checksum, entries))

    def put(self, key: tuple[int, int], planes: dict[str, np.ndarray],
            loaded: bool = False, digest: bytes | None = None) -> None:
        """Insert (or refresh) one block's bytes; `loaded` marks entries
        read from a persisted store rather than spilled live; `digest` is
        the planes' `checksum` where the caller has taken it already."""
        if key in self.entries:
            self.bytes -= self.entry_bytes(self.entries.pop(key))
        self.entries[key] = planes
        self._sums[key] = self.checksum(planes) if digest is None else digest
        self._corrupt.discard(key)
        nb = self.entry_bytes(planes)
        self.bytes += nb
        if loaded:
            self.stats["loaded_blocks"] += 1
        else:
            self.stats["spilled_blocks"] += 1
            self.stats["spilled_bytes"] += nb
        self._shrink()

    def get(self, key: tuple[int, int]) -> dict[str, np.ndarray]:
        self.entries.move_to_end(key)        # LRU touch
        return self.entries[key]

    def verify(self, key: tuple[int, int]) -> bool:
        """Re-derive the entry's checksum and compare with the one taken
        at `put`. A mismatch is remembered and counted once; callers treat
        the entry as absent and recompute, never restoring it."""
        if key in self._corrupt:
            return False
        if self._sums.get(key) == self.checksum(self.entries[key]):
            return True
        self._corrupt.add(key)
        self.stats["corrupt_blocks"] += 1
        return False

    def discard(self, key: tuple[int, int]) -> None:
        """Drop one entry outright (corrupt payloads; must be unpinned)."""
        assert not self.pinned(key), key
        self.bytes -= self.entry_bytes(self.entries.pop(key))
        self._sums.pop(key, None)
        self._corrupt.discard(key)

    def _shrink(self) -> None:
        if self.max_bytes is None:
            return
        while self.bytes > self.max_bytes:
            victim = next((k for k in self.entries if not self.pinned(k)),
                          None)
            if victim is None:
                return                       # everything left is pinned
            self.bytes -= self.entry_bytes(self.entries.pop(victim))
            self._sums.pop(victim, None)
            self._corrupt.discard(victim)
            self.stats["dropped_blocks"] += 1


@dataclasses.dataclass
class _Group:
    """One window group's view of a sequence: physical block ids by
    logical index (TRASH_BLOCK = slide-freed hole), the chain hashes of
    the committed or matched full-block prefix, and how many leading
    logical blocks the window has slid past."""
    blocks: list[int] = dataclasses.field(default_factory=list)
    hashes: list[int] = dataclasses.field(default_factory=list)
    slid: int = 0


@dataclasses.dataclass
class _Seq:
    request_id: str
    groups: list[_Group]       # one block table per window group
    length: int = 0            # tokens committed to the cache
    admitted: int = 0          # admission counter (largest == youngest)

    # group 0's views: the only group of a non-windowed descriptor, the
    # global group of a windowed one
    @property
    def blocks(self) -> list[int]:
        return self.groups[0].blocks

    @property
    def hashes(self) -> list[int]:
        return self.groups[0].hashes


class BlockManager:
    """Free-list allocator of fixed-size KV blocks with per-sequence block
    tables (one per window group), per-block refcounts and optional COW
    prefix caching.

    `n_blocks` counts USABLE blocks of each group's id space; physical
    block 0 (trash) is extra, so pools hold `n_total_blocks` blocks.
    Unassigned table entries and slide-freed holes point at the trash
    block."""

    def __init__(self, n_slots: int, block_size: int, n_blocks: int,
                 max_blocks_per_seq: int, prefix_cache: bool = False,
                 group_windows: tuple[int | None, ...] = (None,),
                 device="cpu", host_pool: HostPool | None = None,
                 mirror_devices=()):
        assert block_size > 0 and n_blocks > 0
        assert group_windows and all(w is None or w > 0
                                     for w in group_windows)
        self.n_slots = n_slots
        self.block_size = block_size
        self.n_blocks = n_blocks
        self.max_blocks_per_seq = max_blocks_per_seq
        self.prefix_cache = prefix_cache
        self.group_windows = tuple(group_windows)
        self.n_groups = len(self.group_windows)
        self.device = torch.device(device)
        # pop() hands out low block ids first
        self._free = [list(range(n_blocks, 0, -1))
                      for _ in range(self.n_groups)]
        self.seqs: list[_Seq | None] = [None] * n_slots
        self._admissions = 0
        self._ref = [[0] * (n_blocks + 1) for _ in range(self.n_groups)]
        self._index: dict[tuple[int, int], int] = {}   # (group, hash) -> block
        self._hash_of: dict[tuple[int, int], int] = {}  # (group, block) -> hash
        self._lru: list[collections.OrderedDict[int, None]] = [
            collections.OrderedDict() for _ in range(self.n_groups)]
        self._tables = np.full((self.n_groups, n_slots, max_blocks_per_seq),
                               TRASH_BLOCK, np.int32)
        self._dev_tables: torch.Tensor | None = None
        # the replicated table's other copies, one a further device
        self._mirrors: dict[torch.device, torch.Tensor] = {}
        self.mirror_devices = tuple(d for d in dict.fromkeys(
            map(torch.device, mirror_devices)) if d != self.device)
        self._dirty: dict[tuple[int, int, int], int] = {}
        self.table_h2d_bytes = 0
        self.table_flushes = 0
        self.table_updates = 0
        self.prefix_stats = {"queries": 0, "lookup_tokens": 0,
                             "hit_tokens": 0, "blocks_shared": 0,
                             "cow_forks": 0, "evictions": 0,
                             "host_hit_blocks": 0}
        self.window_freed_blocks = 0     # blocks returned by window slides
        # ---- tiered KV (HostPool) ----
        # host: the second tier; None disables spilling.
        # _spill_queue: (group, block, hash) of LRU-evicted registered
        #   blocks whose bytes must be captured BEFORE the next
        #   cache-writing step (the id is already reallocated: its bytes
        #   are intact only until then); _spill_pending their keys.
        # restore_jobs: (group, dst block, hash, ticket) uploads the
        #   engine drains under the SLO guard.
        # _unrestored: (group, block) -> (ticket, hash) of device blocks
        #   whose bytes have not arrived; rows holding one wait, and a
        #   stale ticket voids the job.
        # _lo_pending: (group, block) -> hash of planar blocks whose hi
        #   planes were restored and whose lo planes wait for the first
        #   FP16 touch (the host entry stays pinned).
        self.host = host_pool if prefix_cache else None
        self._spill_queue: list[tuple[int, int, int]] = []
        self._spill_pending: set[tuple[int, int]] = set()
        self.restore_jobs: collections.deque[tuple[int, int, int, int]] = \
            collections.deque()
        self._unrestored: dict[tuple[int, int], tuple[int, int]] = {}
        self._lo_pending: dict[tuple[int, int], int] = {}
        self._ticket = 0

    # -- pool-level views ------------------------------------------------------
    @property
    def n_total_blocks(self) -> int:
        return self.n_blocks + 1                     # + trash block 0

    @property
    def capacity(self) -> int:
        """Max tokens a single sequence can hold."""
        return self.max_blocks_per_seq * self.block_size

    def free_blocks(self, group: int) -> int:
        """Allocatable blocks of one group's id space: truly free +
        reclaimable LRU-cached."""
        return len(self._free[group]) + len(self._lru[group])

    def n_free_blocks(self) -> int:
        """Allocatable blocks of the tightest group: every group must be
        able to cover a new block."""
        return min(self.free_blocks(g) for g in range(self.n_groups))

    def n_cached_blocks(self) -> int:
        """Unreferenced blocks kept warm in the prefix cache (summed over
        groups)."""
        return sum(len(lru) for lru in self._lru)

    def blocks_in_use(self) -> int:
        """Group-blocks held by live sequences, summed over groups."""
        return sum(self.n_blocks - self.free_blocks(g)
                   for g in range(self.n_groups))

    def utilization(self) -> float:
        return self.blocks_in_use() / (self.n_blocks * self.n_groups)

    def free_block_frac(self) -> float:
        """Allocatable fraction of the tightest group's pool — the
        controller's memory-pressure signal."""
        return self.n_free_blocks() / self.n_blocks

    def group_tables(self) -> np.ndarray:
        """(n_groups, n_slots, max_blocks_per_seq) host table array, one
        table per window group (do not mutate)."""
        return self._tables

    def _set_table(self, g: int, idx: int, j: int, b: int) -> None:
        """Single point of mutation for table entries: the host array and
        the device mirror's dirty set."""
        if self._tables[g, idx, j] != b:
            self._tables[g, idx, j] = b
            if self._dev_tables is not None:
                self._dirty[(g, idx, j)] = int(b)

    def device_tables(self, device=None) -> torch.Tensor:
        """(n_groups, n_slots, max_blocks_per_seq) int32 table array on
        the device (or its copy on `device`, one of `mirror_devices`).
        The first call uploads the whole host array to every copy; later
        calls write only the entries changed since the last flush, in
        place, into every copy: one logical flush, whatever the number of
        copies (the counters count it once)."""
        if self._dev_tables is None:
            self._dev_tables = torch.from_numpy(self._tables.copy()).to(
                self.device)
            for d in self.mirror_devices:
                self._mirrors[d] = self._dev_tables.to(d)
            self.table_h2d_bytes += self._tables.nbytes
            self.table_flushes += 1
        elif self._dirty:
            upd = np.asarray([(g, s, j, b) for (g, s, j), b
                              in self._dirty.items()], np.int64)
            for tab in (self._dev_tables, *self._mirrors.values()):
                dev = torch.from_numpy(upd).to(tab.device)
                tab[dev[:, 0], dev[:, 1], dev[:, 2]] = dev[:, 3].to(
                    torch.int32)
            self.table_h2d_bytes += upd.nbytes
            self.table_flushes += 1
            self.table_updates += len(self._dirty)
            self._dirty.clear()
        if device is None or torch.device(device) == self.device:
            return self._dev_tables
        return self._mirrors[torch.device(device)]

    # -- allocation core -------------------------------------------------------
    def _alloc_block(self, g: int) -> int | None:
        """Pop a free block of group g; when the free list is dry, reclaim
        the least-recently-used cached block (evicting its index entry)."""
        if self._free[g]:
            return self._free[g].pop()
        if self._lru[g]:
            b, _ = self._lru[g].popitem(last=False)
            h = self._hash_of.pop((g, b))
            del self._index[(g, h)]
            self.prefix_stats["evictions"] += 1
            if self.host is not None:
                # spill instead of discard: queue a capture of the
                # block's bytes. A block already in the host tier (a
                # lo-pending one's device lo bytes are garbage) needs
                # none: the tier is inclusive.
                lo = self._lo_pending.pop((g, b), None)
                if lo is not None:
                    self.host.unpin((g, lo))
                if (g, h) not in self.host \
                        and (g, h) not in self._spill_pending:
                    self._spill_queue.append((g, b, h))
                    self._spill_pending.add((g, h))
            return b
        return None

    def _release_block(self, g: int, b: int) -> None:
        """Decref; park registered zero-ref blocks in the group's LRU
        cache, return unregistered ones to the group's free list. A
        zero-ref block whose restore never completed holds garbage: it is
        deregistered and freed (its job dies at the ticket check)."""
        self._ref[g][b] -= 1
        assert self._ref[g][b] >= 0, f"refcount underflow on block {g}/{b}"
        if self._ref[g][b] == 0:
            if (g, b) in self._unrestored:
                self._forget_restore(g, b)
                h = self._hash_of.pop((g, b), None)
                if h is not None:
                    del self._index[(g, h)]
                self._free[g].append(b)
            elif (g, b) in self._hash_of:
                self._lru[g][b] = None       # most-recent end
            else:
                self._free[g].append(b)

    # -- sequence lifecycle ----------------------------------------------------
    def _group_need(self, seq_len: int, window: int | None) -> int:
        """Blocks one group must hold live for a `seq_len`-token sequence:
        the whole logical coverage for a global group, only the lookback
        window's span for a windowed one (everything earlier is
        slide-freed by the time the sequence reaches that length)."""
        nb = -(-max(seq_len, 1) // self.block_size)
        if not window:
            return nb
        q0 = max(seq_len - 1, 0)
        return nb - max(0, (q0 - window + 1) // self.block_size)

    def try_allocate(self, request_id: str, seq_len: int, max_new: int,
                     cached_blocks=0) -> int | None:
        """Claim a slot (no blocks yet: `ensure` grows them chunk by
        chunk). None when no slot is free or some group's free pool
        cannot cover the whole prompt (the admission watermark);
        `cached_blocks` (an int for every group, or one per group as
        `prefix_admit_discount` gives) discounts prefix hits held live by
        other sequences."""
        if seq_len + max_new > self.capacity:
            raise ValueError(
                f"request {request_id}: {seq_len}+{max_new} exceeds paged "
                f"capacity {self.capacity}")
        if any(self._group_need(seq_len + max_new, w) > self.n_blocks
               for w in self.group_windows):
            raise ValueError(
                f"request {request_id}: needs more blocks than a whole "
                f"group pool holds ({self.n_blocks}) — would preempt-thrash "
                f"forever")
        if isinstance(cached_blocks, int):
            cached_blocks = (cached_blocks,) * self.n_groups
        if any(self._group_need(seq_len, w) - c > self.free_blocks(g)
               for g, (w, c) in enumerate(zip(self.group_windows,
                                              cached_blocks))):
            return None
        for i, s in enumerate(self.seqs):
            if s is None:
                self._admissions += 1
                self.seqs[i] = _Seq(
                    request_id, [_Group() for _ in self.group_windows],
                    0, self._admissions)
                return i
        return None

    def slide_window(self, idx: int) -> int:
        """Free every windowed-group block that has slid wholly out of the
        lookback window of all FUTURE queries (the next query sits at
        `seq.length`, so positions <= length - window are dead).
        Exclusively held dead blocks go straight back to the free list and
        leave the prefix index (a slide-freed block is never matched for
        a local group again); blocks a neighbour still shares are only
        decref'd. Returns the number of blocks freed."""
        seq = self.seqs[idx]
        assert seq is not None, idx
        freed = 0
        for gi, (g, w) in enumerate(zip(seq.groups, self.group_windows)):
            if not w:
                continue
            sp = min(max(0, (seq.length - w + 1) // self.block_size),
                     len(g.blocks))
            for j in range(g.slid, sp):
                b = g.blocks[j]
                if b == TRASH_BLOCK:
                    continue
                self._ref[gi][b] -= 1
                assert self._ref[gi][b] >= 0, \
                    f"refcount underflow on block {gi}/{b}"
                if self._ref[gi][b] == 0:
                    if (gi, b) in self._unrestored:
                        self._forget_restore(gi, b)
                    lo = self._lo_pending.pop((gi, b), None)
                    if lo is not None:
                        self.host.unpin((gi, lo))
                    h = self._hash_of.pop((gi, b), None)
                    if h is not None:
                        del self._index[(gi, h)]
                    self._free[gi].append(b)
                    freed += 1
                g.blocks[j] = TRASH_BLOCK
                self._set_table(gi, idx, j, TRASH_BLOCK)
            g.slid = max(g.slid, sp)
        self.window_freed_blocks += freed
        return freed

    def ensure(self, idx: int, n_tokens: int) -> bool:
        """Grow slot `idx`'s block tables (every group) to cover
        [0, n_tokens), sliding windowed groups first so dead local blocks
        fund the growth. All-or-nothing; False when the pool runs dry."""
        seq = self.seqs[idx]
        assert seq is not None, idx
        self.slide_window(idx)
        nb = -(-n_tokens // self.block_size)
        if all(len(g.blocks) >= nb for g in seq.groups):
            return True
        if n_tokens > self.capacity or any(
                max(0, nb - len(g.blocks)) > self.free_blocks(gi)
                for gi, g in enumerate(seq.groups)):
            return False
        for gi, g in enumerate(seq.groups):
            while len(g.blocks) < nb:
                b = self._alloc_block(gi)
                assert b is not None      # guarded by free_blocks above
                self._ref[gi][b] = 1
                self._set_table(gi, idx, len(g.blocks), b)
                g.blocks.append(b)
        return True

    def max_coverable(self, idx: int, start: int, want: int) -> int:
        """Largest take <= want such that `ensure(idx, start + take)` will
        succeed right now (window slides applied first)."""
        seq = self.seqs[idx]
        assert seq is not None, idx
        self.slide_window(idx)
        avail = [self.free_blocks(gi) + len(g.blocks)
                 for gi, g in enumerate(seq.groups)]
        upper = min(start + want, self.capacity)
        bs = self.block_size
        take = 0
        for nb in range(-(-(start + 1) // bs), -(-upper // bs) + 1):
            if any(nb > a for a in avail):
                break
            take = min(nb * bs, upper) - start
        return take

    def set_length(self, idx: int, n_tokens: int) -> None:
        seq = self.seqs[idx]
        assert seq is not None and n_tokens <= len(seq.blocks) * self.block_size
        seq.length = n_tokens

    def truncate(self, idx: int, n_tokens: int) -> int:
        """Un-write the sequence's tail back to `n_tokens`: the
        speculative-decoding rollback of rejected draft positions.

        Every block whose span lies wholly at or after `n_tokens` is
        dropped from every window group through the release path (shared
        blocks survive for their other holders, registered ones park in
        the LRU, the rest go free), and its table entry is pointed at the
        trash block through `_set_table`. No cache bytes are touched:
        reads past `seq.length` are masked by kv_len and the next write
        lands over them. The hash chain is cut back to the full blocks
        still covered, and a kept tail block the cut partly invalidates
        is evicted from the prefix index (a registered block's bytes must
        never change). Slide-freed holes stay holes: the table only
        shortens, and the slide point is clamped to it. Returns the
        group-blocks dropped."""
        seq = self.seqs[idx]
        assert seq is not None and n_tokens >= 0, idx
        bs = self.block_size
        nb = -(-n_tokens // bs)              # blocks still covered
        nfull = n_tokens // bs               # ... of which fully valid
        dropped = 0
        for gi, g in enumerate(seq.groups):
            while len(g.blocks) > nb:
                j = len(g.blocks) - 1
                b = g.blocks.pop()
                if b != TRASH_BLOCK:         # below-slide holes stay holes
                    self._release_block(gi, b)
                    self._set_table(gi, idx, j, TRASH_BLOCK)
                    dropped += 1
            if len(g.hashes) > nfull:
                del g.hashes[nfull:]
                if nfull < nb:
                    b = g.blocks[nb - 1]
                    h = self._hash_of.pop((gi, b), None)
                    if h is not None:
                        del self._index[(gi, h)]
                        self.prefix_stats["evictions"] += 1
                    lo = self._lo_pending.pop((gi, b), None)
                    if lo is not None:
                        self.host.unpin((gi, lo))
            g.slid = min(g.slid, nb)
        seq.length = min(seq.length, n_tokens)
        return dropped

    def release(self, idx: int) -> None:
        """Decref (not free) every block the sequence holds in any group —
        shared blocks survive for their other holders, registered ones go
        to the LRU."""
        seq = self.seqs[idx]
        if seq is None:
            return
        for gi, g in enumerate(seq.groups):
            for b in reversed(g.blocks):
                if b != TRASH_BLOCK:
                    self._release_block(gi, b)
            for j, b in enumerate(g.blocks):
                if b != TRASH_BLOCK:
                    self._set_table(gi, idx, j, TRASH_BLOCK)
        self.seqs[idx] = None

    def youngest(self) -> int | None:
        """Slot of the most recently admitted live sequence (the
        preemption victim), or None when nothing is live."""
        live = [(s.admitted, i) for i, s in enumerate(self.seqs)
                if s is not None]
        return max(live)[1] if live else None

    # -- prefix caching --------------------------------------------------------
    def _match_plan(self, tokens, allow_host: bool = False
                    ) -> tuple[int, list[tuple[int, list[int | None]]],
                               list[int]]:
        """Group-aware longest servable cached prefix of `tokens`:
        (matched tokens m, per group (j_lo, block ids of logical blocks
        [j_lo, m/bs)), chain hashes of the matched full blocks). A
        prefill resuming at q0 = min(m, len(tokens)-1) needs, per group,
        every cached block covering [q0 - window + 1, m); global groups
        need the whole run [0, m) from the root.

        With `allow_host`, hashes absent from the device index but in the
        host tier (or queued for capture: the engine captures before it
        uploads) are servable too; their plan entries are None, and
        `attach_prefix` allocates device blocks and restore jobs for
        them."""
        bs = self.block_size
        empty = [(0, []) for _ in self.group_windows]
        if not self.prefix_cache:
            return 0, empty, []
        host = self.host if allow_host else None

        def servable(gi: int, h: int) -> bool:
            if (gi, h) in self._index:
                return True
            if host is None:
                return False
            # spill-pending hashes are still device bytes; only true
            # host entries need the integrity check
            return (gi, h) in self._spill_pending or self.host_ok(gi, h)

        hashes: list[int] = []
        parent = _ROOT_HASH
        for i in range(min(len(tokens) // bs, self.max_blocks_per_seq)):
            h = _chain_hash(parent, tuple(tokens[i * bs: (i + 1) * bs]))
            hashes.append(h)
            parent = h
        m = len(hashes)
        for gi, w in enumerate(self.group_windows):
            if w:
                continue
            run = 0
            for h in hashes:
                if not servable(gi, h):
                    break
                run += 1
            m = min(m, run)
        while m > 0:
            q0 = min(m * bs, len(tokens) - 1)
            plan: list[tuple[int, list[int | None]]] | None = []
            # a windowed group missing block j rules out every m' in
            # (j, m), so the next candidate is m' = j
            next_m = m - 1
            for gi, w in enumerate(self.group_windows):
                j_lo = 0 if not w else max(0, q0 - w + 1) // bs
                blks: list[int | None] = []
                for j in range(j_lo, m):
                    b = self._index.get((gi, hashes[j]))
                    if b is None and not (host is not None
                                          and servable(gi, hashes[j])):
                        plan = None
                        next_m = min(next_m, j)
                        break
                    blks.append(b)
                if plan is None:
                    break
                plan.append((j_lo, blks))
            if plan is not None:
                return m * bs, plan, hashes[:m]
            m = next_m
        return 0, empty, []

    def lookup_prefix(self, tokens, allow_host: bool = False) -> int:
        """Matched-prefix length in tokens, without side effects: the
        largest offset a prefill could resume at with every group's needed
        blocks cached (on the device, or with `allow_host` restorable from
        the host tier)."""
        return self._match_plan(tokens, allow_host)[0]

    def prefix_admit_discount(self, tokens) -> tuple[int, ...]:
        """Per-group matched blocks held LIVE by other sequences (sharing
        them costs nothing; LRU-parked ones are already counted as free),
        for `try_allocate(cached_blocks=...)`."""
        if not self.prefix_cache:
            return (0,) * self.n_groups
        _, plan, _ = self._match_plan(tokens)
        return tuple(sum(1 for b in blks
                         if b is not None and self._ref[gi][b] > 0)
                     for gi, (_, blks) in enumerate(plan))

    def attach_prefix(self, idx: int, tokens, allow_host: bool = False
                      ) -> int:
        """Share the longest cached servable prefix of `tokens` into
        freshly allocated slot `idx` (incref each matched block, pulling
        zero-ref ones out of the LRU). Windowed groups attach only the
        blocks of the resume position's lookback window and start
        pre-slid below it. Returns the matched token count.

        With `allow_host`, prefix blocks only the host tier holds are
        re-admitted: a fresh device block is allocated and registered for
        each, a restore job is queued, and the block is marked unrestored
        (rows holding one wait for it). If the free pool cannot cover the
        host hits, the match falls back to device blocks only."""
        seq = self.seqs[idx]
        assert seq is not None and not any(g.blocks for g in seq.groups), \
            "attach before ensure"
        if not self.prefix_cache:
            return 0
        m_tokens, plan, hashes = self._match_plan(tokens, allow_host)
        if allow_host:
            # all or nothing: the host hits' fresh blocks come from the
            # free list + LRU MINUS the plan's own LRU-parked device
            # matches (about to be increfed, so not allocatable)
            for gi, (_, blks) in enumerate(plan):
                need = sum(1 for b in blks if b is None)
                lru_held = sum(1 for b in blks
                               if b is not None and self._ref[gi][b] == 0)
                if need > self.free_blocks(gi) - lru_held:
                    m_tokens, plan, hashes = self._match_plan(tokens, False)
                    break
        shared = restored = 0
        # pass 1: incref every device-matched block first, so the host
        # hits' allocations below never reclaim a plan block from the LRU
        for gi, (g, (j_lo, blks)) in enumerate(zip(seq.groups, plan)):
            g.blocks = [TRASH_BLOCK] * j_lo + list(blks)
            g.hashes = list(hashes)
            g.slid = j_lo
            for j, b in enumerate(blks, start=j_lo):
                if b is None:
                    continue
                if self._ref[gi][b] == 0:
                    del self._lru[gi][b]
                self._ref[gi][b] += 1
                self._set_table(gi, idx, j, b)
            shared += len(blks)
        # pass 2: allocate and queue a restore for each host hit
        for gi, (g, (j_lo, blks)) in enumerate(zip(seq.groups, plan)):
            for j, src in enumerate(blks, start=j_lo):
                if src is not None:
                    continue
                b = self._alloc_block(gi)
                assert b is not None, "host-hit feasibility pre-checked"
                h = hashes[j]
                self._ref[gi][b] = 1
                self._index[(gi, h)] = b
                self._hash_of[(gi, b)] = h
                g.blocks[j] = b
                self._set_table(gi, idx, j, b)
                self._ticket += 1
                self._unrestored[(gi, b)] = (self._ticket, h)
                self.restore_jobs.append((gi, b, h, self._ticket))
                if (gi, h) in self.host:
                    self.host.pin((gi, h))   # spill-pending entries are
                else:                        # pinned at capture time
                    assert (gi, h) in self._spill_pending, (gi, h)
                restored += 1
        seq.length = m_tokens
        st = self.prefix_stats
        st["queries"] += 1
        st["lookup_tokens"] += len(tokens)
        st["hit_tokens"] += m_tokens
        st["blocks_shared"] += shared
        st["host_hit_blocks"] += restored
        return m_tokens

    def cow_for_write(self, idx: int, start: int, end: int
                      ) -> list[tuple[int, int, int]] | None:
        """Copy-on-write fork of every shared block the write range
        [start, end) touches, in every group: allocate a private
        replacement in that group's id space, decref the shared original,
        and return (group, src, dst) triples whose bytes — the group's
        layer rows only — the CALLER copies before writing. None when a
        fork cannot be allocated (caller preempts). All-or-nothing;
        slide-freed holes need no fork."""
        seq = self.seqs[idx]
        assert seq is not None and end <= len(seq.blocks) * self.block_size
        span = range(start // self.block_size, -(-end // self.block_size))
        for gi, g in enumerate(seq.groups):
            if sum(1 for bi in span
                   if g.blocks[bi] != TRASH_BLOCK
                   and self._ref[gi][g.blocks[bi]] > 1) \
                    > self.free_blocks(gi):
                return None
        triples: list[tuple[int, int, int]] = []
        for gi, g in enumerate(seq.groups):
            for bi in span:
                src = g.blocks[bi]
                if src == TRASH_BLOCK or self._ref[gi][src] <= 1:
                    continue
                dst = self._alloc_block(gi)
                assert dst is not None        # guarded above
                self._ref[gi][dst] = 1
                self._release_block(gi, src)
                g.blocks[bi] = dst
                self._set_table(gi, idx, bi, dst)
                triples.append((gi, src, dst))
                self.prefix_stats["cow_forks"] += 1
        return triples

    def commit(self, idx: int, n_tokens: int, tokens) -> None:
        """Record that positions [0, n_tokens) hold the KV of
        `tokens[:n_tokens]`, and register every newly FULL block in the
        per-group content-hash index (slide-freed holes extend the hash
        chain but register nothing). `tokens` is the full committed
        stream."""
        self.set_length(idx, n_tokens)
        if not self.prefix_cache:
            return
        seq = self.seqs[idx]
        bs = self.block_size
        for gi, g in enumerate(seq.groups):
            parent = g.hashes[-1] if g.hashes else _ROOT_HASH
            for bi in range(len(g.hashes), n_tokens // bs):
                h = _chain_hash(parent, tuple(tokens[bi * bs: (bi + 1) * bs]))
                b = g.blocks[bi]
                if b != TRASH_BLOCK and (gi, h) not in self._index \
                        and (gi, b) not in self._hash_of:
                    self._index[(gi, h)] = b
                    self._hash_of[(gi, b)] = h
                g.hashes.append(h)
                parent = h

    # -- tiered KV: host offload and restore ------------------------------------
    def _forget_restore(self, g: int, b: int) -> None:
        """Void block (g, b)'s pending restore: drop the ticket (the
        queued job dies at claim time) and release its host-entry pin (a
        job against a still spill-pending entry took none)."""
        _, h = self._unrestored.pop((g, b))
        if (g, h) in self.host and self.host.pinned((g, h)):
            self.host.unpin((g, h))

    def host_ok(self, g: int, h: int) -> bool:
        """Is host entry (g, h) present and integrity-clean? A checksum
        mismatch drops the entry (when unpinned; the restore drain handles
        pinned ones), so later matches recompute."""
        key = (g, h)
        if self.host is None or key not in self.host:
            return False
        if self.host.verify(key):
            return True
        if not self.host.pinned(key):
            self.host.discard(key)
        return False

    def rows_holding(self, g: int, b: int) -> list[int]:
        """Slots whose group-g table references block b: the owners a
        corrupt-restore fallback preempts."""
        return [idx for idx, s in enumerate(self.seqs)
                if s is not None and b in s.groups[g].blocks]

    def purge_block(self, g: int, b: int) -> None:
        """Evict a zero-ref block outright: deregister its content and
        free it (its bytes must never be prefix-matched again)."""
        assert self._ref[g][b] == 0, f"purge of live block {g}/{b}"
        self._lru[g].pop(b, None)
        h = self._hash_of.pop((g, b), None)
        if h is not None:
            del self._index[(g, h)]
        if b not in self._free[g]:
            self._free[g].append(b)

    def abandon_restores(self) -> None:
        """After every row is released (an engine drain): drop the restore
        jobs (all voided: an unrestored block is always held) and purge the
        blocks whose lo planes never landed, unpinning their host entries,
        which stay in the tier. A purged block's device lo bytes are
        garbage, so its content must not be matched on the device again;
        a later match restores it from the host."""
        assert all(s is None for s in self.seqs), "abandon with rows live"
        self.restore_jobs.clear()
        for (g, b), h in list(self._lo_pending.items()):
            del self._lo_pending[(g, b)]
            self.host.unpin((g, h))
            self.purge_block(g, b)

    def take_spills(self) -> list[tuple[int, int, int]]:
        """Drain the (group, block, hash) capture queue; the caller
        captures these blocks' bytes (`store_spill`) BEFORE any
        cache-writing step."""
        out, self._spill_queue = self._spill_queue, []
        self._spill_pending.clear()
        return out

    def store_spill(self, g: int, h: int, planes: dict,
                    digest: bytes | None = None) -> None:
        """Deposit one captured block (and its checksum, if taken) in the
        host tier and apply the pins of restore jobs queued while it was
        spill-pending."""
        self.host.put((g, h), planes, digest=digest)
        pins = sum(1 for (gi, _b), (_t, hh) in self._unrestored.items()
                   if gi == g and hh == h)
        for _ in range(pins):
            self.host.pin((g, h))

    def claim_restore(self, g: int, b: int, h: int, ticket: int) -> bool:
        """True iff a drained restore job is still wanted: the block is
        still attached and the ticket current (a release or preemption
        voids it; the id may since hold something else)."""
        return self._unrestored.get((g, b)) == (ticket, h)

    def finish_restore(self, g: int, b: int, h: int,
                       lo_pending: bool = False) -> None:
        """Mark block (g, b) device-resident again. `lo_pending` (planar
        pools): only the hi planes were uploaded, and the host entry stays
        pinned as the lazy lo source until the first FP16 touch."""
        del self._unrestored[(g, b)]
        if lo_pending:
            self._lo_pending[(g, b)] = h     # inherits the job's pin
        else:
            self.host.unpin((g, h))

    def row_unrestored(self, idx: int) -> bool:
        """Does slot `idx` hold a block whose restore has not landed?"""
        seq = self.seqs[idx]
        if seq is None or not self._unrestored:
            return False
        return any((gi, b) in self._unrestored
                   for gi, g in enumerate(seq.groups) for b in g.blocks)

    def take_lo_pending(self) -> list[tuple[int, int, int]]:
        """Drain every deferred lo-plane upload as (group, block, hash);
        the pins pass to the caller, which unpins after the upload."""
        out = [(g, b, h) for (g, b), h in self._lo_pending.items()]
        self._lo_pending.clear()
        return out

    def take_lo_pending_for(self, pairs) -> list[tuple[int, int, int]]:
        """Drain the lo-plane uploads of specific (group, block) pairs: a
        write into a lo-pending block must not race a later whole-block
        lo upload, which would clobber the fresh bytes."""
        out = []
        for g, b in pairs:
            h = self._lo_pending.pop((g, b), None)
            if h is not None:
                out.append((g, b, h))
        return out

    def lo_pending_in_range(self, idx: int, start: int, end: int
                            ) -> list[tuple[int, int]]:
        """(group, block) pairs with deferred lo planes that the write
        range [start, end) of slot `idx` touches."""
        if not self._lo_pending:
            return []
        seq = self.seqs[idx]
        span = range(start // self.block_size, -(-end // self.block_size))
        return [(gi, g.blocks[bi]) for gi, g in enumerate(seq.groups)
                for bi in span if bi < len(g.blocks)
                and (gi, g.blocks[bi]) in self._lo_pending]

    def mirror_jobs(self) -> list[tuple[int, int, int]]:
        """(group, block, hash) of every registered device block not yet
        in the host tier, for `save_prefix_store` (unrestored blocks hold
        garbage and are hosted already)."""
        if self.host is None:
            return []
        return [(g, b, h) for (g, h), b in self._index.items()
                if (g, h) not in self.host
                and (g, h) not in self._spill_pending
                and (g, b) not in self._unrestored]

    # -- invariant audit (tests, NFP_DEBUG=1) -----------------------------------
    def check_invariants(self) -> None:
        ref = [[0] * (self.n_blocks + 1) for _ in range(self.n_groups)]
        for s in self.seqs:
            if s is None:
                continue
            for gi, g in enumerate(s.groups):
                for b in g.blocks:
                    if b != TRASH_BLOCK:
                        ref[gi][b] += 1
        assert ref == self._ref, (ref, self._ref)
        for gi in range(self.n_groups):
            free, lru = set(self._free[gi]), set(self._lru[gi])
            assert not (free & lru), f"group {gi} block both free and cached"
            for b in range(1, self.n_blocks + 1):
                if self._ref[gi][b] == 0:
                    assert (b in free) ^ (b in lru), \
                        f"zero-ref block {gi}/{b} neither free nor cached " \
                        f"(or both)"
                else:
                    assert b not in free and b not in lru, \
                        f"live block {gi}/{b} on the free/cached list"
        assert set(self._hash_of) == {(g, b) for (g, _h), b
                                      in self._index.items()}
        for (gi, h), b in self._index.items():
            assert self._hash_of[(gi, b)] == h
            assert b not in self._free[gi], \
                f"indexed block {gi}/{b} on the free list"
        for i, s in enumerate(self.seqs):
            for gi in range(self.n_groups):
                row = np.full(self.max_blocks_per_seq, TRASH_BLOCK, np.int32)
                if s is not None:
                    gl = s.groups[gi].blocks
                    row[: len(gl)] = gl
                assert (self._tables[gi, i] == row).all(), \
                    f"stale table row (group {gi}, slot {i})"
            if s is None:
                continue
            for g, w in zip(s.groups, self.group_windows):
                if not w:
                    assert g.slid == 0, "global group slid"
                assert all(b == TRASH_BLOCK for b in g.blocks[: g.slid]), \
                    "live block below the slide point"
                assert all(b != TRASH_BLOCK for b in g.blocks[g.slid:]), \
                    "hole above the slide point"
        # tiered KV: unrestored blocks are held, spill-pending entries are
        # not yet hosted, lo-pending blocks are live or LRU-parked with a
        # hosted and pinned source, and pins and bytes add up exactly
        for (g, b), (_t, h) in self._unrestored.items():
            assert self._ref[g][b] > 0, f"unrestored block {g}/{b} unheld"
            assert b not in self._free[g] and b not in self._lru[g]
        qhashes = {(g, h) for g, _b, h in self._spill_queue}
        assert qhashes == self._spill_pending, \
            (qhashes, self._spill_pending)
        if self.host is not None:
            for g, h in self._spill_pending:
                assert (g, h) not in self.host, \
                    f"spill queued for already-hosted entry {g}/{h}"
            for (g, b), h in self._lo_pending.items():
                assert (g, h) in self.host, f"lo-pending {g}/{b} unsourced"
                assert self.host.pinned((g, h)), f"lo source {g}/{h} unpinned"
                assert self._ref[g][b] > 0 or b in self._lru[g], \
                    f"lo-pending block {g}/{b} neither live nor cached"
            want_pins: collections.Counter = collections.Counter()
            for (g, _b), h in self._lo_pending.items():
                want_pins[(g, h)] += 1
            for (g, _b), (_t, h) in self._unrestored.items():
                if (g, h) in self.host:
                    want_pins[(g, h)] += 1
            assert want_pins == self.host._pins, \
                (dict(want_pins), dict(self.host._pins))
            assert self.host.bytes == sum(
                self.host.entry_bytes(p) for p in self.host.entries.values())
            assert set(self.host._sums) == set(self.host.entries), \
                "host checksum map out of sync with entries"
        if self._dev_tables is not None:
            # debug-only device read: overlay the pending dirty entries
            for tab in (self._dev_tables, *self._mirrors.values()):
                # nfp: ignore[NFP001] opt-in debug sanitizer: auditing the device mirror IS the sync
                mirror = tab.cpu().numpy().copy()
                for (g, s, j), b in self._dirty.items():
                    mirror[g, s, j] = b
                assert (mirror == self._tables).all(), \
                    "device table mirror diverged from the host tables"
