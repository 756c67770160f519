"""Paged KV-cache bookkeeping for the engine (dense GQA descriptors).

Physical KV lives in a pool of fixed-size token blocks; each sequence
owns an ordered block table and grows one block at a time. Admission is
driven by free blocks, and when blocks run out the youngest sequence is
preempted (blocks released, request recomputed later). Physical block 0
is the trash block: pad and inactive-row writes are pointed at it.

Copy-on-write prefix caching (`prefix_cache=True`): every physical block
carries a refcount, and every FULL committed block is registered in a
content-hash index keyed by a prefix chain hash
`h_i = blake2b(h_{i-1}, tokens_of_block_i)`, so identical prefixes map to
identical chains. `attach_prefix` shares the longest cached run at
admission; `cow_for_write` forks any shared write target before the
write lands; released registered blocks park in an LRU pool that is
reclaimed before preemption ever triggers.

This is the host side of the JAX package's `serving/kvcache.py`
restricted to one window group (no sliding-window reclamation), with no
host tier. The block tables keep a DEVICE mirror: table mutations are
recorded in a dirty set and flushed by one small in-place index write
per step (`device_tables`), not by a re-upload of the whole table.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib

import numpy as np
import torch

TRASH_BLOCK = 0


@dataclasses.dataclass(frozen=True)
class PlaneSpec:
    """One token-granular cache plane, paged into fixed-size blocks; a
    pool leaf is shaped (n_layers, n_total_blocks, block_size,
    *token_shape)."""
    name: str
    n_layers: int
    token_shape: tuple[int, ...]
    dtype: str                          # numpy dtype name


@dataclasses.dataclass(frozen=True)
class CacheDescriptor:
    """Cache layout of one model: its paged planes."""
    kind: str                           # "gqa"
    planes: tuple[PlaneSpec, ...] = ()


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


@dataclasses.dataclass
class _Seq:
    request_id: str
    blocks: list[int] = dataclasses.field(default_factory=list)
    hashes: list[int] = dataclasses.field(default_factory=list)
    length: int = 0            # tokens committed to the cache
    admitted: int = 0          # admission counter (largest == youngest)


class BlockManager:
    """Free-list allocator of fixed-size KV blocks with per-sequence block
    tables, per-block refcounts and optional COW prefix caching.

    `n_blocks` counts USABLE blocks; physical block 0 (trash) is extra, so
    pools hold `n_total_blocks` blocks. Unassigned table entries point at
    the trash block."""

    def __init__(self, n_slots: int, block_size: int, n_blocks: int,
                 max_blocks_per_seq: int, prefix_cache: bool = False,
                 device="cpu"):
        assert block_size > 0 and n_blocks > 0
        self.n_slots = n_slots
        self.block_size = block_size
        self.n_blocks = n_blocks
        self.max_blocks_per_seq = max_blocks_per_seq
        self.prefix_cache = prefix_cache
        self.device = torch.device(device)
        self._free = list(range(n_blocks, 0, -1))   # pop() -> low ids first
        self.seqs: list[_Seq | None] = [None] * n_slots
        self._admissions = 0
        self._ref = [0] * (n_blocks + 1)
        self._index: dict[int, int] = {}            # chain hash -> block
        self._hash_of: dict[int, int] = {}          # block -> chain hash
        self._lru: collections.OrderedDict[int, None] = \
            collections.OrderedDict()               # unreferenced cached
        self._tables = np.full((n_slots, max_blocks_per_seq), TRASH_BLOCK,
                               np.int32)
        self._dev_tables: torch.Tensor | None = None
        self._dirty: dict[tuple[int, int], int] = {}
        self.table_h2d_bytes = 0
        self.table_flushes = 0
        self.table_updates = 0
        self.prefix_stats = {"queries": 0, "lookup_tokens": 0,
                             "hit_tokens": 0, "blocks_shared": 0,
                             "cow_forks": 0, "evictions": 0}

    # -- pool-level views ------------------------------------------------------
    @property
    def n_total_blocks(self) -> int:
        return self.n_blocks + 1                     # + trash block 0

    @property
    def capacity(self) -> int:
        """Max tokens a single sequence can hold."""
        return self.max_blocks_per_seq * self.block_size

    def free_blocks(self) -> int:
        """Allocatable blocks: truly free + reclaimable LRU-cached."""
        return len(self._free) + len(self._lru)

    def n_cached_blocks(self) -> int:
        return len(self._lru)

    def blocks_in_use(self) -> int:
        return self.n_blocks - self.free_blocks()

    def utilization(self) -> float:
        return self.blocks_in_use() / self.n_blocks

    def free_block_frac(self) -> float:
        """Allocatable fraction of the pool — the controller's
        memory-pressure signal."""
        return self.free_blocks() / self.n_blocks

    def tables(self) -> np.ndarray:
        """(n_slots, max_blocks_per_seq) host table array (do not mutate)."""
        return self._tables

    def _set_table(self, idx: int, j: int, b: int) -> None:
        """Single point of mutation for table entries: the host array and
        the device mirror's dirty set."""
        if self._tables[idx, j] != b:
            self._tables[idx, j] = b
            if self._dev_tables is not None:
                self._dirty[(idx, j)] = int(b)

    def device_tables(self) -> torch.Tensor:
        """(n_slots, max_blocks_per_seq) int32 table array on the device.
        The first call uploads the whole host array; later calls write
        only the entries changed since the last flush, in place."""
        if self._dev_tables is None:
            self._dev_tables = torch.from_numpy(self._tables.copy()).to(
                self.device)
            self.table_h2d_bytes += self._tables.nbytes
            self.table_flushes += 1
            return self._dev_tables
        if self._dirty:
            upd = np.asarray([(s, j, b) for (s, j), b in self._dirty.items()],
                             np.int64)
            dev = torch.from_numpy(upd).to(self.device)
            self._dev_tables[dev[:, 0], dev[:, 1]] = dev[:, 2].to(torch.int32)
            self.table_h2d_bytes += upd.nbytes
            self.table_flushes += 1
            self.table_updates += len(self._dirty)
            self._dirty.clear()
        return self._dev_tables

    # -- allocation core -------------------------------------------------------
    def _alloc_block(self) -> int | None:
        """Pop a free block; when the free list is dry, reclaim the
        least-recently-used cached block (evicting its index entry)."""
        if self._free:
            return self._free.pop()
        if self._lru:
            b, _ = self._lru.popitem(last=False)
            h = self._hash_of.pop(b)
            del self._index[h]
            self.prefix_stats["evictions"] += 1
            return b
        return None

    def _release_block(self, b: int) -> None:
        """Decref; park registered zero-ref blocks in the LRU cache,
        return unregistered ones to the free list."""
        self._ref[b] -= 1
        assert self._ref[b] >= 0, f"refcount underflow on block {b}"
        if self._ref[b] == 0:
            if b in self._hash_of:
                self._lru[b] = None          # most-recent end
            else:
                self._free.append(b)

    # -- sequence lifecycle ----------------------------------------------------
    def blocks_needed(self, seq_len: int) -> int:
        return -(-max(seq_len, 1) // self.block_size)

    def try_allocate(self, request_id: str, seq_len: int, max_new: int,
                     cached_blocks: int = 0) -> int | None:
        """Claim a slot (no blocks yet: `ensure` grows them chunk by
        chunk). None when no slot is free or the free pool cannot cover
        the whole prompt (the admission watermark); `cached_blocks`
        discounts prefix hits held live by other sequences."""
        if seq_len + max_new > self.capacity:
            raise ValueError(
                f"request {request_id}: {seq_len}+{max_new} exceeds paged "
                f"capacity {self.capacity}")
        if self.blocks_needed(seq_len + max_new) > self.n_blocks:
            raise ValueError(
                f"request {request_id}: needs more blocks than the whole "
                f"pool holds ({self.n_blocks}) — would preempt-thrash forever")
        if self.blocks_needed(seq_len) - cached_blocks > self.free_blocks():
            return None
        for i, s in enumerate(self.seqs):
            if s is None:
                self._admissions += 1
                self.seqs[i] = _Seq(request_id, admitted=self._admissions)
                return i
        return None

    def ensure(self, idx: int, n_tokens: int) -> bool:
        """Grow slot `idx`'s block table to cover [0, n_tokens).
        All-or-nothing; False when the pool runs dry."""
        seq = self.seqs[idx]
        assert seq is not None, idx
        nb = -(-n_tokens // self.block_size)
        if len(seq.blocks) >= nb:
            return True
        if n_tokens > self.capacity or nb - len(seq.blocks) > self.free_blocks():
            return False
        while len(seq.blocks) < nb:
            b = self._alloc_block()
            assert b is not None          # guarded by free_blocks above
            self._ref[b] = 1
            self._set_table(idx, len(seq.blocks), b)
            seq.blocks.append(b)
        return True

    def max_coverable(self, idx: int, start: int, want: int) -> int:
        """Largest take <= want such that `ensure(idx, start + take)` will
        succeed right now."""
        seq = self.seqs[idx]
        assert seq is not None, idx
        avail = self.free_blocks() + len(seq.blocks)
        upper = min(start + want, self.capacity)
        bs = self.block_size
        take = 0
        for nb in range(-(-(start + 1) // bs), -(-upper // bs) + 1):
            if nb > avail:
                break
            take = min(nb * bs, upper) - start
        return take

    def set_length(self, idx: int, n_tokens: int) -> None:
        seq = self.seqs[idx]
        assert seq is not None and n_tokens <= len(seq.blocks) * self.block_size
        seq.length = n_tokens

    def release(self, idx: int) -> None:
        """Decref (not free) every block the sequence holds — shared blocks
        survive for their other holders, registered ones go to the LRU."""
        seq = self.seqs[idx]
        if seq is None:
            return
        for b in reversed(seq.blocks):
            self._release_block(b)
        for j in range(len(seq.blocks)):
            self._set_table(idx, j, TRASH_BLOCK)
        self.seqs[idx] = None

    def youngest(self) -> int | None:
        """Slot of the most recently admitted live sequence (the
        preemption victim), or None when nothing is live."""
        live = [(s.admitted, i) for i, s in enumerate(self.seqs)
                if s is not None]
        return max(live)[1] if live else None

    # -- prefix caching --------------------------------------------------------
    def _match(self, tokens) -> tuple[int, list[int], list[int]]:
        """Longest cached full-block prefix of `tokens`: (matched tokens,
        its block ids, their chain hashes)."""
        if not self.prefix_cache:
            return 0, [], []
        bs = self.block_size
        blocks: list[int] = []
        hashes: list[int] = []
        parent = _ROOT_HASH
        for i in range(min(len(tokens) // bs, self.max_blocks_per_seq)):
            h = _chain_hash(parent, tuple(tokens[i * bs: (i + 1) * bs]))
            b = self._index.get(h)
            if b is None:
                break
            blocks.append(b)
            hashes.append(h)
            parent = h
        return len(blocks) * bs, blocks, hashes

    def prefix_admit_discount(self, tokens) -> int:
        """Matched blocks held LIVE by other sequences (sharing them costs
        nothing; LRU-parked ones are already counted as free)."""
        _, blocks, _ = self._match(tokens)
        return sum(1 for b in blocks if self._ref[b] > 0)

    def attach_prefix(self, idx: int, tokens) -> int:
        """Share the longest cached prefix of `tokens` into freshly
        allocated slot `idx` (incref each matched block, pulling zero-ref
        ones out of the LRU). Returns the matched token count."""
        seq = self.seqs[idx]
        assert seq is not None and not seq.blocks, "attach before ensure"
        if not self.prefix_cache:
            return 0
        m_tokens, blocks, hashes = self._match(tokens)
        seq.blocks = list(blocks)
        seq.hashes = list(hashes)
        for j, b in enumerate(blocks):
            if self._ref[b] == 0:
                del self._lru[b]
            self._ref[b] += 1
            self._set_table(idx, j, b)
        seq.length = m_tokens
        st = self.prefix_stats
        st["queries"] += 1
        st["lookup_tokens"] += len(tokens)
        st["hit_tokens"] += m_tokens
        st["blocks_shared"] += len(blocks)
        return m_tokens

    def cow_for_write(self, idx: int, start: int, end: int
                      ) -> list[tuple[int, int]] | None:
        """Copy-on-write fork of every shared block the write range
        [start, end) touches: allocate a private replacement, decref the
        shared original, and return (src, dst) pairs whose bytes the
        CALLER copies before writing. None when a fork cannot be
        allocated (caller preempts). All-or-nothing."""
        seq = self.seqs[idx]
        assert seq is not None and end <= len(seq.blocks) * self.block_size
        span = range(start // self.block_size, -(-end // self.block_size))
        if sum(1 for bi in span if self._ref[seq.blocks[bi]] > 1) \
                > self.free_blocks():
            return None
        pairs: list[tuple[int, int]] = []
        for bi in span:
            src = seq.blocks[bi]
            if self._ref[src] <= 1:
                continue
            dst = self._alloc_block()
            assert dst is not None        # guarded above
            self._ref[dst] = 1
            self._release_block(src)
            seq.blocks[bi] = dst
            self._set_table(idx, bi, dst)
            pairs.append((src, dst))
            self.prefix_stats["cow_forks"] += 1
        return pairs

    def commit(self, idx: int, n_tokens: int, tokens) -> None:
        """Record that positions [0, n_tokens) hold the KV of
        `tokens[:n_tokens]`, and register every newly FULL block in the
        content-hash index. `tokens` is the full committed stream."""
        self.set_length(idx, n_tokens)
        if not self.prefix_cache:
            return
        seq = self.seqs[idx]
        bs = self.block_size
        parent = seq.hashes[-1] if seq.hashes else _ROOT_HASH
        for bi in range(len(seq.hashes), n_tokens // bs):
            h = _chain_hash(parent, tuple(tokens[bi * bs: (bi + 1) * bs]))
            b = seq.blocks[bi]
            if h not in self._index and b not in self._hash_of:
                self._index[h] = b
                self._hash_of[b] = h
            seq.hashes.append(h)
            parent = h

    # -- invariant audit (tests, NFP_DEBUG=1) -----------------------------------
    def check_invariants(self) -> None:
        ref = [0] * (self.n_blocks + 1)
        for s in self.seqs:
            if s is not None:
                for b in s.blocks:
                    ref[b] += 1
        assert ref == self._ref, (ref, self._ref)
        free, lru = set(self._free), set(self._lru)
        assert not (free & lru), "block both free and cached"
        for b in range(1, self.n_blocks + 1):
            if self._ref[b] == 0:
                assert (b in free) ^ (b in lru), \
                    f"zero-ref block {b} neither free nor cached (or both)"
            else:
                assert b not in free and b not in lru, \
                    f"live block {b} on the free/cached list"
        assert set(self._hash_of) == set(self._index.values())
        for h, b in self._index.items():
            assert self._hash_of[b] == h
            assert b not in free, f"indexed block {b} on the free list"
        for i, s in enumerate(self.seqs):
            row = np.full(self.max_blocks_per_seq, TRASH_BLOCK, np.int32)
            if s is not None:
                row[: len(s.blocks)] = s.blocks
            assert (self._tables[i] == row).all(), f"stale table row {i}"
        if self._dev_tables is not None:
            # debug-only device read: overlay the pending dirty entries
            mirror = self._dev_tables.cpu().numpy().copy()
            for (s, j), b in self._dirty.items():
                mirror[s, j] = b
            assert (mirror == self._tables).all(), \
                "device table mirror diverged from the host tables"
