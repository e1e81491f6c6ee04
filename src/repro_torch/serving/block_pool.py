"""Paged-KV block pool + tool-prefix cache (host-side bookkeeping).

The port's copy of `repro.serving.block_pool` (framework-free, kept line for
line so both engines share one allocation policy).

`BlockPool` is the vLLM-style allocator behind the paged serving engine: the
physical KV store is a flat pool of `num_blocks` fixed-size blocks; each slot
maps logical token positions to physical blocks through a block table, and
blocks are refcounted so prompt-prefix blocks can be shared across requests.
Block 0 is reserved as a scratch block — inactive decode rows scatter their
(dead) writes there, so the jitted decode step never needs a validity branch.

`PrefixCache` keys already-prefilled block chains by the exact token prefix
(padded-row tokens, so positions — and therefore RoPE — are part of the key by
construction). One entry per chunk boundary: full `block_size` chunks plus an
optional partial tail covering the whole padded prompt. A lookup returns the
longest cached chain; the caller increfs the chain's blocks into its slot and
prefills only the suffix. The cache holds its own reference on every block it
lists, so entries survive request completion until evicted (LRU, triggered by
allocation pressure).
"""
from __future__ import annotations

# cc-lint: disable-file=CC004 -- this file is the port's block pool itself: its refcount/free-list writes are the pool API that CC004 confines mutation to, as in the JAX package's serving/block_pool.py

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class BlockPool:
    """Refcounted fixed-size block allocator with free-list reuse."""

    def __init__(self, num_blocks: int, block_size: int):
        assert num_blocks >= 2, "need at least one allocatable block + scratch"
        self.num_blocks = num_blocks
        self.block_size = block_size
        # block 0 is the reserved scratch block — never handed out
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self.refcount = np.zeros((num_blocks,), np.int32)

    @property
    def num_free(self) -> int:
        return len(self._free)

    def alloc(self) -> Optional[int]:
        """Take one block (refcount 1); None when the pool is exhausted."""
        if not self._free:
            return None
        bid = self._free.pop()
        assert self.refcount[bid] == 0, f"block {bid} on free list with refs"
        self.refcount[bid] = 1
        return bid

    def incref(self, bid: int):
        assert 0 < bid < self.num_blocks and self.refcount[bid] > 0, bid
        self.refcount[bid] += 1

    def decref(self, bid: int) -> bool:
        """Drop one reference; returns True when the block was freed."""
        assert 0 < bid < self.num_blocks and self.refcount[bid] > 0, bid
        self.refcount[bid] -= 1
        if self.refcount[bid] == 0:
            self._free.append(bid)
            return True
        return False

    def is_shared(self, bid: int) -> bool:
        return self.refcount[bid] > 1


@dataclasses.dataclass
class PrefixEntry:
    tokens: Tuple[int, ...]          # exact padded-row prefix this entry covers
    blocks: List[int]                # physical chain (entry holds 1 ref each)
    cached_len: int                  # tokens covered; last block may be partial
    last_logits: Optional[np.ndarray] = None   # only for whole-row entries
    last_used: int = 0


class PrefixCache:
    """Token-prefix -> prefilled block chain, with LRU eviction.

    Entries are salted by the weight variant that computed them (KV
    projections differ between e.g. Q8 and Q4 trees), so a hot swap never
    serves stale-variant KV; swapping back re-hits the old variant's entries.
    Hit/miss accounting is owned by the caller — a lookup may be retried for
    a deferred admission and must not double-count."""

    def __init__(self, pool: BlockPool):
        self.pool = pool
        self.entries: Dict[tuple, PrefixEntry] = {}
        self._tick = 0
        self.hits = 0
        self.misses = 0

    @staticmethod
    def chunk_lens(total: int, block_size: int) -> List[int]:
        """Candidate prefix lengths for a padded row of `total` tokens: every
        full block boundary, plus the (possibly partial) whole row."""
        lens = list(range(block_size, total + 1, block_size))
        if total % block_size:
            lens.append(total)
        return lens

    def lookup(self, row: Sequence[int],
               salt: Optional[str] = None) -> Optional[PrefixEntry]:
        """Longest cached prefix of `row` (padded-row tokens). The caller owns
        incref'ing the returned chain into its slot."""
        self._tick += 1
        for cl in reversed(self.chunk_lens(len(row), self.pool.block_size)):
            e = self.entries.get((salt, tuple(row[:cl])))
            if e is not None:
                e.last_used = self._tick
                return e
        return None

    def insert(self, row: Sequence[int], blocks: Sequence[int],
               last_logits: Optional[np.ndarray] = None,
               salt: Optional[str] = None):
        """Register every chunk boundary of `row` whose prefix is not yet
        cached. `blocks` is the row's full physical chain; each new entry
        increfs the blocks it lists."""
        self._tick += 1
        bs = self.pool.block_size
        for cl in self.chunk_lens(len(row), bs):
            key = (salt, tuple(row[:cl]))
            if key in self.entries:
                # a re-insert IS a use: without the refresh a prefix that is
                # re-prefilled every admission still looks cold to evict_lru
                # and hot tool prefixes get evicted first under pool pressure
                self.entries[key].last_used = self._tick
                if cl == len(row) and last_logits is not None:
                    self.entries[key].last_logits = last_logits
                continue
            chain = list(blocks[: -(-cl // bs)])
            for bid in chain:
                self.pool.incref(bid)
            self.entries[key] = PrefixEntry(
                tokens=key[1], blocks=chain, cached_len=cl,
                last_logits=last_logits if cl == len(row) else None,
                last_used=self._tick)

    def evict_lru(self) -> bool:
        """Drop the least-recently-used entry that would actually return at
        least one block to the free list; False when no eviction can help.
        Entries whose blocks are all shared (with active slots or other
        entries) are kept — destroying them frees nothing and only costs
        future hits. Nested chain entries cascade: the deepest entry owns an
        exclusive tail block, and dropping it exposes the next one."""
        best = None
        for key, e in self.entries.items():
            if any(self.pool.refcount[b] == 1 for b in e.blocks):
                if best is None or e.last_used < self.entries[best].last_used:
                    best = key
        if best is None:
            return False
        self._drop(best)
        return True

    def clear(self):
        for key in list(self.entries):
            self._drop(key)

    def _drop(self, key):
        e = self.entries.pop(key)
        for bid in e.blocks:
            self.pool.decref(bid)
