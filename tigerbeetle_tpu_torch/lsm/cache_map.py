"""Bounded set-associative object cache.

The hot-object cache in front of the forest's object trees (reference:
src/lsm/set_associative_cache.zig:1 + src/lsm/cache_map.zig:1): a fixed
sets × ways grid of entries, LRU within each set. Memory is bounded by
construction — at most `sets * ways` cached objects, ever — which is the
static-allocation doctrine applied to the read path
(docs/ARCHITECTURE.md:189-230): serving state no longer needs to fit in
host RAM; misses fall through to the LSM.

Write discipline (reference: the groove object cache is written THROUGH
at commit, src/lsm/groove.zig:1770): mutated objects are upserted after
every durable flush, so a cached entry is always the current value —
reads never need invalidation logic.

Deliberate non-port: the reference CacheMap pairs the cache with a
"stash" map holding entries evicted mid-bar whose mutations are not yet
in the LSM, plus scope open/persist/discard for linked-chain rollback
(src/lsm/cache_map.zig:1-40). Here neither exists by design: mutations
reach this cache only AFTER the durable flush (the LSM below already
holds the truth, so an evicted entry is always re-readable), and
rollback scopes are resolved on device before anything is applied
(ops/create_kernels.py undo log) — there is no mid-bar mutable window
to stash.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

__all__ = ["ObjectCache"]

# Fibonacci hashing spreads sequential ids across sets
# (reference: set_associative_cache.zig uses a permuted tag hash).
_GOLDEN = 0x9E3779B97F4A7C15
_MASK64 = (1 << 64) - 1


class ObjectCache:
    """sets × ways bounded cache: key (u128 int) -> object."""

    def __init__(self, sets: int = 1024, ways: int = 8):
        assert sets > 0 and ways > 0
        self.n_sets = sets
        self.ways = ways
        self._sets: list[OrderedDict] = [OrderedDict() for _ in range(sets)]
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @property
    def capacity(self) -> int:
        return self.n_sets * self.ways

    def __len__(self) -> int:
        return sum(len(s) for s in self._sets)

    def _set_for(self, key: int) -> OrderedDict:
        h = ((key ^ (key >> 64)) * _GOLDEN) & _MASK64
        return self._sets[h % self.n_sets]

    def get(self, key: int):
        s = self._set_for(key)
        value = s.get(key)
        if value is None:
            self.misses += 1
            return None
        s.move_to_end(key)  # LRU within the set
        self.hits += 1
        return value

    def put(self, key: int, value) -> None:
        s = self._set_for(key)
        if key in s:
            s[key] = value
            s.move_to_end(key)
            return
        if len(s) >= self.ways:
            s.popitem(last=False)  # evict set-LRU
            self.evictions += 1
        s[key] = value

    def remove(self, key: int) -> None:
        self._set_for(key).pop(key, None)

    def clear(self) -> None:
        for s in self._sets:
            s.clear()

    def stats(self) -> dict:
        return dict(hits=self.hits, misses=self.misses,
                    evictions=self.evictions, size=len(self),
                    capacity=self.capacity)
