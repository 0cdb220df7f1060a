"""Streaming k-way merge of sorted (key, value) iterators.

reference: src/lsm/k_way_merge.zig — the merge engine under compaction and
scans. Sources are ordered by precedence (lower index = newer): when
several sources yield the same key, the newest wins and the rest are
consumed (the reference's deduplication for mutable-beats-immutable).
"""

from __future__ import annotations

import heapq
from typing import Iterable, Iterator, Optional


def k_way_merge(sources: list[Iterable], *,
                reverse: bool = False) -> Iterator[tuple]:
    """Merge sorted (key, value) streams; on duplicate keys the
    lowest-index source wins. `reverse=True` merges descending streams."""
    heap: list = []
    iters = [iter(s) for s in sources]
    sign = -1 if reverse else 1

    def push(i: int) -> None:
        for key, value in iters[i]:
            heapq.heappush(heap, (_Key(key, sign), i, value))
            return

    for i in range(len(iters)):
        push(i)
    last_key: Optional[bytes] = None
    while heap:
        wrapped, i, value = heapq.heappop(heap)
        push(i)
        if last_key is not None and wrapped.key == last_key:
            continue  # older duplicate: newest already emitted
        last_key = wrapped.key
        yield wrapped.key, value


class _Key:
    """Orders keys ascending or descending under one heap."""

    __slots__ = ("key", "sign")

    def __init__(self, key, sign: int):
        self.key = key
        self.sign = sign

    def __lt__(self, other: "_Key") -> bool:
        if self.sign > 0:
            return self.key < other.key
        return self.key > other.key

    def __eq__(self, other) -> bool:
        return self.key == other.key
