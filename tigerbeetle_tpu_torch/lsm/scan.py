"""Scan trees: ordered, seekable range scans over LSM trees, with union
and intersection combinators.

reference: src/lsm/scan_tree.zig (per-tree merge of memtable + every
on-disk level), scan_merge.zig (k-way union / zig-zag intersection across
scans), scan_builder.zig (composing index conditions), scan_lookup.zig
(resolving matched keys to objects). composite_key.zig's encoding lives in
`composite_key` here: secondary index keys are (field prefix ||
timestamp), so one prefix's matches are a contiguous, timestamp-ordered
key range.
"""

from __future__ import annotations

import bisect
from typing import Iterator, Optional

from .k_way_merge import k_way_merge
from .table import TOMBSTONE
from .tree import Tree
from .zig_zag_merge import zig_zag_intersect


def composite_key(prefix: int, timestamp: int, prefix_size: int) -> bytes:
    """(field value, timestamp) -> big-endian index key (reference:
    src/lsm/composite_key.zig — prefix-major so one field value's matches
    sort by timestamp)."""
    return (prefix.to_bytes(prefix_size, "big")
            + timestamp.to_bytes(8, "big"))


def composite_key_timestamp(key: bytes) -> int:
    return int.from_bytes(key[-8:], "big")


class TreeScan:
    """Seekable ascending scan of one tree over [key_min, key_max].

    Sources: the memtable plus every table whose range intersects; merged
    lazily with newest-first dedupe; tombstones are filtered. Implements
    the SeekableStream protocol for zig-zag intersection."""

    def __init__(self, tree: Tree, key_min: bytes, key_max: bytes,
                 snapshot: Optional[int] = None):
        self.tree = tree
        self.key_min = key_min
        self.key_max = key_max
        # snapshot=None scans the latest state (memtable included);
        # snapshot=s scans the table set visible at op s — the view stays
        # consistent while compaction mutates the levels mid-scan
        # (reference: scans pin a snapshot in manifest_level.zig).
        self.snapshot = snapshot
        self._head: Optional[tuple] = None
        self._exhausted = False
        self._iter = self._merged(key_min)
        self._advance()

    def _sources(self, start: bytes):
        sources = []
        if self.snapshot is None:
            sources.append(sorted(
                (k, v) for k, v in self.tree.memtable.items()
                if start <= k <= self.key_max))
        if self.tree._frozen_visible(self.snapshot):
            # The frozen memtable is table-visible from its freeze op on,
            # even while its flush job is still streaming it out.
            sources.append(sorted(
                (k, v) for k, v in self.tree.immutable_map.items()
                if start <= k <= self.key_max))
        # Levels newest-first; within L0, newest table first (L0 overlaps).
        for level_i, level in enumerate(self.tree.levels):
            entries = level.visible(self.snapshot)
            tables = [e.table for e in
                      (reversed(entries) if level_i == 0 else entries)]
            for table in tables:
                if (table.info.key_max < start
                        or table.info.key_min > self.key_max):
                    continue
                sources.append(_table_range(table, start, self.key_max))
        return sources

    def _merged(self, start: bytes) -> Iterator[tuple]:
        dead = TOMBSTONE * self.tree.value_size
        for key, value in k_way_merge(self._sources(start)):
            if value != dead:
                yield key, value

    def _advance(self) -> None:
        self._head = next(self._iter, None)
        if self._head is None:
            self._exhausted = True

    # ------------------------------------------------- SeekableStream API

    def peek(self) -> Optional[bytes]:
        return self._head[0] if self._head is not None else None

    def peek_value(self) -> Optional[bytes]:
        return self._head[1] if self._head is not None else None

    def next(self) -> None:
        self._advance()

    def seek(self, key: bytes) -> None:
        """Advance to the first key >= `key` (zig-zag leapfrog). Rebuilds
        the merge from the target — each source binary-searches, so a seek
        is O(sources * log n), not a linear drain. Seek only moves forward:
        an exhausted scan stays exhausted (SeekableStream contract)."""
        if self._exhausted or (self._head is not None
                               and self._head[0] >= key):
            return
        self._iter = self._merged(key)
        self._advance()

    def __iter__(self) -> Iterator[tuple]:
        while self._head is not None:
            item = self._head
            self._advance()
            yield item


def _table_range(table, key_min: bytes, key_max: bytes) -> Iterator[tuple]:
    """Lazy (key, value) stream of one table clipped to [key_min, key_max]
    (binary search to the starting block, reference: binary_search.zig)."""
    start_block = max(
        0, bisect.bisect_right(table.block_first_keys, key_min) - 1)
    for i in range(start_block, len(table.block_addresses)):
        if table.block_first_keys[i] > key_max:
            return
        keys, values = table._block_entries(i)
        j = bisect.bisect_left(keys, key_min)
        for key, value in zip(keys[j:], values[j:]):
            if key > key_max:
                return
            yield key, value


def union_scans(scans: list[TreeScan]) -> Iterator[tuple]:
    """Ascending union (OR) of scans, deduplicated by key (reference:
    scan_merge.zig k-way union — e.g. debits OR credits)."""
    return k_way_merge([iter(s) for s in scans])


def intersect_scans(scans: list[TreeScan]) -> Iterator[bytes]:
    """Ascending intersection (AND) via zig-zag leapfrog."""
    return zig_zag_intersect(scans)


def intersect_by_suffix(scans: list[TreeScan]) -> Iterator[int]:
    """Intersect composite-key scans on their TIMESTAMP suffix: each scan
    covers one field prefix's contiguous range, so the suffix stream stays
    ascending and zig-zag applies (reference: multi-index queries join on
    timestamp, src/lsm/scan_builder.zig)."""

    class _Suffix:
        def __init__(self, scan: TreeScan):
            self.scan = scan

        def peek(self):
            head = self.scan.peek()
            return None if head is None else head[-8:]

        def next(self):
            self.scan.next()

        def seek(self, suffix: bytes) -> None:
            head = self.scan.peek()
            if head is None:
                return
            self.scan.seek(head[:-8] + suffix)

    for suffix in zig_zag_intersect([_Suffix(s) for s in scans]):
        yield int.from_bytes(suffix, "big")
