"""In-memory per-level manifest structure over (key range x snapshot range).

reference: src/lsm/manifest_level.zig (the two-dimensional table index a
tree's manifest keeps per level) + src/lsm/manifest.zig TableInfo's
snapshot_min/snapshot_max lifecycle. Every table entry carries the op at
which it became visible (snapshot_min) and the op at which compaction
removed it (snapshot_max, SNAPSHOT_LATEST while live). Removal keeps the
entry queryable for older snapshots: a scan or lookup pinned to snapshot s
sees exactly the tables with snapshot_min <= s < snapshot_max, so an
iterator opened before a compaction installs its outputs keeps reading a
consistent table set while the level mutates around it.

Physical block release is decoupled from logical removal (the reference
frees a removed table's blocks only once no live snapshot can reference
it): `prune(snapshot_oldest)` pops entries whose snapshot_max has fallen
behind the oldest snapshot the caller still serves, and the caller releases
their grid blocks. The tree prunes at bar boundaries with a one-bar
retention window — a pure function of the op sequence, so replicas release
byte-identical block sets (physical determinism, the load-bearing property
of docs/internals/lsm.md:37-91).

Containers are Python lists ordered by key_min (live set) — the by-design
substitution for the reference's segmented arrays (src/lsm/segmented_array
.zig); the history set (removed, unpruned) is small by construction (at
most one bar of removals) and scanned linearly.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Iterator, Optional

SNAPSHOT_LATEST = (1 << 64) - 1


@dataclasses.dataclass
class LevelEntry:
    """One table's manifest entry (reference: manifest.zig TableInfo —
    address/checksum live in lsm/table.py's TableInfo; this adds the
    snapshot dimension). `seq` is the level-local insertion sequence:
    recency for overlapping level-0 tables is decided by it, never by
    snapshot_min (two tables can share a snapshot — e.g. a bar-boundary
    flush plus a checkpoint-time flush at the same op — and a restore
    must not re-derive recency from op numbers)."""

    table: object  # lsm.table.Table
    snapshot_min: int
    snapshot_max: int = SNAPSHOT_LATEST
    seq: int = 0

    @property
    def key_min(self) -> bytes:
        return self.table.info.key_min

    @property
    def key_max(self) -> bytes:
        return self.table.info.key_max

    def visible(self, snapshot: int) -> bool:
        return self.snapshot_min <= snapshot < self.snapshot_max


class ManifestLevel:
    """One level's table index.

    The LIVE set (snapshot_max == SNAPSHOT_LATEST) answers the serving
    path: kept sorted by key_min for disjoint levels (binary-searched
    lookups), in insertion order for level 0 (newest last — L0 tables
    overlap and recency decides). The HISTORY set holds removed entries
    until `prune`; snapshot queries merge both.

    The sequence protocol (len/iter/getitem/reversed) exposes live TABLES
    so existing consumers (scans, scrubber, tests) read the level as
    before.
    """

    def __init__(self, keep_sorted: bool):
        self.keep_sorted = keep_sorted
        self.live: list[LevelEntry] = []
        self.history: list[LevelEntry] = []
        self.next_seq = 0

    # ------------------------------------------------------------ mutation

    def insert(self, table, snapshot: int,
               seq: Optional[int] = None) -> None:
        if seq is None:
            seq = self.next_seq
        self.next_seq = max(self.next_seq, seq + 1)
        entry = LevelEntry(table=table, snapshot_min=snapshot, seq=seq)
        if self.keep_sorted:
            i = bisect.bisect_left(self.live, entry.key_min,
                                   key=lambda e: e.key_min)
            self.live.insert(i, entry)
        else:
            self.live.append(entry)

    def remove(self, table, snapshot: int) -> None:
        """Logical removal: the entry moves to history, visible to
        snapshots < `snapshot`, until pruned."""
        for i, e in enumerate(self.live):
            if e.table is table:
                e.snapshot_max = snapshot
                self.history.append(e)
                del self.live[i]
                return
        raise AssertionError("table not present in level")

    def prune(self, snapshot_oldest: int) -> list:
        """Pop history entries no snapshot >= snapshot_oldest can see;
        returns their tables for physical release."""
        dead = [e for e in self.history if e.snapshot_max <= snapshot_oldest]
        self.history = [e for e in self.history
                        if e.snapshot_max > snapshot_oldest]
        return [e.table for e in dead]

    # ------------------------------------------------------------- queries

    def visible(self, snapshot: Optional[int]) -> list[LevelEntry]:
        """Entries a snapshot sees, ordered like the live set (history
        entries merge in key order / recency order)."""
        if snapshot is None:
            return list(self.live)
        out = [e for e in self.live if e.visible(snapshot)]
        out.extend(e for e in self.history if e.visible(snapshot))
        if self.keep_sorted:
            out.sort(key=lambda e: e.key_min)
        else:
            out.sort(key=lambda e: e.seq)  # oldest first (scan reverses)
        return out

    def lookup(self, key: bytes, snapshot: Optional[int] = None):
        """Tables possibly containing `key`, newest-first. Disjoint levels
        at the latest snapshot binary-search the live set (the hot path);
        everything else filters linearly."""
        if snapshot is None and self.keep_sorted:
            i = bisect.bisect_right(self.live, key,
                                    key=lambda e: e.key_min) - 1
            if i >= 0 and key <= self.live[i].key_max:
                return [self.live[i].table]
            return []
        cands = [e for e in self.visible(snapshot)
                 if e.key_min <= key <= e.key_max]
        cands.sort(key=lambda e: -e.seq)  # newest insertion first
        return [e.table for e in cands]

    def query(self, key_min: bytes, key_max: bytes,
              snapshot: Optional[int] = None) -> list:
        """Tables intersecting [key_min, key_max] at `snapshot`, in the
        level's serving order."""
        return [e.table for e in self.visible(snapshot)
                if not (e.key_max < key_min or e.key_min > key_max)]

    # ------------------------------------------ sequence protocol (live)

    def __len__(self) -> int:
        return len(self.live)

    def __iter__(self) -> Iterator:
        return (e.table for e in self.live)

    def __reversed__(self) -> Iterator:
        return (e.table for e in reversed(self.live))

    def __getitem__(self, i):
        return self.live[i].table

    def entry_for(self, table) -> LevelEntry:
        for e in self.live:
            if e.table is table:
                return e
        raise AssertionError("table not present in level")
