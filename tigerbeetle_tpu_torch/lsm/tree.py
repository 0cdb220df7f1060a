"""One LSM tree: memtable + leveled immutable tables with deterministic
compaction.

reference: src/lsm/tree.zig (mutable/immutable memtables, 7 levels, growth
factor 8 — src/config.zig:162-163), src/lsm/compaction.zig (incremental
merge paced in bars/beats; deterministic pacing is load-bearing for
replica-identical data files), src/lsm/manifest.zig (least-overlap table
selection, docs/internals/lsm.md:93-108).

Pacing model here (incremental; reference:
src/lsm/compaction.zig:289, docs/internals/lsm.md:37-138): `compact_beat()`
is called once per committed op (the reference's beat). At each bar
boundary the mutable memtable FREEZES (mutable/immutable swap,
tree.zig:543) and one compaction JOB is scheduled per over-budget level;
both kinds of work then spread evenly across the bar's remaining beats.
The frozen memtable streams value blocks to the grid each beat but its
tables INSTALL only at completion; compaction merges in memory and writes
only at its completing beat. Either way no manifest ever references
partial state: checkpoints drain in-flight work first (manifest_pack),
and blocks written by an abandoned mid-bar job are unreferenced (freed at
the next checkpoint). The last beat of the bar drains whatever remains,
so a bar always ends with its scheduled work installed. All decisions are
pure functions of the op sequence — byte-deterministic across replicas
(tested), including across a crash/replay."""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional

from .grid import Grid
from .manifest_level import SNAPSHOT_LATEST, ManifestLevel
from .table import (
    Table,
    TableInfo,
    TOMBSTONE,
    release_table,
    table_block_bound,
    table_entry_max,
    value_block_entry_max,
    write_index_block,
    write_tables,
    write_value_block,
)

LSM_LEVELS = 7
GROWTH_FACTOR = 8
BAR_LENGTH = 32  # ops per bar (reference: lsm_compaction_ops)
L0_TABLES_MAX = 4


@dataclasses.dataclass
class _FlushJob:
    """The frozen (immutable) memtable being written out incrementally
    (reference: the mutable/immutable memtable pair, src/lsm/tree.zig +
    table_memory.zig — the immutable side streams to disk across the
    bar's beats while staying readable)."""

    entries: list  # sorted (key, value)
    snapshot: int  # freeze op: installed tables carry this snapshot_min
    pos: int = 0
    # Current table's completed value blocks: (address, size, first_key).
    blocks: list = dataclasses.field(default_factory=list)
    infos: list = dataclasses.field(default_factory=list)
    # Worst-case grid reservation claimed at freeze (free_set.zig:28-35).
    reservation: object = None


@dataclasses.dataclass
class _CompactionJob:
    """One level's in-flight incremental merge: input tables captured at
    schedule time, merge advanced a bounded number of entries per beat,
    output written + installed only at completion."""

    level: int
    table: Table
    overlapping: list[Table]
    total: int  # input entries (pacing estimate)
    merged: dict = dataclasses.field(default_factory=dict)
    streams: list = dataclasses.field(default_factory=list)
    stream_i: int = 0
    # Worst-case grid reservation claimed at schedule (free_set.zig:28-35).
    reservation: object = None

    def advance(self, budget: Optional[int]):
        """Merge up to `budget` INPUT entries (None = drain). Returns
        (done, used): done when the inputs are exhausted (caller
        finalizes); used = entries consumed, which the caller charges
        against the beat budget (NOT merged-dict growth — duplicate-key
        merges consume entries without growing the dict)."""
        used = 0
        while self.stream_i < len(self.streams):
            stream = self.streams[self.stream_i]
            for k, v in stream:
                self.merged[k] = v
                used += 1
                if budget is not None and used >= budget:
                    return False, used
            self.stream_i += 1
        return True, used


class Tree:
    def __init__(self, grid: Grid, *, key_size: int, value_size: int,
                 name: str = "tree", tree_id: int = 0):
        self.grid = grid
        self.key_size = key_size
        self.value_size = value_size
        self.name = name
        # Stamped into every block this tree writes (lsm/schema.py);
        # 0 = standalone. The forest assigns deterministic ids.
        self.tree_id = tree_id
        self.memtable: dict[bytes, bytes] = {}
        # Frozen previous memtable: readable while its flush job streams
        # it into level-0 tables across the bar's beats.
        self.immutable_map: dict[bytes, bytes] = {}
        self._flush: Optional[_FlushJob] = None
        self._flush_per_beat = 0
        # Per-level manifest structures over (key range x snapshot range)
        # (reference: src/lsm/manifest_level.zig). L0 tables overlap
        # (insertion order, recency decides); deeper levels are disjoint
        # per snapshot (key_min order, binary-searched).
        self.levels: list[ManifestLevel] = [
            ManifestLevel(keep_sorted=(i > 0)) for i in range(LSM_LEVELS)]
        self.beat = 0
        # In-flight incremental compaction jobs (scheduled at bar start,
        # advanced per beat, drained by bar end).
        self._jobs: list[_CompactionJob] = []
        self._per_beat = 0

    # ------------------------------------------------------------- updates

    def put(self, key: bytes, value: bytes) -> None:
        assert len(key) == self.key_size and len(value) == self.value_size
        self.memtable[key] = value

    def remove(self, key: bytes) -> None:
        assert len(key) == self.key_size
        self.memtable[key] = TOMBSTONE * self.value_size

    def get(self, key: bytes,
            snapshot: Optional[int] = None) -> Optional[bytes]:
        """Point lookup. snapshot=None serves the latest state (memtable
        included); snapshot=s reads the table set visible at op s — a
        point-in-time view that stays consistent while compaction installs
        and removes tables around it (valid within the tree's one-bar
        retention window; reference: manifest snapshot queries,
        src/lsm/manifest_level.zig)."""
        value = self.memtable.get(key) if snapshot is None else None
        if value is None and self._frozen_visible(snapshot):
            # The frozen memtable became logically table-visible at its
            # freeze op: snapshots at or past it must read it even while
            # the flush job is still streaming it out (otherwise the same
            # (key, snapshot) would answer differently before and after
            # the install).
            value = self.immutable_map.get(key)
        if value is None:
            # L0 tables may overlap: newest-first probe; deeper levels
            # yield at most one candidate per snapshot (binary-searched on
            # the live set for the latest snapshot).
            for level in self.levels:
                for table in level.lookup(key, snapshot):
                    value = table.get(key)
                    if value is not None:
                        break
                if value is not None:
                    break
        if value is None or value == TOMBSTONE * self.value_size:
            return None
        return value

    def get_many(self, keys, snapshot: Optional[int] = None) -> dict:
        """Batched point lookups: per level, every unresolved key's value
        block is issued in ONE concurrent fan-out (Grid.read_blocks),
        then resolved in place — a cold cache costs one round trip per
        level touched, not one per key (reference: the prefetch fan-out,
        src/lsm/groove.zig:996,1339). Returns {key: value} for keys
        found live (tombstoned/missing keys are absent)."""
        found: dict = {}
        remaining = []
        for key in keys:
            value = self.memtable.get(key) if snapshot is None else None
            if value is None and self._frozen_visible(snapshot):
                value = self.immutable_map.get(key)
            if value is not None:
                found[key] = value
            else:
                remaining.append(key)
        plans: dict = {}  # key -> [(table, blk)] planned by the lookahead
        for li, level in enumerate(self.levels):
            if not remaining:
                break
            # Per-key candidate queues (L0 may yield several overlapping
            # tables, newest first; deeper levels at most one). The
            # previous level's lookahead already planned (table, block)
            # pairs for this level — reuse them instead of re-probing.
            active = []
            for key in remaining:
                cand = plans.get(key)
                if cand is None:
                    cand = [(t, t.block_for(key))
                            for t in level.lookup(key, snapshot)]
                if cand:
                    active.append((key, cand))
            # Overlap: submit the NEXT level's candidate blocks (planned
            # read-free) while THIS level's fan-out resolves — a superset
            # read-ahead (keys resolved here waste their submit) bounded
            # by the grid's in-flight cap; no-op on synchronous devices.
            plans = {}
            if li + 1 < len(self.levels) and active:
                lookahead = []
                for key, _ in active:
                    cand2 = [(t, t.block_for(key)) for t in
                             self.levels[li + 1].lookup(key, snapshot)]
                    if cand2:
                        plans[key] = cand2
                        lookahead.extend(
                            b for _, b in cand2 if b is not None)
                if lookahead:
                    self.grid.prefetch_async(lookahead)
            while active:
                reqs, slots, nxt = [], [], []
                for key, cand in active:
                    blk = None
                    while cand and blk is None:
                        table, blk = cand.pop(0)
                    if blk is None:
                        continue
                    reqs.append(blk)
                    slots.append((key, table, cand))
                if not reqs:
                    break
                for (key, table, cand), raw in zip(
                        slots, self.grid.read_blocks(reqs)):
                    value = table.get_in_block(key, raw)
                    if value is not None:
                        found[key] = value  # tombstones shadow deeper levels
                    elif cand:
                        nxt.append((key, cand))
                active = nxt
            remaining = [k for k in remaining if k not in found]
        dead = TOMBSTONE * self.value_size
        return {k: v for k, v in found.items() if v != dead}

    def scan(self, key_min: bytes, key_max: bytes,
             snapshot: Optional[int] = None) -> list[tuple[bytes, bytes]]:
        """Merged range scan, newest version wins (streaming k-way merge
        over memtable + levels — reference: scan_tree.zig; the lazy
        iterator API is lsm/scan.py's TreeScan)."""
        from .scan import TreeScan

        return list(TreeScan(self, key_min, key_max, snapshot=snapshot))

    # ---------------------------------------------------------- compaction

    def compact_beat(self, op: Optional[int] = None) -> None:
        """One beat. At a bar boundary: flush the memtable and SCHEDULE one
        compaction job per over-budget level; on every beat, advance the
        in-flight jobs by a bounded number of merged entries (total work /
        remaining beats), deferring grid writes to each job's completion;
        the bar's last beat drains the rest. Deterministic in the op
        sequence (no clocks, no randomness). When `op` is given, the bar
        phase is derived from the op number itself so a restarted replica
        replaying the WAL suffix hits the exact same flush and merge
        points as one that never crashed (the reference derives compaction
        pacing from op % lsm_compaction_ops the same way,
        docs/internals/lsm.md:37-91)."""
        self.beat = self.beat + 1 if op is None else op
        phase = self.beat % BAR_LENGTH
        if phase == 0:
            self._drain_flush()  # defensive: the previous freeze is done
            self._freeze_memtable()
            self._drain_jobs()  # defensive: a bar never leaves work behind
            # Physically release tables removed at least one full bar ago
            # (snapshot reads within the retention window stay valid; a
            # pure function of the op sequence, so every replica frees the
            # identical block set — physical determinism).
            self._prune(self.beat - BAR_LENGTH)
            self._schedule_jobs()
        if self._flush is not None:
            if phase == BAR_LENGTH - 1:
                self._drain_flush()
            else:
                self._advance_flush(self._flush_per_beat)
        if self._jobs:
            if phase == BAR_LENGTH - 1:
                self._drain_jobs()
            else:
                self._advance_jobs(self._per_beat)

    def flush_memtable(self) -> None:
        """Synchronous freeze + drain (checkpoints and callers that need
        every row table-resident NOW; the beat path streams instead)."""
        self._freeze_memtable()
        self._drain_flush()

    # -------------------------------------------------- memtable flushing

    def _frozen_visible(self, snapshot: Optional[int]) -> bool:
        """Is the frozen memtable part of the view at `snapshot`?"""
        if snapshot is None:
            return True
        return self._flush is not None and snapshot >= self._flush.snapshot

    def _freeze_memtable(self) -> None:
        """Swap mutable -> immutable (reference tree.zig:543): the frozen
        rows stay readable from `immutable_map` while a flush job streams
        them into level-0 tables across the bar's beats."""
        if not self.memtable:
            return
        self._drain_flush()  # at most one frozen memtable at a time
        # Reserve BEFORE the swap: a "grid full" reserve failure must
        # leave the tree unchanged (a post-swap failure would strand the
        # frozen rows with no flush job and lose them at the next freeze).
        entries = sorted(self.memtable.items())
        reservation = self.grid.reserve(table_block_bound(
            self.grid, len(entries), self.key_size, self.value_size))
        self.immutable_map = self.memtable
        self.memtable = {}
        self._flush = _FlushJob(
            entries=entries,
            snapshot=self.beat,
            reservation=reservation)
        self._flush_per_beat = max(
            1, -(-len(self._flush.entries) // (BAR_LENGTH - 1)))

    def _advance_flush(self, budget: Optional[int]) -> None:
        """Write up to `budget` entries (whole value blocks; None = all).
        Value blocks hit the grid each beat, but tables INSTALL only at
        job completion: the mid-bar blocks stay unreferenced from any
        manifest, and checkpoints drain the job first (manifest_pack ->
        flush_memtable), so no checkpoint ever references a partial
        table."""
        job = self._flush
        if job is None:
            return
        per_block = value_block_entry_max(self.grid, self.key_size,
                                          self.value_size)
        cap = table_entry_max(self.grid, self.key_size, self.value_size)
        while job.pos < len(job.entries):
            if budget is not None and budget <= 0:
                return
            table_end = min(len(job.entries),
                            (job.pos // cap + 1) * cap)
            chunk = job.entries[job.pos:min(job.pos + per_block, table_end)]
            job.blocks.append(write_value_block(
                self.grid, chunk, reservation=job.reservation,
                tree_id=self.tree_id))
            job.pos += len(chunk)
            if budget is not None:
                budget -= len(chunk)
            if job.pos == table_end:
                job.infos.append(self._finish_flush_table(job, cap))
        # All entries written: install every produced table.
        for info in job.infos:
            self.levels[0].insert(
                Table(self.grid, info, self.key_size, self.value_size),
                snapshot=job.snapshot)
        if job.reservation is not None:
            self.grid.forfeit(job.reservation)
        self.immutable_map = {}
        self._flush = None

    def _finish_flush_table(self, job: _FlushJob, cap: int) -> TableInfo:
        index_addr, index_size = write_index_block(
            self.grid, job.blocks, reservation=job.reservation,
            tree_id=self.tree_id)
        first_key = job.blocks[0][2]
        # job.pos sits at this table's end; recover its entry range.
        start = (job.pos - 1) // cap * cap
        info = TableInfo(
            index_address=index_addr, index_size=index_size,
            key_min=first_key, key_max=job.entries[job.pos - 1][0],
            entry_count=job.pos - start)
        job.blocks = []
        return info

    def _drain_flush(self) -> None:
        self._advance_flush(None)

    def _prune(self, snapshot_oldest: int) -> None:
        for level in self.levels:
            for table in level.prune(snapshot_oldest):
                release_table(self.grid, table)

    def _level_budget(self, level: int) -> int:
        if level == 0:
            return L0_TABLES_MAX
        return GROWTH_FACTOR ** level

    def _schedule_jobs(self) -> None:
        """One job per over-budget level, inputs captured now (they stay
        installed and readable until the job completes). A level whose
        pick or overlap set intersects an earlier job's captured tables
        is SKIPPED this bar (adjacent over-budget levels would otherwise
        double-release a shared level-(L+1) table); it reschedules next
        bar — deterministic either way."""
        assert not self._jobs
        jobs: list[_CompactionJob] = []
        claimed: set[int] = set()  # id() of captured Table objects
        for level in range(LSM_LEVELS - 1):
            if len(self.levels[level]) > self._level_budget(level):
                table = self._pick_table(level)
                overlapping = [
                    t for t in self.levels[level + 1]
                    if not (t.info.key_max < table.info.key_min
                            or t.info.key_min > table.info.key_max)]
                touched = [table, *overlapping]
                if any(id(t) in claimed for t in touched):
                    continue
                claimed.update(id(t) for t in touched)
                total = (table.info.entry_count
                         + sum(t.info.entry_count for t in overlapping))
                job = _CompactionJob(
                    level=level, table=table,
                    overlapping=overlapping, total=total,
                    reservation=self.grid.reserve(table_block_bound(
                        self.grid, total, self.key_size, self.value_size)))
                # Older tables first so the newer input wins the merge.
                job.streams = [t.iter_entries() for t in overlapping]
                job.streams.append(table.iter_entries())
                # Warm the first input block of every stream now: the
                # device reads run during the beats before the job's
                # first advance (iter_entries read-ahead covers the
                # rest of each table).
                self.grid.prefetch_async(
                    [(t.block_addresses[0], t.block_sizes[0])
                     for t in touched if t.block_addresses])
                jobs.append(job)
        self._jobs = jobs
        total = sum(j.total for j in jobs)
        self._per_beat = max(1, -(-total // (BAR_LENGTH - 1)))

    def _advance_jobs(self, budget: int) -> None:
        while budget > 0 and self._jobs:
            job = self._jobs[0]
            done, used = job.advance(budget)
            if done:
                self._finalize_job(job)
                self._jobs.pop(0)
            budget -= max(1, used)

    def _drain_jobs(self) -> None:
        for job in self._jobs:
            done, _ = job.advance(None)
            assert done
            self._finalize_job(job)
        self._jobs = []

    def _finalize_job(self, job: _CompactionJob) -> None:
        """Write output tables, install, logically remove inputs — the
        only beat that touches the grid (mid-bar checkpoints therefore
        never see a partially-written compaction). Inputs move to the
        manifest's history (snapshot_max = this op) and stay readable for
        snapshots taken before this beat; their blocks are freed by
        `_prune` a bar later."""
        level = job.level
        self.levels[level].remove(job.table, snapshot=self.beat)
        next_level = self.levels[level + 1]
        for t in job.overlapping:
            next_level.remove(t, snapshot=self.beat)
        last_level = level + 1 == LSM_LEVELS - 1
        dead = TOMBSTONE * self.value_size
        entries = sorted(
            (k, v) for k, v in job.merged.items()
            if not (last_level and v == dead))  # tombstones die at the bottom
        if entries:
            # A merge output exceeding one table's capacity splits into
            # several disjoint tables (all still inside next_level's range).
            for info in write_tables(self.grid, entries, self.key_size,
                                     self.value_size,
                                     reservation=job.reservation,
                                     tree_id=self.tree_id):
                next_level.insert(Table(
                    self.grid, info, self.key_size, self.value_size),
                    snapshot=self.beat)
        if job.reservation is not None:
            self.grid.forfeit(job.reservation)

    def _pick_table(self, level: int) -> Table:
        """Selection policy: L0 tables overlap each other, so only the
        OLDEST may move down (a newer table would otherwise be shadowed by
        stale data left behind). Deeper levels are disjoint; pick by least
        overlap with the next level, ties on smallest key_min for
        determinism (reference: docs/internals/lsm.md:93-108)."""
        if level == 0:
            return self.levels[0][0]

        def overlap(table: Table) -> int:
            return sum(
                1 for t in self.levels[level + 1]
                if not (t.info.key_max < table.info.key_min
                        or t.info.key_min > table.info.key_max))

        return min(self.levels[level],
                   key=lambda t: (overlap(t), t.info.key_min))

    # ------------------------------------------------------------ manifest

    def manifest_pack(self) -> bytes:
        """Serialize the level structure AND any in-flight compaction
        jobs (reference: manifest log replay). Persisting the job plans
        is load-bearing for physical determinism: a mid-bar checkpoint
        precedes the bar-end install, so a replica restarting from it
        must resume the SAME merges (same inputs, same install beat) a
        never-crashed replica completes — the merge output is a pure
        function of the inputs, so the grids stay byte-identical even
        though the restarted replica redoes the merge work."""
        self.flush_memtable()
        # The beat is persisted so a restored tree keeps stamping snapshots
        # and pruning on the same op clock (a reset-to-zero beat would
        # invert level-0 recency for post-restore flushes and re-extend
        # the retention window).
        parts = [struct.pack("<QB", self.beat, LSM_LEVELS)]
        for level in self.levels:
            entries = list(level.live) + list(level.history)
            # next_seq is persisted (not re-derived from surviving
            # entries): once the max-seq entry is pruned, a re-derived
            # counter would diverge from never-restarted replicas and
            # break byte-identical checkpoints.
            parts.append(struct.pack("<QI", level.next_seq, len(entries)))
            for e in entries:
                parts.append(struct.pack("<QQQ", e.snapshot_min,
                                         e.snapshot_max, e.seq))
                parts.append(e.table.info.pack())
        parts.append(struct.pack("<I", len(self._jobs)))
        for job in self._jobs:
            parts.append(struct.pack("<BI", job.level, len(job.overlapping)))
            parts.append(job.table.info.pack())
            for t in job.overlapping:
                parts.append(t.info.pack())
        return b"".join(parts)

    def manifest_restore(self, raw: bytes) -> None:
        from .manifest_level import LevelEntry

        beat, n_levels = struct.unpack_from("<QB", raw)
        assert n_levels == LSM_LEVELS
        self.beat = beat
        pos = 9
        self.levels = [ManifestLevel(keep_sorted=(i > 0))
                       for i in range(LSM_LEVELS)]
        for level in range(n_levels):
            next_seq, count = struct.unpack_from("<QI", raw, pos)
            pos += 12
            for _ in range(count):
                snap_min, snap_max, seq = struct.unpack_from(
                    "<QQQ", raw, pos)
                pos += 24
                info, pos = TableInfo.unpack(raw, pos)
                table = Table(self.grid, info, self.key_size,
                              self.value_size)
                if snap_max == SNAPSHOT_LATEST:
                    self.levels[level].insert(table, snapshot=snap_min,
                                              seq=seq)
                else:
                    self.levels[level].history.append(LevelEntry(
                        table=table, snapshot_min=snap_min,
                        snapshot_max=snap_max, seq=seq))
            self.levels[level].next_seq = next_seq
        self.memtable.clear()
        self.immutable_map = {}
        self._flush = None
        # Rebuild in-flight jobs against the RESTORED Table objects
        # (identity matters: finalize removes job tables from the level
        # lists by identity). Merge progress restarts from zero — the
        # output is input-deterministic, so only pacing differs.
        self._jobs = []
        if pos < len(raw):
            (n_jobs,) = struct.unpack_from("<I", raw, pos)
            pos += 4
            for _ in range(n_jobs):
                level, n_over = struct.unpack_from("<BI", raw, pos)
                pos += 5
                t_info, pos = TableInfo.unpack(raw, pos)
                over_infos = []
                for _ in range(n_over):
                    info, pos = TableInfo.unpack(raw, pos)
                    over_infos.append(info)

                def resident(lvl: int, info: TableInfo) -> Table:
                    for t in self.levels[lvl]:
                        if (t.info.index_address == info.index_address
                                and t.info.index_size == info.index_size):
                            return t
                    raise AssertionError(
                        f"job table missing from restored level {lvl}")

                table = resident(level, t_info)
                overlapping = [resident(level + 1, i) for i in over_infos]
                total = (table.info.entry_count
                         + sum(t.info.entry_count for t in overlapping))
                job = _CompactionJob(
                    level=level, table=table,
                    overlapping=overlapping, total=total,
                    reservation=self.grid.reserve(table_block_bound(
                        self.grid, total, self.key_size, self.value_size)))
                job.streams = [t.iter_entries() for t in overlapping]
                job.streams.append(table.iter_entries())
                self._jobs.append(job)
            total = sum(j.total for j in self._jobs)
            self._per_beat = max(1, -(-total // (BAR_LENGTH - 1)))


