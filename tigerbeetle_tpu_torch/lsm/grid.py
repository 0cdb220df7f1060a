"""Block grid: copy-on-write checksummed block store + free set.

reference: src/vsr/grid.zig (block addressing, cache) + src/vsr/free_set.zig
(EWAH-compressed allocation bitset with reserve/acquire determinism) +
docs/internals/data_file.md:30-44 (addresses are (index, checksum) pairs;
blocks are immutable once written — updates write NEW blocks and free the
old ones at checkpoint, which is what makes checkpoints atomic).

Simplification vs the reference: the block checksum is stored alongside the
address by the referring structure (same contract — a block is only
readable through its address+checksum pair), and block size defaults to
64 KiB (the reference uses 512 KiB; both are config)."""

from __future__ import annotations

import dataclasses
from typing import Optional

from .. import ewah
from ..vsr.checksum import checksum

BLOCK_SIZE_DEFAULT = 64 * 1024


@dataclasses.dataclass(frozen=True)
class BlockAddress:
    index: int
    checksum: int

    def pack(self) -> bytes:
        return self.index.to_bytes(8, "little") + self.checksum.to_bytes(16, "little")

    @classmethod
    def unpack(cls, raw: bytes) -> "BlockAddress":
        return cls(int.from_bytes(raw[:8], "little"),
                   int.from_bytes(raw[8:24], "little"))


ADDRESS_SIZE = 24


class GridReservation:
    """A pre-claimed run of grid blocks (see Grid.reserve)."""

    __slots__ = ("grid", "indices", "cursor", "closed")

    def __init__(self, grid: "Grid", indices: list):
        self.grid = grid
        self.indices = indices
        self.cursor = 0
        self.closed = False

    def next_index(self) -> int:
        assert not self.closed, "reservation already forfeited"
        assert self.cursor < len(self.indices), \
            "reservation exhausted: worst-case bound was wrong"
        idx = self.indices[self.cursor]
        self.cursor += 1
        return idx

    def unused(self) -> list:
        return self.indices[self.cursor:]


class Grid:
    """Block store over a flat byte device (file or memory).

    Two-phase allocation like the reference free set (:28-35): blocks freed
    during a checkpoint interval stay unavailable until `checkpoint()` so
    crash recovery never sees a block overwritten mid-interval."""

    def __init__(self, device, block_size: int = BLOCK_SIZE_DEFAULT,
                 block_count: int = 4096, cache_sets: int = 64,
                 cache_ways: int = 8):
        from .cache_map import ObjectCache

        self.device = device  # .read(off, size) / .write(off, data)
        self.block_size = block_size
        self.block_count = block_count
        self.free: list[bool] = [True] * block_count
        # Bounded block cache (reference: the set-associative grid block
        # cache, src/vsr/grid.zig:30). Keys are (checksum, index), so a
        # freed-and-reused index can never serve stale bytes — blocks
        # are immutable under copy-on-write, making entries forever valid.
        self.cache = ObjectCache(sets=cache_sets, ways=cache_ways)
        # Standing missing-block hook (reference: grid_blocks_missing,
        # src/vsr/grid_blocks_missing.zig:24): the replica wires this to
        # its repair queue so ANY corrupt read — serving path included,
        # not just the scrubber's tour — queues a peer repair.
        self.on_corrupt = None
        self.freed_pending: list[int] = []  # released at next checkpoint
        self.acquire_cursor = 0
        # Live reservations (reserve() .. forfeit()): their unwritten
        # blocks are excluded from checkpointed free sets — a crash mid-
        # job must not leak them (the restored job re-reserves afresh).
        self._reservations: set = set()
        # Read-ahead in flight: key -> (device token, size). Submitted by
        # prefetch_async (compaction input lookahead), consumed by the
        # next read of the same block — the IO runs while the replica
        # keeps computing (reference: all reads are issued concurrently
        # through io_uring and the event loop continues,
        # src/storage.zig:177 + src/io/linux.zig).
        self._inflight: dict[int, tuple] = {}  # key -> (token, size);
        # dict insertion order IS submission order (oldest first).
        self._discard_pending: list[tuple] = []  # evicted, not yet freed
        self.prefetch_inflight_max = 256
        self.prefetched = 0  # blocks submitted, lifetime
        self.prefetch_hits = 0  # reads served from a VALIDATED read-ahead
        self.prefetch_evicted = 0  # dead entries discarded to make room

    # ------------------------------------------------------------ alloc

    def acquire(self) -> int:
        """Deterministic first-free-from-cursor allocation."""
        for _ in range(self.block_count):
            idx = self.acquire_cursor % self.block_count
            self.acquire_cursor += 1
            if self.free[idx]:
                self.free[idx] = False
                return idx
        raise RuntimeError("grid full")

    # Two-stage reserve/acquire (reference: src/vsr/free_set.zig:28-35):
    # a long-running job claims its WORST-CASE block count up front, then
    # acquires from its reservation as it writes, and forfeits the unused
    # remainder at completion. Guarantees (a) a job can never die of
    # "grid full" mid-write, and (b) allocation stays deterministic no
    # matter how concurrent jobs interleave their writes.

    def reserve(self, count: int) -> "GridReservation":
        indices = []
        try:
            for _ in range(count):
                indices.append(self.acquire())
        except RuntimeError:
            for idx in indices:  # all-or-nothing
                self.free[idx] = True
            raise RuntimeError(
                f"grid cannot reserve {count} blocks (full)")
        res = GridReservation(self, indices)
        self._reservations.add(res)
        return res

    def forfeit(self, reservation: "GridReservation") -> None:
        """Return a reservation's unwritten blocks to the free set (they
        were never written, so immediate reuse is crash-safe)."""
        for idx in reservation.unused():
            assert not self.free[idx]
            self.free[idx] = True
        reservation.closed = True
        self._reservations.discard(reservation)

    def release(self, index: int) -> None:
        """Free a block at the NEXT checkpoint (two-phase, crash-safe)."""
        assert not self.free[index]
        self.freed_pending.append(index)

    def checkpoint_free_set(self) -> bytes:
        """Apply pending frees and serialize the free set (EWAH). Live
        reservations serialize as FREE in their entirety — an incomplete
        job's blocks (written or not) are referenced by no manifest
        (tables install and manifests pack only after a job drains), so
        a crash must not leak them: the restored job re-reserves and
        rewrites from scratch."""
        for idx in self.freed_pending:
            self.free[idx] = True
        self.freed_pending.clear()
        self.acquire_cursor = 0
        bits = list(self.free)
        for res in self._reservations:
            for idx in res.indices:
                assert not bits[idx]
                bits[idx] = True
        return ewah.encode_bitset(bits)

    def restore_free_set(self, blob: bytes) -> None:
        bits = ewah.decode_bitset(blob)
        assert len(bits) == self.block_count
        self.free = bits
        self.freed_pending.clear()
        self.acquire_cursor = 0
        self._reservations.clear()

    # ------------------------------------------------------------- blocks

    def write_block(self, data: bytes,
                    reservation: "GridReservation" = None) -> BlockAddress:
        assert len(data) <= self.block_size
        index = (self.acquire() if reservation is None
                 else reservation.next_index())
        self.device.write(index * self.block_size, data)
        address = BlockAddress(index, checksum(data, domain=b"blk"))
        self.cache.put((address.checksum << 64) | index, data)
        return address

    def prefetch_async(self, reqs: list) -> int:
        """Fire-and-continue block read-ahead: submit device reads for
        the cache-missing blocks in `reqs` [(address, size)] and return
        immediately; a later read_block/read_blocks of the same block
        collects the completed data instead of touching the device.
        No-ops (returns 0) on devices without read_submit — the
        deterministic simulator stays strictly synchronous."""
        submit = getattr(self.device, "read_submit", None)
        if submit is None:
            return 0
        wanted = []
        seen: set = set()
        for address, size in reqs:
            key = (address.checksum << 64) | address.index
            # Dedupe within the call too: many lookup keys map to ONE
            # value block; a duplicate submit would orphan the first
            # token in the engine forever.
            if key in self._inflight or key in seen:
                continue
            if len(wanted) >= self.prefetch_inflight_max:
                break
            cached = self.cache.get(key)
            if cached is not None and len(cached) == size:
                continue
            seen.add(key)
            wanted.append((key, address, size))
        if not wanted:
            return 0
        # Make room by discarding the OLDEST in-flight entries (fetched
        # and dropped, so the engine record is freed): superset
        # lookaheads for keys that resolved early would otherwise pin
        # dead entries until the cap silently disabled read-ahead.
        overflow = len(self._inflight) + len(wanted) \
            - self.prefetch_inflight_max
        if overflow > 0:
            self._evict_inflight(overflow)
        tokens = submit([(a.index * self.block_size, s)
                         for _, a, s in wanted])
        if tokens is None:
            return 0
        for (key, _, size), token in zip(wanted, tokens):
            self._inflight[key] = (token, size)
        self.prefetched += len(wanted)
        return len(wanted)

    def _evict_inflight(self, count: int) -> None:
        """Drop the OLDEST in-flight entries (dict order = submission
        order). Their engine records are freed LATER, at the next
        collect (which already blocks on a fetch by nature) — the
        submit path stays fire-and-continue even when an evicted
        entry's IO hasn't completed yet."""
        import itertools

        for key in list(itertools.islice(self._inflight, count)):
            self._discard_pending.append(self._inflight.pop(key))
            self.prefetch_evicted += 1
        # Backstop: if collects never run (all read-ahead went dead),
        # don't let deferred discards pin unbounded engine records.
        if len(self._discard_pending) >= self.prefetch_inflight_max:
            self._drain_discards()

    def _drain_discards(self) -> None:
        """Free engine records of evicted entries. Called right after a
        blocking collect: by then the (older) evicted reads have almost
        always completed, so the fetch-and-drop rarely waits."""
        while self._discard_pending:
            # FIFO: the oldest eviction was submitted earliest and is
            # the most likely to have completed — freeing it first
            # keeps this drain (on the collect path) from waiting on
            # the freshest in-flight read.
            token, sz = self._discard_pending.pop(0)
            try:
                self.device.read_fetch(token, sz)
            except OSError:
                pass

    def _take_inflight(self, key: int, address: BlockAddress, size: int):
        """Collect a completed, CHECKSUM-VALIDATED read-ahead for `key`,
        or None (caller reads synchronously). A stale buffer — the
        extent was freed and rewritten after submit — fails validation
        here and the sync re-read takes over; correctness never rests
        on the read-ahead, and only validated data counts as a hit."""
        entry = self._inflight.pop(key, None)
        if entry is None:
            return None
        token, sz = entry
        if sz != size:
            self._discard_pending.append((token, sz))
            self._drain_discards()
            return None
        try:
            data = self.device.read_fetch(token, sz)
        except OSError:
            return None
        finally:
            self._drain_discards()
        if len(data) != size or \
                checksum(data, domain=b"blk") != address.checksum:
            return None
        self.prefetch_hits += 1
        return data

    def read_block(self, address: BlockAddress, size: int,
                   bypass_cache: bool = False) -> bytes:
        """bypass_cache: the scrubber's latent-fault tour must touch the
        MEDIA, not the cache (reference: scrub reads skip the block
        cache so cached copies can't mask sector rot)."""
        key = (address.checksum << 64) | address.index
        if not bypass_cache:
            cached = self.cache.get(key)
            if cached is not None and len(cached) == size:
                return cached
            data = self._take_inflight(key, address, size)
            if data is not None:
                self.cache.put(key, data)
                return data
        data = self.device.read(address.index * self.block_size, size)
        if checksum(data, domain=b"blk") != address.checksum:
            if self.on_corrupt is not None:
                self.on_corrupt(address, size)
            raise IOError(f"grid block {address.index} corrupt")
        self.cache.put(key, data)
        return data

    def read_blocks(self, reqs: list) -> list:
        """Batched point reads: all cache misses are issued as ONE
        concurrent fan-out to the device (reference: the prefetch
        fan-out, src/lsm/groove.zig:996,1339). reqs: [(address, size)];
        returns the block bytes in request order."""
        out: list = [None] * len(reqs)
        # Requesters per unique missing block (a clustered key batch maps
        # many keys to ONE value block — read it once, not per key).
        misses: dict = {}
        for i, (address, size) in enumerate(reqs):
            key = (address.checksum << 64) | address.index
            cached = self.cache.get(key)
            if cached is not None and len(cached) == size:
                out[i] = cached
                continue
            if (address, size) not in misses:
                data = self._take_inflight(key, address, size)
                if data is not None:
                    self.cache.put(key, data)
                    out[i] = data
                    continue
            misses.setdefault((address, size), []).append(i)
        if misses:
            unique = list(misses)
            batch = getattr(self.device, "read_batch", None)
            extents = [(address.index * self.block_size, size)
                       for address, size in unique]
            datas = (batch(extents) if batch is not None else
                     [self.device.read(off, size) for off, size in extents])
            for (address, size), data in zip(unique, datas):
                if checksum(data, domain=b"blk") != address.checksum:
                    if self.on_corrupt is not None:
                        self.on_corrupt(address, size)
                    raise IOError(f"grid block {address.index} corrupt")
                self.cache.put((address.checksum << 64) | address.index, data)
                for i in misses[(address, size)]:
                    out[i] = data
        return out


class MemoryDevice:
    def __init__(self, size: int):
        self.data = bytearray(size)

    def read(self, off: int, size: int) -> bytes:
        return bytes(self.data[off:off + size])

    def write(self, off: int, data: bytes) -> None:
        self.data[off:off + len(data)] = data


class FileDevice:
    def __init__(self, path: str, create: bool = False):
        import os

        flags = os.O_RDWR | (os.O_CREAT if create else 0)
        self.fd = os.open(path, flags, 0o644)

    def read(self, off: int, size: int) -> bytes:
        import os

        data = os.pread(self.fd, size, off)
        return data + b"\x00" * (size - len(data))

    def write(self, off: int, data: bytes) -> None:
        import os

        os.pwrite(self.fd, data, off)

    def close(self) -> None:
        import os

        os.close(self.fd)
