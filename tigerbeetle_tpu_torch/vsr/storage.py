"""Storage: zoned access to a replica's single data file.

A copy of the JAX package's `vsr/storage.py` (reference: src/storage.zig
zone-aware sector IO + the data-file layout,
docs/internals/data_file.md:11-97). Zones:

  superblock   SUPERBLOCK_COPIES x SUPERBLOCK_COPY_SIZE
  wal_headers  slot_count x 256
  wal_prepares slot_count x message_size_max
  client_replies clients_max x message_size_max
  snapshot     2 x snapshot_size_max  (A/B checkpoint-root slots)
  grid         grid_block_count x grid_block_size (LSM copy-on-write blocks)

`FileStorage` is served by the native C++ engine (`native.py`,
csrc/storage_engine.cpp) when it builds: pread/pwrite through it, and
through its submission engine the asynchronous grid writes, the
journal's asynchronous WAL pairs (`write_pair_async`, `io_poll`,
`io_reap`) and read-ahead (`read_submit` / `read_fetch`). Without a
toolchain it falls back to plain `os.pread` / `os.pwrite`, synchronous,
the same bytes. `MemoryStorage` is synchronous.
"""

from __future__ import annotations

import dataclasses
import os

from .header import HEADER_SIZE

SUPERBLOCK_COPIES = 4
SUPERBLOCK_COPY_SIZE = 4096


@dataclasses.dataclass(frozen=True)
class StorageLayout:
    """Sizes that shape the data file (consensus-critical; reference:
    src/config.zig:153-163)."""

    slot_count: int = 1024
    message_size_max: int = 1024 * 1024
    clients_max: int = 64
    # The snapshot zone holds the two A/B checkpoint-root blobs (forest
    # manifests address + free set) — small; bulk state lives in the grid.
    snapshot_size_max: int = 4 * 1024 * 1024
    grid_block_size: int = 64 * 1024
    grid_block_count: int = 8192  # 512 MiB grid zone

    @property
    def zone_offsets(self) -> dict:
        off = {}
        pos = 0
        off["superblock"] = pos
        pos += SUPERBLOCK_COPIES * SUPERBLOCK_COPY_SIZE
        off["wal_headers"] = pos
        pos += self.slot_count * HEADER_SIZE
        off["wal_prepares"] = pos
        pos += self.slot_count * self.message_size_max
        off["client_replies"] = pos
        pos += self.clients_max * self.message_size_max
        off["snapshot"] = pos
        pos += 2 * self.snapshot_size_max
        off["grid"] = pos
        pos += self.grid_block_count * self.grid_block_size
        off["_end"] = pos
        return off

    @property
    def size(self) -> int:
        return self.zone_offsets["_end"]


TEST_LAYOUT = StorageLayout(
    slot_count=32, message_size_max=64 * 1024, clients_max=8,
    snapshot_size_max=256 * 1024, grid_block_size=8 * 1024,
    grid_block_count=2048)


class Storage:
    """Abstract zoned storage."""

    layout: StorageLayout

    def read(self, zone: str, offset: int, size: int) -> bytes:
        raise NotImplementedError

    def write(self, zone: str, offset: int, data: bytes) -> None:
        raise NotImplementedError

    def sync(self) -> None:
        pass

    def erase(self) -> None:
        """Zero the entire data file (the vortex data-file-destruction
        fault: total single-replica data loss, recoverable only via
        `recover --from-cluster`). Chunked so a production-size file
        never materializes in memory at once."""
        chunk = 1 << 20
        zones = self.layout.zone_offsets
        names = [z for z in zones if z != "_end"]
        for i, zone in enumerate(names):
            size = (zones[names[i + 1]] if i + 1 < len(names)
                    else zones["_end"]) - zones[zone]
            for off in range(0, size, chunk):
                self.write(zone, off, b"\x00" * min(chunk, size - off))
        self.sync()

    # ------------------------------------------------ async (optional)
    # Overlapped IO for the WAL path (reference: src/io/linux.zig). The
    # default implementation is synchronous-only: write_pair_async
    # returns None and the caller falls back to blocking writes — the
    # deterministic simulator keeps this behavior.

    def write_pair_async(self, zone1: str, off1: int, data1: bytes,
                         zone2: str, off2: int, data2: bytes):
        """Submit an ordered write pair (data2 strictly after data1);
        returns a completion token, or None when unsupported."""
        return None

    def io_poll(self) -> list:
        """Nonblocking: completion tokens ready to reap."""
        return []

    def io_reap(self, token) -> None:
        """Block until `token` completes; raises on write failure."""
        raise KeyError(f"unknown io token {token!r}")

    def read_batch(self, zone: str, reqs: list) -> list:
        """Read many (offset, size) extents; concurrent when the engine
        supports it (reference: the prefetch fan-out issues all of a
        batch's reads at once, src/lsm/groove.zig:996,1339)."""
        return [self.read(zone, off, size) for off, size in reqs]

    def read_submit(self, zone: str, reqs: list):
        """Submit (offset, size) reads WITHOUT waiting; returns tokens
        for read_fetch, or None when unsupported (the caller reads
        synchronously instead). This is the fire-and-continue half of
        the reference's overlapped read path (src/storage.zig:177 —
        every read is an io_uring submission the event loop outlives);
        the grid's block read-ahead rides it."""
        return None

    def read_fetch(self, token, size: int) -> bytes:
        """Block until a read_submit token completes; returns the data."""
        raise KeyError(f"unknown read token {token!r}")

    def _check(self, zone: str, offset: int, size: int) -> int:
        zones = self.layout.zone_offsets
        base = zones[zone]
        keys = list(zones)
        limit = zones[keys[keys.index(zone) + 1]]
        assert base + offset + size <= limit, (zone, offset, size)
        return base + offset


class MemoryStorage(Storage):
    """In-memory data file (simulator base; reference testing/storage.zig)."""

    def __init__(self, layout: StorageLayout = TEST_LAYOUT):
        self.layout = layout
        self.data = bytearray(layout.size)
        self.reads = 0
        self.writes = 0

    def read(self, zone: str, offset: int, size: int) -> bytes:
        pos = self._check(zone, offset, size)
        self.reads += 1
        return bytes(self.data[pos:pos + size])

    def write(self, zone: str, offset: int, data: bytes) -> None:
        pos = self._check(zone, offset, len(data))
        self.writes += 1
        self.data[pos:pos + len(data)] = data


class FileStorage(Storage):
    """File-backed storage, served by the native C++ engine when available
    (csrc/storage_engine.cpp via ctypes; reference: src/storage.zig
    read_sectors/write_sectors). Falls back to os.pread/pwrite."""

    def __init__(self, path: str, layout: StorageLayout = StorageLayout(),
                 create: bool = False, async_grid: bool = True):
        from .. import native as native_mod

        self.layout = layout
        self.path = path
        self.native = None
        # Async grid-zone writes through the native submission engine
        # (reference: the io_uring layer, src/io/linux.zig): LSM block
        # writes (compaction, flush) no longer block the replica loop.
        # Correctness: grid blocks are immutable copy-on-write and cached
        # at write, so the only read that could race a pending write is a
        # cold/bypass read — those drain first (`_drain_grid`); sync()
        # drains + fsyncs (the checkpoint barrier).
        self.aio = None
        self._grid_pending: dict[int, tuple[int, int]] = {}  # token -> (pos, end)
        self._read_pending: set[int] = set()  # read-ahead tokens in flight
        if native_mod.available():
            self.native = native_mod.NativeFile(path, layout.size, create)
            self.fd = -1
            if async_grid:
                self.aio = native_mod.AsyncEngine(self.native)
            return
        flags = os.O_RDWR | (os.O_CREAT if create else 0)
        self.fd = os.open(path, flags, 0o644)
        if create:
            os.ftruncate(self.fd, layout.size)

    def _drain_grid(self, pos: int = None, size: int = None) -> None:
        """Settle pending grid writes overlapping [pos, pos+size) — or all
        of them. Waits only on the overlapping grid tokens, never on
        unrelated in-flight ops (the journal's async WAL pairs share the
        engine; a cold grid read must not stall behind them)."""
        if self.aio is None or not self._grid_pending:
            return
        if pos is None:
            tokens = list(self._grid_pending)
        else:
            end = pos + size
            tokens = [tok for tok, (p, e) in self._grid_pending.items()
                      if p < end and pos < e]
            if not tokens:
                return
        for token in tokens:
            del self._grid_pending[token]
            self._reap_grid(token)

    def _reap_grid(self, token: int) -> None:
        try:
            self.aio.fetch(token)
        except OSError:
            # Same contract as the drain barrier: a lost grid write
            # means durability is compromised (sticky in the engine).
            raise RuntimeError(
                "async write failed (sticky): storage compromised")

    def read(self, zone: str, offset: int, size: int) -> bytes:
        pos = self._check(zone, offset, size)
        if zone == "grid":
            self._drain_grid(pos, size)
        if self.native is not None:
            return self.native.read(pos, size)
        data = os.pread(self.fd, size, pos)
        if len(data) < size:
            data += b"\x00" * (size - len(data))
        return data

    def write(self, zone: str, offset: int, data: bytes) -> None:
        pos = self._check(zone, offset, len(data))
        if zone == "grid" and self.aio is not None:
            # The engine's workers may run two in-flight writes in either
            # order: settle any pending write this one overlaps first, so
            # the later write's bytes are the ones that land.
            self._drain_grid(pos, len(data))
            token = self.aio.submit_write_tracked(pos, data)
            self._grid_pending[token] = (pos, pos + len(data))
            return
        if self.native is not None:
            self.native.write(pos, data)
            return
        os.pwrite(self.fd, data, pos)

    def write_pair_async(self, zone1: str, off1: int, data1: bytes,
                         zone2: str, off2: int, data2: bytes):
        if self.aio is None:
            return None
        pos1 = self._check(zone1, off1, len(data1))
        pos2 = self._check(zone2, off2, len(data2))
        return self.aio.submit_write_pair(pos1, data1, pos2, data2)

    def io_poll(self) -> list:
        """Completion tokens for OTHER subsystems (the journal's WAL
        pairs). Completed grid-write records are reaped here as a side
        effect — left unfetched they would pile up in the engine and
        crowd real tokens out of the poll window (a stalled WAL callback
        is a stalled commit)."""
        if self.aio is None:
            return []
        out = []
        for token in self.aio.poll():
            if token in self._grid_pending:
                del self._grid_pending[token]
                self._reap_grid(token)
            elif token not in self._read_pending:
                # Read-ahead tokens stay in the engine until their
                # owner fetches them (tbio_poll is non-consuming).
                out.append(token)
        return out

    def io_reap(self, token) -> None:
        assert self.aio is not None
        self.aio.fetch(token)

    def read_batch(self, zone: str, reqs: list) -> list:
        if self.aio is None or len(reqs) <= 1:
            return [self.read(zone, off, size) for off, size in reqs]
        positions = []
        for off, size in reqs:
            pos = self._check(zone, off, size)
            if zone == "grid":
                self._drain_grid(pos, size)
            positions.append(pos)
        tokens = [self.aio.submit_read(pos, size)
                  for pos, (_, size) in zip(positions, reqs)]
        out = []
        for tok, (_, size) in zip(tokens, reqs):
            data = self.aio.fetch(tok, size)
            if len(data) < size:
                data += b"\x00" * (size - len(data))
            out.append(data)
        return out

    def read_submit(self, zone: str, reqs: list):
        if self.aio is None:
            return None
        tokens = []
        for off, size in reqs:
            pos = self._check(zone, off, size)
            if zone == "grid":
                self._drain_grid(pos, size)
            token = self.aio.submit_read(pos, size)
            self._read_pending.add(token)
            tokens.append(token)
        return tokens

    def read_fetch(self, token, size: int) -> bytes:
        self._read_pending.discard(token)
        data = self.aio.fetch(token, size)
        if len(data) < size:
            data += b"\x00" * (size - len(data))
        return data

    def sync(self) -> None:
        if self.aio is not None:
            # Reap tracked grid tokens first (drain alone would leave
            # their completion records unfetched in the engine), then the
            # engine-wide durability barrier.
            self._drain_grid()
            self.aio.drain(sync=True)
            return
        if self.native is not None:
            self.native.sync()
            return
        os.fsync(self.fd)

    def close(self) -> None:
        if self.aio is not None:
            try:
                self.aio.drain(sync=True)
            finally:
                # Even a failed final drain must release the worker
                # threads and the fd.
                self.aio.close()
                self.aio = None
        if self.native is not None:
            self.native.close()
            return
        os.close(self.fd)
