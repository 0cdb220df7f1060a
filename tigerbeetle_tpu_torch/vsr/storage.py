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

The IO interface is synchronous. `FileStorage` does plain `os.pread` /
`os.pwrite` file IO, the same bytes the JAX package's native C++ engine
writes; that engine and its async WAL writes are not ported here.
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
    """File-backed storage with plain `os.pread` / `os.pwrite` (reference:
    src/storage.zig read_sectors/write_sectors). Synchronous: every write
    has landed in the file when `write` returns, and `sync` fsyncs. The
    file is created sparse at the layout's size."""

    def __init__(self, path: str, layout: StorageLayout = StorageLayout(),
                 create: bool = False):
        self.layout = layout
        self.path = path
        flags = os.O_RDWR | (os.O_CREAT if create else 0)
        self.fd = os.open(path, flags, 0o644)
        if create:
            os.ftruncate(self.fd, layout.size)

    def read(self, zone: str, offset: int, size: int) -> bytes:
        pos = self._check(zone, offset, size)
        data = os.pread(self.fd, size, pos)
        if len(data) < size:
            data += b"\x00" * (size - len(data))
        return data

    def write(self, zone: str, offset: int, data: bytes) -> None:
        pos = self._check(zone, offset, len(data))
        os.pwrite(self.fd, data, pos)

    def sync(self) -> None:
        os.fsync(self.fd)

    def close(self) -> None:
        os.close(self.fd)
