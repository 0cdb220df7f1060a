"""Immutable sorted tables serialized into grid blocks.

reference: src/lsm/table.zig (index block + value blocks) +
src/lsm/table_memory.zig. A table is one sorted run of fixed-size
(key, value) entries: value blocks hold the entries, the index block holds
each value block's first key + address. Lookups binary-search the index
then the block (reference: src/lsm/binary_search.zig — here Python's
bisect over in-memory key arrays)."""

from __future__ import annotations

import bisect
import dataclasses
import struct

from .grid import ADDRESS_SIZE, BlockAddress, Grid
from .schema import BLOCK_HEADER_SIZE, BlockKind, unwrap, wrap

TOMBSTONE = b"\xff"  # value prefix marking a deletion


@dataclasses.dataclass
class TableInfo:
    """Manifest entry (reference: manifest TableInfo)."""

    index_address: BlockAddress
    index_size: int
    key_min: bytes
    key_max: bytes
    entry_count: int

    def pack(self) -> bytes:
        return (self.index_address.pack()
                + struct.pack("<IHHI", self.index_size, len(self.key_min),
                              len(self.key_max), self.entry_count)
                + self.key_min + self.key_max)

    @classmethod
    def unpack(cls, raw: bytes, offset: int = 0) -> tuple["TableInfo", int]:
        addr = BlockAddress.unpack(raw[offset:offset + ADDRESS_SIZE])
        offset += ADDRESS_SIZE
        size, kmin_len, kmax_len, count = struct.unpack_from("<IHHI", raw, offset)
        offset += 12
        kmin = raw[offset:offset + kmin_len]
        offset += kmin_len
        kmax = raw[offset:offset + kmax_len]
        offset += kmax_len
        return cls(addr, size, kmin, kmax, count), offset


class Table:
    """Reader over one on-grid table: index loaded, blocks read on demand."""

    def __init__(self, grid: Grid, info: TableInfo, key_size: int,
                 value_size: int):
        self.grid = grid
        self.info = info
        self.key_size = key_size
        self.value_size = value_size
        raw = unwrap(grid.read_block(info.index_address, info.index_size),
                     BlockKind.index)
        (count,) = struct.unpack_from("<I", raw)
        self.block_first_keys: list[bytes] = []
        self.block_addresses: list[BlockAddress] = []
        self.block_sizes: list[int] = []
        pos = 4
        for _ in range(count):
            addr = BlockAddress.unpack(raw[pos:pos + ADDRESS_SIZE])
            pos += ADDRESS_SIZE
            (size,) = struct.unpack_from("<I", raw, pos)
            pos += 4
            first = raw[pos:pos + key_size]
            pos += key_size
            self.block_addresses.append(addr)
            self.block_sizes.append(size)
            self.block_first_keys.append(first)

    def _block_entries(self, i: int) -> tuple[list[bytes], list[bytes]]:
        raw = unwrap(self.grid.read_block(self.block_addresses[i],
                                          self.block_sizes[i]),
                     BlockKind.value)
        (n,) = struct.unpack_from("<I", raw)
        pos = 4
        entry = self.key_size + self.value_size
        keys = [raw[pos + j * entry: pos + j * entry + self.key_size]
                for j in range(n)]
        vals = [raw[pos + j * entry + self.key_size: pos + (j + 1) * entry]
                for j in range(n)]
        return keys, vals

    def get(self, key: bytes):
        blk = self.block_for(key)
        if blk is None:
            return None
        address, size = blk
        return self.get_in_block(key, self.grid.read_block(address, size))

    def block_for(self, key: bytes):
        """(address, size) of the one value block that could hold `key`,
        or None — the read-free planning half of a point lookup (the
        batched prefetch fan-out plans ALL of a batch's reads first)."""
        if not (self.info.key_min <= key <= self.info.key_max):
            return None
        i = bisect.bisect_right(self.block_first_keys, key) - 1
        if i < 0:
            return None
        return self.block_addresses[i], self.block_sizes[i]

    def get_in_block(self, key: bytes, raw: bytes):
        """Binary-search `key` inside a fetched value block."""
        raw = unwrap(raw, BlockKind.value)
        (n,) = struct.unpack_from("<I", raw)
        entry = self.key_size + self.value_size
        lo, hi = 0, n
        while lo < hi:
            mid = (lo + hi) // 2
            if raw[4 + mid * entry: 4 + mid * entry + self.key_size] < key:
                lo = mid + 1
            else:
                hi = mid
        if lo < n and raw[4 + lo * entry: 4 + lo * entry + self.key_size] == key:
            return raw[4 + lo * entry + self.key_size: 4 + (lo + 1) * entry]
        return None

    def iter_entries(self):
        # Read-ahead: block i+1's device read runs while block i's
        # entries are merged (compaction input no longer stalls the
        # replica loop per block — reference: compaction reads are
        # pipelined through io_uring, src/storage.zig:177 +
        # docs/internals/lsm.md pipelined compaction). No-op on
        # synchronous devices (the deterministic simulator).
        n = len(self.block_addresses)
        for i in range(n):
            if i + 1 < n:
                self.grid.prefetch_async(
                    [(self.block_addresses[i + 1],
                      self.block_sizes[i + 1])])
            keys, vals = self._block_entries(i)
            yield from zip(keys, vals)


def value_block_entry_max(grid: Grid, key_size: int,
                          value_size: int) -> int:
    """Entries per value block (block header + u32 count + k||v rows)."""
    return max(1, (grid.block_size - BLOCK_HEADER_SIZE - 4)
               // (key_size + value_size))


def table_entry_max(grid: Grid, key_size: int, value_size: int) -> int:
    """Largest entry count whose index still fits one block (reference:
    tables have a fixed value_count_max per comptime layout)."""
    per_block = value_block_entry_max(grid, key_size, value_size)
    index_entries_max = ((grid.block_size - BLOCK_HEADER_SIZE - 4)
                         // (ADDRESS_SIZE + 4 + key_size))
    return per_block * index_entries_max


def write_value_block(grid: Grid, chunk: list[tuple[bytes, bytes]],
                      reservation=None, tree_id: int = 0):
    """One value block; returns (address, size, first_key) — the index
    entry triple. The SINGLE encoder for the value-block layout (shared
    by whole-table writes and the incremental memtable flush)."""
    raw = wrap(BlockKind.value,
               struct.pack("<I", len(chunk)) + b"".join(
                   k + v for k, v in chunk),
               tree_id=tree_id)
    addr = grid.write_block(raw, reservation=reservation)
    return addr, len(raw), chunk[0][0]


def write_index_block(grid: Grid, blocks: list,
                      reservation=None,
                      tree_id: int = 0) -> tuple[BlockAddress, int]:
    """The table's index block over (address, size, first_key) triples."""
    index_raw = wrap(
        BlockKind.index,
        struct.pack("<I", len(blocks)) + b"".join(
            addr.pack() + struct.pack("<I", size) + first
            for addr, size, first in blocks),
        tree_id=tree_id)
    assert len(index_raw) <= grid.block_size, "table too large for one index"
    return grid.write_block(index_raw, reservation=reservation), len(index_raw)


def table_block_bound(grid: Grid, n_entries: int, key_size: int,
                      value_size: int) -> int:
    """Worst-case grid blocks (value + index) for writing `n_entries` as
    tables — the reservation bound for flush/compaction jobs (reference:
    compactions reserve their worst case, src/vsr/free_set.zig:28-35)."""
    per_block = value_block_entry_max(grid, key_size, value_size)
    cap = table_entry_max(grid, key_size, value_size)
    n = max(1, n_entries)
    tables = -(-n // cap)
    # Value blocks: ceil(n/per_block) plus one possible short block per
    # table boundary; one index block per table.
    return -(-n // per_block) + 2 * tables


def write_tables(grid: Grid, entries: list[tuple[bytes, bytes]],
                 key_size: int, value_size: int,
                 reservation=None, tree_id: int = 0) -> list["TableInfo"]:
    """Serialize a sorted run as one or more bounded tables (a single merge
    output may exceed one table's index capacity — split, like the
    reference's compaction emitting multiple output tables)."""
    cap = table_entry_max(grid, key_size, value_size)
    return [write_table(grid, entries[i:i + cap], key_size, value_size,
                        reservation=reservation, tree_id=tree_id)
            for i in range(0, len(entries), cap)]


def write_table(grid: Grid, entries: list[tuple[bytes, bytes]],
                key_size: int, value_size: int,
                reservation=None, tree_id: int = 0) -> TableInfo:
    """Serialize one sorted run (caller guarantees sort order + unique keys)."""
    assert entries
    per_block = value_block_entry_max(grid, key_size, value_size)
    blocks = [write_value_block(grid, entries[base:base + per_block],
                                reservation=reservation, tree_id=tree_id)
              for base in range(0, len(entries), per_block)]
    index_addr, index_size = write_index_block(grid, blocks,
                                               reservation=reservation,
                                               tree_id=tree_id)
    return TableInfo(
        index_address=index_addr, index_size=index_size,
        key_min=entries[0][0], key_max=entries[-1][0],
        entry_count=len(entries))


def release_table(grid: Grid, table: Table) -> None:
    """Free all of a table's blocks (effective at next checkpoint)."""
    for addr in table.block_addresses:
        grid.release(addr.index)
    grid.release(table.info.index_address.index)
