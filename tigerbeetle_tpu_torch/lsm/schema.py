"""Unified grid-block header (reference: src/lsm/schema.zig:624 — every
grid block is self-describing, so inspect/repair tooling can classify
any block from its bytes alone, and a reader that follows a wrong
address fails LOUDLY on the kind check instead of misparsing).

Layout (16 bytes, little-endian), before the block payload:

    magic       u32   0x54424C4B ("TBLK")
    kind        u8    BlockKind
    version     u8    format version (1)
    tree_id     u16   owning tree (0 = none/standalone)
    payload_len u32   exact payload byte length
    reserved    u32   zero

The block checksum (BlockAddress.checksum, keyed BLAKE2b over the FULL
block including this header) remains the integrity boundary; the header
is the classification boundary.
"""

from __future__ import annotations

import enum
import struct

MAGIC = 0x54424C4B  # "TBLK"
VERSION = 1
BLOCK_HEADER_SIZE = 16
_FMT = struct.Struct("<IBBHII")
assert _FMT.size == BLOCK_HEADER_SIZE


class BlockKind(enum.IntEnum):
    value = 1      # sorted (key, value) entries (lsm/table.py)
    index = 2      # a table's value-block directory (lsm/table.py)
    manifest = 3   # checkpoint manifest chain link (lsm/forest.py)


def wrap(kind: BlockKind, payload: bytes, tree_id: int = 0) -> bytes:
    return _FMT.pack(MAGIC, int(kind), VERSION, tree_id,
                     len(payload), 0) + payload


def unwrap(raw: bytes, kind: BlockKind) -> bytes:
    """Validate the header and return the payload. Raises ValueError on
    any mismatch — a misdirected or misclassified block must never be
    silently misparsed."""
    if len(raw) < BLOCK_HEADER_SIZE:
        raise ValueError(f"block shorter than header ({len(raw)} B)")
    magic, got_kind, version, _tree_id, payload_len, _ = _FMT.unpack_from(raw)
    if magic != MAGIC:
        raise ValueError(f"bad block magic {magic:#x}")
    if version != VERSION:
        raise ValueError(f"unknown block version {version}")
    if got_kind != int(kind):
        raise ValueError(
            f"block kind {got_kind} where {int(kind)} expected")
    if BLOCK_HEADER_SIZE + payload_len > len(raw):
        raise ValueError("block payload_len exceeds block bytes")
    return raw[BLOCK_HEADER_SIZE:BLOCK_HEADER_SIZE + payload_len]


def classify(raw: bytes):
    """(BlockKind, tree_id, payload_len) of any block, or None if the
    bytes carry no valid header (inspect/devhub tooling)."""
    if len(raw) < BLOCK_HEADER_SIZE:
        return None
    magic, kind, version, tree_id, payload_len, _ = _FMT.unpack_from(raw)
    if magic != MAGIC or version != VERSION:
        return None
    if BLOCK_HEADER_SIZE + payload_len > len(raw):
        return None  # torn header: length does not fit the block
    try:
        return BlockKind(kind), tree_id, payload_len
    except ValueError:
        return None
