"""Forest: named trees sharing one grid, with atomic checkpoints.

reference: src/lsm/forest.zig (open/compact/checkpoint across all trees,
shared manifest log — a linked list of manifest blocks replayed at
startup, docs/internals/data_file.md:151-194). A checkpoint serializes
every tree's manifest into a CHAIN of grid blocks (head -> ... -> tail,
each block carrying the next block's address) plus the grid free set, and
returns one small root blob — the superblock-equivalent pointer a caller
persists atomically.
"""

from __future__ import annotations

import struct
from typing import Optional

from .grid import ADDRESS_SIZE, BlockAddress, Grid
from .tree import Tree

from .schema import BLOCK_HEADER_SIZE, BlockKind, unwrap, wrap

# Per-chain-block header (inside the unified block header,
# lsm/schema.py): next address (24) + next block size (4).
# next size == 0 marks the tail.
CHAIN_HEADER = ADDRESS_SIZE + 4


def chain_next(block_raw: bytes) -> Optional[tuple[BlockAddress, int]]:
    """(next address, next size) of a manifest chain block, or None."""
    inner = unwrap(block_raw, BlockKind.manifest)
    (next_size,) = struct.unpack_from("<I", inner, ADDRESS_SIZE)
    if next_size == 0:
        return None
    return BlockAddress.unpack(inner[:ADDRESS_SIZE]), next_size


def chain_payload(block_raw: bytes) -> bytes:
    return unwrap(block_raw, BlockKind.manifest)[CHAIN_HEADER:]


class Forest:
    def __init__(self, grid: Grid, schema: dict[str, tuple[int, int]]):
        """schema: name -> (key_size, value_size), fixed at format time
        (the reference's comptime groove schema)."""
        self.grid = grid
        self.schema = dict(sorted(schema.items()))
        # Deterministic tree ids (sorted-name order, 1-based; 0 means
        # standalone) — stamped into every block a tree writes.
        self.trees: dict[str, Tree] = {
            name: Tree(grid, key_size=k, value_size=v, name=name,
                       tree_id=i + 1)
            for i, (name, (k, v)) in enumerate(self.schema.items())}
        self._manifest_chain: list[int] = []  # previous checkpoint's blocks
        # (address, size) of the live chain — the scrubber's tour set.
        self.manifest_chain_blocks: list = []

    def compact_beat(self, op=None) -> None:
        for tree in self.trees.values():
            tree.compact_beat(op)

    def checkpoint(self) -> bytes:
        """Flush + serialize everything; returns the root blob (manifest
        chain head address + free set). Pending grid frees are applied
        here — the atomic flip point."""
        manifests = {name: tree.manifest_pack()
                     for name, tree in self.trees.items()}
        parts = [struct.pack("<I", len(manifests))]
        for name, raw in manifests.items():
            nb = name.encode()
            parts.append(struct.pack("<HI", len(nb), len(raw)))
            parts.append(nb)
            parts.append(raw)
        manifest_blob = b"".join(parts)
        # Free the previous checkpoint's manifest chain (two-phase: the
        # blocks stay intact on disk until this checkpoint's free set takes
        # effect, so a crash before the superblock flip still recovers the
        # old root).
        for index in self._manifest_chain:
            self.grid.release(index)
        # Write the chain tail-first so each block can embed its
        # successor's address.
        chunk_max = self.grid.block_size - CHAIN_HEADER - BLOCK_HEADER_SIZE
        chunks = [manifest_blob[off:off + chunk_max]
                  for off in range(0, len(manifest_blob), chunk_max)] or [b""]
        next_address: Optional[BlockAddress] = None
        next_size = 0
        chain: list[int] = []
        chain_blocks: list[tuple[BlockAddress, int]] = []
        for chunk in reversed(chunks):
            raw = wrap(
                BlockKind.manifest,
                (next_address.pack() if next_address is not None
                 else b"\x00" * ADDRESS_SIZE)
                + struct.pack("<I", next_size) + chunk)
            next_address = self.grid.write_block(raw)
            next_size = len(raw)
            chain.append(next_address.index)
            chain_blocks.append((next_address, next_size))
        # ONE canonical store, head-first; the release-index list is
        # derived (order is irrelevant for release). The scrubber tours
        # these: manifest blocks are reachable checkpoint state and must
        # be scrubbed/repairable like table blocks (reference
        # grid_scrubber tours the manifest log too).
        self.manifest_chain_blocks = list(reversed(chain_blocks))
        self._manifest_chain = [a.index
                                for a, _ in self.manifest_chain_blocks]
        head_address, head_size = next_address, next_size
        free_blob = self.grid.checkpoint_free_set()
        return (head_address.pack() + struct.pack("<I", head_size)
                + struct.pack("<I", len(free_blob)) + free_blob)

    def open(self, root: bytes) -> None:
        """Restore from a checkpoint root blob (walking the chain)."""
        address = BlockAddress.unpack(root[:ADDRESS_SIZE])
        (size,) = struct.unpack_from("<I", root, ADDRESS_SIZE)
        (free_size,) = struct.unpack_from("<I", root, ADDRESS_SIZE + 4)
        free_blob = root[ADDRESS_SIZE + 8:ADDRESS_SIZE + 8 + free_size]
        self.grid.restore_free_set(free_blob)
        payload_parts = []
        chain_blocks: list[tuple[BlockAddress, int]] = []
        link: Optional[tuple[BlockAddress, int]] = (address, size)
        while link is not None:
            block_address, block_size = link
            raw = self.grid.read_block(block_address, block_size)
            chain_blocks.append((block_address, block_size))
            payload_parts.append(chain_payload(raw))
            link = chain_next(raw)
        # Head-first, matching checkpoint() — one canonical order.
        self.manifest_chain_blocks = chain_blocks
        self._manifest_chain = [a.index for a, _ in chain_blocks]
        raw = b"".join(payload_parts)
        (count,) = struct.unpack_from("<I", raw)
        pos = 4
        for _ in range(count):
            name_len, size = struct.unpack_from("<HI", raw, pos)
            pos += 6
            name = raw[pos:pos + name_len].decode()
            pos += name_len
            self.trees[name].manifest_restore(raw[pos:pos + size])
            pos += size
