"""VSR consensus and durability (reference: src/vsr/): checksums, the
256-byte header, zoned data-file storage, the superblock, the LSM-backed
DurableState, the journal (WAL), client sessions, the clock, the message
bus, the client and the replica. Copies of the JAX package's host modules
of the same names, byte for byte where bytes are written or sent. All
components are sans-IO: Storage, MessageBus and Time are injected, so the
deterministic simulator (testing/cluster.py) runs whole clusters in one
process."""

from .checksum import checksum
from .header import Command, Header

__all__ = ["checksum", "Command", "Header"]
