"""The durable layer under a replica (reference: src/vsr/): checksums,
the 256-byte header, zoned data-file storage, the superblock and the
LSM-backed DurableState. Copies of the JAX package's host modules of the
same names, byte for byte where bytes are written. The replica itself
(journal, client sessions, message bus) is not ported yet."""

from .checksum import checksum
from .header import Command, Header

__all__ = ["checksum", "Command", "Header"]
