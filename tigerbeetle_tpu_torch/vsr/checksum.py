"""128-bit content checksums.

The reference uses AEGIS-128L with a zero key for speed on AES-NI hardware
(src/vsr/checksum.zig:1-63). This rebuild uses keyed BLAKE2b truncated to
128 bits — the fastest cryptographic-quality hash in the Python stdlib and
available everywhere the host runtime runs. The role is identical: detect
disk/network corruption and misdirected reads, not authenticate adversaries.

Checksums are domain-separated by a context byte so a header checksum can
never validate as a body checksum.
"""

from __future__ import annotations

import hashlib

_SEED = b"tigerbeetle-tpu-checksum"


def checksum(data: bytes, domain: bytes = b"") -> int:
    """128-bit checksum of `data` as an int."""
    h = hashlib.blake2b(data, digest_size=16, key=_SEED + domain)
    return int.from_bytes(h.digest(), "little")


def checksum_bytes(data: bytes, domain: bytes = b"") -> bytes:
    return hashlib.blake2b(data, digest_size=16, key=_SEED + domain).digest()
