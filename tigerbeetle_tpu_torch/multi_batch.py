"""Multi-batch wire codec (a copy of the JAX package's `multi_batch.py`).

Packs multiple independent batches of one operation into a single message
body (reference: src/vsr/multi_batch.zig:1-41). Layout: concatenated batch
payloads, then a trailer of u16s written from the END of the body backwards:

    [payloads...][padding(0xFFFF)...][count_bn]...[count_b2][count_b1][batch_count]

- the last u16 is the postamble (number of batches);
- the u16 before it is the FIRST batch's element count, and so on backwards;
- the trailer is padded with 0xFFFF so its byte length is a multiple of the
  operation's element size (keeping payload slices element-aligned).
"""

from __future__ import annotations

import struct

TRAILER_ITEM = 2  # u16
PADDING = 0xFFFF
BATCH_COUNT_MAX = 0xFFFF - 1


def trailer_size(batch_count: int, element_size: int) -> int:
    """Trailer bytes for batch_count batches, rounded up to element_size."""
    raw = (batch_count + 1) * TRAILER_ITEM
    if element_size <= 1:
        return raw
    return -(-raw // element_size) * element_size


def encode(batches: list[bytes], element_size: int) -> bytes:
    """Concatenate batch payloads and append the u16 trailer."""
    assert 0 < len(batches) <= BATCH_COUNT_MAX
    counts = []
    for payload in batches:
        if element_size > 0:
            assert len(payload) % element_size == 0
            counts.append(len(payload) // element_size)
        else:
            assert payload == b""
            counts.append(0)
    body = b"".join(batches)
    tsize = trailer_size(len(batches), max(element_size, 1))
    n_items = tsize // TRAILER_ITEM
    items = [PADDING] * n_items
    # Written backwards: last item = batch_count, item before it = batch 1.
    items[-1] = len(batches)
    for i, count in enumerate(counts):
        items[-2 - i] = count
    return body + struct.pack(f"<{n_items}H", *items)


def decode(body: bytes, element_size: int) -> list[bytes]:
    """Split a multi-batch body back into per-batch payloads.

    Raises ValueError on malformed trailers (the replica treats that as a
    client protocol error)."""
    if len(body) < TRAILER_ITEM:
        raise ValueError("multi-batch body too small for postamble")
    (batch_count,) = struct.unpack_from("<H", body, len(body) - TRAILER_ITEM)
    if batch_count == 0 or batch_count > BATCH_COUNT_MAX:
        raise ValueError(f"invalid batch_count {batch_count}")
    tsize = trailer_size(batch_count, max(element_size, 1))
    if tsize > len(body):
        raise ValueError("trailer larger than body")
    n_items = tsize // TRAILER_ITEM
    items = struct.unpack_from(f"<{n_items}H", body, len(body) - tsize)
    counts = [items[-2 - i] for i in range(batch_count)]
    if any(c == PADDING for c in counts):
        raise ValueError("padding marker inside counts")
    if any(p != PADDING for p in items[:n_items - 1 - batch_count]):
        raise ValueError("trailer padding not 0xFFFF")
    payload_len = sum(counts) * element_size
    if payload_len + tsize != len(body):
        raise ValueError("body size does not match trailer counts")
    out = []
    offset = 0
    for c in counts:
        size = c * element_size
        out.append(body[offset:offset + size])
        offset += size
    return out
