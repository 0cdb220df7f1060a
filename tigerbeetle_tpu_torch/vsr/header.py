"""256-byte checksummed message header.

Every message and WAL entry starts with one (reference:
src/vsr/message_header.zig:17-76). This is a fresh layout — same size, same
invariant style (checksum covers the rest of the header; checksum_body
covers the body; `parent` hash-chains prepares) — designed for this
framework rather than wire compatibility with the reference.

Layout (little-endian, 256 bytes):
  offset size field
  0      16   checksum        (over bytes 16..256)
  16     16   checksum_body
  32     16   parent          (hash chain: previous prepare's checksum)
  48     16   client          (client id, u128)
  64     16   context         (command-specific, e.g. reply's request chain)
  80     8    cluster
  96+    ...  see _FMT below
"""

from __future__ import annotations

import dataclasses
import enum
import struct

from ..trace.context import CTX_WIRE_SIZE, TraceContext
from .checksum import checksum

HEADER_SIZE = 256

# The trace-context block rides in the reserved region, at
# this offset into the packed 256 bytes.  The header checksum is
# computed over a ZEROED reserved region (`_packed_tail`), so the block
# is out-of-checksum by construction: corrupting it degrades the frame
# to "unsampled" (TraceContext.unpack -> None) without invalidating the
# header or body.
TRACE_CTX_OFFSET = HEADER_SIZE - 116
assert TRACE_CTX_OFFSET + CTX_WIRE_SIZE <= HEADER_SIZE


class Command(enum.IntEnum):
    """reference: src/vsr.zig:230 (21 live commands, table in
    docs/internals/vsr.md:30-51)."""

    reserved = 0
    ping = 1
    pong = 2
    ping_client = 3
    pong_client = 4
    request = 5
    prepare = 6
    prepare_ok = 7
    reply = 8
    commit = 9
    start_view_change = 10
    do_view_change = 11
    start_view = 12
    request_start_view = 13
    request_headers = 14
    headers = 15
    request_prepare = 16
    request_reply = 17
    eviction = 18
    request_blocks = 19
    block = 20
    # Protocol-aware recovery (reference: quorum_nack_prepare,
    # src/vsr/replica.zig:254, docs/ARCHITECTURE.md:540-563): "I can
    # prove I never prepared this op/checksum" — sent in response to an
    # unserviceable request_prepare by a replica whose WAL slot for the
    # op is demonstrably not a torn write of it.
    nack_prepare = 21


_FMT = struct.Struct(
    "<16s16s16s16s16s"  # checksum, checksum_body, parent, client, context
    "QII"               # cluster, size, epoch
    "QQQQ"              # view, op, commit, timestamp
    "IIHBB"             # request, release, operation, command, replica
    "116s"              # reserved
)
assert _FMT.size == HEADER_SIZE


def _u128b(x: int) -> bytes:
    return x.to_bytes(16, "little")


def _u128i(b: bytes) -> int:
    return int.from_bytes(b, "little")


@dataclasses.dataclass
class Header:
    checksum: int = 0
    checksum_body: int = 0
    parent: int = 0
    client: int = 0
    context: int = 0
    cluster: int = 0
    size: int = HEADER_SIZE  # header + body bytes
    epoch: int = 0
    view: int = 0
    op: int = 0
    commit: int = 0
    timestamp: int = 0
    request: int = 0
    release: int = 0
    operation: int = 0
    command: Command = Command.reserved
    replica: int = 0
    # Causal identity (not part of either checksum; see TRACE_CTX_OFFSET).
    trace_ctx: TraceContext | None = None

    def _packed_tail(self) -> bytes:
        return _FMT.pack(
            b"\x00" * 16,
            _u128b(self.checksum_body),
            _u128b(self.parent),
            _u128b(self.client),
            _u128b(self.context),
            self.cluster, self.size, self.epoch,
            self.view, self.op, self.commit, self.timestamp,
            self.request, self.release, self.operation,
            int(self.command), self.replica,
            b"\x00" * 116,
        )[16:]

    def calculate_checksum(self) -> int:
        return checksum(self._packed_tail(), domain=b"hdr")

    def set_checksum_body(self, body: bytes) -> None:
        assert len(body) == self.size - HEADER_SIZE
        self.checksum_body = checksum(body, domain=b"body")

    def finalize(self, body: bytes = b"") -> "Header":
        """Set size/checksum_body/checksum for this header+body."""
        self.size = HEADER_SIZE + len(body)
        self.set_checksum_body(body)
        self.checksum = self.calculate_checksum()
        return self

    def pack(self) -> bytes:
        raw = _u128b(self.checksum) + self._packed_tail()
        if self.trace_ctx is None:
            return raw
        return (raw[:TRACE_CTX_OFFSET] + self.trace_ctx.pack()
                + raw[TRACE_CTX_OFFSET + CTX_WIRE_SIZE:])

    @classmethod
    def unpack(cls, data: bytes) -> "Header":
        f = _FMT.unpack(data[:HEADER_SIZE])
        return cls(
            checksum=_u128i(data[:16]),
            checksum_body=_u128i(f[1]),
            parent=_u128i(f[2]),
            client=_u128i(f[3]),
            context=_u128i(f[4]),
            cluster=f[5], size=f[6], epoch=f[7],
            view=f[8], op=f[9], commit=f[10], timestamp=f[11],
            request=f[12], release=f[13], operation=f[14],
            command=Command(f[15]), replica=f[16],
            trace_ctx=TraceContext.unpack(
                data[TRACE_CTX_OFFSET:TRACE_CTX_OFFSET + CTX_WIRE_SIZE]),
        )

    def valid_checksum(self) -> bool:
        return self.checksum == self.calculate_checksum()

    def valid_checksum_body(self, body: bytes) -> bool:
        if len(body) != self.size - HEADER_SIZE:
            return False
        return self.checksum_body == checksum(body, domain=b"body")


@dataclasses.dataclass
class Message:
    """A header + body pair (reference: src/message_pool.zig Message)."""

    header: Header
    body: bytes = b""

    def pack(self) -> bytes:
        return self.header.pack() + self.body

    @classmethod
    def unpack(cls, data: bytes) -> "Message":
        header = Header.unpack(data[:HEADER_SIZE])
        body = data[HEADER_SIZE:header.size]
        return cls(header=header, body=body)

    def valid(self) -> bool:
        return (self.header.valid_checksum()
                and self.header.valid_checksum_body(self.body))
