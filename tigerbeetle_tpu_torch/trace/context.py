"""Trace-context: the compact causal identity one request carries on
the wire from client submit to device dispatch and back.

The reference implementation has no distributed tracer; this module is
the package's own observability plane, modelled on the W3C
trace-context shape but packed for the 256-byte VSR header's reserved
region rather than an HTTP header:

wire block (``CTX_WIRE_SIZE`` = 28 bytes, little-endian ``<BBH16sQ``)::

    off  size  field
    0    1     magic          CTX_MAGIC (0xC7) — absent/garbage => no ctx
    1    1     flags          bit 0 = sampled (head decision at mint)
    2    2     mini-checksum  crc32(flags + trace_id + parent) & 0xFFFF
    4    16    trace_id       u128, minted once per client request
    20   8     parent_span_id u64, span the receiver should parent to

The block lives OUTSIDE the header checksum (the checksum is computed
over a zeroed reserved region), so a corrupt or truncated context
degrades to "unsampled" — ``TraceContext.unpack`` returns None and the
payload parse is unaffected.  That is the fuzzer's contract: tracing
may never take down the bus.

Identity is deterministic end to end: trace ids hash (client_id,
request_number, seed) and the head-sampling decision hashes the trace
id against a seedable rate, so a run reproduces its sampling decisions
exactly and the deterministic core needs no wall clock or unseeded RNG.
"""

from __future__ import annotations

import dataclasses
import hashlib
import struct
import zlib

CTX_MAGIC = 0xC7
FLAG_SAMPLED = 0x01

_CTX_FMT = struct.Struct("<BBH16sQ")
CTX_WIRE_SIZE = _CTX_FMT.size
assert CTX_WIRE_SIZE == 28


def _mini_checksum(flags: int, trace_id: int, parent_span_id: int) -> int:
    payload = (bytes((flags,)) + trace_id.to_bytes(16, "little")
               + parent_span_id.to_bytes(8, "little"))
    return zlib.crc32(payload) & 0xFFFF


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """One request's causal coordinates: (trace, parent span, flags)."""

    trace_id: int
    parent_span_id: int = 0
    flags: int = FLAG_SAMPLED

    @property
    def sampled(self) -> bool:
        return bool(self.flags & FLAG_SAMPLED)

    def child(self, span_id: int) -> "TraceContext":
        """The context a span hands to ITS children (bus hops, sub-work)."""
        return TraceContext(self.trace_id, span_id, self.flags)

    def pack(self) -> bytes:
        return _CTX_FMT.pack(
            CTX_MAGIC, self.flags & 0xFF,
            _mini_checksum(self.flags & 0xFF, self.trace_id,
                           self.parent_span_id),
            self.trace_id.to_bytes(16, "little"), self.parent_span_id)

    @classmethod
    def unpack(cls, data: bytes) -> "TraceContext | None":
        """None (never an exception) on anything but a pristine block."""
        if len(data) < CTX_WIRE_SIZE:
            return None
        try:
            magic, flags, mini, tid, parent = _CTX_FMT.unpack(
                data[:CTX_WIRE_SIZE])
        except struct.error:  # pragma: no cover - length guarded above
            return None
        if magic != CTX_MAGIC:
            return None
        trace_id = int.from_bytes(tid, "little")
        if mini != _mini_checksum(flags, trace_id, parent):
            return None
        return cls(trace_id=trace_id, parent_span_id=parent, flags=flags)


def fmt_trace_id(trace_id: int) -> str:
    return f"{trace_id:032x}"


def fmt_span_id(span_id: int) -> str:
    return f"{span_id:016x}"


def mint_trace_id(client_id: int, request_number: int, seed: int = 0) -> int:
    """Deterministic u128 trace id — unique per (client, request) and
    reproducible under a fixed seed, so the deterministic core never
    needs randomness to trace."""
    h = hashlib.blake2s(
        client_id.to_bytes(16, "little")
        + request_number.to_bytes(8, "little")
        + seed.to_bytes(8, "little", signed=False),
        digest_size=16).digest()
    return int.from_bytes(h, "little") or 1


def head_sampled(trace_id: int, rate: float, seed: int = 0) -> bool:
    """Deterministic head-sampling decision: hash the trace id against
    the rate.  rate >= 1.0 keeps everything, <= 0.0 nothing; the same
    (trace_id, seed) always lands on the same side, so every pid in the
    cluster agrees without coordination."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    h = hashlib.blake2s(trace_id.to_bytes(16, "little")
                        + seed.to_bytes(8, "little"),
                        digest_size=8).digest()
    return int.from_bytes(h, "little") < rate * 2.0**64


def mint_context(client_id: int, request_number: int, *,
                 head_rate: float = 1.0, seed: int = 0) -> TraceContext:
    """Mint the root context for one client request.  The context is
    ALWAYS minted (tail retention needs identity on every request);
    only the sampled flag reflects the head decision."""
    trace_id = mint_trace_id(client_id, request_number, seed)
    flags = FLAG_SAMPLED if head_sampled(trace_id, head_rate, seed) else 0
    return TraceContext(trace_id=trace_id, parent_span_id=0, flags=flags)
