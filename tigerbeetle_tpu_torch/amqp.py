"""AMQP 0.9.1 wire protocol: the CDC publisher's transport.

reference: src/amqp.zig + src/amqp/{protocol,spec,types}.zig — the
reference implements the protocol itself rather than depending on a client
library, and so does this module: frame codec, connection/channel
handshake, exchange/queue declaration, publisher confirms, and
basic.publish with content frames. Only the subset the CDC runner needs
(reference: src/cdc/runner.zig publishes change events with confirms).

Layout is sans-io at the codec level (encode_*/Frame.parse are pure) with
a small blocking socket client on top.

The port's copy of the JAX package's `amqp.py`: the same frames, byte
for byte.
"""

from __future__ import annotations

import socket
import struct
from typing import Iterator, Optional

PROTOCOL_HEADER = b"AMQP\x00\x00\x09\x01"

FRAME_METHOD = 1
FRAME_HEADER = 2
FRAME_BODY = 3
FRAME_HEARTBEAT = 8
FRAME_END = 0xCE

# (class, method) ids — AMQP 0.9.1 spec numbering.
CONNECTION_START = (10, 10)
CONNECTION_START_OK = (10, 11)
CONNECTION_TUNE = (10, 30)
CONNECTION_TUNE_OK = (10, 31)
CONNECTION_OPEN = (10, 40)
CONNECTION_OPEN_OK = (10, 41)
CONNECTION_CLOSE = (10, 50)
CONNECTION_CLOSE_OK = (10, 51)
CHANNEL_OPEN = (20, 10)
CHANNEL_OPEN_OK = (20, 11)
CHANNEL_CLOSE = (20, 40)
CHANNEL_CLOSE_OK = (20, 41)
EXCHANGE_DECLARE = (40, 10)
EXCHANGE_DECLARE_OK = (40, 11)
QUEUE_DECLARE = (50, 10)
QUEUE_DECLARE_OK = (50, 11)
QUEUE_BIND = (50, 20)
QUEUE_BIND_OK = (50, 21)
BASIC_PUBLISH = (60, 40)
BASIC_GET = (60, 70)
BASIC_GET_OK = (60, 71)
BASIC_GET_EMPTY = (60, 72)
BASIC_CLASS = 60
BASIC_ACK = (60, 80)
BASIC_NACK = (60, 120)
CONFIRM_SELECT = (85, 10)
CONFIRM_SELECT_OK = (85, 11)

RESOURCE_LOCKED = 405


class ProtocolError(Exception):
    pass


# ------------------------------------------------------------- primitives

def shortstr(s: str) -> bytes:
    raw = s.encode()
    assert len(raw) < 256
    return bytes([len(raw)]) + raw


def longstr(raw: bytes) -> bytes:
    return struct.pack(">I", len(raw)) + raw


def field_table(d: Optional[dict] = None) -> bytes:
    """Encode a field table (longstr values only — all this client emits)."""
    parts = []
    for key, value in (d or {}).items():
        if isinstance(value, str):
            parts.append(shortstr(key) + b"S" + longstr(value.encode()))
        elif isinstance(value, bool):
            parts.append(shortstr(key) + b"t" + (b"\x01" if value else b"\x00"))
        elif isinstance(value, int):
            parts.append(shortstr(key) + b"I" + struct.pack(">i", value))
        else:
            raise ProtocolError(f"unsupported table value {value!r}")
    body = b"".join(parts)
    return struct.pack(">I", len(body)) + body


class Reader:
    def __init__(self, raw: bytes):
        self.raw = raw
        self.pos = 0

    def u8(self) -> int:
        (v,) = struct.unpack_from(">B", self.raw, self.pos)
        self.pos += 1
        return v

    def u16(self) -> int:
        (v,) = struct.unpack_from(">H", self.raw, self.pos)
        self.pos += 2
        return v

    def u32(self) -> int:
        (v,) = struct.unpack_from(">I", self.raw, self.pos)
        self.pos += 4
        return v

    def u64(self) -> int:
        (v,) = struct.unpack_from(">Q", self.raw, self.pos)
        self.pos += 8
        return v

    def shortstr(self) -> str:
        n = self.u8()
        s = self.raw[self.pos:self.pos + n]
        self.pos += n
        return s.decode()

    def longstr(self) -> bytes:
        n = self.u32()
        s = self.raw[self.pos:self.pos + n]
        self.pos += n
        return s

    def table(self) -> dict:
        size = self.u32()
        end = self.pos + size
        out = {}
        while self.pos < end:
            key = self.shortstr()
            kind = self.raw[self.pos:self.pos + 1]
            self.pos += 1
            if kind == b"S":
                out[key] = self.longstr().decode()
            elif kind == b"t":
                out[key] = self.u8() != 0
            elif kind == b"I":
                (v,) = struct.unpack_from(">i", self.raw, self.pos)
                self.pos += 4
                out[key] = v
            else:
                raise ProtocolError(f"unsupported table type {kind!r}")
        return out


# ------------------------------------------------------------------ frames

def frame(frame_type: int, channel: int, payload: bytes) -> bytes:
    return (struct.pack(">BHI", frame_type, channel, len(payload))
            + payload + bytes([FRAME_END]))


def method_frame(channel: int, class_method: tuple, args: bytes = b"") -> bytes:
    class_id, method_id = class_method
    return frame(FRAME_METHOD, channel,
                 struct.pack(">HH", class_id, method_id) + args)


def content_frames(channel: int, body: bytes,
                   frame_max: int = 128 * 1024) -> bytes:
    """Content header + body frames for one basic.publish."""
    header = struct.pack(">HHQH", BASIC_CLASS, 0, len(body), 0)
    out = [frame(FRAME_HEADER, channel, header)]
    chunk_max = frame_max - 8
    for off in range(0, len(body), chunk_max):
        out.append(frame(FRAME_BODY, channel, body[off:off + chunk_max]))
    return b"".join(out)


class Frame:
    def __init__(self, frame_type: int, channel: int, payload: bytes):
        self.type = frame_type
        self.channel = channel
        self.payload = payload

    @property
    def method(self) -> Optional[tuple]:
        if self.type != FRAME_METHOD:
            return None
        return struct.unpack_from(">HH", self.payload)

    def args(self) -> Reader:
        reader = Reader(self.payload)
        reader.pos = 4
        return reader

    @staticmethod
    def parse(buffer: bytearray) -> Optional["Frame"]:
        """Pop one frame off the buffer, or None if incomplete."""
        if len(buffer) < 8:
            return None
        frame_type, channel, size = struct.unpack_from(">BHI", buffer)
        total = 7 + size + 1
        if len(buffer) < total:
            return None
        if buffer[total - 1] != FRAME_END:
            raise ProtocolError("missing frame-end octet")
        payload = bytes(buffer[7:7 + size])
        del buffer[:total]
        return Frame(frame_type, channel, payload)


# ------------------------------------------------------------------ client

class AmqpClient:
    """Blocking publisher connection with confirms.

    reference: src/cdc/amqp.zig connection bring-up + publish path."""

    def __init__(self, host: str, port: int, *, virtual_host: str = "/",
                 user: str = "guest", password: str = "guest",
                 timeout_s: float = 10.0):
        self.sock = socket.create_connection((host, port), timeout=timeout_s)
        self.rx = bytearray()
        self.channel = 1
        self.confirm_mode = False
        self.publish_seq = 0
        self.outstanding: set[int] = set()  # unacked delivery tags
        self._handshake(virtual_host, user, password)

    # -------------------------------------------------------------- wires

    def _send(self, raw: bytes) -> None:
        self.sock.sendall(raw)

    def _recv_frame(self) -> Frame:
        while True:
            got = Frame.parse(self.rx)
            if got is not None:
                if got.type == FRAME_HEARTBEAT:
                    continue
                return got
            chunk = self.sock.recv(64 * 1024)
            if not chunk:
                raise ProtocolError("connection closed by broker")
            self.rx += chunk

    def _expect(self, class_method: tuple) -> Frame:
        got = self._recv_frame()
        if got.method != class_method:
            raise ProtocolError(
                f"expected {class_method}, got {got.method}")
        return got

    # ---------------------------------------------------------- handshake

    def _handshake(self, virtual_host: str, user: str, password: str) -> None:
        self._send(PROTOCOL_HEADER)
        self._expect(CONNECTION_START)
        response = b"\x00" + user.encode() + b"\x00" + password.encode()
        self._send(method_frame(0, CONNECTION_START_OK,
                                field_table({"product": "tigerbeetle-tpu"})
                                + shortstr("PLAIN") + longstr(response)
                                + shortstr("en_US")))
        tune = self._expect(CONNECTION_TUNE).args()
        channel_max = tune.u16()
        frame_max = tune.u32()
        tune.u16()  # broker-proposed heartbeat
        self.frame_max = frame_max or 128 * 1024
        # Negotiate heartbeats OFF (0): this client is a pump that may
        # legitimately idle between polls and sends no heartbeat frames.
        self._send(method_frame(0, CONNECTION_TUNE_OK, struct.pack(
            ">HIH", channel_max, self.frame_max, 0)))
        self._send(method_frame(0, CONNECTION_OPEN,
                                shortstr(virtual_host) + shortstr("") + b"\x00"))
        self._expect(CONNECTION_OPEN_OK)
        self._send(method_frame(self.channel, CHANNEL_OPEN, shortstr("")))
        self._expect(CHANNEL_OPEN_OK)

    # ------------------------------------------------------------ methods

    def exchange_declare(self, exchange: str, kind: str = "topic",
                         durable: bool = True) -> None:
        flags = 0b10 if durable else 0
        self._send(method_frame(
            self.channel, EXCHANGE_DECLARE,
            struct.pack(">H", 0) + shortstr(exchange) + shortstr(kind)
            + bytes([flags]) + field_table()))
        self._expect(EXCHANGE_DECLARE_OK)

    def queue_declare(self, queue: str, durable: bool = True,
                      exclusive: bool = False) -> None:
        """Declare a queue. `exclusive` queues belong to this connection
        and make a second declare by another connection fail with
        RESOURCE_LOCKED — the CDC runner's single-writer lock
        (reference: the locker queue, src/cdc/runner.zig:35)."""
        flags = (0b10 if durable else 0) | (0b100 if exclusive else 0)
        self._send(method_frame(
            self.channel, QUEUE_DECLARE,
            struct.pack(">H", 0) + shortstr(queue) + bytes([flags])
            + field_table()))
        got = self._recv_frame()
        if got.method == QUEUE_DECLARE_OK:
            return
        if got.method in (CONNECTION_CLOSE, CHANNEL_CLOSE):
            args = got.args()
            code = args.u16()
            text = args.shortstr()
            raise ProtocolError(f"queue.declare failed: {code} {text}")
        raise ProtocolError(f"expected queue.declare-ok, got {got.method}")

    def _apply_confirm(self, got: Frame) -> None:
        """Fold one broker basic.ack/nack into the outstanding confirm
        set (shared by wait_confirms and basic_get's absorption path)."""
        args = got.args()
        delivery_tag = args.u64()
        multiple = args.u8() & 1
        tags = ([t for t in self.outstanding if t <= delivery_tag]
                if multiple else
                [delivery_tag] if delivery_tag in self.outstanding
                else [])
        self.outstanding.difference_update(tags)
        if got.method == BASIC_NACK:
            raise ProtocolError(
                f"broker nacked delivery tag(s) {tags or [delivery_tag]}")

    def basic_get(self, queue: str,
                  no_ack: bool = False) -> Optional[tuple[int, bytes]]:
        """Synchronous single-message fetch: (delivery_tag, body), or
        None when the queue is empty — how the CDC runner recovers its
        progress watermark from the broker at startup (reference:
        runner.zig get_progress_message phase)."""
        self._send(method_frame(
            self.channel, BASIC_GET,
            struct.pack(">H", 0) + shortstr(queue)
            + bytes([1 if no_ack else 0])))
        got = self._recv_frame()
        # Outstanding publisher confirms may interleave ahead of the
        # get-ok on a shared channel; absorb them into the confirm set.
        while got.method in (BASIC_ACK, BASIC_NACK) and self.confirm_mode:
            self._apply_confirm(got)
            got = self._recv_frame()
        if got.method == BASIC_GET_EMPTY:
            return None
        if got.method != BASIC_GET_OK:
            raise ProtocolError(f"expected get-ok/empty, got {got.method}")
        args = got.args()
        delivery_tag = args.u64()
        args.u8()  # redelivered
        args.shortstr()  # exchange
        args.shortstr()  # routing key
        args.u32()  # message count
        header = self._recv_frame()
        if header.type != FRAME_HEADER:
            raise ProtocolError("expected content header after get-ok")
        _, _, body_size, _ = struct.unpack_from(">HHQH", header.payload)
        body = b""
        while len(body) < body_size:
            part = self._recv_frame()
            if part.type != FRAME_BODY:
                raise ProtocolError("expected content body frame")
            body += part.payload
        return delivery_tag, body

    def basic_ack(self, delivery_tag: int, multiple: bool = False) -> None:
        self._send(method_frame(
            self.channel, BASIC_ACK,
            struct.pack(">QB", delivery_tag, 1 if multiple else 0)))

    def queue_bind(self, queue: str, exchange: str, routing_key: str) -> None:
        self._send(method_frame(
            self.channel, QUEUE_BIND,
            struct.pack(">H", 0) + shortstr(queue) + shortstr(exchange)
            + shortstr(routing_key) + b"\x00" + field_table()))
        self._expect(QUEUE_BIND_OK)

    def confirm_select(self) -> None:
        """Publisher confirms (reference: the CDC runner publishes with
        confirms so progress only advances on broker ack)."""
        self._send(method_frame(self.channel, CONFIRM_SELECT, b"\x00"))
        self._expect(CONFIRM_SELECT_OK)
        self.confirm_mode = True

    def publish(self, exchange: str, routing_key: str, body: bytes) -> None:
        self._send(
            method_frame(self.channel, BASIC_PUBLISH,
                         struct.pack(">H", 0) + shortstr(exchange)
                         + shortstr(routing_key) + b"\x00")
            + content_frames(self.channel, body, self.frame_max))
        self.publish_seq += 1
        if self.confirm_mode:
            self.outstanding.add(self.publish_seq)

    def wait_confirms(self) -> None:
        """Block until every published message is acked. Acks may arrive
        out of order and with `multiple` set; a nack is a delivery failure
        the caller must treat as such (the CDC runner keeps its watermark
        in place and re-publishes)."""
        assert self.confirm_mode
        while self.outstanding:
            got = self._recv_frame()
            if got.method not in (BASIC_ACK, BASIC_NACK):
                raise ProtocolError(
                    f"expected basic.ack/nack, got {got.method}")
            self._apply_confirm(got)

    def close(self) -> None:
        try:
            self._send(method_frame(
                0, CONNECTION_CLOSE,
                struct.pack(">H", 200) + shortstr("bye")
                + struct.pack(">HH", 0, 0)))
            self._expect(CONNECTION_CLOSE_OK)
        except Exception:
            pass
        self.sock.close()


# --------------------------------------------------- consumption (testing)

def parse_publishes(raw: bytes) -> Iterator[tuple[str, str, bytes]]:
    """Decode (exchange, routing key, body) triples from a raw channel
    byte stream of publish + content frames — the broker-side half the
    tests use to verify what the client put on the wire."""
    buffer = bytearray(raw)
    pending: Optional[tuple[str, str]] = None
    body_size = 0
    body = b""
    while True:
        got = Frame.parse(buffer)
        if got is None:
            return
        if got.method == BASIC_PUBLISH:
            args = got.args()
            args.u16()
            exchange = args.shortstr()
            routing_key = args.shortstr()
            pending = (exchange, routing_key)
        elif got.type == FRAME_HEADER and pending is not None:
            _, _, body_size, _ = struct.unpack_from(">HHQH", got.payload)
            body = b""
            if body_size == 0:
                yield (*pending, b"")
                pending = None
        elif got.type == FRAME_BODY and pending is not None:
            body += got.payload
            if len(body) >= body_size:
                yield (*pending, body)
                pending = None
