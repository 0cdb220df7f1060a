"""TCP message bus: the production network transport.

reference: src/message_bus.zig (MessageBusType over io_uring sockets) +
src/message_buffer.zig (checksum-validated framing). This implementation is
a single-threaded selectors-based event loop — the same run-to-completion
model as the reference's io_uring loop, portable Python instead of Zig.

Delivery contract is deliberately weak, exactly like the reference
(docs/ARCHITECTURE.md:610-615): messages may be dropped (send buffers full,
connection resets), duplicated (reconnects), or reordered across
connections; VSR tolerates all of it. Frames are validated by header +
body checksums before delivery; garbage closes the connection.

Peers: each replica listens on its address and dials every other replica;
inbound connections are identified by the `replica` field of their first
valid message. Clients connect inbound only and are identified by the
`client` field of their requests.

A copy of the JAX package's `vsr/message_bus.py`; the wire bytes are its.
"""

from __future__ import annotations

import errno
import selectors
import socket
from collections import deque
from typing import Callable, Optional

from ..trace import Event, NullTracer
from .header import HEADER_SIZE, Command, Header, Message

RECV_CHUNK = 256 * 1024
SEND_BUFFER_MAX = 64 * 1024 * 1024

# Static message pool (reference: src/message_pool.zig:107 — a fixed
# buffer budget shared by every connection; exhaustion SUSPENDS reads
# instead of growing memory). Here the pooled resource is queued outbound
# messages: client reads stop at the high watermark and resume at the low
# one, so overload turns into TCP backpressure on clients instead of
# reply drops + retry storms (reference: message_bus suspend/resume,
# src/message_bus.zig:1217-1223). Replica-to-replica traffic is never
# suspended — VSR liveness rides on it (its contract tolerates drops).
MESSAGE_POOL_SIZE = 4096
POOL_SUSPEND_AT = MESSAGE_POOL_SIZE * 3 // 4
POOL_RESUME_AT = MESSAGE_POOL_SIZE // 2


class _Connection:
    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.rx = bytearray()
        self.tx = bytearray()
        self.tx_sizes: deque = deque()  # per-message byte sizes (pool acct)
        self.tx_sent = 0  # bytes sent of tx_sizes[0]
        self.peer: Optional[tuple] = None  # ("replica", i) | ("client", id)
        self.read_suspended = False

    def want_write(self) -> bool:
        return bool(self.tx)


class MessageBus:
    """One event loop endpoint (a replica process or a client process)."""

    def __init__(self, *, cluster: int,
                 on_message: Callable[[Message], None],
                 replica_addresses: list[tuple[str, int]],
                 replica_id: Optional[int] = None,
                 listen: bool = False,
                 listen_port: Optional[int] = None,
                 tracer=None):
        self.cluster = cluster
        self.on_message = on_message
        self.tracer = tracer if tracer is not None else NullTracer()
        self.replica_addresses = replica_addresses
        self.replica_id = replica_id
        self.selector = selectors.DefaultSelector()
        self.connections: dict[socket.socket, _Connection] = {}
        self.by_peer: dict[tuple, _Connection] = {}
        # Pool accounting + drop counters (observable backpressure).
        self.pool_used = 0
        self.dropped_replica = 0
        self.dropped_client = 0
        # Regime flags: O(1) hot-path checks instead of per-message scans.
        self._global_suspended = False
        self._suspended_count = 0
        self.listener: Optional[socket.socket] = None
        if listen:
            assert replica_id is not None
            host, port = replica_addresses[replica_id]
            if listen_port is not None:
                # Bind here while peers dial us at the advertised address —
                # lets a fault-injecting proxy sit in between (vortex).
                port = listen_port
            self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self.listener.bind((host, port))
            self.listener.listen(64)
            self.listener.setblocking(False)
            self.selector.register(self.listener, selectors.EVENT_READ, None)

    @property
    def listen_address(self) -> tuple[str, int]:
        return self.listener.getsockname()

    # ------------------------------------------------------------- sending

    def send_to_replica(self, dst: int, msg: Message) -> None:
        if dst == self.replica_id:
            self.on_message(msg)
            return
        conn = self.by_peer.get(("replica", dst))
        if conn is None:
            conn = self._dial(dst)
            if conn is None:
                return  # dropped: weak delivery contract
        self._enqueue(conn, msg)

    def send_to_client(self, client_id: int, msg: Message) -> None:
        conn = self.by_peer.get(("client", client_id))
        if conn is not None:
            self._enqueue(conn, msg)

    def _enqueue(self, conn: _Connection, msg: Message) -> None:
        is_client = conn.peer is not None and conn.peer[0] == "client"
        # Replica traffic may use the FULL pool; client replies stop at
        # the suspend watermark — wedged clients (connected, never
        # draining) must not starve consensus messages of slots.
        budget = POOL_SUSPEND_AT if is_client else MESSAGE_POOL_SIZE
        if self.pool_used >= budget or len(conn.tx) > SEND_BUFFER_MAX:
            # Pool exhausted / peer not draining: drop is the last resort
            # (the suspend watermarks below make this rare for clients).
            if is_client:
                self.dropped_client += 1
            else:
                self.dropped_replica += 1
            return
        # `csum` ties this span to the receiver's bus_recv of the SAME
        # frame: trace/merge.py matches the pairs to estimate per-pid
        # clock offsets before causal assembly (low 32 bits are plenty
        # to match within one trace window).
        with self.tracer.span(Event.bus_send,
                              command=Command(msg.header.command).name,
                              csum=msg.header.checksum & 0xFFFFFFFF):
            raw = msg.pack()
            conn.tx += raw
        conn.tx_sizes.append(len(raw))
        self.pool_used += 1
        self.tracer.gauge(Event.bus_pool_used, self.pool_used)
        if self.pool_used >= POOL_SUSPEND_AT and not self._global_suspended:
            self._global_suspended = True
            self._suspend_client_reads()
        elif (is_client and not conn.read_suspended
                and len(conn.tx) > SEND_BUFFER_MAX // 2):
            # A single slow client: stop reading ITS requests before its
            # reply queue forces drops (per-connection backpressure).
            conn.read_suspended = True
            self._suspended_count += 1
        self._update_events(conn)

    def _suspend_client_reads(self) -> None:
        for conn in self.connections.values():
            if (not conn.read_suspended and conn.peer is not None
                    and conn.peer[0] == "client"):
                conn.read_suspended = True
                self._suspended_count += 1
                self._update_events(conn)

    def _maybe_resume_reads(self) -> None:
        if not self._suspended_count:
            return
        if self._global_suspended:
            if self.pool_used > POOL_RESUME_AT:
                return  # the GLOBAL regime holds everyone parked
            self._global_suspended = False
        # Per-connection hysteresis: resume once the connection's own
        # queue falls back below its suspend watermark (the global axis,
        # once cleared above, must not keep an individually-drained
        # client parked forever).
        for conn in self.connections.values():
            if conn.read_suspended and len(conn.tx) <= SEND_BUFFER_MAX // 2:
                conn.read_suspended = False
                self._suspended_count -= 1
                self._update_events(conn)

    def _dial(self, dst: int) -> Optional[_Connection]:
        host, port = self.replica_addresses[dst]
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setblocking(False)
        try:
            sock.connect((host, port))
        except BlockingIOError:
            pass
        except OSError:
            sock.close()
            return None
        conn = _Connection(sock)
        conn.peer = ("replica", dst)
        self.connections[sock] = conn
        self.by_peer[conn.peer] = conn
        self.selector.register(sock, selectors.EVENT_READ | selectors.EVENT_WRITE,
                               conn)
        if self.replica_id is not None:
            # Identify ourselves so the peer can route prepare_oks back
            # (reference: peer handshake via header fields, src/vsr.zig:88-94).
            # Through _enqueue like any message: the pool accounting reaps
            # per tx_sizes entry, and an unaccounted prefix would skew it
            # one message early forever.
            hello = Header(command=Command.ping, cluster=self.cluster,
                           replica=self.replica_id)
            self._enqueue(conn, Message(hello.finalize()))
        return conn

    # ------------------------------------------------------------ the loop

    def poll(self, timeout: float = 0.0) -> None:
        for key, events in self.selector.select(timeout):
            if key.fileobj is self.listener:
                self._accept()
                continue
            conn: _Connection = key.data
            if events & selectors.EVENT_WRITE:
                self._flush(conn)
            if events & selectors.EVENT_READ and conn.sock in self.connections:
                self._drain(conn)

    def _accept(self) -> None:
        try:
            sock, _addr = self.listener.accept()
        except OSError:
            return
        sock.setblocking(False)
        conn = _Connection(sock)
        self.connections[sock] = conn
        self.selector.register(sock, selectors.EVENT_READ, conn)

    def _flush(self, conn: _Connection) -> None:
        try:
            while conn.tx:
                sent = conn.sock.send(conn.tx[:RECV_CHUNK])
                if sent == 0:
                    break
                del conn.tx[:sent]
                self._reap_sent(conn, sent)
        except OSError as e:
            if e.errno not in (errno.EAGAIN, errno.EWOULDBLOCK):
                self._close(conn)
                return
        self._maybe_resume_reads()
        self._update_events(conn)

    def _reap_sent(self, conn: _Connection, sent: int) -> None:
        """Release pool slots for fully-transmitted messages."""
        conn.tx_sent += sent
        while conn.tx_sizes and conn.tx_sent >= conn.tx_sizes[0]:
            conn.tx_sent -= conn.tx_sizes.popleft()
            self.pool_used -= 1

    def _drain(self, conn: _Connection) -> None:
        try:
            chunk = conn.sock.recv(RECV_CHUNK)
        except OSError as e:
            if e.errno in (errno.EAGAIN, errno.EWOULDBLOCK):
                return
            self._close(conn)
            return
        if not chunk:
            self._close(conn)
            return
        conn.rx += chunk
        while len(conn.rx) >= HEADER_SIZE:
            try:
                header = Header.unpack(bytes(conn.rx[:HEADER_SIZE]))
            except Exception:
                self._close(conn)
                return
            if (not header.valid_checksum()
                    or header.size < HEADER_SIZE
                    or header.size > 64 * 1024 * 1024):
                self._close(conn)  # corrupt stream: force reconnect
                return
            if len(conn.rx) < header.size:
                break
            raw = bytes(conn.rx[:header.size])
            del conn.rx[:header.size]
            msg = Message.unpack(raw)
            if not msg.valid() or msg.header.cluster != self.cluster:
                continue
            with self.tracer.span(
                    Event.bus_recv,
                    command=Command(msg.header.command).name,
                    csum=msg.header.checksum & 0xFFFFFFFF):
                self._identify(conn, msg.header)
                self.on_message(msg)

    def _identify(self, conn: _Connection, header: Header) -> None:
        if conn.peer is not None:
            return
        if header.command == Command.request or header.command in (
                Command.ping_client, Command.pong_client):
            peer = ("client", header.client)
        else:
            peer = ("replica", header.replica)
        conn.peer = peer
        old = self.by_peer.get(peer)
        self.by_peer[peer] = conn
        if old is not None and old is not conn:
            self._close(old, forget_peer=False)

    def _update_events(self, conn: _Connection) -> None:
        if conn.sock not in self.connections:
            return
        events = 0 if conn.read_suspended else selectors.EVENT_READ
        if conn.want_write():
            events |= selectors.EVENT_WRITE
        try:
            if events:
                try:
                    self.selector.modify(conn.sock, events, conn)
                except KeyError:
                    self.selector.register(conn.sock, events, conn)
            else:
                # selectors cannot watch for "nothing": park the socket
                # (resume re-registers it).
                try:
                    self.selector.unregister(conn.sock)
                except KeyError:
                    pass
        except ValueError:
            pass

    def _close(self, conn: _Connection, forget_peer: bool = True) -> None:
        self.pool_used -= len(conn.tx_sizes)  # unsent slots return
        conn.tx_sizes = deque()
        if conn.read_suspended:
            conn.read_suspended = False
            self._suspended_count -= 1
        self.connections.pop(conn.sock, None)
        # Slots released by the close may be what suspended clients were
        # waiting for — a quiet bus would otherwise never resume them.
        self._maybe_resume_reads()
        if forget_peer and conn.peer is not None:
            if self.by_peer.get(conn.peer) is conn:
                del self.by_peer[conn.peer]
        try:
            self.selector.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        conn.sock.close()

    def close(self) -> None:
        for conn in list(self.connections.values()):
            self._close(conn)
        if self.listener is not None:
            self.selector.unregister(self.listener)
            self.listener.close()
