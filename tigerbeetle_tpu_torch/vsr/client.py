"""Cluster client: sessions, request/reply, adaptive hedged retries.

reference: src/vsr/client.zig (ClientType: register :273, request :326,
send_request_with_hedging :734). Sessions are implicit (created on first
request); one in-flight request at a time (the reference enforces the same
per-client serialization). Hedging: the request goes to the believed
primary first; only if no reply arrives within the hedge delay does it fan
out to every replica — steady-state traffic is 1 message per request, not
N, while view changes still resolve via the fan-out.

Adaptivity (the reference's resend battery is RTT-driven, not fixed):
the hedge delay tracks an EWMA of observed reply round-trips (hedge =
multiple of smoothed RTT, clamped), and fan-out resends back off
exponentially with deterministic jitter — a slow-but-alive cluster isn't
drowned in duplicate requests, a fast one hedges in milliseconds.

A copy of the JAX package's `vsr/client.py`.
"""

from __future__ import annotations

import time as _time
from typing import Optional

from ..clients.common import ClientHelpers
from ..trace import Event, NullTracer, mint_context
from ..types import Operation
from .header import Command, Header, Message
from .message_bus import MessageBus

# Hedge-delay bounds (seconds): even a sub-ms RTT keeps a floor (one
# scheduling quantum), and a degraded link never pushes the first
# fan-out past the ceiling.
HEDGE_MIN_S = 0.01
HEDGE_MAX_S = 1.0
HEDGE_RTT_MULTIPLIER = 4.0
RESEND_BASE_S = 0.25
RESEND_MAX_S = 4.0
RTT_EWMA_ALPHA = 0.2


class SessionEvicted(Exception):
    """The cluster evicted this client's session (table full); create a
    new Client (new session) to continue (reference: eviction message)."""


class Client(ClientHelpers):
    def __init__(self, *, cluster: int, client_id: int,
                 replica_addresses: list[tuple[str, int]],
                 hedge_delay_s: Optional[float] = None,
                 tracer=None, trace_head_rate: float = 1.0,
                 trace_seed: int = 0):
        self.cluster = cluster
        self.client_id = client_id
        self.request_number = 0
        # Fixed override for tests/operators; None = adapt to RTT.
        self._hedge_override = hedge_delay_s
        self.rtt_ewma_s: Optional[float] = None
        self._reply: Optional[Message] = None
        self._evicted = False
        self._primary_guess = 0
        # Causal tracing: every request mints a deterministic trace
        # context; the recording span is the request's ROOT,
        # and the context rides the wire header to the replicas.
        self.tracer = tracer if tracer is not None else NullTracer()
        self.trace_head_rate = trace_head_rate
        self.trace_seed = trace_seed
        self.bus = MessageBus(
            cluster=cluster, on_message=self._on_message,
            replica_addresses=replica_addresses, tracer=self.tracer)

    # ------------------------------------------------------- adaptivity

    def _observe_rtt(self, rtt_s: float) -> None:
        """Fold one observed request->reply round-trip into the EWMA
        (reference: the client's timeouts are RTT-informed rather than
        fixed constants, src/vsr/client.zig:734)."""
        if self.rtt_ewma_s is None:
            self.rtt_ewma_s = rtt_s
        else:
            self.rtt_ewma_s += RTT_EWMA_ALPHA * (rtt_s - self.rtt_ewma_s)

    def hedge_delay_s(self) -> float:
        """Current hedge delay: a multiple of the smoothed RTT, clamped.
        Before any reply has been observed, the ceiling applies (an
        unknown cluster gets maximum patience before the fan-out)."""
        if self._hedge_override is not None:
            return self._hedge_override
        if self.rtt_ewma_s is None:
            return HEDGE_MAX_S
        return min(HEDGE_MAX_S,
                   max(HEDGE_MIN_S, HEDGE_RTT_MULTIPLIER * self.rtt_ewma_s))

    def _resend_delay_s(self, attempt: int) -> float:
        """Exponential backoff with deterministic per-client jitter
        (clients hash to different phases so synchronized retry storms
        can't form)."""
        base = min(RESEND_MAX_S, RESEND_BASE_S * (2 ** attempt))
        jitter = 1.0 + 0.25 * (((self.client_id * 2654435761) >> 7 & 0xFF)
                               / 255.0)
        return base * jitter

    # --------------------------------------------------------- messages

    def _on_message(self, msg: Message) -> None:
        h = msg.header
        if h.command == Command.eviction and h.client == self.client_id:
            self._evicted = True
            return
        if h.command == Command.reply and h.request == self.request_number:
            self._reply = msg
            # The reply carries the committing view: remember its primary
            # so the next request goes straight there (hedging).
            self._primary_guess = h.view % len(self.bus.replica_addresses)

    def request(self, operation: Operation, body: bytes,
                timeout_s: float = 10.0) -> bytes:
        """Send one request and block until its reply. Hedged: believed
        primary first; full fan-out only after the adaptive hedge delay,
        then resends with exponential backoff until the deadline."""
        if self._evicted:
            raise SessionEvicted(f"client {self.client_id} was evicted")
        self.request_number += 1
        ctx = mint_context(self.client_id, self.request_number,
                           head_rate=self.trace_head_rate,
                           seed=self.trace_seed)
        with self.tracer.span(Event.client_request, ctx=ctx,
                              operation=int(operation)) as root:
            header = Header(
                command=Command.request, cluster=self.cluster,
                client=self.client_id, request=self.request_number,
                operation=int(operation), trace_ctx=root.ctx or ctx)
            msg = Message(header.finalize(body), body=body)
            self._reply = None
            # Liveness plane (timeout/hedge pacing), never committed
            # state: replies are ordered by the replicas, not by when
            # this client observed them.
            start = _time.monotonic()  # torchhound: allow(wall_clock)
            deadline = start + timeout_s
            hedge_at = start + self.hedge_delay_s()
            resend_at = 0.0
            attempt = 0
            self.bus.send_to_replica(self._primary_guess, msg)
            while self._reply is None:
                if self._evicted:
                    raise SessionEvicted(
                        f"client {self.client_id} was evicted")
                now = _time.monotonic()  # torchhound: allow(wall_clock)
                if now >= deadline:
                    raise TimeoutError(
                        f"request {self.request_number} timed out")
                if now >= hedge_at and now >= resend_at:
                    resend_at = now + self._resend_delay_s(attempt)
                    attempt += 1
                    for r in range(len(self.bus.replica_addresses)):
                        self.bus.send_to_replica(r, msg)
                self.bus.poll(0.02)
            if attempt == 0:
                # Only un-hedged round-trips feed the EWMA: a reply that
                # needed the fan-out measures hedge-wait + loss recovery,
                # not RTT — folding those in would ratchet the hedge
                # delay toward the cap exactly when fast fan-out matters
                # most.
                self._observe_rtt(
                    _time.monotonic() - start)  # torchhound: allow(wall_clock)
            return self._reply.body

    # Typed helpers (create_accounts, lookups, queries) come from
    # ClientHelpers — the typed request helpers (clients/common.py).

    def close(self) -> None:
        self.bus.close()
