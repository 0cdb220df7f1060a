"""Change-data-capture runner: pump get_change_events into a sink.

reference: src/cdc/runner.zig — a producer reads change events from the
cluster past a progress watermark while a consumer publishes the
previous batch to RabbitMQ (AMQP 0.9.1) with publisher confirms; the
watermark itself is durable in the broker, so a crashed runner resumes
exactly where the confirmed stream ended (at-least-once delivery). The
reference overlaps the two sides with io_uring and a dual buffer
(runner.zig:20-24); this runtime overlaps them with a single consumer
worker thread — batch N publishes while batch N+1 is being read.

Pieces:
- Sinks: AMQP with confirms (the reference's transport), JSONL file,
  callback (testing).
- ProgressStore: durable watermark. `AmqpProgress` keeps it in a broker
  queue exactly like the reference's progress-tracker queue
  (runner.zig:34, get_progress_message recovery phase); `FileProgress`
  is the file-sink analog (atomic sidecar). `MemoryProgress` for tests.
- Locker: `AmqpSink` declares an exclusive locker queue so two runners
  can't double-publish the same cluster's stream (runner.zig:35).
- CDCRunner: recover() -> pipelined poll()/run_until_idle().

The port's copy of the JAX package's `cdc.py`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue as queue_mod
import threading
from typing import Callable, Optional, Protocol

from .types import ChangeEvent, ChangeEventsFilter


class Sink(Protocol):
    def publish(self, event: ChangeEvent) -> None: ...
    def flush(self) -> None: ...


class CallbackSink:
    def __init__(self, fn: Callable[[ChangeEvent], None]):
        self.fn = fn

    def publish(self, event: ChangeEvent) -> None:
        self.fn(event)

    def flush(self) -> None:
        pass


class JsonlSink:
    """One JSON object per change event, append-only."""

    def __init__(self, path: str):
        self.file = open(path, "a")

    def publish(self, event: ChangeEvent) -> None:
        record = dataclasses.asdict(event)
        record["type"] = event.type.name
        self.file.write(json.dumps(record) + "\n")

    def flush(self) -> None:
        self.file.flush()
        os.fsync(self.file.fileno())

    def close(self) -> None:
        self.file.close()


class AmqpSink:
    """Publish change events to an AMQP 0.9.1 exchange with confirms
    (reference: src/cdc/runner.zig + src/amqp.zig). The watermark only
    advances after `flush()` saw every broker ack — at-least-once.

    `lock=True` declares an exclusive locker queue on this connection:
    a second runner against the same cluster fails fast instead of
    double-publishing (reference locker queue, runner.zig:35)."""

    def __init__(self, host: str, port: int, *, exchange: str = "tb.cdc",
                 routing_prefix: str = "cdc", cluster: int = 0,
                 lock: bool = False, **connect_kwargs):
        from .amqp import AmqpClient

        self.client = AmqpClient(host, port, **connect_kwargs)
        try:
            self.exchange = exchange
            self.routing_prefix = routing_prefix
            self.client.exchange_declare(exchange, "topic", durable=True)
            if lock:
                self.client.queue_declare(
                    f"tb.internal.locker.{cluster}", durable=False,
                    exclusive=True)
            self.client.confirm_select()
        except BaseException:
            # Don't strand the connection when e.g. the locker declare
            # loses to a concurrent runner (RESOURCE_LOCKED).
            self.client.close()
            raise

    def publish(self, event: ChangeEvent) -> None:
        record = dataclasses.asdict(event)
        record["type"] = event.type.name
        routing_key = f"{self.routing_prefix}.{event.type.name}"
        self.client.publish(self.exchange, routing_key,
                            json.dumps(record).encode())

    def flush(self) -> None:
        self.client.wait_confirms()

    def close(self) -> None:
        self.client.close()


# ------------------------------------------------------------- progress

class ProgressStore(Protocol):
    def load(self) -> int: ...
    def store(self, timestamp: int) -> None: ...


class MemoryProgress:
    def __init__(self, timestamp: int = 0):
        self.timestamp = timestamp

    def load(self) -> int:
        return self.timestamp

    def store(self, timestamp: int) -> None:
        self.timestamp = timestamp


class FileProgress:
    """Watermark in a sidecar file, written atomically (tmp + rename) so
    a crash mid-store leaves the previous watermark intact."""

    def __init__(self, path: str):
        self.path = path

    def load(self) -> int:
        try:
            with open(self.path) as f:
                return int(json.load(f)["timestamp_processed"])
        except (OSError, ValueError, KeyError, TypeError):
            return 0

    def store(self, timestamp: int) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"timestamp_processed": timestamp}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)


class AmqpProgress:
    """Watermark as the single message in a durable broker queue — the
    reference's progress-tracker queue (runner.zig:34): recovery drains
    the queue for the newest watermark; each store publishes the new
    watermark and acks the old message, so there is always at least one
    watermark message in the queue (crash between publish and ack leaves
    two; recovery takes the max)."""

    def __init__(self, host: str, port: int, *, cluster: int = 0,
                 **connect_kwargs):
        from .amqp import AmqpClient

        self.client = AmqpClient(host, port, **connect_kwargs)
        self.queue = f"tb.internal.progress.{cluster}"
        self.client.queue_declare(self.queue, durable=True)
        self.client.confirm_select()
        self._last_tag: Optional[int] = None

    @staticmethod
    def _parse(body: bytes) -> Optional[int]:
        try:
            return int(json.loads(body)["timestamp_processed"])
        except (ValueError, KeyError, TypeError):
            return None

    def load(self) -> int:
        newest = 0
        while True:
            got = self.client.basic_get(self.queue)
            if got is None:
                break
            tag, body = got
            parsed = self._parse(body)
            if parsed is not None:
                newest = max(newest, parsed)
            if self._last_tag is not None:
                self.client.basic_ack(self._last_tag)
            self._last_tag = tag
        return newest

    def store(self, timestamp: int) -> None:
        body = json.dumps({"timestamp_processed": timestamp}).encode()
        # Default exchange routes by queue name; confirm before acking
        # the predecessor so the queue never goes empty on a crash.
        self.client.publish("", self.queue, body)
        self.client.wait_confirms()
        if self._last_tag is not None:
            self.client.basic_ack(self._last_tag)
            self._last_tag = None
        # Check out our own message (and absorb any stale older ones) so
        # the queue holds exactly one durable watermark: the checkout is
        # acked by the NEXT store; a crash returns it to the queue for
        # recovery. Without this the queue would grow one message per
        # confirmed batch for the life of the process.
        while True:
            got = self.client.basic_get(self.queue)
            if got is None:
                break
            tag, got_body = got
            parsed = self._parse(got_body)
            if parsed is not None and parsed >= timestamp:
                self._last_tag = tag
                break
            self.client.basic_ack(tag)

    def close(self) -> None:
        self.client.close()


# --------------------------------------------------------------- runner

class CDCRunner:
    """At-least-once pump with a pipelined producer/consumer split.

    The producer (caller thread) reads change events from the source;
    the consumer (worker thread) publishes the previous batch and
    flushes confirms; the durable watermark advances only after the
    flush — so a crash replays from the last confirmed event, never
    skipping one (reference: runner.zig DualBuffer + progress queue).
    `pipeline=False` degrades to the strictly serial pump."""

    def __init__(self, source, sink: Sink, batch_limit: int = 1024,
                 progress: Optional[ProgressStore] = None,
                 pipeline: bool = True):
        # source: anything with get_change_events(ChangeEventsFilter) ->
        # list[ChangeEvent] (a StateMachine or a client wrapper).
        self.source = source
        self.sink = sink
        self.batch_limit = batch_limit
        self.progress = progress if progress is not None else \
            MemoryProgress()
        self.timestamp_processed = 0
        self.published = 0
        self.pipeline = pipeline
        self._work: Optional[queue_mod.Queue] = None
        self._done: Optional[queue_mod.Queue] = None
        self._worker: Optional[threading.Thread] = None
        self._in_flight = 0
        # Set by the worker on a publish/flush/store failure; later
        # in-flight batches are SKIPPED (not published) so the stream
        # can never advance past a failed batch — the watermark holds
        # and the next run replays from it in order.
        self._poisoned: Optional[BaseException] = None

    def recover(self) -> int:
        """Load the durable watermark (broker queue / sidecar file) —
        the crashed-runner resume point (runner.zig recovery phases)."""
        self.timestamp_processed = self.progress.load()
        return self.timestamp_processed

    # ---- consumer worker ----

    def _ensure_worker(self) -> None:
        if self._worker is not None:
            return
        self._work = queue_mod.Queue(maxsize=1)  # the dual buffer
        self._done = queue_mod.Queue()
        self._worker = threading.Thread(target=self._consume, daemon=True)
        self._worker.start()

    def _consume(self) -> None:
        assert self._work is not None and self._done is not None
        while True:
            batch = self._work.get()
            if batch is None:
                return
            if self._poisoned is not None:
                # A prior batch failed: this one must not publish (it
                # would put later events on the wire ahead of the failed
                # batch's replay) nor advance the watermark.
                self._done.put(("skipped", 0, None))
                continue
            try:
                for event in batch:
                    self.sink.publish(event)
                self.sink.flush()
                # Durable watermark AFTER the confirmed flush.
                self.progress.store(batch[-1].timestamp)
                self._done.put(("ok", len(batch), batch[-1].timestamp))
            except Exception as exc:  # noqa: BLE001 — surfaced to caller
                self._poisoned = exc
                self._done.put(("error", exc, None))

    def _drain_one(self, block: bool) -> bool:
        assert self._done is not None
        try:
            kind, a, b = self._done.get(block=block)
        except queue_mod.Empty:
            return False
        self._in_flight -= 1
        if kind == "error":
            raise a
        if kind == "ok":
            self.published += a
            self.timestamp_processed = b
        return True

    def _drain_done(self, wait_all: bool) -> None:
        """wait_all: block until every in-flight batch resolved (end of
        run). Otherwise: block only while the pipeline is full (both
        buffers busy), then absorb whatever is already finished."""
        while self._in_flight >= (1 if wait_all else 2):
            self._drain_one(block=True)
        while self._in_flight and self._drain_one(block=False):
            pass

    def _reset_pipeline(self) -> None:
        """Settle any leftovers of a previous aborted run: wait out
        in-flight batches (their results — ok before the failure,
        skipped after — are absorbed; a stale error was already raised
        to the caller once) and clear the poison. Only runs with the
        worker idle-blocked on the work queue afterward."""
        assert self._done is not None
        while self._in_flight:
            kind, a, b = self._done.get()
            self._in_flight -= 1
            if kind == "ok":
                self.published += a
                self.timestamp_processed = b
        self._poisoned = None

    # ---- producer ----

    def _read_batch(self, after: int) -> list[ChangeEvent]:
        return self.source.get_change_events(ChangeEventsFilter(
            timestamp_min=after + 1,
            timestamp_max=0,
            limit=self.batch_limit))

    def poll(self) -> int:
        """One serial pump iteration; returns events published. The
        watermark commits only after the sink flushed — a failed flush
        leaves it in place so the batch is re-read (at-least-once)."""
        if self._worker is not None:
            self._reset_pipeline()
        events = self._read_batch(self.timestamp_processed)
        if not events:
            return 0
        for event in events:
            self.sink.publish(event)
        self.sink.flush()
        self.timestamp_processed = events[-1].timestamp
        self.progress.store(self.timestamp_processed)
        self.published += len(events)
        return len(events)

    def run_until_idle(self, max_batches: int = 1 << 20) -> int:
        """Pump until the source has no newer events. With the pipeline
        on, batch N publishes on the worker while batch N+1 is read from
        the source (the reference's dual-buffer overlap); the producer
        reads past the durable watermark using its own read cursor so
        the two sides stay one batch apart."""
        if not self.pipeline:
            total = 0
            for _ in range(max_batches):
                n = self.poll()
                total += n
                if n < self.batch_limit:
                    break
            return total
        self._ensure_worker()
        assert self._work is not None
        self._reset_pipeline()
        total = 0
        cursor = self.timestamp_processed
        for _ in range(max_batches):
            events = self._read_batch(cursor)
            self._drain_done(wait_all=False)
            if not events:
                break
            cursor = events[-1].timestamp
            total += len(events)
            self._work.put(events)  # blocks only when both buffers full
            self._in_flight += 1
            if len(events) < self.batch_limit:
                break
        self._drain_done(wait_all=True)
        return total

    def close(self) -> None:
        if self._worker is not None:
            assert self._work is not None
            self._work.put(None)
            self._worker.join(timeout=10)
            self._worker = None
