"""Write-ahead journal: two on-disk rings (redundant headers + prepares).

reference: src/vsr/journal.zig:16-27 — the WAL is two rings indexed by
op % slot_count: a ring of full prepare messages and a ring of just their
256-byte headers. The redundant header ring disambiguates torn prepare
writes during recovery: a valid header whose prepare is corrupt marks the
slot faulty-but-known, repairable from peers; both-invalid marks it
unknown.

A copy of the JAX package's `vsr/journal.py`; the WAL bytes are its.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

from ..trace import Event, NullTracer
from .header import HEADER_SIZE, Command, Header, Message
from .storage import Storage


class SlotState(enum.Enum):
    clean = "clean"  # header and prepare agree and validate
    faulty = "faulty"  # header valid, prepare torn/corrupt -> repair
    unknown = "unknown"  # nothing valid in the slot


@dataclasses.dataclass
class Slot:
    state: SlotState
    header: Optional[Header] = None  # valid for clean/faulty


class Journal:
    def __init__(self, storage: Storage, tracer=None):
        self.storage = storage
        self.tracer = tracer if tracer is not None else NullTracer()
        self.slot_count = storage.layout.slot_count
        self.prepare_size_max = storage.layout.message_size_max
        # In-memory copy of the header ring (reference keeps headers
        # resident: src/vsr/journal.zig headers array).
        self.headers: list[Optional[Header]] = [None] * self.slot_count
        self.dirty: set[int] = set()
        self.faulty: set[int] = set()
        # In-flight async appends: token -> (slot, message, callbacks);
        # reads of a pending slot are served from the retained message, so
        # the disk write never blocks the replica loop (reference: the
        # journal overlaps write_prepare with replication,
        # src/io/linux.zig + src/vsr/journal.zig:137).
        self._pending: dict[int, tuple[int, Message, list]] = {}
        self._pending_by_slot: dict[int, int] = {}
        # Durability callbacks reaped at a no-fire barrier (checkpoint) or
        # mid-append; fired in order at the next poll_io.
        self._deferred: list = []

    def slot_for_op(self, op: int) -> int:
        return op % self.slot_count

    # ---------------------------------------------------------------- write

    def append(self, message: Message, on_durable=None) -> bool:
        """Write prepare body then its redundant header (ordering matters:
        a crash between the two leaves the old header pointing at the old,
        still-valid prepare, or the new prepare not yet referenced).

        When the storage has an async engine the ordered pair is submitted
        without blocking and `on_durable` fires at a later poll_io() /
        wait barrier; otherwise the write is synchronous (the
        deterministic simulator path) and `on_durable` fires before
        return. Returns True if the append is already durable."""
        with self.tracer.span(Event.journal_write, op=message.header.op):
            return self._append(message, on_durable)

    def _append(self, message: Message, on_durable) -> bool:
        header = message.header
        assert header.command == Command.prepare
        assert header.size <= self.prepare_size_max
        slot = self.slot_for_op(header.op)
        raw = message.pack()
        # Same-slot appends must not reorder across the worker pool:
        # settle the in-flight one first (rare — a wrapped ring reusing a
        # slot, or a repair overwrite racing the original write).
        prev = self._pending_by_slot.get(slot)
        if prev is not None:
            # Callbacks are deferred, not fired here: firing mid-append
            # could reenter the replica (quorum -> commit) from inside
            # another replica action.
            self._finish(prev, fire=False)
        token = self.storage.write_pair_async(
            "wal_prepares", slot * self.prepare_size_max, raw,
            "wal_headers", slot * HEADER_SIZE, header.pack())
        self.headers[slot] = header
        self.dirty.discard(slot)
        self.faulty.discard(slot)
        if token is None:
            native_file = getattr(self.storage, "native", None)
            if native_file is not None:
                zones = self.storage.layout.zone_offsets
                native_file.wal_append(
                    zones["wal_headers"], zones["wal_prepares"], slot,
                    self.prepare_size_max, raw)
            else:
                self.storage.write(
                    "wal_prepares", slot * self.prepare_size_max, raw)
                self.storage.write(
                    "wal_headers", slot * HEADER_SIZE, header.pack())
            if on_durable is not None:
                on_durable()
            return True
        self._pending[token] = (
            slot, message, [on_durable] if on_durable is not None else [])
        self._pending_by_slot[slot] = token
        return False

    def on_slot_durable(self, op: int, callback) -> None:
        """Run `callback` once the slot holding `op` is durable — now, if
        no append is in flight for it."""
        token = self._pending_by_slot.get(self.slot_for_op(op))
        if token is None:
            callback()
        else:
            self._pending[token][2].append(callback)

    def _fire_deferred(self) -> None:
        while self._deferred:
            deferred, self._deferred = self._deferred, []
            for cb in deferred:
                cb()

    def poll_io(self) -> None:
        """Reap completed async appends and fire their callbacks in append
        order (called from the replica tick; cheap no-op when nothing is
        in flight)."""
        self._fire_deferred()
        if not self._pending:
            return
        for token in self.storage.io_poll():
            if token in self._pending:
                self._finish(token)

    def wait_all(self, fire: bool = True) -> None:
        """Durability barrier: every in-flight append lands. With
        fire=False the callbacks are DEFERRED to the next poll_io — the
        checkpoint barrier must not let a quorum callback advance
        commit_min (and reenter the checkpoint) mid-flip."""
        while self._pending:
            self._finish(next(iter(self._pending)), fire=fire)
        if fire:
            self._fire_deferred()

    def _finish(self, token: int, fire: bool = True) -> None:
        slot, _message, callbacks = self._pending.pop(token)
        if self._pending_by_slot.get(slot) == token:
            del self._pending_by_slot[slot]
        # Blocks if still in flight; raises if the write failed (sticky in
        # the engine — durability is compromised, never paper over it).
        self.storage.io_reap(token)
        if fire and not self._deferred:
            for cb in callbacks:
                cb()
        else:
            # Keep append order: once anything is deferred, everything
            # later defers behind it.
            self._deferred.extend(callbacks)

    # ---------------------------------------------------------------- read

    def read_prepare(self, op: int) -> Optional[Message]:
        slot = self.slot_for_op(op)
        header = self.headers[slot]
        if header is None or header.op != op:
            return None
        # An in-flight async append is served from the retained message —
        # the write-buffer read path (the disk bytes are not there yet).
        token = self._pending_by_slot.get(slot)
        if token is not None:
            msg = self._pending[token][1]
            return msg if msg.header.op == op else None
        raw = self.storage.read(
            "wal_prepares", slot * self.prepare_size_max,
            min(self.prepare_size_max, max(header.size, HEADER_SIZE)))
        try:
            msg = Message.unpack(raw)
        except Exception:
            return None
        if not msg.valid() or msg.header.op != op:
            return None
        return msg

    # ------------------------------------------------------------- recovery

    def recover(self) -> list[Slot]:
        """Scan both rings, classify each slot, and load the in-memory header
        ring (reference: journal recovery in src/vsr/journal.zig; decision
        table in docs/internals/vsr.md:188-217). Runs on the native engine
        when the storage is native-backed."""
        with self.tracer.span(Event.journal_recover):
            return self._recover_scan()

    def _recover_scan(self) -> list[Slot]:
        native_file = getattr(self.storage, "native", None)
        if native_file is not None:
            return self._recover_native(native_file)
        slots: list[Slot] = []
        for slot in range(self.slot_count):
            hdr_raw = self.storage.read(
                "wal_headers", slot * HEADER_SIZE, HEADER_SIZE)
            header = _try_header(hdr_raw)
            prep_raw = self.storage.read(
                "wal_prepares", slot * self.prepare_size_max, HEADER_SIZE)
            prep_header = _try_header(prep_raw)

            prepare_valid = False
            if prep_header is not None and prep_header.command == Command.prepare:
                msg = None
                if prep_header.size <= self.prepare_size_max:
                    body_raw = self.storage.read(
                        "wal_prepares", slot * self.prepare_size_max,
                        prep_header.size)
                    try:
                        msg = Message.unpack(body_raw)
                    except Exception:
                        msg = None
                prepare_valid = msg is not None and msg.valid()

            if header is not None and header.command == Command.prepare:
                if (prepare_valid and prep_header.checksum == header.checksum):
                    slots.append(Slot(SlotState.clean, header))
                    self.headers[slot] = header
                elif prepare_valid and prep_header.op > header.op:
                    # Torn header write after a newer prepare landed: trust
                    # the newer prepare.
                    slots.append(Slot(SlotState.clean, prep_header))
                    self.headers[slot] = prep_header
                else:
                    slots.append(Slot(SlotState.faulty, header))
                    self.headers[slot] = header
                    self.faulty.add(slot)
            elif prepare_valid:
                # Header torn, prepare intact.
                slots.append(Slot(SlotState.clean, prep_header))
                self.headers[slot] = prep_header
            elif header is not None and header.command == Command.reserved:
                # Formatted-empty (replica_format wrote a valid reserved
                # header and no prepare ever landed): provably never
                # prepared anything — NOT faulty, so the replica may NACK
                # ops mapping here (reference: the empty/torn distinction
                # behind quorum_nack_prepare eligibility).
                slots.append(Slot(SlotState.clean))
            else:
                slots.append(Slot(SlotState.unknown))
                self.faulty.add(slot)
        return slots

    def _recover_native(self, native_file) -> list[Slot]:
        """Native scan: classification logic is mirrored in C++
        (csrc/storage_engine.cpp tbs_wal_scan); differential-tested
        against the Python path in tests/test_torch_vsr.py."""
        from ..vsr.checksum import _SEED

        zones = self.storage.layout.zone_offsets
        states, headers_raw = native_file.wal_scan(
            zones["wal_headers"], zones["wal_prepares"],
            self.slot_count, self.prepare_size_max,
            _SEED + b"hdr", _SEED + b"body")
        slots: list[Slot] = []
        for slot in range(self.slot_count):
            state = states[slot]
            raw = headers_raw[slot * HEADER_SIZE:(slot + 1) * HEADER_SIZE]
            if state == 0:
                header = Header.unpack(raw)
                slots.append(Slot(SlotState.clean, header))
                self.headers[slot] = header
            elif state == 1:
                header = Header.unpack(raw)
                slots.append(Slot(SlotState.faulty, header))
                self.headers[slot] = header
                self.faulty.add(slot)
            elif state == 3:
                # Formatted-empty slot (valid reserved ring header, no
                # prepare): clean, nack-eligible — see the Python
                # classifier above.
                slots.append(Slot(SlotState.clean))
            else:
                slots.append(Slot(SlotState.unknown))
                self.faulty.add(slot)
        return slots

    def op_max(self) -> int:
        """Highest op in the journal (after recover())."""
        return max((h.op for h in self.headers if h is not None), default=0)


def _try_header(raw: bytes) -> Optional[Header]:
    try:
        header = Header.unpack(raw)
    except Exception:
        return None
    if not header.valid_checksum():
        return None
    return header
