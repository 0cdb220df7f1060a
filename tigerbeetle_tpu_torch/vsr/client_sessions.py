"""Client sessions + durable replies.

reference: src/vsr/client_sessions.zig (session table, at-most-once
semantics, eviction) + src/vsr/client_replies.zig (latest reply per client
persisted in the client_replies zone, one slot per session). The session
table itself rides in the checkpoint root blob (reference: checkpoint
trailer); reply bodies live in the zone so a restarted replica can answer
duplicate requests without re-executing them.

Each entry records its reply's size + checksum independently of whether the
reply bytes are currently present: a torn/corrupt reply slot (or a
state-synced table whose zone hasn't been filled yet) keeps the entry with
`reply=None` and is repaired from peers (request_reply), while `pack()`
stays a pure function of the committed op sequence — so checkpoint roots
remain byte-identical across replicas even while a reply is missing
locally (reference: reply slots are repairable faults the same way).

Determinism: slot assignment and eviction are pure functions of the
committed op sequence (first-free slot; evict the session with the oldest
request number, ties on client id), so all replicas agree byte-for-byte.

A copy of the JAX package's `vsr/client_sessions.py`; `pack` writes its bytes.
"""

from __future__ import annotations

import struct
from typing import Optional

from .checksum import checksum
from .header import Message
from .storage import Storage

_ENTRY = struct.Struct("<16sIIQ16s")  # client, request, slot, size, checksum


class ClientSessions:
    def __init__(self, storage: Storage):
        self.storage = storage
        self.capacity = storage.layout.clients_max
        # client id -> {"request", "slot", "reply": Optional[Message],
        #               "reply_size", "reply_checksum"}
        self.entries: dict[int, dict] = {}

    # ------------------------------------------------------------- lookups

    def get(self, client: int) -> Optional[dict]:
        return self.entries.get(client)

    def missing_replies(self) -> list[int]:
        """Clients whose recorded reply bytes are absent locally (torn slot
        or post-state-sync) — the repair work list."""
        return [c for c, e in self.entries.items()
                if e["reply"] is None and e["reply_size"] > 0]

    # ------------------------------------------------------------- updates

    def put_reply(self, client: int, request: int,
                  reply: Message) -> Optional[int]:
        """Record the latest reply for `client`; persist it to the zone.
        Returns an evicted client id when the table was full (the caller
        sends it an eviction message), else None."""
        evicted = None
        entry = self.entries.get(client)
        if entry is None:
            if len(self.entries) >= self.capacity:
                evicted = min(
                    self.entries,
                    key=lambda c: (self.entries[c]["request"], c))
                entry = self.entries.pop(evicted)
                slot = entry["slot"]
            else:
                used = {e["slot"] for e in self.entries.values()}
                slot = next(s for s in range(self.capacity) if s not in used)
            entry = {"slot": slot}
            self.entries[client] = entry
        raw = reply.pack()
        assert len(raw) <= self.storage.layout.message_size_max
        entry["request"] = request
        entry["reply"] = reply
        entry["reply_size"] = len(raw)
        entry["reply_checksum"] = checksum(raw, domain=b"reply")
        self.storage.write(
            "client_replies",
            entry["slot"] * self.storage.layout.message_size_max, raw)
        return evicted

    def repair_reply(self, client: int, reply: Message) -> bool:
        """Install a peer-provided reply iff it matches the entry's recorded
        checksum (reference: client_replies repair via request_reply)."""
        entry = self.entries.get(client)
        if entry is None or entry["reply"] is not None:
            return False
        raw = reply.pack()
        if (len(raw) != entry["reply_size"]
                or checksum(raw, domain=b"reply") != entry["reply_checksum"]):
            return False
        entry["reply"] = reply
        self.storage.write(
            "client_replies",
            entry["slot"] * self.storage.layout.message_size_max, raw)
        return True

    # ---------------------------------------------------------- checkpoint

    def pack(self) -> bytes:
        """Session table blob for the checkpoint root. A pure function of
        the committed op sequence (recorded sizes/checksums), regardless of
        which reply bytes happen to be present locally."""
        parts = [struct.pack("<I", len(self.entries))]
        for client in sorted(self.entries):
            e = self.entries[client]
            parts.append(_ENTRY.pack(
                client.to_bytes(16, "little"), e["request"], e["slot"],
                e["reply_size"],
                e["reply_checksum"].to_bytes(16, "little")))
        return b"".join(parts)

    def restore(self, blob: bytes) -> None:
        """Rebuild the table; re-read each reply from its zone slot,
        validating against the checkpointed checksum. Mismatches (torn
        write, or a freshly state-synced table) leave `reply=None` for the
        repair path."""
        self.entries.clear()
        (count,) = struct.unpack_from("<I", blob)
        pos = 4
        for _ in range(count):
            client_b, request, slot, size, csum_b = _ENTRY.unpack_from(blob, pos)
            pos += _ENTRY.size
            client = int.from_bytes(client_b, "little")
            csum = int.from_bytes(csum_b, "little")
            reply: Optional[Message] = None
            if size:
                raw = self.storage.read(
                    "client_replies",
                    slot * self.storage.layout.message_size_max, size)
                if checksum(raw, domain=b"reply") == csum:
                    reply = Message.unpack(raw)
            self.entries[client] = {
                "request": request, "slot": slot, "reply": reply,
                "reply_size": size, "reply_checksum": csum}
