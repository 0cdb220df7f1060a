"""SuperBlock: the root of all durable state, quorum-replicated in-file.

reference: src/vsr/superblock.zig:53-120 + quorum picking in
src/vsr/superblock_quorums.zig. Four physical copies are written on every
update (sequence number bumped); startup reads all four and adopts the
highest sequence present in at least `read_quorum` identical valid copies.
A crash mid-update leaves a mix of old/new copies — the quorum rule makes
the flip atomic.

The superblock here references the current checkpoint snapshot (A/B slot,
size, checksum) and persists the VSR state the protocol must not forget
(view, log_view, commit_min/max, checkpoint id chain).

`sync_op` is the staged-install record (reference: the superblock's
vsr_state.sync_op_min/max brackets a state sync the same way): it is
persisted BEFORE a state-sync install writes its first grid block and
cleared in the same store that flips to the installed checkpoint. A
nonzero sync_op therefore proves the data file is mid-install — grid
bytes may be half-written — and a normal open must refuse it (recover
--from-cluster restarts the rebuild cleanly instead).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional

from .checksum import checksum
from .storage import SUPERBLOCK_COPIES, SUPERBLOCK_COPY_SIZE, Storage

READ_QUORUM = 2  # of 4 copies (tolerates one torn write + one latent fault)

_FMT = struct.Struct("<16sQQQQQQQQQQQIIQ16s")


@dataclasses.dataclass
class SuperBlock:
    cluster: int = 0
    replica_id: int = 0
    replica_count: int = 1
    sequence: int = 0
    view: int = 0
    log_view: int = 0
    commit_min: int = 0  # checkpointed op (state snapshot covers <= this)
    commit_max: int = 0
    op_checkpoint: int = 0
    checkpoint_id: int = 0  # hash-chained across checkpoints
    # Staged-install record: target op of an in-progress state-sync
    # install (0 = none). Nonzero across a restart means the install was
    # torn — the grid is suspect and a normal open must refuse.
    sync_op: int = 0
    snapshot_slot: int = 0  # 0 or 1 (A/B)
    release: int = 0  # release that wrote this checkpoint (multiversion)
    snapshot_size: int = 0
    snapshot_checksum: int = 0

    def pack_copy(self) -> bytes:
        body = _FMT.pack(
            b"\x00" * 16,
            self.cluster, self.replica_id, self.replica_count,
            self.sequence, self.view, self.log_view,
            self.commit_min, self.commit_max, self.op_checkpoint,
            self.checkpoint_id & ((1 << 64) - 1),
            self.sync_op,
            self.snapshot_slot, self.release,
            self.snapshot_size,
            self.snapshot_checksum.to_bytes(16, "little"),
        )
        csum = checksum(body[16:], domain=b"sb")
        raw = csum.to_bytes(16, "little") + body[16:]
        return raw.ljust(SUPERBLOCK_COPY_SIZE, b"\x00")

    @classmethod
    def unpack_copy(cls, raw: bytes) -> Optional["SuperBlock"]:
        try:
            f = _FMT.unpack(raw[:_FMT.size])
        except struct.error:
            return None
        csum = int.from_bytes(raw[:16], "little")
        if csum != checksum(raw[16:_FMT.size], domain=b"sb"):
            return None
        return cls(
            cluster=f[1], replica_id=f[2], replica_count=f[3],
            sequence=f[4], view=f[5], log_view=f[6],
            commit_min=f[7], commit_max=f[8], op_checkpoint=f[9],
            checkpoint_id=f[10], sync_op=f[11],
            snapshot_slot=f[12], release=f[13], snapshot_size=f[14],
            snapshot_checksum=int.from_bytes(f[15], "little"),
        )

    # ----------------------------------------------------------------- io

    def store(self, storage: Storage) -> None:
        """Bump sequence and write all copies (atomic via quorum rule)."""
        self.sequence += 1
        raw = self.pack_copy()
        for copy in range(SUPERBLOCK_COPIES):
            storage.write("superblock", copy * SUPERBLOCK_COPY_SIZE, raw)
        storage.sync()

    @classmethod
    def load(cls, storage: Storage) -> Optional["SuperBlock"]:
        """Quorum-pick across the copies (reference:
        src/vsr/superblock_quorums.zig working-quorum selection)."""
        copies: list[SuperBlock] = []
        for copy in range(SUPERBLOCK_COPIES):
            raw = storage.read(
                "superblock", copy * SUPERBLOCK_COPY_SIZE, SUPERBLOCK_COPY_SIZE)
            sb = cls.unpack_copy(raw)
            if sb is not None:
                copies.append(sb)
        if not copies:
            return None
        by_seq: dict[int, list[SuperBlock]] = {}
        for sb in copies:
            by_seq.setdefault(sb.sequence, []).append(sb)
        for seq in sorted(by_seq, reverse=True):
            group = by_seq[seq]
            if len(group) >= READ_QUORUM:
                first = group[0]
                assert all(g == first for g in group[1:])
                return dataclasses.replace(first)
        return None
