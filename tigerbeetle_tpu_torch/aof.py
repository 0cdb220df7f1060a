"""Append-only file: disaster recovery of last resort.

reference: src/aof.zig — every committed prepare is appended to a separate
magic-framed file; `recover` replays it into a fresh state machine when the
cluster's data files are lost. Not in the durability path (the WAL is);
this is the belt to the journal's suspenders.

Frame: MAGIC(8) | size u32 | crc-less (the message carries its own
checksums) | message bytes.

The port's copy of the JAX package's `aof.py`: the same magic and
frames, byte for byte, so a file written by either package is read by
the other.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, Optional

from .vsr.header import Command, Message

_MAGIC = b"TBTPUAOF"
_FRAME = struct.Struct("<8sI")


class AOF:
    def __init__(self, path: str):
        self.path = path
        # Resume-safe: find the last op already framed so restarts neither
        # duplicate nor gap the sequence, and truncate a torn tail (a crashed
        # mid-append) so new frames don't land unreachable after garbage.
        self.last_op = 0
        valid_end = 0
        if os.path.exists(path):
            for msg, end in AOF._iterate_offsets(path):
                self.last_op = msg.header.op
                valid_end = end
            if os.path.getsize(path) > valid_end:
                with open(path, "r+b") as f:
                    f.truncate(valid_end)
        self.file = open(path, "ab")

    def append(self, message: Message) -> None:
        assert message.header.command == Command.prepare
        op = message.header.op
        if op <= self.last_op:
            return  # already framed (startup WAL replay re-commits these)
        if self.last_op == 0 and op != 1:
            # A fresh AOF starting mid-history can never satisfy recover()'s
            # contiguity-from-1 requirement — fail at write time, not at
            # disaster-recovery time.
            raise RuntimeError(
                f"AOF is empty but the first committed op is {op} "
                "(was --aof enabled mid-life? reformat, or restore the "
                "original AOF file)")
        if self.last_op and op != self.last_op + 1:
            raise RuntimeError(
                f"AOF gap: last framed op {self.last_op}, appending {op} "
                "(was --aof enabled mid-life? start a fresh AOF)")
        raw = message.pack()
        self.file.write(_FRAME.pack(_MAGIC, len(raw)) + raw)
        self.file.flush()
        os.fsync(self.file.fileno())
        self.last_op = op

    def close(self) -> None:
        self.file.close()

    @staticmethod
    def iterate(path: str) -> Iterator[Message]:
        """Replay frames; stops at the first torn/corrupt frame (a crashed
        append), like the reference's recovery scan."""
        for msg, _ in AOF._iterate_offsets(path):
            yield msg

    @staticmethod
    def _iterate_offsets(path: str) -> Iterator[tuple[Message, int]]:
        """(message, end-offset-of-its-frame) pairs up to the first torn
        frame — the end offset is where a resuming writer must truncate."""
        with open(path, "rb") as f:
            pos = 0
            while True:
                frame = f.read(_FRAME.size)
                if len(frame) < _FRAME.size:
                    return
                magic, size = _FRAME.unpack(frame)
                if magic != _MAGIC:
                    return
                raw = f.read(size)
                if len(raw) < size:
                    return
                try:
                    msg = Message.unpack(raw)
                except Exception:
                    return
                if not msg.valid():
                    return
                pos += _FRAME.size + size
                yield msg, pos


def recover(path: str, state_machine) -> int:
    """Replay an AOF into a state machine (reference: `tigerbeetle
    recover`). The op sequence must start at 1 and be contiguous — a gap
    means the AOF cannot reproduce the full state and recovery must fail
    loudly rather than write a divergent snapshot. Returns ops applied."""
    from .types import Operation

    applied = 0
    last_op = 0
    for msg in AOF.iterate(path):
        op = msg.header.op
        if op <= last_op:
            continue
        if op != last_op + 1:
            raise ValueError(
                f"AOF not contiguous: op {op} follows {last_op} "
                "(truncated or mid-life AOF; cannot rebuild full state)")
        state_machine.commit(Operation(msg.header.operation), msg.body,
                             msg.header.timestamp)
        last_op = op
        applied += 1
    return applied
