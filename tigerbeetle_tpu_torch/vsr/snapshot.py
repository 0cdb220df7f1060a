"""Checkpoint snapshot codec: serialize the whole state machine state.

A copy of the JAX package's `vsr/snapshot.py`. Checkpoints live in the
LSM forest (vsr/durable.py); this canonical whole-state encoding is what
the cluster harness (testing/cluster.py) compares replicas' states by:
equal states encode to equal bytes (docs/internals/data_file.md:63-94).

Format: little-endian sections, each `count` + packed fixed-size records.
"""

from __future__ import annotations

import struct

from ..oracle.state_machine import AccountEventRecord, StateMachineOracle
from ..types import Account, Transfer, TransferPendingStatus

_MAGIC = b"TBTPUSNAP1"


def _pack_u128(x: int) -> bytes:
    return x.to_bytes(16, "little")


def encode(state: StateMachineOracle) -> bytes:
    """Canonical encoding: containers are serialized in timestamp/key
    order, NOT dict iteration order — under the lazy mirror
    (ops/lazy_mirror.py) dict insertion order depends on each replica's
    READ history, while content must compare byte-identical across
    replicas (the StorageChecker doctrine)."""
    out = [_MAGIC]

    accounts = sorted(state.accounts.values(), key=lambda a: a.timestamp)
    out.append(struct.pack("<Q", len(accounts)))
    out.extend(a.pack() for a in accounts)

    transfers = sorted(state.transfers.values(), key=lambda t: t.timestamp)
    out.append(struct.pack("<Q", len(transfers)))
    out.extend(t.pack() for t in transfers)

    out.append(struct.pack("<Q", len(state.orphaned)))
    out.extend(_pack_u128(i) for i in sorted(state.orphaned))

    out.append(struct.pack("<Q", len(state.pending_status)))
    out.extend(struct.pack("<QB", ts, int(s))
               for ts, s in sorted(state.pending_status.items()))

    out.append(struct.pack("<Q", len(state.expiry)))
    out.extend(struct.pack("<QQ", ts, exp)
               for ts, exp in sorted(state.expiry.items()))

    out.append(struct.pack(
        "<QQQQ",
        state.accounts_key_max or 0, state.transfers_key_max or 0,
        state.pulse_next_timestamp, state.commit_timestamp))

    events = state.account_events
    out.append(struct.pack("<Q", state.events_base))
    out.append(struct.pack("<Q", len(events)))
    for rec in events:
        has_p = rec.transfer_pending is not None
        out.append(struct.pack(
            "<QHB?", rec.timestamp, rec.transfer_flags or 0,
            int(rec.transfer_pending_status), has_p))
        out.append(rec.dr_account.pack())
        out.append(rec.cr_account.pack())
        out.append(_pack_u128(rec.amount_requested))
        out.append(_pack_u128(rec.amount))
        if has_p:
            out.append(rec.transfer_pending.pack())
    return b"".join(out)


def decode(raw: bytes) -> StateMachineOracle:
    assert raw[:len(_MAGIC)] == _MAGIC, "bad snapshot magic"
    pos = len(_MAGIC)

    def take(n: int) -> bytes:
        nonlocal pos
        chunk = raw[pos:pos + n]
        assert len(chunk) == n, "truncated snapshot"
        pos += n
        return chunk

    def count() -> int:
        return struct.unpack("<Q", take(8))[0]

    state = StateMachineOracle()
    for _ in range(count()):
        a = Account.unpack(take(128))
        state.accounts[a.id] = a
        state.account_by_timestamp[a.timestamp] = a.id
    for _ in range(count()):
        t = Transfer.unpack(take(128))
        state.transfers[t.id] = t
        state.transfer_by_timestamp[t.timestamp] = t.id
    for _ in range(count()):
        state.orphaned.add(int.from_bytes(take(16), "little"))
    for _ in range(count()):
        ts, s = struct.unpack("<QB", take(9))
        state.pending_status[ts] = TransferPendingStatus(s)
    for _ in range(count()):
        ts, exp = struct.unpack("<QQ", take(16))
        state.expiry[ts] = exp
    (akm, tkm, pulse, commit_ts) = struct.unpack("<QQQQ", take(32))
    state.accounts_key_max = akm or None
    state.transfers_key_max = tkm or None
    state.pulse_next_timestamp = pulse
    state.commit_timestamp = commit_ts
    state.events_base = count()
    for _ in range(count()):
        ts, tflags, pstat, has_p = struct.unpack("<QHB?", take(12))
        dr = Account.unpack(take(128))
        cr = Account.unpack(take(128))
        amount_requested = int.from_bytes(take(16), "little")
        amount = int.from_bytes(take(16), "little")
        pending = Transfer.unpack(take(128)) if has_p else None
        state.account_events.append(AccountEventRecord(
            timestamp=ts, dr_account=dr, cr_account=cr,
            transfer_flags=tflags,
            transfer_pending_status=TransferPendingStatus(pstat),
            transfer_pending=pending,
            amount_requested=amount_requested, amount=amount))
    return state
