"""DurableState: the LSM forest under the replica.

A copy of the JAX package's `vsr/durable.py`, the incremental-checkpoint
engine: state-machine objects are written through to LSM trees sharing
one copy-on-write grid in the data file's grid zone, compaction is paced
deterministically by op number, and a checkpoint serializes only manifests
plus the free set into one small root blob the superblock references.

reference mapping:
  grooves / object trees        src/lsm/groove.zig, forest.zig  -> Forest
  grid zone (CoW blocks)        src/vsr/grid.zig                -> lsm/grid.py
  checkpoint trailer (free set) src/vsr/checkpoint_trailer.zig  -> root blob
  write-through after commit    groove insert/update at commit

Determinism contract (load-bearing, like the reference's physical
determinism, docs/ARCHITECTURE.md:281-307): given an identical committed op
sequence, every replica produces byte-identical grid zones. Achieved by
(a) sorted dirty-set flush order, (b) op-derived compaction pacing, and
(c) deterministic grid allocation (cursor scan, reset at checkpoint).
"""

from __future__ import annotations

import struct
from typing import Optional

from ..lsm.forest import Forest
from ..lsm.grid import Grid
from ..lsm.scan import composite_key
from ..oracle.state_machine import AccountEventRecord, StateMachineOracle
from ..types import (Account, AccountFlags, Transfer, TransferFlags,
                     TransferPendingStatus)
from .storage import Storage

# Fixed-size AccountEventRecord row (reference: 256-byte AccountEvent,
# src/state_machine.zig:104-220; ours carries both full account snapshots).
_EVENT_SIZE = 8 + 2 + 1 + 1 + 128 + 128 + 16 + 16 + 128

SCHEMA = {
    "accounts": (16, 128),
    "transfers": (16, 128),
    "pending": (8, 1),
    "expiry": (8, 8),
    "orphaned": (16, 1),
    "events": (8, _EVENT_SIZE),
    # Secondary indexes (reference: the groove index trees,
    # src/state_machine.zig:45-90 — accounts: 9 trees, transfers: 14):
    # composite key = field prefix || timestamp (composite_key.zig);
    # timestamp trees map ts -> id for the object lookup hop
    # (scan_lookup.zig).
    "acct_by_ts": (8, 16),
    "acct_by_ud128": (24, 1),
    "acct_by_ud64": (16, 1),
    "acct_by_ud32": (12, 1),
    "acct_by_ledger": (12, 1),
    "acct_by_code": (10, 1),
    "xfer_by_ts": (8, 16),
    "xfer_by_dr": (24, 1),
    "xfer_by_cr": (24, 1),
    "xfer_by_pid": (24, 1),
    "xfer_by_ud128": (24, 1),
    "xfer_by_ud64": (16, 1),
    "xfer_by_ud32": (12, 1),
    "xfer_by_ledger": (12, 1),
    "xfer_by_code": (10, 1),
    # Flag indexes (reference: tree_ids 23-26 — presence-keyed; `closed`
    # and `closing` are the only mutable indexed attributes, maintained
    # put/remove on every dirty flush, which is deterministic and
    # idempotent across replicas):
    "acct_by_imported": (9, 1),
    "acct_by_closed": (9, 1),
    "xfer_by_amount": (24, 1),
    "xfer_by_imported": (9, 1),
    "xfer_by_closing": (9, 1),
    # account_events secondary trees (reference: tree_ids 27-33,
    # src/state_machine.zig:525-605 — account_timestamp put per
    # history-flagged side in account_event() :4452-4466; *_expired only
    # for expiry rows; prunable when neither side keeps history):
    "ev_by_acct_ts": (16, 1),
    "ev_by_pstat": (9, 1),
    "ev_by_dr_expired": (24, 1),
    "ev_by_cr_expired": (24, 1),
    "ev_by_pid_expired": (24, 1),
    "ev_by_ledger_expired": (12, 1),
    "ev_by_prunable": (8, 1),
}

_META_SIZE = 40  # scalars appended to the checkpoint root blob

_NO_PENDING = b"\x00" * 128

# The host dtypes of the flush columns the column path reads, as the
# ledger hands them over (u64 lanes as uint64, never the device's int64
# carrier: as int64, values >= 2^63 would order and pack differently).
_U64, _U32, _I32 = "uint64", "uint32", "int32"
_BAL = tuple(f"{side}_{f}_{half}" for side in ("dr", "cr")
             for f in ("dp", "dpos", "cp", "cpos") for half in ("lo", "hi"))
_COLUMN_DTYPES = {
    "t": {**{k: _U64 for k in (
        "id_lo", "id_hi", "dr_lo", "dr_hi", "cr_lo", "cr_hi", "amt_lo",
        "amt_hi", "pid_lo", "pid_hi", "ud128_lo", "ud128_hi", "ud64", "ts",
        "expires")},
          **{k: _U32 for k in ("ud32", "timeout", "ledger", "code",
                               "flags")}},
    "e": {**{k: _U64 for k in ("amt_lo", "amt_hi", "areq_lo", "areq_hi")
             + _BAL},
          "pstat": _I32, "p_row": _I32,
          **{k: _U32 for k in ("tflags", "dr_flags", "cr_flags")}},
    "der": {k: _U64 for k in ("dr_id_hi", "dr_id_lo", "cr_id_hi",
                              "cr_id_lo", "p_ts")},
}


def _check_column_dtypes(**cols) -> None:
    """The column path's entry check: every column it reads carries the
    ledger's host dtype."""
    for which, c in cols.items():
        for k, want in _COLUMN_DTYPES[which].items():
            got = c[k].dtype
            assert got == want, f"flush column {which}.{k} is {got}, not {want}"
_FLAGS_NONE = 0xFFFF  # transfer_flags=None sentinel (expiry events)


def _k8(x: int) -> bytes:
    return x.to_bytes(8, "big")  # big-endian: lexicographic == numeric


def _k16(x: int) -> bytes:
    return x.to_bytes(16, "big")


def _pack_event(rec: AccountEventRecord) -> bytes:
    flags = _FLAGS_NONE if rec.transfer_flags is None else rec.transfer_flags
    return (struct.pack(
        "<QHBB", rec.timestamp, flags, int(rec.transfer_pending_status),
        1 if rec.transfer_pending is not None else 0)
        + rec.dr_account.pack() + rec.cr_account.pack()
        + rec.amount_requested.to_bytes(16, "little")
        + rec.amount.to_bytes(16, "little")
        + (rec.transfer_pending.pack() if rec.transfer_pending is not None
           else _NO_PENDING))


def _unpack_event(raw: bytes) -> AccountEventRecord:
    ts, flags, pstat, has_p = struct.unpack_from("<QHBB", raw)
    pos = 12
    dr = Account.unpack(raw[pos:pos + 128]); pos += 128
    cr = Account.unpack(raw[pos:pos + 128]); pos += 128
    amount_requested = int.from_bytes(raw[pos:pos + 16], "little"); pos += 16
    amount = int.from_bytes(raw[pos:pos + 16], "little"); pos += 16
    pending = Transfer.unpack(raw[pos:pos + 128]) if has_p else None
    return AccountEventRecord(
        timestamp=ts, dr_account=dr, cr_account=cr,
        transfer_flags=None if flags == _FLAGS_NONE else flags,
        transfer_pending_status=TransferPendingStatus(pstat),
        transfer_pending=pending,
        amount_requested=amount_requested, amount=amount)


def mirror_quiescent(state, events_persisted: int) -> bool:
    """True when the host mirror holds nothing the durable flush would
    have to serialize object-side: no dirty stores and every mirror
    event already persisted. The ONE predicate behind (a) the column
    flush contract, (b) the replica's drain-before-flush decision, and
    (c) commit-window formation — they must agree or the window path's
    per-op flush cadence silently diverges."""
    return not (
        state.accounts.dirty or state.transfers.dirty
        or state.pending_status.dirty or state.expiry.dirty
        or state.orphaned.dirty
        or events_persisted < (state.events_base
                               + len(state.account_events)))


def checkpoint_manifest(root_with_meta: bytes):
    """(manifest BlockAddress, manifest size) of a checkpoint root."""
    from ..lsm.grid import ADDRESS_SIZE, BlockAddress

    address = BlockAddress.unpack(root_with_meta[:ADDRESS_SIZE])
    (size,) = struct.unpack_from("<I", root_with_meta, ADDRESS_SIZE)
    return address, size


def manifest_children(manifest_raw: bytes) -> list:
    """(tree name, key_size, TableInfo) per table referenced by a forest
    manifest blob — the first expansion step of a checkpoint's block
    reachability graph (used by delta state sync)."""
    from ..lsm.table import TableInfo

    out = []
    (count,) = struct.unpack_from("<I", manifest_raw)
    pos = 4
    for _ in range(count):
        name_len, size = struct.unpack_from("<HI", manifest_raw, pos)
        pos += 6
        name = manifest_raw[pos:pos + name_len].decode()
        pos += name_len
        raw = manifest_raw[pos:pos + size]
        pos += size
        key_size = SCHEMA[name][0]
        # Tree blob: u64 beat, u8 level count (lsm.tree manifest_pack);
        # per level: u64 next_seq, u32 entry count.
        (n_levels,) = struct.unpack_from("<B", raw, 8)
        tpos = 9
        for _ in range(n_levels):
            (n_tables,) = struct.unpack_from("<I", raw, tpos + 8)
            tpos += 12
            for _ in range(n_tables):
                # Each entry: snapshot range + seq (3x u64,
                # lsm.manifest_level) then the TableInfo. History entries
                # (removed, unpruned) are reachable too — their blocks
                # stay allocated until the retention bar elapses.
                tpos += 24
                info, tpos = TableInfo.unpack(raw, tpos)
                out.append((name, key_size, info))
    return out


def index_children(index_raw: bytes, key_size: int) -> list:
    """(BlockAddress, size) of every value block an index block references
    (mirrors lsm.table.Table.__init__'s parse)."""
    from ..lsm.grid import ADDRESS_SIZE, BlockAddress
    from ..lsm.schema import BlockKind, unwrap

    index_raw = unwrap(index_raw, BlockKind.index)
    (count,) = struct.unpack_from("<I", index_raw)
    out = []
    pos = 4
    for _ in range(count):
        addr = BlockAddress.unpack(index_raw[pos:pos + ADDRESS_SIZE])
        pos += ADDRESS_SIZE
        (size,) = struct.unpack_from("<I", index_raw, pos)
        pos += 4 + key_size
        out.append((addr, size))
    return out


def allocated_blocks(root_with_meta: bytes) -> list[int]:
    """Grid block indices a checkpoint root reaches (the complement of its
    free set) — the exact transfer set for state sync."""
    from .. import ewah
    from ..lsm.grid import ADDRESS_SIZE

    root = root_with_meta[:-_META_SIZE]
    (free_size,) = struct.unpack_from("<I", root, ADDRESS_SIZE + 4)
    free_blob = root[ADDRESS_SIZE + 8:ADDRESS_SIZE + 8 + free_size]
    bits = ewah.decode_bitset(free_blob)
    return [i for i, free in enumerate(bits) if not free]


class _DictDevice:
    """Read-only staging device over a {block index: raw bytes} dict — used
    to validate state-synced blocks BEFORE they touch the live grid zone."""

    def __init__(self, blocks: dict, block_size: int):
        self.blocks = blocks
        self.block_size = block_size

    def read(self, off: int, size: int) -> bytes:
        idx, within = divmod(off, self.block_size)
        raw = self.blocks.get(idx, b"").ljust(self.block_size, b"\x00")
        return raw[within:within + size]

    def write(self, off: int, data: bytes) -> None:
        raise RuntimeError("staging device is read-only")


def validate_staged_checkpoint(blocks: dict, layout,
                               root_forest: bytes) -> StateMachineOracle:
    """Open a checkpoint root entirely from staged blocks; every read
    validates its parent-held checksum, so success proves the transfer is
    complete and uncorrupted. Raises on any fault — the caller must not
    have written anything to the live grid yet."""
    staged = DurableState.__new__(DurableState)
    staged.grid = Grid(
        _DictDevice(blocks, layout.grid_block_size),
        block_size=layout.grid_block_size,
        block_count=layout.grid_block_count)
    staged.forest = Forest(staged.grid, SCHEMA)
    staged.events_persisted = 0
    staged._indexed_accounts = set()
    staged._closed_indexed = set()
    return staged.open(root_forest)


class _ZoneDevice:
    """Adapter: a storage zone as the grid's flat byte device."""

    def __init__(self, storage: Storage, zone: str):
        self.storage = storage
        self.zone = zone

    def read(self, off: int, size: int) -> bytes:
        return self.storage.read(self.zone, off, size)

    def read_batch(self, reqs: list) -> list:
        return self.storage.read_batch(self.zone, reqs)

    def read_submit(self, reqs: list):
        return self.storage.read_submit(self.zone, reqs)

    def read_fetch(self, token, size: int) -> bytes:
        return self.storage.read_fetch(token, size)

    def write(self, off: int, data: bytes) -> None:
        self.storage.write(self.zone, off, data)


class DurableState:
    """Write-behind LSM persistence for one replica's state machine."""

    def __init__(self, storage: Storage):
        layout = storage.layout
        self.grid = Grid(
            _ZoneDevice(storage, "grid"),
            block_size=layout.grid_block_size,
            block_count=layout.grid_block_count)
        self.forest = Forest(self.grid, SCHEMA)
        self.events_persisted = 0
        # Accounts whose (immutable) index entries are already in the
        # trees: balance updates re-dirty accounts every batch, but only
        # the object row changes — index keys are written once.
        self._indexed_accounts: set[int] = set()
        # Accounts whose key is currently present in acct_by_closed —
        # the one mutable account index writes only on transitions
        # (rebuilt from the tree at open()).
        self._closed_indexed: set[int] = set()

    # ------------------------------------------------------------- writes

    def flush(self, state: StateMachineOracle, flush_columns=None):
        """Write every object mutated since the last flush into the trees
        (sorted key order: byte-deterministic across replicas). Returns
        (flushed account ids, flushed transfer ids) so the serving layer
        can write its bounded object caches through (state_machine.py
        cache_upsert).

        flush_columns: drained device-delta transfer columns
        (DeviceLedger.take_flush_columns). Transfers covered by them are
        flushed through the VECTORIZED path — values and index keys built
        in numpy passes instead of per-object int.to_bytes — and skipped
        by the object loop. Same puts, same bytes; memtable freeze sorts,
        so put order cannot affect the on-grid result."""
        trees = self.forest.trees
        vector_tids: list = []
        vector_aids: list = []
        if flush_columns:
            # Contract: the column path is only valid against a QUIESCENT
            # mirror — interleaved mirror writes (hard-regime handoffs,
            # account creations, expiries) carry ordering the two paths
            # cannot merge; the caller must drain and flush the object
            # path instead (vsr/replica.py does exactly that).
            assert mirror_quiescent(state, self.events_persisted), \
                "column flush with a dirty/unpersisted mirror: drain first"
        for (t_cols, e_cols, der_cols, n_new, abs_start,
             orphan_ids) in flush_columns or ():
            # Orphan puts are idempotent: flushed even for zero-create
            # chunks (transient failures poison ids without creating).
            for oid in orphan_ids:
                trees["orphaned"].put(_k16(oid), b"\x01")
            if n_new == 0:
                continue
            if abs_start + n_new <= self.events_persisted:
                # Stale chunk: an object-path flush (after a mirror
                # drain) already covered it — every put would be a
                # re-put of identical bytes.
                continue
            assert abs_start >= self.events_persisted, \
                "flush chunks must arrive whole and in order"
            _check_column_dtypes(t=t_cols, e=e_cols, der=der_cols)
            vector_tids.extend(self._flush_transfer_columns(
                trees, t_cols, n_new))
            vector_aids.extend(self._flush_side_columns(
                trees, t_cols, e_cols, der_cols, n_new))
            self.events_persisted = abs_start + n_new
        # A dirty key absent from its dict was created then rolled back by a
        # linked-chain scope within one commit — it was never flushed, so
        # skip it (accounts/transfers/pending are never legitimately
        # removed; only expiry needs real tombstones).
        acc = state.accounts
        flushed_accounts = sorted(a for a in acc.dirty if a in acc)
        for aid in flushed_accounts:
            a = acc[aid]
            trees["accounts"].put(_k16(aid), a.pack())
            # `closed` is the one mutable indexed account attribute
            # (closing transfers set it; voiding them clears it) —
            # written only on transitions.
            closed = bool(a.flags & AccountFlags.closed)
            if closed != (aid in self._closed_indexed):
                closed_key = composite_key(1, a.timestamp, 1)
                if closed:
                    trees["acct_by_closed"].put(closed_key, b"\x01")
                    self._closed_indexed.add(aid)
                else:
                    trees["acct_by_closed"].remove(closed_key)
                    self._closed_indexed.discard(aid)
            if aid in self._indexed_accounts:
                continue  # balances changed; indexed fields immutable
            self._indexed_accounts.add(aid)
            ts = a.timestamp
            if a.flags & AccountFlags.imported:
                trees["acct_by_imported"].put(
                    composite_key(1, ts, 1), b"\x01")
            trees["acct_by_ts"].put(_k8(ts), _k16(aid))
            trees["acct_by_ud128"].put(
                composite_key(a.user_data_128, ts, 16), b"\x01")
            trees["acct_by_ud64"].put(
                composite_key(a.user_data_64, ts, 8), b"\x01")
            trees["acct_by_ud32"].put(
                composite_key(a.user_data_32, ts, 4), b"\x01")
            trees["acct_by_ledger"].put(
                composite_key(a.ledger, ts, 4), b"\x01")
            trees["acct_by_code"].put(
                composite_key(a.code, ts, 2), b"\x01")
        acc.dirty.clear()
        xfr = state.transfers
        xfr.dirty.difference_update(vector_tids)
        flushed_transfers = sorted(t for t in xfr.dirty if t in xfr)
        for tid in flushed_transfers:
            t = xfr[tid]
            ts = t.timestamp
            trees["transfers"].put(_k16(tid), t.pack())
            trees["xfer_by_ts"].put(_k8(ts), _k16(tid))
            trees["xfer_by_dr"].put(
                composite_key(t.debit_account_id, ts, 16), b"\x01")
            trees["xfer_by_cr"].put(
                composite_key(t.credit_account_id, ts, 16), b"\x01")
            if t.pending_id:
                # Zero means 'not a post/void' — never indexed
                # (reference: the pending_id tree likewise only holds
                # resolutions; ForestQuery.transfers_by_pending_id
                # reads it).
                trees["xfer_by_pid"].put(
                    composite_key(t.pending_id, ts, 16), b"\x01")
            trees["xfer_by_ud128"].put(
                composite_key(t.user_data_128, ts, 16), b"\x01")
            trees["xfer_by_ud64"].put(
                composite_key(t.user_data_64, ts, 8), b"\x01")
            trees["xfer_by_ud32"].put(
                composite_key(t.user_data_32, ts, 4), b"\x01")
            trees["xfer_by_ledger"].put(
                composite_key(t.ledger, ts, 4), b"\x01")
            trees["xfer_by_code"].put(
                composite_key(t.code, ts, 2), b"\x01")
            trees["xfer_by_amount"].put(
                composite_key(t.amount, ts, 16), b"\x01")
            if t.flags & TransferFlags.imported:
                trees["xfer_by_imported"].put(
                    composite_key(1, ts, 1), b"\x01")
            if t.flags & (TransferFlags.closing_debit
                          | TransferFlags.closing_credit):
                trees["xfer_by_closing"].put(
                    composite_key(1, ts, 1), b"\x01")
        xfr.dirty.clear()
        pend = state.pending_status
        for ts in sorted(pend.dirty):
            if ts in pend:
                trees["pending"].put(_k8(ts), bytes([int(pend[ts])]))
        pend.dirty.clear()
        exp = state.expiry
        for ts in sorted(exp.dirty):
            if ts in exp:
                trees["expiry"].put(_k8(ts), struct.pack("<Q", exp[ts]))
            else:
                trees["expiry"].remove(_k8(ts))
        exp.dirty.clear()
        orph = state.orphaned
        for oid in sorted(orph.dirty):
            trees["orphaned"].put(_k16(oid), b"\x01")
        orph.dirty.clear()
        for rec in state.account_events[self.events_persisted
                                        - state.events_base:]:
            ets = rec.timestamp
            trees["events"].put(_k8(ets), _pack_event(rec))
            if rec.dr_account.flags & AccountFlags.history:
                trees["ev_by_acct_ts"].put(
                    composite_key(rec.dr_account.timestamp, ets, 8), b"\x01")
            if rec.cr_account.flags & AccountFlags.history:
                trees["ev_by_acct_ts"].put(
                    composite_key(rec.cr_account.timestamp, ets, 8), b"\x01")
            trees["ev_by_pstat"].put(
                composite_key(int(rec.transfer_pending_status), ets, 1),
                b"\x01")
            if rec.transfer_pending_status == TransferPendingStatus.expired:
                trees["ev_by_dr_expired"].put(
                    composite_key(rec.dr_account.id, ets, 16), b"\x01")
                trees["ev_by_cr_expired"].put(
                    composite_key(rec.cr_account.id, ets, 16), b"\x01")
                trees["ev_by_pid_expired"].put(
                    composite_key(rec.transfer_pending.id, ets, 16), b"\x01")
                trees["ev_by_ledger_expired"].put(
                    composite_key(rec.dr_account.ledger, ets, 4), b"\x01")
            if not ((rec.dr_account.flags | rec.cr_account.flags)
                    & AccountFlags.history):
                trees["ev_by_prunable"].put(_k8(ets), b"\x01")
        # max(): with the drain deferred, the mirror's event list lags the
        # column watermark — never rewind it.
        self.events_persisted = max(
            self.events_persisted,
            state.events_base + len(state.account_events))
        return (flushed_accounts + vector_aids,
                flushed_transfers + vector_tids)

    def _flush_transfer_columns(self, trees, t, n: int) -> list:
        """Vectorized transfer flush from drained device columns: value
        bytes and every index key built in whole-column numpy passes; the
        per-row Python work is the memtable puts themselves. Returns the
        flushed transfer ids. Bit-identical to the object path (the wire
        codec IS the object pack format)."""
        import numpy as np

        from ..ops.batch import TRANSFER_WIRE
        from ..types import TransferFlags as TF

        # Closing and imported transfers come through the fast path now
        # (closing-native fixpoint tiers / the imported tiers), so the
        # column flush maintains their flag indexes exactly like the
        # object path does.
        flags = t["flags"][:n]
        closing_l = ((flags & np.uint32(int(TF.closing_debit
                                            | TF.closing_credit))) != 0
                     ).tolist()
        imported_l = ((flags & np.uint32(int(TF.imported))) != 0).tolist()

        rec = np.zeros(n, dtype=TRANSFER_WIRE)
        for f in ("id_lo", "id_hi", "dr_lo", "dr_hi", "cr_lo", "cr_hi",
                  "amt_lo", "amt_hi", "pid_lo", "pid_hi",
                  "ud128_lo", "ud128_hi", "ud64", "ud32", "timeout", "ts"):
            rec[f] = t[f][:n]
        rec["ledger"] = t["ledger"][:n]
        rec["code"] = t["code"][:n].astype(np.uint16)
        rec["flags"] = flags.astype(np.uint16)
        valb = rec.tobytes()

        def be(*cols):
            return np.ascontiguousarray(
                np.stack([c[:n] for c in cols], axis=1).astype(">u8")
            ).tobytes()

        ts = t["ts"]
        idb = be(t["id_hi"], t["id_lo"])                      # 16B rows
        ts8 = be(ts)                                          # 8B rows
        drk = be(t["dr_hi"], t["dr_lo"], ts)                  # 24B rows
        crk = be(t["cr_hi"], t["cr_lo"], ts)
        pidk = be(t["pid_hi"], t["pid_lo"], ts)
        ud128k = be(t["ud128_hi"], t["ud128_lo"], ts)
        amtk = be(t["amt_hi"], t["amt_lo"], ts)
        ud64k = be(t["ud64"], ts)
        ud32p = np.ascontiguousarray(t["ud32"][:n].astype(">u4")).tobytes()
        ledp = np.ascontiguousarray(t["ledger"][:n].astype(">u4")).tobytes()
        codep = np.ascontiguousarray(
            t["code"][:n].astype(np.uint16).astype(">u2")).tobytes()
        pid_live = ((t["pid_hi"][:n] != 0) | (t["pid_lo"][:n] != 0)).tolist()

        put_obj = trees["transfers"].put
        put_ts = trees["xfer_by_ts"].put
        put_dr = trees["xfer_by_dr"].put
        put_cr = trees["xfer_by_cr"].put
        put_pid = trees["xfer_by_pid"].put
        put_ud128 = trees["xfer_by_ud128"].put
        put_ud64 = trees["xfer_by_ud64"].put
        put_ud32 = trees["xfer_by_ud32"].put
        put_led = trees["xfer_by_ledger"].put
        put_code = trees["xfer_by_code"].put
        put_amt = trees["xfer_by_amount"].put
        put_closing = trees["xfer_by_closing"].put
        put_imported = trees["xfer_by_imported"].put
        ONE = b"\x01"
        tids = []
        for i in range(n):
            k16 = idb[16 * i:16 * i + 16]
            t8 = ts8[8 * i:8 * i + 8]
            tids.append(int.from_bytes(k16, "big"))
            put_obj(k16, valb[128 * i:128 * i + 128])
            put_ts(t8, k16)
            put_dr(drk[24 * i:24 * i + 24], ONE)
            put_cr(crk[24 * i:24 * i + 24], ONE)
            if pid_live[i]:
                put_pid(pidk[24 * i:24 * i + 24], ONE)
            put_ud128(ud128k[24 * i:24 * i + 24], ONE)
            put_ud64(ud64k[16 * i:16 * i + 16], ONE)
            put_ud32(ud32p[4 * i:4 * i + 4] + t8, ONE)
            put_led(ledp[4 * i:4 * i + 4] + t8, ONE)
            put_code(codep[2 * i:2 * i + 2] + t8, ONE)
            put_amt(amtk[24 * i:24 * i + 24], ONE)
            # Flag indexes (composite_key(1, ts, 1) == b"\x01" + ts_be).
            if closing_l[i]:
                put_closing(ONE + t8, ONE)
            if imported_l[i]:
                put_imported(ONE + t8, ONE)
        return tids

    def _flush_side_columns(self, trees, t, e, der, n: int) -> None:
        """Vectorized flush of one chunk's NON-transfer effects: the
        account_events rows (+ their index trees), the touched accounts'
        object rows, and the pending/expiry trees — all from device delta
        columns, so the flush does not require materializing the mirror.

        Immutable account metadata (user_data/ledger/code/timestamp) is
        spliced from the account's PREVIOUS tree value (the fast path
        never mutates it); the FLAGS word comes from the event columns,
        which carry the closing-native tiers' evolved closed bit — the
        closed-flag index transitions are maintained here exactly like
        the object path. Per-event balances come from the event columns.
        Byte-identical to the object path (oracle-exact snapshots either
        way)."""
        import numpy as np

        from ..types import AccountFlags as AF
        from ..types import TransferFlags as TF

        hist = int(AF.history)

        def le(*cols):
            return np.ascontiguousarray(
                np.stack([c[:n] for c in cols], axis=1).astype("<u8")
            ).tobytes()

        ets8 = np.ascontiguousarray(t["ts"][:n].astype(">u8")).tobytes()
        amt16 = le(e["amt_lo"], e["amt_hi"])
        areq16 = le(e["areq_lo"], e["areq_hi"])
        # Per-side account front half (id + four balances, wire LE).
        fronts = {}
        for side, idh, idl in (("dr", "dr_id_hi", "dr_id_lo"),
                               ("cr", "cr_id_hi", "cr_id_lo")):
            fronts[side] = le(
                der[idl], der[idh],
                e[f"{side}_dp_lo"], e[f"{side}_dp_hi"],
                e[f"{side}_dpos_lo"], e[f"{side}_dpos_hi"],
                e[f"{side}_cp_lo"], e[f"{side}_cp_hi"],
                e[f"{side}_cpos_lo"], e[f"{side}_cpos_hi"])
        flags2 = {
            side: np.ascontiguousarray(
                e[f"{side}_flags"][:n].astype("<u2")).tobytes()
            for side in ("dr", "cr")}
        idbe = {
            side: np.ascontiguousarray(np.stack(
                [der[f"{side}_id_hi"][:n], der[f"{side}_id_lo"][:n]],
                axis=1).astype(">u8")).tobytes()
            for side in ("dr", "cr")}
        pstat_l = e["pstat"][:n].tolist()
        p_row_l = e["p_row"][:n].tolist()
        tflags_l = e["tflags"][:n].tolist()
        side_flags_l = {side: e[f"{side}_flags"][:n].tolist()
                        for side in ("dr", "cr")}
        p_ts_l = der["p_ts"][:n].tolist()
        timeout_l = t["timeout"][:n].tolist()
        expires_l = t["expires"][:n].tolist()
        ts_l = t["ts"][:n].tolist()

        acct_tree = trees["accounts"]
        xfer_tree = trees["transfers"]
        by_ts = trees["xfer_by_ts"]
        put_ev = trees["events"].put
        put_ev_acct = trees["ev_by_acct_ts"].put
        put_ev_pstat = trees["ev_by_pstat"].put
        put_ev_prun = trees["ev_by_prunable"].put
        put_pending = trees["pending"].put
        put_expiry = trees["expiry"].put
        rm_expiry = trees["expiry"].remove
        ONE = b"\x01"
        meta_cache: dict = {}  # acct key16be -> (meta bytes, ts_be8)
        p_cache: dict = {}  # p_ts -> pending transfer value bytes
        acct_last: dict = {}  # acct key16be -> final account value bytes

        def acct_meta(k16):
            got = meta_cache.get(k16)
            if got is None:
                old = acct_tree.get(k16)
                assert old is not None, "account flushed before transfers"
                got = (old[80:118], old[120:128])
                meta_cache[k16] = got
            return got

        for i in range(n):
            pstat = pstat_l[i]
            assert 0 <= pstat <= 3, "expiry events never come from chunks"
            has_p = 1 if p_row_l[i] >= 0 else 0
            tflags = tflags_l[i]
            tflags16 = _FLAGS_NONE if tflags == 0xFFFFFFFF else tflags
            sides_bytes = {}
            for side in ("dr", "cr"):
                k16 = idbe[side][16 * i:16 * i + 16]
                meta, ts_le = acct_meta(k16)
                acct = (fronts[side][80 * i:80 * i + 80] + meta
                        + flags2[side][2 * i:2 * i + 2] + ts_le)
                sides_bytes[side] = acct
                acct_last[k16] = acct
            p_val = _NO_PENDING
            if has_p:
                pts = p_ts_l[i]
                p_val = p_cache.get(pts)
                if p_val is None:
                    ptid = by_ts.get(pts.to_bytes(8, "big"))
                    assert ptid is not None, "pending flushed before resolve"
                    p_val = xfer_tree.get(ptid)
                    p_cache[pts] = p_val
            ets = ets8[8 * i:8 * i + 8]
            put_ev(ets, struct.pack("<QHBB", ts_l[i], tflags16, pstat, has_p)
                   + sides_bytes["dr"] + sides_bytes["cr"]
                   + areq16[16 * i:16 * i + 16] + amt16[16 * i:16 * i + 16]
                   + p_val)
            dr_hist = side_flags_l["dr"][i] & hist
            cr_hist = side_flags_l["cr"][i] & hist
            if dr_hist:
                put_ev_acct(sides_bytes["dr"][120:128][::-1] + ets, ONE)
            if cr_hist:
                put_ev_acct(sides_bytes["cr"][120:128][::-1] + ets, ONE)
            if not (dr_hist or cr_hist):
                put_ev_prun(ets, ONE)
            put_ev_pstat(bytes([pstat]) + ets, ONE)
            # Pending-status + expiry effects (oracle semantics).
            if pstat == 1:
                put_pending(ets, ONE)
                if timeout_l[i]:
                    put_expiry(ets, struct.pack("<Q", expires_l[i]))
            elif pstat in (2, 3):
                pts = p_ts_l[i]
                pk8 = pts.to_bytes(8, "big")
                put_pending(pk8, bytes([pstat]))
                p_timeout = int.from_bytes(p_val[108:112], "little")
                if p_timeout:
                    rm_expiry(pk8)
        put_acct = acct_tree.put
        closed_bit = int(AF.closed)
        by_closed = trees["acct_by_closed"]
        for k16, val in acct_last.items():
            put_acct(k16, val)
            # `closed` transitions (closing-native tiers evolve it on
            # the fast path): same put/remove-on-transition contract as
            # the object flush, keyed by the account's timestamp.
            aid = int.from_bytes(k16, "big")
            closed = bool(val[118] & closed_bit)  # flags u16 LE low byte
            if closed != (aid in self._closed_indexed):
                a_ts = int.from_bytes(val[120:128], "little")
                ckey = composite_key(1, a_ts, 1)
                if closed:
                    by_closed.put(ckey, b"\x01")
                    self._closed_indexed.add(aid)
                else:
                    by_closed.remove(ckey)
                    self._closed_indexed.discard(aid)
        # The touched account ids: the caller invalidates their cache
        # entries (reads must never serve pre-chunk balances).
        return [int.from_bytes(k16, "big") for k16 in acct_last]

    def prune_events(self, before_ts: int) -> int:
        """Delete prunable (no-history) event rows older than `before_ts`
        (the CDC consumer watermark) — the cleanup job the reference's
        `prunable` index exists for (src/state_machine.zig:590-601).
        Returns the number of rows pruned. Deterministic: driven purely by
        tree contents and the argument, so replicas pruning at the same
        op produce byte-identical grids."""
        from ..lsm.scan import TreeScan

        trees = self.forest.trees
        doomed = [key for key, _ in TreeScan(
            trees["ev_by_prunable"], _k8(0), _k8(max(0, before_ts - 1)))]
        for key in doomed:
            raw = trees["events"].get(key)
            if raw is not None:  # groove delete: object + every index row
                rec = _unpack_event(raw)
                ets = rec.timestamp
                trees["ev_by_pstat"].remove(
                    composite_key(int(rec.transfer_pending_status), ets, 1))
                if (rec.transfer_pending_status
                        == TransferPendingStatus.expired):
                    trees["ev_by_dr_expired"].remove(
                        composite_key(rec.dr_account.id, ets, 16))
                    trees["ev_by_cr_expired"].remove(
                        composite_key(rec.cr_account.id, ets, 16))
                    trees["ev_by_pid_expired"].remove(
                        composite_key(rec.transfer_pending.id, ets, 16))
                    trees["ev_by_ledger_expired"].remove(
                        composite_key(rec.dr_account.ledger, ets, 4))
            trees["events"].remove(key)
            trees["ev_by_prunable"].remove(key)
        return len(doomed)

    def compact_beat(self, op: int) -> None:
        self.forest.compact_beat(op)

    def checkpoint(self, state: StateMachineOracle,
                   flush_columns=None) -> bytes:
        """Flush + forest checkpoint; returns the root blob to persist.
        The 40 scalar bytes (key maxes, pulse, commit timestamp, event
        count) ride in the root blob itself — they are only ever read at
        restore, so they don't belong in a tree (reference analog: the
        superblock's VSRState vs the checkpoint trailer)."""
        self.flush(state, flush_columns=flush_columns)
        meta = struct.pack(
            "<QQQQQ",
            state.accounts_key_max or 0, state.transfers_key_max or 0,
            state.pulse_next_timestamp, state.commit_timestamp,
            self.events_persisted)
        return self.forest.checkpoint() + meta

    # ------------------------------------------------------------- recover

    def open(self, root: Optional[bytes],
             load_events: bool = True) -> StateMachineOracle:
        """Restore the forest from a checkpoint root and rebuild the
        in-memory state (object dicts + derived timestamp indexes).

        load_events=False (the replica serving path) leaves the event
        history in the forest's events tree and starts the host list at
        events_base = the persisted count — bounded memory regardless of
        history size (history queries are forest-served)."""
        state = StateMachineOracle()
        if root is not None:
            meta = root[-_META_SIZE:]
            self.forest.open(root[:-_META_SIZE])
            trees = self.forest.trees
            lo16, hi16 = b"\x00" * 16, b"\xff" * 16
            lo8, hi8 = b"\x00" * 8, b"\xff" * 8
            for _, v in trees["accounts"].scan(lo16, hi16):
                a = Account.unpack(v)
                state.accounts[a.id] = a
                state.account_by_timestamp[a.timestamp] = a.id
                self._indexed_accounts.add(a.id)
            for _, v in trees["transfers"].scan(lo16, hi16):
                t = Transfer.unpack(v)
                state.transfers[t.id] = t
                state.transfer_by_timestamp[t.timestamp] = t.id
            for k, v in trees["pending"].scan(lo8, hi8):
                state.pending_status[int.from_bytes(k, "big")] = \
                    TransferPendingStatus(v[0])
            for k, v in trees["expiry"].scan(lo8, hi8):
                state.expiry[int.from_bytes(k, "big")] = \
                    struct.unpack("<Q", v)[0]
            for k, _ in trees["orphaned"].scan(lo16, hi16):
                state.orphaned.add(int.from_bytes(k, "big"))
            for k, _ in trees["acct_by_closed"].scan(
                    b"\x00" * 9, b"\xff" * 9):
                ats = int.from_bytes(k[-8:], "big")
                self._closed_indexed.add(state.account_by_timestamp[ats])
            if load_events:
                for _, v in trees["events"].scan(lo8, hi8):
                    state.account_events.append(_unpack_event(v))
            akm, tkm, pulse, commit_ts, events_len = struct.unpack("<QQQQQ", meta)
            state.accounts_key_max = akm or None
            state.transfers_key_max = tkm or None
            state.pulse_next_timestamp = pulse
            state.commit_timestamp = commit_ts
            if load_events:
                # prune_events removes rows from the events tree, but
                # events_len is the monotonic persisted COUNT — start the
                # host list past the pruned prefix so flush's
                # un-persisted-tail slice stays exact.
                assert events_len >= len(state.account_events)
                state.events_base = events_len - len(state.account_events)
            else:
                state.events_base = events_len
        # Everything just loaded is already durable.
        for container in (state.accounts, state.transfers,
                          state.pending_status, state.expiry, state.orphaned):
            container.dirty.clear()
        self.events_persisted = state.events_base + len(state.account_events)
        return state
