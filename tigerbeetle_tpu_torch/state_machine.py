"""StateMachine shell: operation dispatch, queries, and the wire boundary.

A port of the JAX package's `state_machine.py`: the host-side counterpart
of the reference StateMachine (src/state_machine.zig:222
StateMachineType). It owns the authoritative state store, routes create
batches through an engine, serves lookups and queries, schedules the
expiry pulse, and encodes/decodes operation bodies (including the
multi-batch trailer, src/vsr/multi_batch.zig). Engines:

  - "device": the serving path — `DeviceLedger` with a write-through host
    mirror (the state store itself): creates commit on the card, wire
    body to reply bytes with no per-event object, commit windows as one
    dispatch (sync, or staged / submitted / resolved two deep); queries
    and lookups read the mirror after its drain;
  - "kernel": batches through the sequential kernel
    (`ops/create_seq.run_create_*`, `csrc/create_seq.cu` on the card);
  - "oracle": the pure-Python oracle.

`device=None` means the card, and raises without one; the tests pass
"cpu".

Standalone, queries are served from incrementally-maintained secondary
indexes over the host state — the host analog of the reference's 33 LSM
index trees (tree ids at src/state_machine.zig:45-90). Index lists are
keyed by field value and hold timestamps in ascending commit order
(imported-timestamp regression checks guarantee inserts are
timestamp-monotonic per groove). With a durable forest attached
(`attach_durable`), lookups and queries are served from the forest
(`lsm/query.py`) behind bounded object caches, and never drain the
device engine's mirror; `cache_upsert` keeps the caches coherent after
each durable flush, and `raw_state` hands the flush the undrained state.
"""

from __future__ import annotations

import dataclasses
import itertools
import struct
import time as _time

import numpy as np

from . import constants, multi_batch
from .constants import (
    MESSAGE_BODY_SIZE_MAX,
    TIMESTAMP_MAX,
    U128_MAX,
)
from .ops.batch import encode_create_results, transfers_soa_from_bytes
from .ops.create_seq import run_create_accounts, run_create_transfers
from .ops.device import resolve_device
from .ops.ledger import DeviceLedger
from .oracle.state_machine import AccountEventRecord, StateMachineOracle
from .types import (
    Account,
    AccountBalance,
    AccountFilter,
    AccountFilterFlags,
    AccountFlags,
    ChangeEvent,
    ChangeEventType,
    ChangeEventsFilter,
    CreateTransferStatus,
    Operation,
    QueryFilter,
    QueryFilterFlags,
    Transfer,
    TransferPendingStatus,
)

__all__ = ["StateMachine", "OperationSpec", "OPERATION_SPECS", "ProtocolError"]


class ProtocolError(ValueError):
    """Malformed operation body (the replica rejects the request;
    reference: input_valid / batch en/decode errors)."""


@dataclasses.dataclass(frozen=True)
class OperationSpec:
    """Wire shape of one operation (reference: src/tigerbeetle.zig:717-785
    EventType/ResultType per operation)."""

    event_size: int
    result_size: int
    sparse_results: bool = False  # deprecated {index, result} encoding

    def event_max(self, body_max: int = MESSAGE_BODY_SIZE_MAX) -> int:
        return body_max // self.event_size if self.event_size else 0

    def result_max(self, body_max: int = MESSAGE_BODY_SIZE_MAX) -> int:
        return body_max // self.result_size if self.result_size else 0


OPERATION_SPECS: dict[Operation, OperationSpec] = {
    Operation.pulse: OperationSpec(0, 0),
    Operation.create_accounts: OperationSpec(128, 16),
    Operation.create_transfers: OperationSpec(128, 16),
    Operation.lookup_accounts: OperationSpec(16, 128),
    Operation.lookup_transfers: OperationSpec(16, 128),
    Operation.get_account_transfers: OperationSpec(128, 128),
    Operation.get_account_balances: OperationSpec(128, 128),
    Operation.query_accounts: OperationSpec(64, 128),
    Operation.query_transfers: OperationSpec(64, 128),
    Operation.get_change_events: OperationSpec(64, 384),
    Operation.deprecated_create_accounts_unbatched: OperationSpec(128, 8, True),
    Operation.deprecated_create_transfers_unbatched: OperationSpec(128, 8, True),
    Operation.deprecated_create_accounts_sparse: OperationSpec(128, 8, True),
    Operation.deprecated_create_transfers_sparse: OperationSpec(128, 8, True),
    Operation.deprecated_lookup_accounts_unbatched: OperationSpec(16, 128),
    Operation.deprecated_lookup_transfers_unbatched: OperationSpec(16, 128),
    Operation.deprecated_get_account_transfers_unbatched: OperationSpec(128, 128),
    Operation.deprecated_get_account_balances_unbatched: OperationSpec(128, 128),
    Operation.deprecated_query_accounts_unbatched: OperationSpec(64, 128),
    Operation.deprecated_query_transfers_unbatched: OperationSpec(64, 128),
}


class _Index:
    """Per-field secondary index: value -> ascending timestamp list."""

    def __init__(self):
        self.by_value: dict[int, list[int]] = {}

    def add(self, value: int, timestamp: int) -> None:
        self.by_value.setdefault(value, []).append(timestamp)

    def get(self, value: int) -> list[int]:
        return self.by_value.get(value, [])


class StateMachine:
    """Engine selection mirrors the reference's `-Dvopr-state-machine=`
    differential-testing switch: 'device' serves batches from the
    device-resident DeviceLedger via the vectorized tiers
    (ops/fast_kernels.py) with a write-through host mirror for queries —
    the database serving path; 'kernel' runs batches on the sequential
    kernel; 'oracle' runs the pure-Python reference implementation."""

    def __init__(self, engine: str = "kernel",
                 a_cap: int = 1 << 14, t_cap: int = 1 << 16, device=None):
        assert engine in ("kernel", "oracle", "device")
        self.engine = engine
        self.device = resolve_device(device)
        self._a_cap = a_cap
        self._t_cap = t_cap
        self._state = StateMachineOracle()
        self.led = None
        if engine == "device":
            self.led = DeviceLedger(a_cap=a_cap, t_cap=t_cap,
                                    write_through=self._state,
                                    device=self.device)
        # Secondary indexes (host analog of the LSM index trees).
        self._xfer_ts: list[int] = []  # all transfer timestamps ascending
        self._xfer_by: dict[str, _Index] = {
            f: _Index() for f in (
                "debit_account_id", "credit_account_id",
                "user_data_128", "user_data_64", "user_data_32",
                "ledger", "code")}
        self._xfer_indexed = 0
        self._acct_ts: list[int] = []
        self._acct_by: dict[str, _Index] = {
            f: _Index() for f in (
                "user_data_128", "user_data_64", "user_data_32",
                "ledger", "code")}
        self._acct_indexed = 0
        self._events_by_ts: dict[int, AccountEventRecord] = {}
        self._events_indexed = 0
        # The forest read path (attach_durable): ForestQuery and the
        # bounded object caches; None standalone.
        self._fq = None
        self._acct_cache = None
        self._xfer_cache = None
        # Per-operation commit timing table (op name -> count/total/max).
        self.metrics: dict[str, dict] = {}
        # Pipelined commit windows awaiting resolution (submit_commit_window).
        self._pending_windows: list = []
        # stage_commit_window's decode cache: the staged window's exact
        # SoA dicts, reused by the matching submit_commit_window so the
        # ledger's staged pack can be consumed by identity.
        self._staged_window = None

    def fallback_stats(self) -> dict:
        """Device-engine routing/fallback counters (per-cause host
        fallbacks + on-device escalations); empty for host engines."""
        if self.led is None:
            return {}
        return self.led.fallback_stats()

    # -------------------------------------------------------- LSM serving

    def attach_durable(self, durable, *, cache_sets: int = 1024,
                       ways: int = 8) -> None:
        """Serve reads from `durable`'s LSM forest behind a bounded object
        cache (reference: groove object cache + prefetch,
        src/lsm/groove.zig:885,996,1339). Queries route through
        ForestQuery; lookups hit the cache first and fall through to the
        object trees on a miss. At most 2 * cache_sets * ways cached
        objects. On the device engine the event ring becomes a per-batch
        transport (recycle_events: the history lives in the forest) and
        the ledger retains its delta columns for the durable flush
        (retain_flush_columns)."""
        from .lsm.cache_map import ObjectCache
        from .lsm.query import ForestQuery

        self._fq = ForestQuery(durable.forest)
        self._acct_cache = ObjectCache(sets=cache_sets, ways=ways)
        self._xfer_cache = ObjectCache(sets=cache_sets, ways=ways)
        if self.led is not None:
            self.led.recycle_events = True
            self.led.retain_flush_columns = True

    def cache_upsert(self, acct_ids, xfer_ids) -> None:
        """Cache coherence after a durable flush. Device engine: the
        flush consumed device delta columns (the mirror holds no objects
        for them yet), so the flushed ids are dropped and the next read
        misses into the just-written trees, with no drain. Host engines:
        the cached copies are refreshed from the state."""
        if self._fq is None:
            return
        if self.led is not None:
            for aid in acct_ids:
                self._acct_cache.remove(aid)
            for tid in xfer_ids:
                self._xfer_cache.remove(tid)
            return
        for aid in acct_ids:
            a = self.state.accounts.get(aid)
            if a is not None:
                self._acct_cache.put(aid, a)
        for tid in xfer_ids:
            t = self.state.transfers.get(tid)
            if t is not None:
                self._xfer_cache.put(tid, t)

    # ------------------------------------------------------------- state

    @property
    def raw_state(self) -> StateMachineOracle:
        """The state WITHOUT draining the device engine's deferred mirror:
        for the durable flush only, which consumes the delta columns
        directly. Every object-level reader uses `state`."""
        return self._state

    @property
    def state(self) -> StateMachineOracle:
        # The device engine defers the write-through materialization
        # (columnar chunks); every object-level read goes through this
        # property, so draining here keeps the mirror exact at every read.
        if self.led is not None:
            self.led.drain_mirror()
        return self._state

    @state.setter
    def state(self, new_state: StateMachineOracle) -> None:
        """Replace the authoritative state (restart recovery / state sync,
        vsr/replica.py). For the device engine this rebuilds the device
        tables from the restored host state."""
        self._state = new_state
        if self.engine == "device":
            if self.led is not None:
                self.led.shutdown_staging()
            self.led = DeviceLedger(a_cap=self._a_cap, t_cap=self._t_cap,
                                    write_through=new_state,
                                    device=self.device)
        # Derived query indexes must be rebuilt from scratch.
        self._xfer_ts = []
        for idx in self._xfer_by.values():
            idx.by_value = {}
        self._xfer_indexed = 0
        self._acct_ts = []
        for idx in self._acct_by.values():
            idx.by_value = {}
        self._acct_indexed = 0
        self._events_by_ts = {}
        self._events_indexed = 0
        if self._acct_cache is not None:
            self._acct_cache.clear()
            self._xfer_cache.clear()

    # ------------------------------------------------------------- creates

    def create_accounts(self, events: list[Account], timestamp: int):
        if self.engine == "device":
            return self.led.create_accounts(events, timestamp)
        if self.engine == "kernel":
            return run_create_accounts(self.state, events, timestamp,
                                       device=self.device)
        return self.state.create_accounts(events, timestamp)

    def create_transfers(self, events: list[Transfer], timestamp: int):
        if self.engine == "device":
            return self.led.create_transfers(events, timestamp)
        if self.engine == "kernel":
            return run_create_transfers(self.state, events, timestamp,
                                        device=self.device)
        return self.state.create_transfers(events, timestamp)

    # ------------------------------------------------------------- lookups

    def lookup_accounts(self, ids: list[int]) -> list[Account]:
        if self._fq is not None:
            return self._lookup_batched(
                ids, self._acct_cache, "accounts", Account)
        return [self.state.accounts[i] for i in ids if i in self.state.accounts]

    def lookup_transfers(self, ids: list[int]) -> list[Transfer]:
        if self._fq is not None:
            return self._lookup_batched(
                ids, self._xfer_cache, "transfers", Transfer)
        return [self.state.transfers[i] for i in ids if i in self.state.transfers]

    def _lookup_batched(self, ids, cache, tree_name, cls) -> list:
        """Cache hits first; all misses go to the object tree as one
        batched fan-out (Tree.get_many) and refill the cache: a cold
        batch costs one read round an LSM level, not one read an id
        (reference: src/lsm/groove.zig:996,1339)."""
        hit: dict = {}
        misses = []
        for i in ids:
            obj = cache.get(i)
            if obj is not None:
                hit[i] = obj
            elif i not in hit:
                misses.append(i)
        tree = self._fq.forest.trees[tree_name]
        if misses:
            unique = list(dict.fromkeys(misses))
            got = tree.get_many([i.to_bytes(16, "big") for i in unique])
            for i in unique:
                raw = got.get(i.to_bytes(16, "big"))
                if raw is not None:
                    obj = cls.unpack(raw)
                    cache.put(i, obj)
                    hit[i] = obj
        if constants.VERIFY and hit:
            # Extra-check mode: cached objects match their tree copies
            # (both are updated at the durable flush boundary).
            for i, obj in list(hit.items())[:4]:
                raw = tree.get(i.to_bytes(16, "big"))
                assert raw is not None and cls.unpack(raw) == obj, \
                    f"verify: cache/tree divergence on {tree_name} {i}"
        return [hit[i] for i in ids if i in hit]

    # ------------------------------------------------------------- indexes

    def _refresh_indexes(self) -> None:
        # Walk the by-timestamp maps, not the object dicts: they are the
        # commit-ordered spine (1:1 with the stores — scope rollbacks pop
        # both), and stay ordered under the lazy mirror, where a point
        # read moves a transfer out of dict insertion position
        # (ops/lazy_mirror.py).
        transfers = self.state.transfers
        by_ts_t = self.state.transfer_by_timestamp
        if len(by_ts_t) > self._xfer_indexed:
            for ts, tid in itertools.islice(by_ts_t.items(),
                                            self._xfer_indexed, None):
                t = transfers[tid]
                self._xfer_ts.append(ts)
                for field, idx in self._xfer_by.items():
                    idx.add(getattr(t, field), ts)
            self._xfer_indexed = len(by_ts_t)
        accounts = self.state.accounts
        by_ts_a = self.state.account_by_timestamp
        if len(by_ts_a) > self._acct_indexed:
            for ts, aid in itertools.islice(by_ts_a.items(),
                                            self._acct_indexed, None):
                a = accounts[aid]
                self._acct_ts.append(ts)
                for field, idx in self._acct_by.items():
                    idx.add(getattr(a, field), ts)
            self._acct_indexed = len(by_ts_a)
        events = self.state.account_events
        if len(events) > self._events_indexed:
            for rec in events[self._events_indexed:]:
                self._events_by_ts[rec.timestamp] = rec
            self._events_indexed = len(events)

    # ------------------------------------------------------------- queries

    @staticmethod
    def _account_filter_valid(f: AccountFilter) -> bool:
        """reference: src/state_machine.zig:1737-1752"""
        ts_ok = (
            (f.timestamp_min == 0 or 1 <= f.timestamp_min <= TIMESTAMP_MAX)
            and (f.timestamp_max == 0 or 1 <= f.timestamp_max <= TIMESTAMP_MAX)
            and (f.timestamp_max == 0 or f.timestamp_min <= f.timestamp_max)
        )
        flags_ok = (
            (f.flags & (AccountFilterFlags.credits | AccountFilterFlags.debits))
            and not (f.flags & ~0x7)
        )
        return bool(
            f.account_id not in (0, U128_MAX) and ts_ok and f.limit != 0
            and flags_ok
        )

    def _filtered_account_transfer_ts(self, f: AccountFilter) -> list[int]:
        """Candidate timestamps matching an AccountFilter, in scan order."""
        self._refresh_indexes()
        ts_min = f.timestamp_min or 1
        ts_max = f.timestamp_max or TIMESTAMP_MAX
        cands: list[int] = []
        if f.flags & AccountFilterFlags.debits:
            cands += self._xfer_by["debit_account_id"].get(f.account_id)
        if f.flags & AccountFilterFlags.credits:
            cands += self._xfer_by["credit_account_id"].get(f.account_id)
        cands = sorted(set(cands))
        out = []
        for ts in cands:
            if not (ts_min <= ts <= ts_max):
                continue
            t = self.state.transfers[self.state.transfer_by_timestamp[ts]]
            if f.user_data_128 and t.user_data_128 != f.user_data_128:
                continue
            if f.user_data_64 and t.user_data_64 != f.user_data_64:
                continue
            if f.user_data_32 and t.user_data_32 != f.user_data_32:
                continue
            if f.code and t.code != f.code:
                continue
            out.append(ts)
        if f.flags & AccountFilterFlags.reversed:
            out.reverse()
        return out

    def get_account_transfers(self, f: AccountFilter) -> list[Transfer]:
        """reference: src/state_machine.zig:3294-3310 + scan construction
        :1737-1831 (debits OR credits, AND user_data/code, range, limit)."""
        if self._fq is not None:
            return self._fq.get_account_transfers(f)
        if not self._account_filter_valid(f):
            return []
        limit = min(f.limit,
                    OPERATION_SPECS[Operation.get_account_transfers].result_max())
        ts_list = self._filtered_account_transfer_ts(f)[:limit]
        return [self.state.transfers[self.state.transfer_by_timestamp[ts]]
                for ts in ts_list]

    def get_account_balances(self, f: AccountFilter) -> list[AccountBalance]:
        """reference: src/state_machine.zig:1568-1666, 3312-3357 — the same
        transfer scan, mapped through account_events history rows; only for
        accounts with flags.history."""
        if self._fq is not None:
            return self._fq.get_account_balances(f)
        if not self._account_filter_valid(f):
            return []
        account = self.state.accounts.get(f.account_id)
        if account is None or not (account.flags & AccountFlags.history):
            return []
        limit = min(f.limit,
                    OPERATION_SPECS[Operation.get_account_balances].result_max())
        out: list[AccountBalance] = []
        for ts in self._filtered_account_transfer_ts(f):
            rec = self._events_by_ts.get(ts)
            if rec is None:
                continue
            if rec.dr_account.id == f.account_id:
                side = rec.dr_account
            elif rec.cr_account.id == f.account_id:
                side = rec.cr_account
            else:
                continue
            out.append(AccountBalance(
                debits_pending=side.debits_pending,
                debits_posted=side.debits_posted,
                credits_pending=side.credits_pending,
                credits_posted=side.credits_posted,
                timestamp=ts,
            ))
            if len(out) >= limit:
                break
        return out

    @staticmethod
    def _query_filter_valid(f: QueryFilter) -> bool:
        """reference: src/state_machine.zig:2054-2070"""
        ts_ok = (
            (f.timestamp_min == 0 or 1 <= f.timestamp_min <= TIMESTAMP_MAX)
            and (f.timestamp_max == 0 or 1 <= f.timestamp_max <= TIMESTAMP_MAX)
            and (f.timestamp_max == 0 or f.timestamp_min <= f.timestamp_max)
        )
        return bool(ts_ok and f.limit != 0 and not (f.flags & ~0x1))

    def _query(self, f: QueryFilter, kind: str, limit_cap: int) -> list[int]:
        """Shared query_accounts/query_transfers index walk."""
        self._refresh_indexes()
        indexes = self._acct_by if kind == "accounts" else self._xfer_by
        all_ts = self._acct_ts if kind == "accounts" else self._xfer_ts
        ts_min = f.timestamp_min or 1
        ts_max = f.timestamp_max or TIMESTAMP_MAX
        conds = [(field, getattr(f, field))
                 for field in ("user_data_128", "user_data_64", "user_data_32",
                               "ledger", "code")
                 if getattr(f, field) != 0]
        if conds:
            # Walk the most selective index; verify the rest on the object.
            field0, value0 = min(
                conds, key=lambda fv: len(indexes[fv[0]].get(fv[1])))
            cands = indexes[field0].get(value0)
        else:
            cands = all_ts
        by_ts = (self.state.account_by_timestamp if kind == "accounts"
                 else self.state.transfer_by_timestamp)
        store = (self.state.accounts if kind == "accounts"
                 else self.state.transfers)
        out = []
        it = reversed(cands) if f.flags & QueryFilterFlags.reversed else iter(cands)
        limit = min(f.limit, limit_cap)
        for ts in it:
            if not (ts_min <= ts <= ts_max):
                continue
            obj = store[by_ts[ts]]
            if any(getattr(obj, field) != value for field, value in conds):
                continue
            out.append(ts)
            if len(out) >= limit:
                break
        return out

    def query_accounts(self, f: QueryFilter) -> list[Account]:
        """reference: src/state_machine.zig:3359-3375 + :2054-2124."""
        if self._fq is not None:
            return self._fq.query_accounts(f)
        if not self._query_filter_valid(f):
            return []
        cap = OPERATION_SPECS[Operation.query_accounts].result_max()
        return [self.state.accounts[self.state.account_by_timestamp[ts]]
                for ts in self._query(f, "accounts", cap)]

    def query_transfers(self, f: QueryFilter) -> list[Transfer]:
        if self._fq is not None:
            return self._fq.query_transfers(f)
        if not self._query_filter_valid(f):
            return []
        cap = OPERATION_SPECS[Operation.query_transfers].result_max()
        return [self.state.transfers[self.state.transfer_by_timestamp[ts]]
                for ts in self._query(f, "transfers", cap)]

    def get_change_events(self, f: ChangeEventsFilter) -> list[ChangeEvent]:
        """reference: src/state_machine.zig:3395-3528 — scan account_events
        by timestamp, join the transfer (by event timestamp; by pending id
        for expiries) and both accounts."""
        valid = (
            f.limit != 0
            and (f.timestamp_min == 0 or 1 <= f.timestamp_min <= TIMESTAMP_MAX)
            and (f.timestamp_max == 0 or 1 <= f.timestamp_max <= TIMESTAMP_MAX)
            and (f.timestamp_max == 0 or f.timestamp_min <= f.timestamp_max)
        )
        if not valid:
            return []
        if self._fq is not None:
            return self._fq.get_change_events(f)
        self._refresh_indexes()
        ts_min = f.timestamp_min or 1
        ts_max = f.timestamp_max or TIMESTAMP_MAX
        limit = min(f.limit,
                    OPERATION_SPECS[Operation.get_change_events].result_max())
        out: list[ChangeEvent] = []
        for rec in self.state.account_events:
            if not (ts_min <= rec.timestamp <= ts_max):
                continue
            out.append(self._change_event(rec))
            if len(out) >= limit:
                break
        return out

    def _change_event(self, rec: AccountEventRecord) -> ChangeEvent:
        return build_change_event(
            rec,
            lambda ts: self.state.transfers[
                self.state.transfer_by_timestamp[ts]],
            lambda aid: self.state.accounts[aid])

    # ------------------------------------------------------------- pulse

    def pulse_needed(self, timestamp: int) -> bool:
        """reference: src/state_machine.zig:1138-1144"""
        if self.led is not None:
            # Answered from the device pulse_next scalar: the primary asks
            # this once per prepare, and a drain-on-read here would negate
            # the deferred mirror materialization on the serving path.
            return self.led.pulse_needed(timestamp)
        return self.state.pulse_needed(timestamp)

    # ------------------------------------------------------------- wire

    def input_valid(self, op: Operation, body: bytes) -> bool:
        """Cheap wire-shape validation before a request is accepted
        (reference: input_valid, src/state_machine.zig:~1000)."""
        spec = OPERATION_SPECS.get(op)
        if spec is None:
            return False
        if op == Operation.pulse:
            return body == b""
        if len(body) > MESSAGE_BODY_SIZE_MAX:
            return False  # would not fit a prepare (journal slot bound)
        try:
            batches = (multi_batch.decode(body, spec.event_size)
                       if op.is_multi_batch() else [body])
        except ValueError:
            return False
        base = _base_operation(op)
        single = base in (
            Operation.get_account_transfers, Operation.get_account_balances,
            Operation.query_accounts, Operation.query_transfers,
            Operation.get_change_events)
        for b in batches:
            if spec.event_size and len(b) % spec.event_size != 0:
                return False
            if single and len(b) != spec.event_size:
                return False
        return True

    def commit(self, op: Operation, body: bytes, timestamp: int) -> bytes:
        """Execute one operation body (reference StateMachine.commit,
        src/state_machine.zig:2564-2669): decode (multi-batch aware),
        dispatch, encode results. Raises ProtocolError on malformed input
        (callers validate first via input_valid). Per-op timings aggregate
        into `metrics` (reference: the commit Metrics table,
        src/state_machine.zig:729-780, :2637-2667)."""
        # Metrics-only timing, never committed state.
        t0 = _time.perf_counter_ns()
        try:
            return self._commit_timed(op, body, timestamp)
        finally:
            m = self.metrics.setdefault(
                op.name, {"count": 0, "total_ns": 0, "max_ns": 0})
            dt = _time.perf_counter_ns() - t0
            m["count"] += 1
            m["total_ns"] += dt
            if dt > m["max_ns"]:
                m["max_ns"] = dt

    def commit_window(self, op: Operation, bodies: list[bytes],
                      timestamps: list[int],
                      all_or_nothing: bool = False):
        """Commit a contiguous run of already-ordered prepares in one
        device dispatch (commit-window aggregation). Replicas may call
        this whenever several committed prepares are queued behind the
        execute stage — the analog of the reference pipelining 8
        prepares (src/config.zig:155). Results are bit-identical to
        committing one body at a time: any cross-prepare dependency
        falls back to the sequential path inside the ledger.

        Only device-engine create_transfers windows aggregate; anything
        else (mixed ops, pulse, host engine) commits per body.

        all_or_nothing=True (the replica commit loop): never executes
        per body on any obstacle — returns None with state untouched
        (the caller re-commits op by op through its normal path), and
        on success returns (replies, chunks_per_body) so the caller can
        attribute flush chunks to prepares."""
        if not self._windowable(op, bodies):
            if all_or_nothing:
                return None
            return [self.commit(op, b, ts)
                    for b, ts in zip(bodies, timestamps)]

        spec = OPERATION_SPECS[op]
        # Metrics-only timing, never committed state.
        t0 = _time.perf_counter_ns()
        evs, tss, shape = self._flatten_window(op, bodies, timestamps)
        outs = self.led.create_transfers_window(
            evs, tss, all_or_nothing=all_or_nothing)
        if outs is None:
            assert all_or_nothing
            return None
        replies = self._encode_window_replies(spec, outs, shape)
        m = self.metrics.setdefault(
            op.name, {"count": 0, "total_ns": 0, "max_ns": 0})
        dt = _time.perf_counter_ns() - t0
        m["count"] += len(bodies)
        m["total_ns"] += dt
        if dt > m["max_ns"]:
            m["max_ns"] = dt
        if all_or_nothing:
            return replies, shape
        return replies

    def _flatten_window(self, op: Operation, bodies: list[bytes],
                        timestamps: list[int]):
        """Decode a window's bodies into flat (evs, tss, shape): each
        body may hold several inner batches, each consuming one
        timestamp per event ending at the prepare timestamp (reference:
        execute_multi_batch, src/state_machine.zig:2720-2756). Shared by
        the sync and pipelined window paths so their timestamp
        attribution can never diverge."""
        spec = OPERATION_SPECS[op]
        evs, tss, shape = [], [], []
        for body, ts in zip(bodies, timestamps):
            batches = multi_batch.decode(body, spec.event_size)
            counts = [len(b) // spec.event_size for b in batches]
            running = ts - sum(counts)
            for b, n in zip(batches, counts):
                running += n
                evs.append(transfers_soa_from_bytes(b))
                tss.append(running)
            shape.append(len(batches))
        return evs, tss, shape

    @staticmethod
    def _encode_window_replies(spec, outs, shape) -> list[bytes]:
        replies = []
        i = 0
        for k in shape:
            parts = [_encode_results_soa(st, t, spec)
                     for st, t in outs[i:i + k]]
            i += k
            replies.append(multi_batch.encode(parts, spec.result_size))
        return replies

    def _windowable(self, op: Operation, bodies: list[bytes]) -> bool:
        """Only device-engine windows of several valid multi-batch
        create_transfers bodies run as one dispatch."""
        return (self.engine == "device" and len(bodies) > 1
                and _base_operation(op) == Operation.create_transfers
                and op.is_multi_batch()
                and all(self.input_valid(op, b) for b in bodies))

    def stage_commit_window(self, op: Operation, bodies: list[bytes],
                            timestamps: list[int]) -> bool:
        """Host↔device overlap: decode window k+1's bodies and hand its
        stacked operands to the ledger's background stager while window
        k's dispatch is in flight (DeviceLedger.stage_window). The
        decode is cached by body identity so the following
        submit_commit_window of the same window reuses the exact SoA
        dicts — which is what lets the ledger match its staged pack.
        Purely an optimization: an unstaged or mismatched submit packs
        inline, bit-identically. Returns True when a stage was
        enqueued."""
        if not self._windowable(op, bodies):
            self._staged_window = None
            return False
        evs, tss, shape = self._flatten_window(op, bodies, timestamps)
        # Keep the bodies alive in the cache: their ids key the reuse.
        self._staged_window = (op, tuple(map(id, bodies)), bodies,
                               list(timestamps), evs, tss, shape)
        return self.led.stage_window(evs, tss)

    def submit_commit_window(self, op: Operation, bodies: list[bytes],
                             timestamps: list[int]):
        """Pipelined serving: decode + submit one commit window with no
        device synchronization (DeviceLedger.submit_window — the
        reference's 8-deep prepare pipeline analog, src/config.zig:155).
        Returns an opaque pending record, or None when the window cannot
        pipeline (caller takes the synchronous commit_window path).
        Replies materialize at resolve_commit_windows()."""
        if not self._windowable(op, bodies):
            return None
        staged, self._staged_window = self._staged_window, None
        if (staged is not None and staged[0] == op
                and staged[1] == tuple(map(id, bodies))
                and staged[3] == list(timestamps)):
            evs, tss, shape = staged[4], staged[5], staged[6]
        else:
            evs, tss, shape = self._flatten_window(op, bodies,
                                                   timestamps)
        ticket = self.led.submit_window(evs, tss)
        if ticket is None:
            return None
        rec = {"op": op, "ticket": ticket, "shape": shape,
               "n_bodies": len(bodies)}
        self._pending_windows.append(rec)
        return rec

    def resolve_commit_windows(self, count: int | None = None) -> list:
        """Resolve pending pipelined windows in order — all, or at least
        the oldest `count` (a mid-pipeline fallback resolves everything;
        see DeviceLedger.resolve_windows) — and attach wire replies to
        each completed record under rec['replies']. Returns the
        completed records in order."""
        if not self._pending_windows:
            return []
        self.led.resolve_windows(count)
        done = []
        while (self._pending_windows
               and self._pending_windows[0]["ticket"].results is not None):
            rec = self._pending_windows.pop(0)
            _, outs = rec["ticket"].results
            rec["replies"] = self._encode_window_replies(
                OPERATION_SPECS[rec["op"]], outs, rec["shape"])
            done.append(rec)
        return done

    def _commit_timed(self, op: Operation, body: bytes,
                      timestamp: int) -> bytes:
        if not self.input_valid(op, body):
            raise ProtocolError(f"malformed body for {op!r}")
        spec = OPERATION_SPECS[op]
        if op == Operation.pulse:
            if self.engine == "device":
                self.led.expire_pending_transfers(timestamp)
            else:
                self.state.expire_pending_transfers(timestamp)
            return b""
        if op.is_multi_batch():
            batches = multi_batch.decode(body, spec.event_size)
            results = []
            if _base_operation(op) in (Operation.create_accounts,
                                       Operation.create_transfers):
                # Each inner batch consumes one timestamp per event; the
                # prepare timestamp is the LAST event's
                # (reference: execute_multi_batch advances the execute
                # timestamp per batch, src/state_machine.zig:2720-2756).
                counts = [len(b) // spec.event_size for b in batches]
                running = timestamp - sum(counts)
                for b, n in zip(batches, counts):
                    running += n
                    results.append(self._commit_one(op, spec, b, running))
            else:
                results = [self._commit_one(op, spec, b, timestamp)
                           for b in batches]
            return multi_batch.encode(results, spec.result_size)
        return self._commit_one(op, spec, body, timestamp)

    def _commit_one(self, op: Operation, spec: OperationSpec, body: bytes,
                    timestamp: int) -> bytes:
        O = Operation
        base = _base_operation(op)
        if base == O.create_transfers and self.engine == "device":
            # Vectorized serving path: wire -> SoA -> kernel -> wire with
            # no per-event Python objects (reference: commit is the cheap
            # part, src/state_machine.zig:2564-2669).
            ev = transfers_soa_from_bytes(body)
            st, ts = self.led.create_transfers_soa(ev, timestamp)
            return _encode_results_soa(st, ts, spec)
        events = [body[i:i + spec.event_size]
                  for i in range(0, len(body), spec.event_size)]
        if base == O.create_accounts:
            accounts = [Account.unpack(e) for e in events]
            results = self.create_accounts(accounts, timestamp)
            return _encode_create_results(results, spec)
        if base == O.create_transfers:
            transfers = [Transfer.unpack(e) for e in events]
            results = self.create_transfers(transfers, timestamp)
            return _encode_create_results(results, spec)
        if base == O.lookup_accounts:
            ids = [int.from_bytes(e, "little") for e in events]
            return b"".join(a.pack() for a in self.lookup_accounts(ids))
        if base == O.lookup_transfers:
            ids = [int.from_bytes(e, "little") for e in events]
            return b"".join(t.pack() for t in self.lookup_transfers(ids))
        if base == O.get_account_transfers:
            assert len(events) == 1
            return b"".join(t.pack() for t in
                            self.get_account_transfers(AccountFilter.unpack(events[0])))
        if base == O.get_account_balances:
            assert len(events) == 1
            return b"".join(b.pack() for b in
                            self.get_account_balances(AccountFilter.unpack(events[0])))
        if base == O.query_accounts:
            assert len(events) == 1
            return b"".join(a.pack() for a in
                            self.query_accounts(QueryFilter.unpack(events[0])))
        if base == O.query_transfers:
            assert len(events) == 1
            return b"".join(t.pack() for t in
                            self.query_transfers(QueryFilter.unpack(events[0])))
        if base == O.get_change_events:
            assert len(events) == 1
            return b"".join(e.pack() for e in
                            self.get_change_events(ChangeEventsFilter.unpack(events[0])))
        raise ValueError(f"unhandled operation {op!r}")


def _base_operation(op: Operation) -> Operation:
    """Map deprecated wire-compat variants onto their modern semantics
    (reference: src/tigerbeetle.zig:685-715)."""
    O = Operation
    return {
        O.deprecated_create_accounts_unbatched: O.create_accounts,
        O.deprecated_create_transfers_unbatched: O.create_transfers,
        O.deprecated_create_accounts_sparse: O.create_accounts,
        O.deprecated_create_transfers_sparse: O.create_transfers,
        O.deprecated_lookup_accounts_unbatched: O.lookup_accounts,
        O.deprecated_lookup_transfers_unbatched: O.lookup_transfers,
        O.deprecated_get_account_transfers_unbatched: O.get_account_transfers,
        O.deprecated_get_account_balances_unbatched: O.get_account_balances,
        O.deprecated_query_accounts_unbatched: O.query_accounts,
        O.deprecated_query_transfers_unbatched: O.query_transfers,
    }.get(op, op)


def _encode_results_soa(st, ts, spec: OperationSpec) -> bytes:
    """Vectorized result encode from (status, timestamp) arrays."""
    if not spec.sparse_results:
        return encode_create_results(st, ts)
    # Deprecated sparse encoding: {index, result} u32 pairs, non-created only.
    created = np.uint32(int(CreateTransferStatus.created))
    idx = np.nonzero(st != created)[0]
    out = np.empty(len(idx), dtype=np.dtype(
        {"names": ["index", "result"], "formats": ["<u4", "<u4"]}))
    out["index"] = idx
    out["result"] = st[idx]
    return out.tobytes()


def _encode_create_results(results, spec: OperationSpec) -> bytes:
    if not spec.sparse_results:
        return b"".join(r.pack() for r in results)
    # Deprecated sparse encoding: {index: u32, result: u32} for non-ok only,
    # where `created` maps to omitted and wire code `ok`=0 is never sent.
    out = b""
    for i, r in enumerate(results):
        if r.status.name == "created":
            continue
        out += struct.pack("<II", i, int(r.status))
    return out


def build_change_event(rec: AccountEventRecord, transfer_by_timestamp,
                       account_by_id) -> ChangeEvent:
    """Join one account_events record with its transfer + accounts
    (reference: src/state_machine.zig:3395-3528)."""
    status = rec.transfer_pending_status
    if status == TransferPendingStatus.expired:
        transfer = rec.transfer_pending
        assert transfer is not None
        etype = ChangeEventType.two_phase_expired
    else:
        transfer = transfer_by_timestamp(rec.timestamp)
        etype = {
            TransferPendingStatus.none: ChangeEventType.single_phase,
            TransferPendingStatus.pending: ChangeEventType.two_phase_pending,
            TransferPendingStatus.posted: ChangeEventType.two_phase_posted,
            TransferPendingStatus.voided: ChangeEventType.two_phase_voided,
        }[status]
    dr = account_by_id(rec.dr_account.id)
    cr = account_by_id(rec.cr_account.id)
    return ChangeEvent(
        transfer_id=transfer.id,
        transfer_amount=rec.amount,
        transfer_pending_id=transfer.pending_id,
        transfer_user_data_128=transfer.user_data_128,
        transfer_user_data_64=transfer.user_data_64,
        transfer_user_data_32=transfer.user_data_32,
        transfer_timeout=transfer.timeout,
        transfer_code=transfer.code,
        transfer_flags=transfer.flags,
        ledger=transfer.ledger,
        type=etype,
        debit_account_id=dr.id,
        debit_account_debits_pending=rec.dr_account.debits_pending,
        debit_account_debits_posted=rec.dr_account.debits_posted,
        debit_account_credits_pending=rec.dr_account.credits_pending,
        debit_account_credits_posted=rec.dr_account.credits_posted,
        debit_account_user_data_128=dr.user_data_128,
        debit_account_user_data_64=dr.user_data_64,
        debit_account_user_data_32=dr.user_data_32,
        debit_account_code=dr.code,
        debit_account_flags=rec.dr_account.flags,
        credit_account_id=cr.id,
        credit_account_debits_pending=rec.cr_account.debits_pending,
        credit_account_debits_posted=rec.cr_account.debits_posted,
        credit_account_credits_pending=rec.cr_account.credits_pending,
        credit_account_credits_posted=rec.cr_account.credits_posted,
        credit_account_user_data_128=cr.user_data_128,
        credit_account_user_data_64=cr.user_data_64,
        credit_account_user_data_32=cr.user_data_32,
        credit_account_code=cr.code,
        credit_account_flags=rec.cr_account.flags,
        timestamp=rec.timestamp,
        transfer_timestamp=transfer.timestamp,
        debit_account_timestamp=dr.timestamp,
        credit_account_timestamp=cr.timestamp,
    )
