"""Forest query engine: secondary-index scans resolved to objects.

reference: src/lsm/scan_builder.zig (composing index conditions into
union/intersection scans) + scan_lookup.zig (resolving matched timestamps
to objects) as used by get_account_transfers / get_account_balances
(src/state_machine.zig:1737-1831). This is the on-disk query path over the
durable forest — it must return exactly what the state machine's in-memory
indexes return (differential-tested).
"""

from __future__ import annotations

from typing import Iterator, Optional

from ..constants import TIMESTAMP_MAX
from ..types import (
    Account,
    AccountBalance,
    AccountFilter,
    AccountFilterFlags,
    AccountFlags,
    Operation,
    QueryFilter,
    QueryFilterFlags,
    Transfer,
)
from .forest import Forest
from .k_way_merge import k_way_merge
from .scan import TreeScan, composite_key

# QueryFilter condition fields -> (index tree suffix, prefix byte width).
_QUERY_FIELDS = (
    ("user_data_128", "ud128", 16),
    ("user_data_64", "ud64", 8),
    ("user_data_32", "ud32", 4),
    ("ledger", "ledger", 4),
    ("code", "code", 2),
)


def _transfer_matches(f: AccountFilter, t: Transfer) -> bool:
    """AccountFilter residual predicate (the conditions not served by the
    debits/credits index scan) — shared by transfers and balances."""
    if f.user_data_128 and t.user_data_128 != f.user_data_128:
        return False
    if f.user_data_64 and t.user_data_64 != f.user_data_64:
        return False
    if f.user_data_32 and t.user_data_32 != f.user_data_32:
        return False
    if f.code and t.code != f.code:
        return False
    return True


class ForestQuery:
    def __init__(self, forest: Forest):
        self.forest = forest

    # ---------------------------------------------------------- primitives

    def _index_scan(self, tree_name: str, prefix: int,
                    ts_min: int, ts_max: int) -> TreeScan:
        tree = self.forest.trees[tree_name]
        return TreeScan(
            tree,
            composite_key(prefix, ts_min, 16),
            composite_key(prefix, ts_max, 16))

    def transfer_by_timestamp(self, timestamp: int) -> Optional[Transfer]:
        tid = self.forest.trees["xfer_by_ts"].get(
            timestamp.to_bytes(8, "big"))
        if tid is None:
            return None
        raw = self.forest.trees["transfers"].get(tid)
        return None if raw is None else Transfer.unpack(raw)

    def account_by_timestamp(self, timestamp: int) -> Optional[Account]:
        aid = self.forest.trees["acct_by_ts"].get(
            timestamp.to_bytes(8, "big"))
        if aid is None:
            return None
        raw = self.forest.trees["accounts"].get(aid)
        return None if raw is None else Account.unpack(raw)

    # ------------------------------------------------------------- queries

    def account_transfer_timestamps(self, f: AccountFilter) -> Iterator[int]:
        """Ascending matching timestamps for an AccountFilter's
        debits/credits index conditions (the OR side; user_data/code
        predicates apply at lookup)."""
        ts_min = f.timestamp_min or 1
        ts_max = f.timestamp_max or TIMESTAMP_MAX
        scans = []
        if f.flags & AccountFilterFlags.debits:
            scans.append(self._index_scan(
                "xfer_by_dr", f.account_id, ts_min, ts_max))
        if f.flags & AccountFilterFlags.credits:
            scans.append(self._index_scan(
                "xfer_by_cr", f.account_id, ts_min, ts_max))
        # Union on the timestamp suffix (dr and cr scans share the same
        # account prefix, so suffix order == key order).
        suffix_streams = [
            ((key[-8:], None) for key, _ in scan) for scan in scans]
        for suffix, _ in k_way_merge(suffix_streams):
            yield int.from_bytes(suffix, "big")

    def get_account_transfers(self, f: AccountFilter,
                              limit_cap: int = 0) -> list[Transfer]:
        """The reference query (src/state_machine.zig:3294-3310) served
        from the forest: filter validation -> index scan -> object lookup
        -> residual filters -> direction/limit. Must return exactly what
        the host-index path returns (differential-tested)."""
        from ..state_machine import OPERATION_SPECS, StateMachine

        if not StateMachine._account_filter_valid(f):
            return []
        if not limit_cap:
            limit_cap = OPERATION_SPECS[
                Operation.get_account_transfers].result_max()
        limit = min(f.limit, limit_cap)
        reverse = bool(f.flags & AccountFilterFlags.reversed)
        matches: list[Transfer] = []
        for timestamp in self.account_transfer_timestamps(f):
            t = self.transfer_by_timestamp(timestamp)
            if t is None or not _transfer_matches(f, t):
                continue
            matches.append(t)
            if not reverse and len(matches) >= limit:
                break  # ascending: the limit cuts the front of the stream
        if reverse:
            matches.reverse()
        return matches[:limit]

    def get_account_balances(self, f: AccountFilter,
                             limit_cap: int = 0) -> list[AccountBalance]:
        """Balance history from the events tree (reference:
        src/state_machine.zig:1568-1666 — the same transfer scan mapped
        through account_events rows; history-flagged accounts only)."""
        from ..state_machine import OPERATION_SPECS, StateMachine
        from ..vsr.durable import _unpack_event

        if not StateMachine._account_filter_valid(f):
            return []
        raw = self.forest.trees["accounts"].get(
            f.account_id.to_bytes(16, "big"))
        if raw is None:
            return []
        account = Account.unpack(raw)
        if not (account.flags & AccountFlags.history):
            return []
        if not limit_cap:
            limit_cap = OPERATION_SPECS[
                Operation.get_account_balances].result_max()
        limit = min(f.limit, limit_cap)
        events = self.forest.trees["events"]
        reverse = bool(f.flags & AccountFilterFlags.reversed)

        def balances():
            for timestamp in self.account_transfer_timestamps(f):
                raw_event = events.get(timestamp.to_bytes(8, "big"))
                if raw_event is None:
                    continue
                t = self.transfer_by_timestamp(timestamp)
                if t is None or not _transfer_matches(f, t):
                    continue
                rec = _unpack_event(raw_event)
                if rec.dr_account.id == f.account_id:
                    side = rec.dr_account
                elif rec.cr_account.id == f.account_id:
                    side = rec.cr_account
                else:
                    continue
                yield AccountBalance(
                    debits_pending=side.debits_pending,
                    debits_posted=side.debits_posted,
                    credits_pending=side.credits_pending,
                    credits_posted=side.credits_posted,
                    timestamp=timestamp,
                )

        if reverse:
            # The host path reverses the full match stream, then cuts.
            out = list(balances())
            out.reverse()
            return out[:limit]
        out = []
        for balance in balances():
            out.append(balance)
            if len(out) >= limit:
                break
        return out

    def _query_objects(self, f: QueryFilter, groove: str):
        """Matching objects for a QueryFilter over one groove, ascending
        (reference: src/state_machine.zig:2054-2124 — walk one condition
        index, or the timestamp tree when unconditioned; verify residual
        conditions on the object)."""
        ts_min = f.timestamp_min or 1
        ts_max = f.timestamp_max or TIMESTAMP_MAX
        conds = [(attr, suffix, width)
                 for attr, suffix, width in _QUERY_FIELDS
                 if getattr(f, attr) != 0]
        prefix = "acct" if groove == "accounts" else "xfer"
        lookup = (self.account_by_timestamp if groove == "accounts"
                  else self.transfer_by_timestamp)
        if conds:
            attr, suffix, width = conds[0]
            tree = self.forest.trees[f"{prefix}_by_{suffix}"]
            scan = TreeScan(
                tree,
                composite_key(getattr(f, attr), ts_min, width),
                composite_key(getattr(f, attr), ts_max, width))
            candidates = (int.from_bytes(key[-8:], "big")
                          for key, _ in scan)
        else:
            tree = self.forest.trees[f"{prefix}_by_ts"]
            scan = TreeScan(tree, ts_min.to_bytes(8, "big"),
                            ts_max.to_bytes(8, "big"))
            candidates = (int.from_bytes(key, "big") for key, _ in scan)
        for timestamp in candidates:
            obj = lookup(timestamp)
            if obj is None:
                continue
            if any(getattr(obj, attr) != getattr(f, attr)
                   for attr, _, _ in conds):
                continue
            yield obj

    def _query(self, f: QueryFilter, groove: str, operation: Operation):
        from ..state_machine import OPERATION_SPECS, StateMachine

        if not StateMachine._query_filter_valid(f):
            return []
        limit = min(f.limit, OPERATION_SPECS[operation].result_max())
        if f.flags & QueryFilterFlags.reversed:
            matches = list(self._query_objects(f, groove))
            matches.reverse()
            return matches[:limit]
        matches = []
        for obj in self._query_objects(f, groove):
            matches.append(obj)
            if len(matches) >= limit:
                break  # ascending: stop at limit (host path does too)
        return matches

    def query_accounts(self, f: QueryFilter) -> list[Account]:
        return self._query(f, "accounts", Operation.query_accounts)

    def query_transfers(self, f: QueryFilter) -> list[Transfer]:
        return self._query(f, "transfers", Operation.query_transfers)

    def get_change_events(self, f, limit_cap: int = 0) -> list:
        """CDC query served from the forest's events tree (reference:
        src/state_machine.zig:3395-3528): range-scan account_events by
        timestamp, join transfer + both accounts from their object trees.
        Must return exactly what the host-index path returns."""
        from ..constants import TIMESTAMP_MAX as TS_MAX
        from ..state_machine import (
            OPERATION_SPECS,
            build_change_event,
        )
        from ..vsr.durable import _unpack_event

        valid = (
            f.limit != 0
            and (f.timestamp_min == 0 or 1 <= f.timestamp_min <= TS_MAX)
            and (f.timestamp_max == 0 or 1 <= f.timestamp_max <= TS_MAX)
            and (f.timestamp_max == 0 or f.timestamp_min <= f.timestamp_max)
        )
        if not valid:
            return []
        if not limit_cap:
            limit_cap = OPERATION_SPECS[
                Operation.get_change_events].result_max()
        limit = min(f.limit, limit_cap)
        ts_min = f.timestamp_min or 1
        ts_max = f.timestamp_max or TS_MAX
        scan = TreeScan(self.forest.trees["events"],
                        ts_min.to_bytes(8, "big"), ts_max.to_bytes(8, "big"))

        def account_by_id(aid: int) -> Account:
            raw = self.forest.trees["accounts"].get(aid.to_bytes(16, "big"))
            assert raw is not None, aid
            return Account.unpack(raw)

        out = []
        for _, value in scan:
            rec = _unpack_event(value)
            out.append(build_change_event(
                rec, self.transfer_by_timestamp, account_by_id))
            if len(out) >= limit:
                break
        return out

    def account_history_events(self, account_timestamp: int,
                               ts_min: int = 1,
                               ts_max: int = TIMESTAMP_MAX,
                               limit: int = 8190,
                               reverse: bool = False) -> list:
        """Balance-history rows of one history-flagged account, by the
        account_timestamp event index (reference: tree id 27,
        src/state_machine.zig:534-538 — "balance as-of" / "last time
        account=X was updated" queries). Returns AccountBalance rows of
        the requested side."""
        from ..types import AccountBalance
        from ..vsr.durable import _unpack_event

        events = self.forest.trees["events"]
        scan = TreeScan(
            self.forest.trees["ev_by_acct_ts"],
            composite_key(account_timestamp, ts_min, 8),
            composite_key(account_timestamp, ts_max, 8))
        # Index keys are cheap ints; unpack only the `limit` rows served.
        # (History rows are never prunable — both sides' flags gate the
        # prunable index — so every index key resolves to a row.)
        # Reverse keeps the LAST `limit` ascending keys via a bounded
        # deque: O(range) scan but O(limit) memory.
        from collections import deque

        keys = deque(maxlen=limit) if reverse else []
        for key, _ in scan:
            keys.append(int.from_bytes(key[-8:], "big"))
            if not reverse and len(keys) >= limit:
                break
        if reverse:
            keys = list(reversed(keys))
        rows = []
        for ets in keys:
            raw = events.get(ets.to_bytes(8, "big"))
            assert raw is not None, ets
            rec = _unpack_event(raw)
            side = (rec.dr_account
                    if rec.dr_account.timestamp == account_timestamp
                    else rec.cr_account)
            rows.append(AccountBalance(
                debits_pending=side.debits_pending,
                debits_posted=side.debits_posted,
                credits_pending=side.credits_pending,
                credits_posted=side.credits_posted,
                timestamp=ets))
        return rows

    def expiry_event_of_pending(self, pending_id: int):
        """The expiry event of a pending transfer, if it expired
        (reference: transfer_pending_id_expired index, tree id 31 —
        "when transfer=X has expired")."""
        from ..vsr.durable import _unpack_event

        scan = TreeScan(
            self.forest.trees["ev_by_pid_expired"],
            composite_key(pending_id, 1, 16),
            composite_key(pending_id, TIMESTAMP_MAX, 16))
        for key, _ in scan:
            raw = self.forest.trees["events"].get(key[-8:])
            if raw is not None:
                return _unpack_event(raw)
        return None

    def expired_events_by_account(self, account_id: int,
                                  side: str = "dr",
                                  limit: int = 8190) -> list:
        """Expiry events touching an account on the given side
        (reference: dr/cr_account_id_expired indexes, tree ids 29-30 —
        "all expired debits where account=X")."""
        from ..vsr.durable import _unpack_event

        assert side in ("dr", "cr")
        scan = TreeScan(
            self.forest.trees[f"ev_by_{side}_expired"],
            composite_key(account_id, 1, 16),
            composite_key(account_id, TIMESTAMP_MAX, 16))
        out = []
        for key, _ in scan:
            raw = self.forest.trees["events"].get(key[-8:])
            if raw is not None:
                out.append(_unpack_event(raw))
                if len(out) >= limit:
                    break
        return out

    def transfers_by_pending_id(self, pending_id: int) -> list[Transfer]:
        """Resolutions (posts/voids) of a pending transfer, ascending —
        served by the pending_id index tree (reference: the transfers
        groove's pending_id index)."""
        scan = TreeScan(
            self.forest.trees["xfer_by_pid"],
            composite_key(pending_id, 1, 16),
            composite_key(pending_id, TIMESTAMP_MAX, 16))
        out = []
        for key, _ in scan:
            t = self.transfer_by_timestamp(int.from_bytes(key[-8:], "big"))
            if t is not None:
                out.append(t)
        return out
