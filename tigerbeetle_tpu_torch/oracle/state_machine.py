"""Sequential oracle of the TigerBeetle accounting state machine.

The port's own copy of the JAX package's `oracle/state_machine.py`, kept
line for line (the tests hold the two against each other): the port
imports nothing of the JAX package, and this module is the exact
sequential semantics that `DeviceLedger`'s host-mirror regime runs on.

Pure-Python, dict-backed, event-at-a-time execution with exactly the
reference's validation order and result codes. This is deliberately the
*opposite* of the device design: simple, sequential, obviously-correct.
The port's kernels must produce bit-identical (timestamp, status)
results against this oracle.

reference: src/state_machine.zig — execute_create (:3002-3213),
create_account (:3613-3689), create_transfer (:3719-3986),
post_or_void_pending_transfer (:4053-4299),
execute_expire_pending_transfers (:4511-4628), transient_error (:3215-3252).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..constants import (
    BATCH_MAX,
    NS_PER_S,
    TIMESTAMP_MAX,
    TIMESTAMP_MIN,
    U63_MAX,
    U128_MAX,
    timestamp_valid,
)
from ..types import (
    Account,
    AccountFlags,
    CreateAccountResult,
    CreateAccountStatus,
    CreateTransferResult,
    CreateTransferStatus,
    Transfer,
    TransferFlags,
    TransferPendingStatus,
)


@dataclasses.dataclass
class AccountEventRecord:
    """One row of the account_events groove (CDC + balance history).

    reference: src/state_machine.zig:104-220 (AccountEvent), account_event()
    (:4384-4470). Snapshot of both accounts *after* applying the event.
    """

    timestamp: int
    dr_account: Account
    cr_account: Account
    transfer_flags: Optional[int]
    transfer_pending_status: TransferPendingStatus
    transfer_pending: Optional[Transfer]
    amount_requested: int
    amount: int


class DirtyDict(dict):
    """Dict that records mutated keys on two independent channels:
    `dirty` is the durable layer's write-behind set (cleared by
    DurableState.flush), `dirty_dev` is the device ledger's push-pending
    set (cleared by DeviceLedger._push_dirty / the write-through delta).
    Two consumers with different flush cadences must not share one bit —
    e.g. a replica flushes every commit while the device push only runs
    on hard batches. The device channel only records when a DeviceLedger
    is attached (track_dev, see DeviceLedger._enable_dev_tracking) — on
    the oracle/kernel engines nothing would ever clear it, an unbounded
    leak over a long soak."""

    track_dev = False  # class default; DeviceLedger flips per instance

    def __init__(self, *args):
        super().__init__(*args)
        self.dirty: set = set()
        self.dirty_dev: set = set()

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        self.dirty.add(key)
        if self.track_dev:
            self.dirty_dev.add(key)

    def __delitem__(self, key):
        if key in self:
            self.dirty.add(key)
            if self.track_dev:
                self.dirty_dev.add(key)
        super().__delitem__(key)

    def pop(self, key, *default):
        # Only a pop that actually removes something dirties the key: a
        # no-op pop (absent key, default given) must not produce a spurious
        # tombstone write downstream.
        if key in self:
            self.dirty.add(key)
            if self.track_dev:
                self.dirty_dev.add(key)
        return super().pop(key, *default)


class DirtySet(set):
    """Set that records added members since the last flush (same two
    channels as DirtyDict)."""

    track_dev = False

    def __init__(self, *args):
        super().__init__(*args)
        self.dirty: set = set()
        self.dirty_dev: set = set()

    def add(self, member):
        super().add(member)
        self.dirty.add(member)
        if self.track_dev:
            self.dirty_dev.add(member)


class _Scope:
    """Rollback scope for linked chains (reference: src/lsm/groove.zig:1963-1984
    scope_open/scope_close generalized across all oracle containers)."""

    def __init__(self, oracle: "StateMachineOracle"):
        self.accounts: dict[int, Optional[Account]] = {}
        self.transfers: dict[int, Optional[Transfer]] = {}
        self.pending_status: dict[int, Optional[TransferPendingStatus]] = {}
        self.expiry: dict[int, Optional[int]] = {}
        self.account_events_len = len(oracle.account_events)
        self.commit_timestamp = oracle.commit_timestamp
        self.transfers_key_max = oracle.transfers_key_max
        self.accounts_key_max = oracle.accounts_key_max
        # NOTE: pulse_next_timestamp is deliberately NOT snapshotted — it is
        # state-machine state, not groove state, and the reference never
        # reverts it on scope discard (a rolled-back pending transfer may
        # leave an early pulse_next behind; the pulse scan then finds nothing,
        # which is safe by the "timestamp_min means scan to check" contract,
        # src/state_machine.zig:4915-4920).


class StateMachineOracle:
    """In-memory state machine with reference-exact create/lookup semantics."""

    def __init__(self) -> None:
        self.accounts: DirtyDict = DirtyDict()
        self.transfers: DirtyDict = DirtyDict()
        # Transfer ids that failed with a transient status: retried ids fail
        # with id_already_failed (reference: groove.insert_orphaned_primary_key).
        self.orphaned: DirtySet = DirtySet()
        # pending transfer timestamp -> TransferPendingStatus
        # (reference: transfers_pending groove, state_machine.zig:92-102).
        self.pending_status: DirtyDict = DirtyDict()
        # pending transfer timestamp -> expires_at (live expires_at index).
        self.expiry: DirtyDict = DirtyDict()
        # Object-tree key ranges for imported-timestamp regression checks
        # (reference: groove objects.key_range; key = timestamp).
        self.accounts_key_max: Optional[int] = None
        self.transfers_key_max: Optional[int] = None
        # Timestamp -> id for exact-match indirect lookups
        # (reference: groove.indirect_lookup on the `timestamp` unique index).
        self.account_by_timestamp: dict[int, int] = {}
        self.transfer_by_timestamp: dict[int, int] = {}
        self.account_events: list[AccountEventRecord] = []
        # Absolute index of account_events[0]: the prefix below it has
        # been pruned after durable flush (the forest's events tree is
        # the full history; the host list is only the unflushed tail +
        # the post-checkpoint window). Pruning happens at deterministic
        # (checkpoint) points so replicas stay byte-identical.
        self.events_base: int = 0
        self.commit_timestamp: int = 0
        # reference: src/state_machine.zig:4915-4920.
        self.pulse_next_timestamp: int = TIMESTAMP_MIN
        self._scope: Optional[_Scope] = None

    def prune_account_events(self, up_to_abs: int) -> None:
        """Drop flushed history below the absolute index `up_to_abs`
        (memory-bounds doctrine, docs/ARCHITECTURE.md:189-230: the host
        tail stays bounded by the checkpoint window; history reads come
        from the LSM events tree)."""
        keep_from = up_to_abs - self.events_base
        if keep_from <= 0:
            return
        assert keep_from <= len(self.account_events)
        del self.account_events[:keep_from]
        self.events_base = up_to_abs

    # ------------------------------------------------------------------ scopes

    def _scope_open(self) -> None:
        assert self._scope is None
        self._scope = _Scope(self)

    def _scope_close(self, persist: bool) -> None:
        scope = self._scope
        assert scope is not None
        self._scope = None
        if persist:
            return
        for aid, old in scope.accounts.items():
            if old is None:
                a = self.accounts.pop(aid)
                self.account_by_timestamp.pop(a.timestamp, None)
            else:
                self.accounts[aid] = old
        for tid, old_t in scope.transfers.items():
            if old_t is None:
                t = self.transfers.pop(tid)
                self.transfer_by_timestamp.pop(t.timestamp, None)
            else:
                self.transfers[tid] = old_t
        for ts, old_s in scope.pending_status.items():
            if old_s is None:
                del self.pending_status[ts]
            else:
                self.pending_status[ts] = old_s
        for ts, old_e in scope.expiry.items():
            if old_e is None:
                self.expiry.pop(ts, None)
            else:
                self.expiry[ts] = old_e
        del self.account_events[scope.account_events_len :]
        self.commit_timestamp = scope.commit_timestamp
        self.transfers_key_max = scope.transfers_key_max
        self.accounts_key_max = scope.accounts_key_max

    # ------------------------------------------------------- journaled mutators

    def _put_account(self, account: Account) -> None:
        if self._scope is not None and account.id not in self._scope.accounts:
            self._scope.accounts[account.id] = self.accounts.get(account.id)
        self.accounts[account.id] = account

    def _insert_account(self, account: Account) -> None:
        self._put_account(account)
        self.account_by_timestamp[account.timestamp] = account.id
        if self.accounts_key_max is None or account.timestamp > self.accounts_key_max:
            self.accounts_key_max = account.timestamp

    def _insert_transfer(self, transfer: Transfer) -> None:
        if self._scope is not None and transfer.id not in self._scope.transfers:
            self._scope.transfers[transfer.id] = self.transfers.get(transfer.id)
        self.transfers[transfer.id] = transfer
        self.transfer_by_timestamp[transfer.timestamp] = transfer.id
        if self.transfers_key_max is None or transfer.timestamp > self.transfers_key_max:
            self.transfers_key_max = transfer.timestamp

    def _set_pending_status(self, timestamp: int, status: TransferPendingStatus) -> None:
        if self._scope is not None and timestamp not in self._scope.pending_status:
            self._scope.pending_status[timestamp] = self.pending_status.get(timestamp)
        self.pending_status[timestamp] = status

    def _set_expiry(self, timestamp: int, expires_at: Optional[int]) -> None:
        if self._scope is not None and timestamp not in self._scope.expiry:
            self._scope.expiry[timestamp] = self.expiry.get(timestamp)
        if expires_at is None:
            self.expiry.pop(timestamp, None)
        else:
            self.expiry[timestamp] = expires_at

    # ---------------------------------------------------------------- execution

    def create_accounts(
        self, events: list[Account], timestamp: int
    ) -> list[CreateAccountResult]:
        return self._execute_create(events, timestamp, is_transfer=False)

    def create_transfers(
        self, events: list[Transfer], timestamp: int
    ) -> list[CreateTransferResult]:
        return self._execute_create(events, timestamp, is_transfer=True)

    def _execute_create(self, events, timestamp: int, *, is_transfer: bool):
        """reference: src/state_machine.zig:3002-3213 (execute_create)."""
        if is_transfer:
            status_enum, result_type = CreateTransferStatus, CreateTransferResult
        else:
            status_enum, result_type = CreateAccountStatus, CreateAccountResult
        assert len(events) <= BATCH_MAX

        imported_flag = int(TransferFlags.imported if is_transfer else AccountFlags.imported)
        linked_flag = int(TransferFlags.linked)  # same bit in both flag sets

        results: list = []
        chain: Optional[int] = None
        chain_broken = False
        batch_imported = len(events) > 0 and bool(events[0].flags & imported_flag)

        for index, event in enumerate(events):
            timestamp_event = timestamp - len(events) + index + 1
            assert timestamp_valid(timestamp_event)
            linked = bool(event.flags & linked_flag)
            imported = bool(event.flags & imported_flag)

            status = None
            timestamp_actual = timestamp_event
            if linked:
                if chain is None:
                    chain = index
                    assert not chain_broken
                    self._scope_open()
                if index == len(events) - 1:
                    status = status_enum.linked_event_chain_open

            if status is None and chain_broken:
                status = status_enum.linked_event_failed

            if status is None and batch_imported != imported:
                status = (
                    status_enum.imported_event_not_expected
                    if imported
                    else status_enum.imported_event_expected
                )

            if status is None:
                if imported:
                    if not timestamp_valid(event.timestamp):
                        status = status_enum.imported_event_timestamp_out_of_range
                    elif event.timestamp >= timestamp:
                        status = status_enum.imported_event_timestamp_must_not_advance
                elif event.timestamp != 0:
                    status = status_enum.timestamp_must_be_zero

            if status is None:
                if is_transfer:
                    status, timestamp_actual = self._create_transfer(timestamp_event, event)
                else:
                    status, timestamp_actual = self._create_account(timestamp_event, event)

            if status != status_enum.created:
                if chain is not None:
                    if not chain_broken:
                        chain_broken = True
                        self._scope_close(persist=False)
                        # Rolled-back chain members keep their original result
                        # timestamps; only the status is rewritten (FIFO order,
                        # reference: :3123-3145).
                        for chain_index in range(chain, index):
                            results[chain_index].status = status_enum.linked_event_failed
                    else:
                        assert status in (
                            status_enum.linked_event_failed,
                            status_enum.linked_event_chain_open,
                        )
                if is_transfer and status.transient():
                    # reference: :3215-3252 — poison the id.
                    self.orphaned.add(event.id)

            results.append(result_type(timestamp=timestamp_actual, status=status))

            if chain is not None and (
                not linked or status == status_enum.linked_event_chain_open
            ):
                if not chain_broken:
                    self._scope_close(persist=True)
                chain = None
                chain_broken = False

        assert chain is None
        assert not chain_broken
        return results

    # ----------------------------------------------------------- create_account

    def _create_account(self, timestamp_event: int, a: Account):
        """reference: src/state_machine.zig:3613-3689. Returns (status, timestamp)."""
        S = CreateAccountStatus
        assert timestamp_event != 0

        if a.reserved != 0:
            return S.reserved_field, timestamp_event
        if a.flags & AccountFlags.padding_mask():
            return S.reserved_flag, timestamp_event

        if a.id == 0:
            return S.id_must_not_be_zero, timestamp_event
        if a.id == U128_MAX:
            return S.id_must_not_be_int_max, timestamp_event

        e = self.accounts.get(a.id)
        if e is not None:
            status = self._create_account_exists(a, e)
            return status, (e.timestamp if status == S.exists else timestamp_event)

        if (a.flags & AccountFlags.debits_must_not_exceed_credits) and (
            a.flags & AccountFlags.credits_must_not_exceed_debits
        ):
            return S.flags_are_mutually_exclusive, timestamp_event

        if a.debits_pending != 0:
            return S.debits_pending_must_be_zero, timestamp_event
        if a.debits_posted != 0:
            return S.debits_posted_must_be_zero, timestamp_event
        if a.credits_pending != 0:
            return S.credits_pending_must_be_zero, timestamp_event
        if a.credits_posted != 0:
            return S.credits_posted_must_be_zero, timestamp_event
        if a.ledger == 0:
            return S.ledger_must_not_be_zero, timestamp_event
        if a.code == 0:
            return S.code_must_not_be_zero, timestamp_event

        if a.flags & AccountFlags.imported:
            # Past timestamps allowed, but must not regress vs either groove
            # (reference: :3648-3667).
            if self.accounts_key_max is not None and a.timestamp <= self.accounts_key_max:
                return S.imported_event_timestamp_must_not_regress, timestamp_event
            if a.timestamp in self.transfer_by_timestamp:
                return S.imported_event_timestamp_must_not_regress, timestamp_event
            timestamp_actual = a.timestamp
        else:
            assert a.timestamp == 0
            timestamp_actual = timestamp_event

        self._insert_account(
            Account(
                id=a.id,
                debits_pending=0,
                debits_posted=0,
                credits_pending=0,
                credits_posted=0,
                user_data_128=a.user_data_128,
                user_data_64=a.user_data_64,
                user_data_32=a.user_data_32,
                reserved=0,
                ledger=a.ledger,
                code=a.code,
                flags=a.flags,
                timestamp=timestamp_actual,
            )
        )
        self.commit_timestamp = timestamp_actual
        return S.created, timestamp_actual

    @staticmethod
    def _create_account_exists(a: Account, e: Account) -> CreateAccountStatus:
        """reference: src/state_machine.zig:3691-3703."""
        S = CreateAccountStatus
        assert a.id == e.id
        if (a.flags & 0xFFFF) != (e.flags & 0xFFFF):
            return S.exists_with_different_flags
        if a.user_data_128 != e.user_data_128:
            return S.exists_with_different_user_data_128
        if a.user_data_64 != e.user_data_64:
            return S.exists_with_different_user_data_64
        if a.user_data_32 != e.user_data_32:
            return S.exists_with_different_user_data_32
        if a.ledger != e.ledger:
            return S.exists_with_different_ledger
        if a.code != e.code:
            return S.exists_with_different_code
        return S.exists

    # ---------------------------------------------------------- create_transfer

    def _create_transfer(self, timestamp_event: int, t: Transfer):
        """reference: src/state_machine.zig:3719-3986. Returns (status, timestamp)."""
        S = CreateTransferStatus
        F = TransferFlags
        assert timestamp_event != 0

        if t.flags & F.padding_mask():
            return S.reserved_flag, timestamp_event

        if t.id == 0:
            return S.id_must_not_be_zero, timestamp_event
        if t.id == U128_MAX:
            return S.id_must_not_be_int_max, timestamp_event

        e = self.transfers.get(t.id)
        if e is not None:
            status = self._create_transfer_exists(t, e)
            return status, (e.timestamp if status == S.exists else timestamp_event)
        if t.id in self.orphaned:
            return S.id_already_failed, timestamp_event

        if t.flags & (F.post_pending_transfer | F.void_pending_transfer):
            return self._post_or_void_pending_transfer(timestamp_event, t)

        if t.debit_account_id == 0:
            return S.debit_account_id_must_not_be_zero, timestamp_event
        if t.debit_account_id == U128_MAX:
            return S.debit_account_id_must_not_be_int_max, timestamp_event
        if t.credit_account_id == 0:
            return S.credit_account_id_must_not_be_zero, timestamp_event
        if t.credit_account_id == U128_MAX:
            return S.credit_account_id_must_not_be_int_max, timestamp_event
        if t.credit_account_id == t.debit_account_id:
            return S.accounts_must_be_different, timestamp_event

        if t.pending_id != 0:
            return S.pending_id_must_be_zero, timestamp_event
        if not (t.flags & F.pending):
            if t.timeout != 0:
                return S.timeout_reserved_for_pending_transfer, timestamp_event
            if t.flags & (F.closing_debit | F.closing_credit):
                return S.closing_transfer_must_be_pending, timestamp_event

        if t.ledger == 0:
            return S.ledger_must_not_be_zero, timestamp_event
        if t.code == 0:
            return S.code_must_not_be_zero, timestamp_event

        dr_account = self.accounts.get(t.debit_account_id)
        if dr_account is None:
            return S.debit_account_not_found, timestamp_event
        cr_account = self.accounts.get(t.credit_account_id)
        if cr_account is None:
            return S.credit_account_not_found, timestamp_event

        if dr_account.ledger != cr_account.ledger:
            return S.accounts_must_have_the_same_ledger, timestamp_event
        if t.ledger != dr_account.ledger:
            return S.transfer_must_have_the_same_ledger_as_accounts, timestamp_event

        if t.flags & F.imported:
            # reference: :3800-3833
            if self.transfers_key_max is not None and t.timestamp <= self.transfers_key_max:
                return S.imported_event_timestamp_must_not_regress, timestamp_event
            if t.timestamp in self.account_by_timestamp:
                return S.imported_event_timestamp_must_not_regress, timestamp_event
            if t.timestamp <= dr_account.timestamp:
                return S.imported_event_timestamp_must_postdate_debit_account, timestamp_event
            if t.timestamp <= cr_account.timestamp:
                return S.imported_event_timestamp_must_postdate_credit_account, timestamp_event
            if t.timeout != 0:
                assert t.flags & F.pending
                return S.imported_event_timeout_must_be_zero, timestamp_event
            timestamp_actual = t.timestamp
        else:
            assert t.timestamp == 0
            timestamp_actual = timestamp_event

        if dr_account.flags & AccountFlags.closed:
            return S.debit_account_already_closed, timestamp_event
        if cr_account.flags & AccountFlags.closed:
            return S.credit_account_already_closed, timestamp_event

        # Balancing clamp with saturating subtraction (reference: :3840-3853).
        amount = t.amount
        if t.flags & F.balancing_debit:
            dr_balance = dr_account.debits_posted + dr_account.debits_pending
            amount = min(amount, max(0, dr_account.credits_posted - dr_balance))
        if t.flags & F.balancing_credit:
            cr_balance = cr_account.credits_posted + cr_account.credits_pending
            amount = min(amount, max(0, cr_account.debits_posted - cr_balance))

        # u128 overflow checks (reference: :3856-3884).
        if t.flags & F.pending:
            if amount + dr_account.debits_pending > U128_MAX:
                return S.overflows_debits_pending, timestamp_event
            if amount + cr_account.credits_pending > U128_MAX:
                return S.overflows_credits_pending, timestamp_event
        if amount + dr_account.debits_posted > U128_MAX:
            return S.overflows_debits_posted, timestamp_event
        if amount + cr_account.credits_posted > U128_MAX:
            return S.overflows_credits_posted, timestamp_event
        if amount + dr_account.debits_pending + dr_account.debits_posted > U128_MAX:
            return S.overflows_debits, timestamp_event
        if amount + cr_account.credits_pending + cr_account.credits_posted > U128_MAX:
            return S.overflows_credits, timestamp_event

        # u63 timeout overflow (reference: :3886-3901).
        if timestamp_actual + t.timeout_ns() > U63_MAX:
            return S.overflows_timeout, timestamp_event

        if dr_account.debits_exceed_credits(amount):
            return S.exceeds_credits, timestamp_event
        if cr_account.credits_exceed_debits(amount):
            return S.exceeds_debits, timestamp_event

        # -- Application (reference: :3906-3985) --
        self._insert_transfer(
            Transfer(
                id=t.id,
                debit_account_id=t.debit_account_id,
                credit_account_id=t.credit_account_id,
                amount=amount,
                pending_id=t.pending_id,
                user_data_128=t.user_data_128,
                user_data_64=t.user_data_64,
                user_data_32=t.user_data_32,
                timeout=t.timeout,
                ledger=t.ledger,
                code=t.code,
                flags=t.flags,
                timestamp=timestamp_actual,
            )
        )

        dr_new = dataclasses.replace(dr_account)
        cr_new = dataclasses.replace(cr_account)
        if t.flags & F.pending:
            dr_new.debits_pending += amount
            cr_new.credits_pending += amount
            self._set_pending_status(timestamp_actual, TransferPendingStatus.pending)
        else:
            dr_new.debits_posted += amount
            cr_new.credits_posted += amount

        if t.flags & F.closing_debit:
            dr_new.flags |= AccountFlags.closed
        if t.flags & F.closing_credit:
            cr_new.flags |= AccountFlags.closed

        if amount > 0 or (dr_new.flags & AccountFlags.closed):
            self._put_account(dr_new)
        if amount > 0 or (cr_new.flags & AccountFlags.closed):
            self._put_account(cr_new)

        self.account_events.append(
            AccountEventRecord(
                timestamp=timestamp_actual,
                dr_account=dr_new,
                cr_account=cr_new,
                transfer_flags=t.flags,
                transfer_pending_status=(
                    TransferPendingStatus.pending
                    if t.flags & F.pending
                    else TransferPendingStatus.none
                ),
                transfer_pending=None,
                amount_requested=t.amount,
                amount=amount,
            )
        )

        if t.timeout > 0:
            assert t.flags & F.pending
            assert not (t.flags & F.imported)
            expires_at = timestamp_actual + t.timeout_ns()
            self._set_expiry(timestamp_actual, expires_at)
            if expires_at < self.pulse_next_timestamp:
                self.pulse_next_timestamp = expires_at

        self.commit_timestamp = timestamp_actual
        return S.created, timestamp_actual

    def _create_transfer_exists(self, t: Transfer, e: Transfer) -> CreateTransferStatus:
        """reference: src/state_machine.zig:3988-4051."""
        S = CreateTransferStatus
        F = TransferFlags
        assert t.id == e.id
        if (t.flags & 0xFFFF) != (e.flags & 0xFFFF):
            return S.exists_with_different_flags
        if t.pending_id != e.pending_id:
            return S.exists_with_different_pending_id
        if t.timeout != e.timeout:
            return S.exists_with_different_timeout

        if t.flags & (F.post_pending_transfer | F.void_pending_transfer):
            p = self.transfers[t.pending_id]
            return self._post_or_void_pending_transfer_exists(t, e, p)

        if t.debit_account_id != e.debit_account_id:
            return S.exists_with_different_debit_account_id
        if t.credit_account_id != e.credit_account_id:
            return S.exists_with_different_credit_account_id
        # Balancing transfers compare amount as an upper bound (reference: :4016-4031).
        if t.flags & (F.balancing_debit | F.balancing_credit):
            if t.amount < e.amount:
                return S.exists_with_different_amount
        else:
            if t.amount != e.amount:
                return S.exists_with_different_amount
        if t.user_data_128 != e.user_data_128:
            return S.exists_with_different_user_data_128
        if t.user_data_64 != e.user_data_64:
            return S.exists_with_different_user_data_64
        if t.user_data_32 != e.user_data_32:
            return S.exists_with_different_user_data_32
        if t.ledger != e.ledger:
            return S.exists_with_different_ledger
        if t.code != e.code:
            return S.exists_with_different_code
        return S.exists

    def _post_or_void_pending_transfer(self, timestamp_event: int, t: Transfer):
        """reference: src/state_machine.zig:4053-4299. Returns (status, timestamp)."""
        S = CreateTransferStatus
        F = TransferFlags
        post = bool(t.flags & F.post_pending_transfer)
        void = bool(t.flags & F.void_pending_transfer)
        assert post or void

        if post and void:
            return S.flags_are_mutually_exclusive, timestamp_event
        if t.flags & (F.pending | F.balancing_debit | F.balancing_credit | F.closing_debit | F.closing_credit):
            return S.flags_are_mutually_exclusive, timestamp_event

        if t.pending_id == 0:
            return S.pending_id_must_not_be_zero, timestamp_event
        if t.pending_id == U128_MAX:
            return S.pending_id_must_not_be_int_max, timestamp_event
        if t.pending_id == t.id:
            return S.pending_id_must_be_different, timestamp_event
        if t.timeout != 0:
            return S.timeout_reserved_for_pending_transfer, timestamp_event

        p = self.transfers.get(t.pending_id)
        if p is None:
            return S.pending_transfer_not_found, timestamp_event
        if not (p.flags & F.pending):
            return S.pending_transfer_not_pending, timestamp_event

        dr_account = self.accounts[p.debit_account_id]
        cr_account = self.accounts[p.credit_account_id]

        if t.debit_account_id > 0 and t.debit_account_id != p.debit_account_id:
            return S.pending_transfer_has_different_debit_account_id, timestamp_event
        if t.credit_account_id > 0 and t.credit_account_id != p.credit_account_id:
            return S.pending_transfer_has_different_credit_account_id, timestamp_event
        if t.ledger > 0 and t.ledger != p.ledger:
            return S.pending_transfer_has_different_ledger, timestamp_event
        if t.code > 0 and t.code != p.code:
            return S.pending_transfer_has_different_code, timestamp_event

        # reference: :4113-4121 — void: 0 means "full amount"; post: maxInt
        # means "full amount".
        if void:
            amount = p.amount if t.amount == 0 else t.amount
        else:
            amount = p.amount if t.amount == U128_MAX else t.amount

        if amount > p.amount:
            return S.exceeds_pending_transfer_amount, timestamp_event
        if void and amount < p.amount:
            return S.pending_transfer_has_different_amount, timestamp_event

        pending_status = self.pending_status[p.timestamp]
        if pending_status == TransferPendingStatus.posted:
            return S.pending_transfer_already_posted, timestamp_event
        if pending_status == TransferPendingStatus.voided:
            return S.pending_transfer_already_voided, timestamp_event
        if pending_status == TransferPendingStatus.expired:
            return S.pending_transfer_expired, timestamp_event
        assert pending_status == TransferPendingStatus.pending

        expires_at: Optional[int] = None
        if p.timeout != 0:
            expires_at = p.timestamp + p.timeout_ns()
            if expires_at <= timestamp_event:
                return S.pending_transfer_expired, timestamp_event

        if t.flags & F.imported:
            # reference: :4158-4180
            if self.transfers_key_max is not None and t.timestamp <= self.transfers_key_max:
                return S.imported_event_timestamp_must_not_regress, timestamp_event
            if t.timestamp in self.account_by_timestamp:
                return S.imported_event_timestamp_must_not_regress, timestamp_event
            timestamp_actual = t.timestamp
        else:
            assert t.timestamp == 0
            timestamp_actual = timestamp_event

        # Only voiding may touch a closed account (reference: :4184-4190).
        if (dr_account.flags & AccountFlags.closed) and not void:
            return S.debit_account_already_closed, timestamp_event
        if (cr_account.flags & AccountFlags.closed) and not void:
            return S.credit_account_already_closed, timestamp_event

        # -- Application (reference: :4192-4298) --
        self._insert_transfer(
            Transfer(
                id=t.id,
                debit_account_id=p.debit_account_id,
                credit_account_id=p.credit_account_id,
                amount=amount,
                pending_id=t.pending_id,
                user_data_128=t.user_data_128 if t.user_data_128 > 0 else p.user_data_128,
                user_data_64=t.user_data_64 if t.user_data_64 > 0 else p.user_data_64,
                user_data_32=t.user_data_32 if t.user_data_32 > 0 else p.user_data_32,
                timeout=0,
                ledger=p.ledger,
                code=p.code,
                flags=t.flags,
                timestamp=timestamp_actual,
            )
        )

        if expires_at is not None:
            self._set_expiry(p.timestamp, None)
            if self.pulse_next_timestamp == expires_at:
                self.pulse_next_timestamp = TIMESTAMP_MIN

        new_status = TransferPendingStatus.posted if post else TransferPendingStatus.voided
        self._set_pending_status(p.timestamp, new_status)

        dr_new = dataclasses.replace(dr_account)
        cr_new = dataclasses.replace(cr_account)
        dr_new.debits_pending -= p.amount
        cr_new.credits_pending -= p.amount
        if post:
            dr_new.debits_posted += amount
            cr_new.credits_posted += amount
        if void:
            # Voiding a closing transfer reopens the account (reference: :4252-4263).
            if p.flags & F.closing_debit:
                assert dr_new.flags & AccountFlags.closed
                dr_new.flags &= ~AccountFlags.closed
            if p.flags & F.closing_credit:
                assert cr_new.flags & AccountFlags.closed
                cr_new.flags &= ~AccountFlags.closed

        dr_updated = amount > 0 or p.amount > 0 or (
            (dr_new.flags & AccountFlags.closed) != (dr_account.flags & AccountFlags.closed)
        )
        if dr_updated:
            self._put_account(dr_new)
        cr_updated = amount > 0 or p.amount > 0 or (
            (cr_new.flags & AccountFlags.closed) != (cr_account.flags & AccountFlags.closed)
        )
        if cr_updated:
            self._put_account(cr_new)

        self.account_events.append(
            AccountEventRecord(
                timestamp=timestamp_actual,
                dr_account=dr_new,
                cr_account=cr_new,
                transfer_flags=t.flags,
                transfer_pending_status=new_status,
                transfer_pending=p,
                amount_requested=t.amount,
                amount=amount,
            )
        )

        self.commit_timestamp = timestamp_actual
        return S.created, timestamp_actual

    @staticmethod
    def _post_or_void_pending_transfer_exists(
        t: Transfer, e: Transfer, p: Transfer
    ) -> CreateTransferStatus:
        """reference: src/state_machine.zig:4301-4382."""
        S = CreateTransferStatus
        F = TransferFlags
        assert t.id == e.id

        if t.debit_account_id != 0 and t.debit_account_id != e.debit_account_id:
            return S.exists_with_different_debit_account_id
        if t.credit_account_id != 0 and t.credit_account_id != e.credit_account_id:
            return S.exists_with_different_credit_account_id

        if t.flags & F.void_pending_transfer:
            if t.amount == 0:
                if e.amount != p.amount:
                    return S.exists_with_different_amount
            elif t.amount != e.amount:
                return S.exists_with_different_amount
        if t.flags & F.post_pending_transfer:
            if t.amount == U128_MAX:
                if e.amount != p.amount:
                    return S.exists_with_different_amount
            elif t.amount != e.amount:
                return S.exists_with_different_amount

        if t.user_data_128 == 0:
            if e.user_data_128 != p.user_data_128:
                return S.exists_with_different_user_data_128
        elif t.user_data_128 != e.user_data_128:
            return S.exists_with_different_user_data_128

        if t.user_data_64 == 0:
            if e.user_data_64 != p.user_data_64:
                return S.exists_with_different_user_data_64
        elif t.user_data_64 != e.user_data_64:
            return S.exists_with_different_user_data_64

        if t.user_data_32 == 0:
            if e.user_data_32 != p.user_data_32:
                return S.exists_with_different_user_data_32
        elif t.user_data_32 != e.user_data_32:
            return S.exists_with_different_user_data_32

        if t.ledger != 0 and t.ledger != e.ledger:
            return S.exists_with_different_ledger
        if t.code != 0 and t.code != e.code:
            return S.exists_with_different_code
        return S.exists

    # ------------------------------------------------------------ pulse / expiry

    def pulse_needed(self, timestamp: int) -> bool:
        """reference: src/state_machine.zig:1138-1144."""
        return self.pulse_next_timestamp <= timestamp

    def expire_pending_transfers(self, timestamp: int) -> int:
        """Expire pending transfers whose timeout elapsed, oldest-expiry first,
        one batch at most. Returns the number expired.
        reference: src/state_machine.zig:4511-4628, 4875-5010."""
        due = sorted(
            (expires_at, p_timestamp)
            for p_timestamp, expires_at in self.expiry.items()
            if expires_at <= timestamp
        )
        batch = due[:BATCH_MAX]
        count = len(batch)

        for index, (expires_at, p_timestamp) in enumerate(batch):
            p = self.transfers[self.transfer_by_timestamp[p_timestamp]]
            assert p.flags & TransferFlags.pending
            assert p.timeout > 0
            timestamp_event = timestamp - count + index + 1
            assert self.commit_timestamp < timestamp_event

            dr_account = self.accounts[p.debit_account_id]
            cr_account = self.accounts[p.credit_account_id]
            dr_new = dataclasses.replace(dr_account)
            cr_new = dataclasses.replace(cr_account)
            dr_new.debits_pending -= p.amount
            cr_new.credits_pending -= p.amount
            if p.flags & TransferFlags.closing_debit:
                assert dr_new.flags & AccountFlags.closed
                dr_new.flags &= ~AccountFlags.closed
            if p.flags & TransferFlags.closing_credit:
                assert cr_new.flags & AccountFlags.closed
                cr_new.flags &= ~AccountFlags.closed

            if p.amount > 0 or (dr_new.flags != dr_account.flags):
                self._put_account(dr_new)
            if p.amount > 0 or (cr_new.flags != cr_account.flags):
                self._put_account(cr_new)

            assert self.pending_status[p.timestamp] == TransferPendingStatus.pending
            self._set_pending_status(p.timestamp, TransferPendingStatus.expired)
            self._set_expiry(p.timestamp, None)

            self.account_events.append(
                AccountEventRecord(
                    timestamp=timestamp_event,
                    dr_account=dr_new,
                    cr_account=cr_new,
                    transfer_flags=None,
                    transfer_pending_status=TransferPendingStatus.expired,
                    transfer_pending=p,
                    amount_requested=0,
                    amount=p.amount,
                )
            )
            self.commit_timestamp = timestamp_event

        remaining = [e for e in self.expiry.values()]
        self.pulse_next_timestamp = min(remaining) if remaining else TIMESTAMP_MAX
        return count

    # ----------------------------------------------------------------- lookups

    def lookup_accounts(self, ids: list[int]) -> list[Account]:
        """reference: src/state_machine.zig:3254-3282 — missing ids are omitted."""
        return [self.accounts[i] for i in ids if i in self.accounts]

    def lookup_transfers(self, ids: list[int]) -> list[Transfer]:
        return [self.transfers[i] for i in ids if i in self.transfers]
