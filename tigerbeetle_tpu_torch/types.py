"""Data model and wire types: flags, status codes, the objects of the
create paths and the oracle, the query filters, change events and
operations, each with its little-endian wire codec (a copy of the JAX
package's `types.py`; reference: src/tigerbeetle.zig).

Status enums carry the reference's wire codes as values; declaration
order is the reference's precedence order."""

from __future__ import annotations

import dataclasses
import enum
import struct

from .constants import NS_PER_S


class AccountFlags(enum.IntFlag):
    """reference: src/tigerbeetle.zig:45-68."""

    linked = 1 << 0
    debits_must_not_exceed_credits = 1 << 1
    credits_must_not_exceed_debits = 1 << 2
    history = 1 << 3
    imported = 1 << 4
    closed = 1 << 5

    @staticmethod
    def padding_mask() -> int:
        return ~0x3F & 0xFFFF


class TransferFlags(enum.IntFlag):
    """reference: src/tigerbeetle.zig:132-148."""

    linked = 1 << 0
    pending = 1 << 1
    post_pending_transfer = 1 << 2
    void_pending_transfer = 1 << 3
    balancing_debit = 1 << 4
    balancing_credit = 1 << 5
    closing_debit = 1 << 6
    closing_credit = 1 << 7
    imported = 1 << 8

    @staticmethod
    def padding_mask() -> int:
        return ~0x1FF & 0xFFFF


class TransferPendingStatus(enum.IntEnum):
    """reference: src/tigerbeetle.zig:118-130."""

    none = 0
    pending = 1
    posted = 2
    voided = 3
    expired = 4


def _u128_to_bytes(x: int) -> bytes:
    return x.to_bytes(16, "little")


def _u128_from_bytes(b: bytes) -> int:
    return int.from_bytes(b, "little")


_ACCOUNT_FMT = struct.Struct("<16s16s16s16s16s16sQIIIHHQ")
assert _ACCOUNT_FMT.size == 128


@dataclasses.dataclass
class Account:
    """reference: src/tigerbeetle.zig:10-43."""

    id: int = 0
    debits_pending: int = 0
    debits_posted: int = 0
    credits_pending: int = 0
    credits_posted: int = 0
    user_data_128: int = 0
    user_data_64: int = 0
    user_data_32: int = 0
    reserved: int = 0
    ledger: int = 0
    code: int = 0
    flags: int = 0
    timestamp: int = 0

    def pack(self) -> bytes:
        return _ACCOUNT_FMT.pack(
            _u128_to_bytes(self.id),
            _u128_to_bytes(self.debits_pending),
            _u128_to_bytes(self.debits_posted),
            _u128_to_bytes(self.credits_pending),
            _u128_to_bytes(self.credits_posted),
            _u128_to_bytes(self.user_data_128),
            self.user_data_64,
            self.user_data_32,
            self.reserved,
            self.ledger,
            self.code,
            self.flags,
            self.timestamp,
        )

    @classmethod
    def unpack(cls, data: bytes) -> "Account":
        f = _ACCOUNT_FMT.unpack(data)
        return cls(
            id=_u128_from_bytes(f[0]),
            debits_pending=_u128_from_bytes(f[1]),
            debits_posted=_u128_from_bytes(f[2]),
            credits_pending=_u128_from_bytes(f[3]),
            credits_posted=_u128_from_bytes(f[4]),
            user_data_128=_u128_from_bytes(f[5]),
            user_data_64=f[6],
            user_data_32=f[7],
            reserved=f[8],
            ledger=f[9],
            code=f[10],
            flags=f[11],
            timestamp=f[12],
        )

    def debits_exceed_credits(self, amount: int) -> bool:
        """reference: src/tigerbeetle.zig:34-38"""
        return bool(
            self.flags & AccountFlags.debits_must_not_exceed_credits
            and self.debits_pending + self.debits_posted + amount
            > self.credits_posted
        )

    def credits_exceed_debits(self, amount: int) -> bool:
        """reference: src/tigerbeetle.zig:39-42"""
        return bool(
            self.flags & AccountFlags.credits_must_not_exceed_debits
            and self.credits_pending + self.credits_posted + amount
            > self.debits_posted
        )


_TRANSFER_FMT = struct.Struct("<16s16s16s16s16s16sQIIIHHQ")
assert _TRANSFER_FMT.size == 128


@dataclasses.dataclass
class Transfer:
    """reference: src/tigerbeetle.zig:85-116."""

    id: int = 0
    debit_account_id: int = 0
    credit_account_id: int = 0
    amount: int = 0
    pending_id: int = 0
    user_data_128: int = 0
    user_data_64: int = 0
    user_data_32: int = 0
    timeout: int = 0
    ledger: int = 0
    code: int = 0
    flags: int = 0
    timestamp: int = 0

    def timeout_ns(self) -> int:
        """reference: src/tigerbeetle.zig:106-109"""
        return self.timeout * NS_PER_S

    def pack(self) -> bytes:
        return _TRANSFER_FMT.pack(
            _u128_to_bytes(self.id),
            _u128_to_bytes(self.debit_account_id),
            _u128_to_bytes(self.credit_account_id),
            _u128_to_bytes(self.amount),
            _u128_to_bytes(self.pending_id),
            _u128_to_bytes(self.user_data_128),
            self.user_data_64,
            self.user_data_32,
            self.timeout,
            self.ledger,
            self.code,
            self.flags,
            self.timestamp,
        )

    @classmethod
    def unpack(cls, data: bytes) -> "Transfer":
        f = _TRANSFER_FMT.unpack(data)
        return cls(
            id=_u128_from_bytes(f[0]),
            debit_account_id=_u128_from_bytes(f[1]),
            credit_account_id=_u128_from_bytes(f[2]),
            amount=_u128_from_bytes(f[3]),
            pending_id=_u128_from_bytes(f[4]),
            user_data_128=_u128_from_bytes(f[5]),
            user_data_64=f[6],
            user_data_32=f[7],
            timeout=f[8],
            ledger=f[9],
            code=f[10],
            flags=f[11],
            timestamp=f[12],
        )


_ACCOUNT_BALANCE_FMT = struct.Struct("<16s16s16s16sQ56s")
assert _ACCOUNT_BALANCE_FMT.size == 128


@dataclasses.dataclass
class AccountBalance:
    """reference: src/tigerbeetle.zig:70-83 — 128 bytes."""

    debits_pending: int = 0
    debits_posted: int = 0
    credits_pending: int = 0
    credits_posted: int = 0
    timestamp: int = 0

    def pack(self) -> bytes:
        return _ACCOUNT_BALANCE_FMT.pack(
            _u128_to_bytes(self.debits_pending),
            _u128_to_bytes(self.debits_posted),
            _u128_to_bytes(self.credits_pending),
            _u128_to_bytes(self.credits_posted),
            self.timestamp,
            b"\x00" * 56,
        )

    @classmethod
    def unpack(cls, data: bytes) -> "AccountBalance":
        f = _ACCOUNT_BALANCE_FMT.unpack(data)
        return cls(
            debits_pending=_u128_from_bytes(f[0]),
            debits_posted=_u128_from_bytes(f[1]),
            credits_pending=_u128_from_bytes(f[2]),
            credits_posted=_u128_from_bytes(f[3]),
            timestamp=f[4],
        )


class CreateAccountStatus(enum.IntEnum):
    """Wire codes (reference: src/tigerbeetle.zig:153-215)."""

    ok = 0
    created = (1 << 32) - 1

    linked_event_failed = 1
    linked_event_chain_open = 2

    imported_event_expected = 22
    imported_event_not_expected = 23

    timestamp_must_be_zero = 3

    imported_event_timestamp_out_of_range = 24
    imported_event_timestamp_must_not_advance = 25

    reserved_field = 4
    reserved_flag = 5

    id_must_not_be_zero = 6
    id_must_not_be_int_max = 7

    exists_with_different_flags = 15
    exists_with_different_user_data_128 = 16
    exists_with_different_user_data_64 = 17
    exists_with_different_user_data_32 = 18
    exists_with_different_ledger = 19
    exists_with_different_code = 20
    exists = 21

    flags_are_mutually_exclusive = 8

    debits_pending_must_be_zero = 9
    debits_posted_must_be_zero = 10
    credits_pending_must_be_zero = 11
    credits_posted_must_be_zero = 12
    ledger_must_not_be_zero = 13
    code_must_not_be_zero = 14

    imported_event_timestamp_must_not_regress = 26


class CreateTransferStatus(enum.IntEnum):
    """Wire codes (reference: src/tigerbeetle.zig:220-319)."""

    ok = 0
    created = (1 << 32) - 1

    linked_event_failed = 1
    linked_event_chain_open = 2

    imported_event_expected = 56
    imported_event_not_expected = 57

    timestamp_must_be_zero = 3

    imported_event_timestamp_out_of_range = 58
    imported_event_timestamp_must_not_advance = 59

    reserved_flag = 4

    id_must_not_be_zero = 5
    id_must_not_be_int_max = 6

    exists_with_different_flags = 36
    exists_with_different_pending_id = 40
    exists_with_different_timeout = 44
    exists_with_different_debit_account_id = 37
    exists_with_different_credit_account_id = 38
    exists_with_different_amount = 39
    exists_with_different_user_data_128 = 41
    exists_with_different_user_data_64 = 42
    exists_with_different_user_data_32 = 43
    exists_with_different_ledger = 67
    exists_with_different_code = 45
    exists = 46

    id_already_failed = 68

    flags_are_mutually_exclusive = 7

    debit_account_id_must_not_be_zero = 8
    debit_account_id_must_not_be_int_max = 9
    credit_account_id_must_not_be_zero = 10
    credit_account_id_must_not_be_int_max = 11
    accounts_must_be_different = 12

    pending_id_must_be_zero = 13
    pending_id_must_not_be_zero = 14
    pending_id_must_not_be_int_max = 15
    pending_id_must_be_different = 16
    timeout_reserved_for_pending_transfer = 17

    closing_transfer_must_be_pending = 64

    ledger_must_not_be_zero = 19
    code_must_not_be_zero = 20

    debit_account_not_found = 21
    credit_account_not_found = 22

    accounts_must_have_the_same_ledger = 23
    transfer_must_have_the_same_ledger_as_accounts = 24

    pending_transfer_not_found = 25
    pending_transfer_not_pending = 26

    pending_transfer_has_different_debit_account_id = 27
    pending_transfer_has_different_credit_account_id = 28
    pending_transfer_has_different_ledger = 29
    pending_transfer_has_different_code = 30

    exceeds_pending_transfer_amount = 31
    pending_transfer_has_different_amount = 32

    pending_transfer_already_posted = 33
    pending_transfer_already_voided = 34

    pending_transfer_expired = 35

    imported_event_timestamp_must_not_regress = 60
    imported_event_timestamp_must_postdate_debit_account = 61
    imported_event_timestamp_must_postdate_credit_account = 62
    imported_event_timeout_must_be_zero = 63

    debit_account_already_closed = 65
    credit_account_already_closed = 66

    overflows_debits_pending = 47
    overflows_credits_pending = 48
    overflows_debits_posted = 49
    overflows_credits_posted = 50
    overflows_debits = 51
    overflows_credits = 52
    overflows_timeout = 53

    exceeds_credits = 54
    exceeds_debits = 55

    deprecated_18 = 18

    def transient(self) -> bool:
        """Transient errors poison the transfer id: retrying it returns
        id_already_failed (reference: src/tigerbeetle.zig:320-399)."""
        return self in _TRANSIENT_TRANSFER_STATUSES


_TRANSIENT_TRANSFER_STATUSES = frozenset({
    CreateTransferStatus.debit_account_not_found,
    CreateTransferStatus.credit_account_not_found,
    CreateTransferStatus.pending_transfer_not_found,
    CreateTransferStatus.exceeds_credits,
    CreateTransferStatus.exceeds_debits,
    CreateTransferStatus.debit_account_already_closed,
    CreateTransferStatus.credit_account_already_closed,
})


_RESULT_FMT = struct.Struct("<QII")
assert _RESULT_FMT.size == 16


@dataclasses.dataclass
class CreateAccountResult:
    """reference: src/tigerbeetle.zig:471-481."""

    timestamp: int = 0
    status: CreateAccountStatus = CreateAccountStatus.ok

    def pack(self) -> bytes:
        return _RESULT_FMT.pack(self.timestamp, int(self.status), 0)

    @classmethod
    def unpack(cls, data: bytes) -> "CreateAccountResult":
        t, s, _ = _RESULT_FMT.unpack(data)
        return cls(timestamp=t, status=CreateAccountStatus(s))


@dataclasses.dataclass
class CreateTransferResult:
    """reference: src/tigerbeetle.zig:483-493."""

    timestamp: int = 0
    status: CreateTransferStatus = CreateTransferStatus.ok

    def pack(self) -> bytes:
        return _RESULT_FMT.pack(self.timestamp, int(self.status), 0)

    @classmethod
    def unpack(cls, data: bytes) -> "CreateTransferResult":
        t, s, _ = _RESULT_FMT.unpack(data)
        return cls(timestamp=t, status=CreateTransferStatus(s))


class AccountFilterFlags(enum.IntFlag):
    """reference: src/tigerbeetle.zig:599-612"""

    debits = 1 << 0
    credits = 1 << 1
    reversed = 1 << 2


_ACCOUNT_FILTER_FMT = struct.Struct("<16s16sQIH58sQQII")
assert _ACCOUNT_FILTER_FMT.size == 128


@dataclasses.dataclass
class AccountFilter:
    """reference: src/tigerbeetle.zig:564-597 — 128 bytes."""

    account_id: int = 0
    user_data_128: int = 0
    user_data_64: int = 0
    user_data_32: int = 0
    code: int = 0
    timestamp_min: int = 0
    timestamp_max: int = 0
    limit: int = 0
    flags: int = 0

    def pack(self) -> bytes:
        return _ACCOUNT_FILTER_FMT.pack(
            _u128_to_bytes(self.account_id),
            _u128_to_bytes(self.user_data_128),
            self.user_data_64,
            self.user_data_32,
            self.code,
            b"\x00" * 58,
            self.timestamp_min,
            self.timestamp_max,
            self.limit,
            self.flags,
        )

    @classmethod
    def unpack(cls, data: bytes) -> "AccountFilter":
        f = _ACCOUNT_FILTER_FMT.unpack(data)
        return cls(
            account_id=_u128_from_bytes(f[0]),
            user_data_128=_u128_from_bytes(f[1]),
            user_data_64=f[2],
            user_data_32=f[3],
            code=f[4],
            timestamp_min=f[6],
            timestamp_max=f[7],
            limit=f[8],
            flags=f[9],
        )


class QueryFilterFlags(enum.IntFlag):
    """reference: src/tigerbeetle.zig:552-561"""

    reversed = 1 << 0


_QUERY_FILTER_FMT = struct.Struct("<16sQIIH6sQQII")
assert _QUERY_FILTER_FMT.size == 64


@dataclasses.dataclass
class QueryFilter:
    """reference: src/tigerbeetle.zig:517-550 — 64 bytes."""

    user_data_128: int = 0
    user_data_64: int = 0
    user_data_32: int = 0
    ledger: int = 0
    code: int = 0
    timestamp_min: int = 0
    timestamp_max: int = 0
    limit: int = 0
    flags: int = 0

    def pack(self) -> bytes:
        return _QUERY_FILTER_FMT.pack(
            _u128_to_bytes(self.user_data_128),
            self.user_data_64,
            self.user_data_32,
            self.ledger,
            self.code,
            b"\x00" * 6,
            self.timestamp_min,
            self.timestamp_max,
            self.limit,
            self.flags,
        )

    @classmethod
    def unpack(cls, data: bytes) -> "QueryFilter":
        f = _QUERY_FILTER_FMT.unpack(data)
        return cls(
            user_data_128=_u128_from_bytes(f[0]),
            user_data_64=f[1],
            user_data_32=f[2],
            ledger=f[3],
            code=f[4],
            timestamp_min=f[6],
            timestamp_max=f[7],
            limit=f[8],
            flags=f[9],
        )


class ChangeEventType(enum.IntEnum):
    """reference: src/tigerbeetle.zig:614-620"""

    single_phase = 0
    two_phase_pending = 1
    two_phase_posted = 2
    two_phase_voided = 3
    two_phase_expired = 4


_CHANGE_EVENTS_FILTER_FMT = struct.Struct("<QQI44s")
assert _CHANGE_EVENTS_FILTER_FMT.size == 64


@dataclasses.dataclass
class ChangeEventsFilter:
    """reference: src/tigerbeetle.zig:672-682 — 64 bytes."""

    timestamp_min: int = 0
    timestamp_max: int = 0
    limit: int = 0

    def pack(self) -> bytes:
        return _CHANGE_EVENTS_FILTER_FMT.pack(
            self.timestamp_min, self.timestamp_max, self.limit, b"\x00" * 44
        )

    @classmethod
    def unpack(cls, data: bytes) -> "ChangeEventsFilter":
        f = _CHANGE_EVENTS_FILTER_FMT.unpack(data)
        return cls(timestamp_min=f[0], timestamp_max=f[1], limit=f[2])


_CHANGE_EVENT_FMT = struct.Struct(
    "<16s16s16s16sQIIHHIB39s"  # transfer block + ledger/type/reserved (128)
    "16s16s16s16s16s16sQIHH"   # debit account block (112)
    "16s16s16s16s16s16sQIHH"   # credit account block (112)
    "QQQQ"                     # timestamps (32)
)
assert _CHANGE_EVENT_FMT.size == 384


@dataclasses.dataclass
class ChangeEvent:
    """reference: src/tigerbeetle.zig:622-670 — 384 bytes
    (= one Transfer + two Accounts)."""

    transfer_id: int = 0
    transfer_amount: int = 0
    transfer_pending_id: int = 0
    transfer_user_data_128: int = 0
    transfer_user_data_64: int = 0
    transfer_user_data_32: int = 0
    transfer_timeout: int = 0
    transfer_code: int = 0
    transfer_flags: int = 0
    ledger: int = 0
    type: ChangeEventType = ChangeEventType.single_phase
    debit_account_id: int = 0
    debit_account_debits_pending: int = 0
    debit_account_debits_posted: int = 0
    debit_account_credits_pending: int = 0
    debit_account_credits_posted: int = 0
    debit_account_user_data_128: int = 0
    debit_account_user_data_64: int = 0
    debit_account_user_data_32: int = 0
    debit_account_code: int = 0
    debit_account_flags: int = 0
    credit_account_id: int = 0
    credit_account_debits_pending: int = 0
    credit_account_debits_posted: int = 0
    credit_account_credits_pending: int = 0
    credit_account_credits_posted: int = 0
    credit_account_user_data_128: int = 0
    credit_account_user_data_64: int = 0
    credit_account_user_data_32: int = 0
    credit_account_code: int = 0
    credit_account_flags: int = 0
    timestamp: int = 0
    transfer_timestamp: int = 0
    debit_account_timestamp: int = 0
    credit_account_timestamp: int = 0

    def pack(self) -> bytes:
        return _CHANGE_EVENT_FMT.pack(
            _u128_to_bytes(self.transfer_id),
            _u128_to_bytes(self.transfer_amount),
            _u128_to_bytes(self.transfer_pending_id),
            _u128_to_bytes(self.transfer_user_data_128),
            self.transfer_user_data_64,
            self.transfer_user_data_32,
            self.transfer_timeout,
            self.transfer_code,
            self.transfer_flags,
            self.ledger,
            int(self.type),
            b"\x00" * 39,
            _u128_to_bytes(self.debit_account_id),
            _u128_to_bytes(self.debit_account_debits_pending),
            _u128_to_bytes(self.debit_account_debits_posted),
            _u128_to_bytes(self.debit_account_credits_pending),
            _u128_to_bytes(self.debit_account_credits_posted),
            _u128_to_bytes(self.debit_account_user_data_128),
            self.debit_account_user_data_64,
            self.debit_account_user_data_32,
            self.debit_account_code,
            self.debit_account_flags,
            _u128_to_bytes(self.credit_account_id),
            _u128_to_bytes(self.credit_account_debits_pending),
            _u128_to_bytes(self.credit_account_debits_posted),
            _u128_to_bytes(self.credit_account_credits_pending),
            _u128_to_bytes(self.credit_account_credits_posted),
            _u128_to_bytes(self.credit_account_user_data_128),
            self.credit_account_user_data_64,
            self.credit_account_user_data_32,
            self.credit_account_code,
            self.credit_account_flags,
            self.timestamp,
            self.transfer_timestamp,
            self.debit_account_timestamp,
            self.credit_account_timestamp,
        )

    @classmethod
    def unpack(cls, data: bytes) -> "ChangeEvent":
        f = _CHANGE_EVENT_FMT.unpack(data)
        return cls(
            transfer_id=_u128_from_bytes(f[0]),
            transfer_amount=_u128_from_bytes(f[1]),
            transfer_pending_id=_u128_from_bytes(f[2]),
            transfer_user_data_128=_u128_from_bytes(f[3]),
            transfer_user_data_64=f[4],
            transfer_user_data_32=f[5],
            transfer_timeout=f[6],
            transfer_code=f[7],
            transfer_flags=f[8],
            ledger=f[9],
            type=ChangeEventType(f[10]),
            debit_account_id=_u128_from_bytes(f[12]),
            debit_account_debits_pending=_u128_from_bytes(f[13]),
            debit_account_debits_posted=_u128_from_bytes(f[14]),
            debit_account_credits_pending=_u128_from_bytes(f[15]),
            debit_account_credits_posted=_u128_from_bytes(f[16]),
            debit_account_user_data_128=_u128_from_bytes(f[17]),
            debit_account_user_data_64=f[18],
            debit_account_user_data_32=f[19],
            debit_account_code=f[20],
            debit_account_flags=f[21],
            credit_account_id=_u128_from_bytes(f[22]),
            credit_account_debits_pending=_u128_from_bytes(f[23]),
            credit_account_debits_posted=_u128_from_bytes(f[24]),
            credit_account_credits_pending=_u128_from_bytes(f[25]),
            credit_account_credits_posted=_u128_from_bytes(f[26]),
            credit_account_user_data_128=_u128_from_bytes(f[27]),
            credit_account_user_data_64=f[28],
            credit_account_user_data_32=f[29],
            credit_account_code=f[30],
            credit_account_flags=f[31],
            timestamp=f[32],
            transfer_timestamp=f[33],
            debit_account_timestamp=f[34],
            credit_account_timestamp=f[35],
        )


class Operation(enum.IntEnum):
    """Operations exported by the state machine
    (reference: src/tigerbeetle.zig:685-715; offsets from vsr_operations_reserved=128)."""

    pulse = 128 + 0

    deprecated_create_accounts_unbatched = 128 + 1
    deprecated_create_transfers_unbatched = 128 + 2
    deprecated_lookup_accounts_unbatched = 128 + 3
    deprecated_lookup_transfers_unbatched = 128 + 4
    deprecated_get_account_transfers_unbatched = 128 + 5
    deprecated_get_account_balances_unbatched = 128 + 6
    deprecated_query_accounts_unbatched = 128 + 7
    deprecated_query_transfers_unbatched = 128 + 8

    get_change_events = 128 + 9

    deprecated_create_accounts_sparse = 128 + 10
    deprecated_create_transfers_sparse = 128 + 11

    lookup_accounts = 128 + 12
    lookup_transfers = 128 + 13
    get_account_transfers = 128 + 14
    get_account_balances = 128 + 15
    query_accounts = 128 + 16
    query_transfers = 128 + 17

    create_accounts = 128 + 18
    create_transfers = 128 + 19

    def is_batchable(self) -> bool:
        """reference: src/tigerbeetle.zig:787-815"""
        return self in {
            Operation.create_accounts,
            Operation.create_transfers,
            Operation.lookup_accounts,
            Operation.lookup_transfers,
            Operation.deprecated_create_accounts_sparse,
            Operation.deprecated_create_transfers_sparse,
            Operation.deprecated_create_accounts_unbatched,
            Operation.deprecated_create_transfers_unbatched,
            Operation.deprecated_lookup_accounts_unbatched,
            Operation.deprecated_lookup_transfers_unbatched,
        }

    def is_multi_batch(self) -> bool:
        """reference: src/tigerbeetle.zig:817-849"""
        return self in {
            Operation.create_accounts,
            Operation.create_transfers,
            Operation.lookup_accounts,
            Operation.lookup_transfers,
            Operation.get_account_transfers,
            Operation.get_account_balances,
            Operation.query_accounts,
            Operation.query_transfers,
            Operation.deprecated_create_accounts_sparse,
            Operation.deprecated_create_transfers_sparse,
        }
