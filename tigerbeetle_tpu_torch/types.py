"""Data model: flags, status codes and the object types of the
create_transfers path (a copy of the JAX package's `types.py` subset;
reference: src/tigerbeetle.zig).

Status enums carry the reference's wire codes as values; declaration
order is the reference's precedence order."""

from __future__ import annotations

import dataclasses
import enum


class AccountFlags(enum.IntFlag):
    """reference: src/tigerbeetle.zig:45-68."""

    linked = 1 << 0
    debits_must_not_exceed_credits = 1 << 1
    credits_must_not_exceed_debits = 1 << 2
    history = 1 << 3
    imported = 1 << 4
    closed = 1 << 5


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


class TransferPendingStatus(enum.IntEnum):
    """reference: src/tigerbeetle.zig:118-130."""

    none = 0
    pending = 1
    posted = 2
    voided = 3
    expired = 4


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


@dataclasses.dataclass
class CreateAccountResult:
    """reference: src/tigerbeetle.zig:471-481."""

    timestamp: int = 0
    status: CreateAccountStatus = CreateAccountStatus.ok


@dataclasses.dataclass
class CreateTransferResult:
    """reference: src/tigerbeetle.zig:483-493."""

    timestamp: int = 0
    status: CreateTransferStatus = CreateTransferStatus.ok
