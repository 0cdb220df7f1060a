"""Status codes, flag bits and the shared check folds of the
create_transfers / create_accounts kernels.

The subset of the JAX package's `ops/create_kernels.py` that the
vectorized kernels (`fast_kernels.py`) build on. Each validation check is
a (condition, wire-code) pair in the reference's check order; folding
them in reverse with `torch.where` makes the first failing check win —
the sequential early-return semantics, branch-free (reference hot loop:
src/state_machine.zig:3002-4299). The sequential kernel itself is a
later slice.

Statuses ride as int64 tensors holding the u32 wire code.
"""

from __future__ import annotations

import torch

from ..types import (
    CreateAccountStatus,
    CreateTransferStatus,
    TransferPendingStatus,
)
from . import u128

_CREATED = 0xFFFFFFFF
_TS = {s.name: int(s) for s in CreateTransferStatus}
_AS = {s.name: int(s) for s in CreateAccountStatus}

# Transfer flag bits (types.TransferFlags).
_F_LINKED = 1 << 0
_F_PENDING = 1 << 1
_F_POST = 1 << 2
_F_VOID = 1 << 3
_F_BAL_DR = 1 << 4
_F_BAL_CR = 1 << 5
_F_CLOSE_DR = 1 << 6
_F_CLOSE_CR = 1 << 7
_F_IMPORTED = 1 << 8
_TF_PADDING = 0xFFFF & ~0x1FF

# Account flag bits (types.AccountFlags).
_A_LINKED = 1 << 0
_A_DR_LIMIT = 1 << 1  # debits_must_not_exceed_credits
_A_CR_LIMIT = 1 << 2  # credits_must_not_exceed_debits
_A_IMPORTED = 1 << 4
_A_CLOSED = 1 << 5
_AF_PADDING = 0xFFFF & ~0x3F

_PS_PENDING = int(TransferPendingStatus.pending)
_PS_POSTED = int(TransferPendingStatus.posted)
_PS_VOIDED = int(TransferPendingStatus.voided)
_PS_EXPIRED = int(TransferPendingStatus.expired)

_TRANSIENT_CODES = tuple(
    int(s) for s in CreateTransferStatus if s.transient())


def _flag(flags, bit):
    return (flags & bit) != 0


def _first_failure(checks, created=_CREATED):
    """Fold (cond, code) pairs so the earliest listed failing check wins."""
    status = torch.full_like(checks[0][0], created, dtype=torch.int64)
    for cond, code in reversed(checks):
        status = torch.where(cond, code, status)
    return status


def _ct_eval_exists(e, t_row, p_row):
    """create_transfer_exists + post_or_void_pending_transfer_exists
    (reference: src/state_machine.zig:3988-4051, 4301-4382)."""
    is_post = _flag(e["flags"], _F_POST)
    is_void = _flag(e["flags"], _F_VOID)
    pv = is_post | is_void
    balancing = _flag(e["flags"], _F_BAL_DR) | _flag(e["flags"], _F_BAL_CR)

    t_amt_zero = u128.is_zero(e["amt_hi"], e["amt_lo"])
    t_amt_max = u128.is_max(e["amt_hi"], e["amt_lo"])
    amt_ne_e = ~u128.eq(e["amt_hi"], e["amt_lo"],
                        t_row["amt_hi"], t_row["amt_lo"])
    eamt_ne_pamt = ~u128.eq(t_row["amt_hi"], t_row["amt_lo"],
                            p_row["amt_hi"], p_row["amt_lo"])

    amt_diff_regular = torch.where(
        balancing,
        u128.lt(e["amt_hi"], e["amt_lo"], t_row["amt_hi"], t_row["amt_lo"]),
        amt_ne_e)
    amt_diff_pv = torch.where(
        is_void,
        torch.where(t_amt_zero, eamt_ne_pamt, amt_ne_e),
        torch.where(t_amt_max, eamt_ne_pamt, amt_ne_e))

    def ud_diff(tf, ef, pf):
        zero = tf == 0
        return torch.where(pv, torch.where(zero, ef != pf, tf != ef),
                           tf != ef)

    ud128_zero = u128.is_zero(e["ud128_hi"], e["ud128_lo"])
    ud128_ne_e = ~u128.eq(e["ud128_hi"], e["ud128_lo"],
                          t_row["ud128_hi"], t_row["ud128_lo"])
    ud128_e_ne_p = ~u128.eq(t_row["ud128_hi"], t_row["ud128_lo"],
                            p_row["ud128_hi"], p_row["ud128_lo"])
    ud128_diff = torch.where(
        pv, torch.where(ud128_zero, ud128_e_ne_p, ud128_ne_e), ud128_ne_e)

    dr_ne = ~u128.eq(e["dr_hi"], e["dr_lo"], t_row["dr_hi"], t_row["dr_lo"])
    cr_ne = ~u128.eq(e["cr_hi"], e["cr_lo"], t_row["cr_hi"], t_row["cr_lo"])
    dr_nonzero = ~u128.is_zero(e["dr_hi"], e["dr_lo"])
    cr_nonzero = ~u128.is_zero(e["cr_hi"], e["cr_lo"])
    dr_diff = torch.where(pv, dr_nonzero & dr_ne, dr_ne)
    cr_diff = torch.where(pv, cr_nonzero & cr_ne, cr_ne)

    ledger_diff = torch.where(
        pv, (e["ledger"] != 0) & (e["ledger"] != t_row["ledger"]),
        e["ledger"] != t_row["ledger"])
    code_diff = torch.where(
        pv, (e["code"] != 0) & (e["code"] != t_row["code"]),
        e["code"] != t_row["code"])

    checks = [
        ((e["flags"] & 0xFFFF) != (t_row["flags"] & 0xFFFF),
         _TS["exists_with_different_flags"]),
        (~u128.eq(e["pid_hi"], e["pid_lo"], t_row["pid_hi"], t_row["pid_lo"]),
         _TS["exists_with_different_pending_id"]),
        (e["timeout"] != t_row["timeout"],
         _TS["exists_with_different_timeout"]),
        (dr_diff, _TS["exists_with_different_debit_account_id"]),
        (cr_diff, _TS["exists_with_different_credit_account_id"]),
        (torch.where(pv, amt_diff_pv, amt_diff_regular),
         _TS["exists_with_different_amount"]),
        (ud128_diff, _TS["exists_with_different_user_data_128"]),
        (ud_diff(e["ud64"], t_row["ud64"], p_row["ud64"]),
         _TS["exists_with_different_user_data_64"]),
        (ud_diff(e["ud32"], t_row["ud32"], p_row["ud32"]),
         _TS["exists_with_different_user_data_32"]),
        (ledger_diff, _TS["exists_with_different_ledger"]),
        (code_diff, _TS["exists_with_different_code"]),
    ]
    status = _first_failure(checks, created=_TS["exists"])
    return status, t_row["ts"]
