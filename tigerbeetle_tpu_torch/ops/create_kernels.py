"""Status codes, flag bits and the shared check folds of the
create_transfers / create_accounts kernels, and the sequential kernels
themselves (a port of the JAX package's `ops/create_kernels.py`).

Each validation check is a (condition, wire-code) pair in the
reference's check order; folding them in reverse with `torch.where`
makes the first failing check win — the sequential early-return
semantics, branch-free (reference hot loop: src/state_machine.zig:
3002-4299). The vectorized kernels (`fast_kernels.py`) build on these
folds.

The sequential kernels walk a batch one event at a time over caches the
host prefetched (`batch.prefetch_create_*`): every data-dependent access
is an index into those caches, and a linked chain that breaks replays an
undo log newest-first (the device analog of groove scope_open /
scope_close, src/lsm/groove.zig:1963-1984). Here they are plain PyTorch
twins, each in its CUDA kernel's two stages: a pre-pass vectorised over
every lane (`_ct_prepass` / `_ca_prepass`: the checks that read only
immutable inputs) and a walk in event order on Python ints (`_ct_walk` /
`_ca_walk`: what depends on earlier events), so the tests that hold them
to the JAX package's `create_transfers_kernel` / `create_accounts_kernel`
also check that split. On the card each is one hand-written CUDA kernel
(`create_seq.py`, `csrc/create_seq.cu`). Both return the same dict of
tensors (the JAX kernels' carry: u64 lanes as int64 bit patterns, u32 /
i32 lanes widened to int64, bool lanes as bool), which `apply_create_*`
applies to
a host state. `create_seq.run_create_*` is prefetch -> kernel -> apply
in one call, the port's counterpart of the JAX package's
`engine="kernel"`.

Statuses ride as int64 tensors holding the u32 wire code.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..constants import NS_PER_S, U63_MAX
from ..oracle.state_machine import AccountEventRecord
from ..types import (
    Account,
    CreateAccountResult,
    CreateAccountStatus,
    CreateTransferResult,
    CreateTransferStatus,
    Transfer,
    TransferPendingStatus,
)
from . import u128
from .u64 import carrier, s64, ule, ult

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


# ============================================ the sequential kernels' data

_U63 = s64(U63_MAX)
_NSPS = NS_PER_S

# Each output of the sequential kernels and its dtype in the JAX package
# (the port carries u64 / u32 / i32 lanes as int64, bools as bool).
_U64, _U32, _I32, _B = np.uint64, np.uint32, np.int32, np.bool_
CT_OUT_DTYPES = {
    **{f"a_{f}_{h}": _U64 for f in ("dp", "dpos", "cp", "cpos")
       for h in ("hi", "lo")},
    "a_flags": _U32,
    "s_created": _B, "s_orphaned": _B,
    **{f"s_{k}": _U64 for k in (
        "amt_hi", "amt_lo", "dr_hi", "dr_lo", "cr_hi", "cr_lo", "pid_hi",
        "pid_lo", "ud128_hi", "ud128_lo", "ud64", "ts", "expires")},
    **{f"s_{k}": _U32 for k in ("ud32", "timeout", "ledger", "code",
                                "flags")},
    "s_dr_idx": _I32, "s_cr_idx": _I32, "s_pstat": _I32,
    "tc_pstat": _I32,
    "rb_kind": _I32, "rb_dr_idx": _I32, "rb_cr_idx": _I32,
    "rb_amt_hi": _U64, "rb_amt_lo": _U64,
    "rb_pamt_hi": _U64, "rb_pamt_lo": _U64,
    "rb_p_batch": _B, "rb_p_idx": _I32,
    "rb_dr_closed": _B, "rb_cr_closed": _B,
    "key_max": _U64, "pulse_next": _U64,
    "chain_start": _I32, "chain_broken": _B, "chain_key_max": _U64,
    "r_ts": _U64, "r_status": _U32,
}
CA_OUT_DTYPES = {
    "s_created": _B,
    "s_ud128_hi": _U64, "s_ud128_lo": _U64, "s_ud64": _U64,
    "s_ud32": _U32, "s_ledger": _U32, "s_code": _U32, "s_flags": _U32,
    "s_ts": _U64,
    "key_max": _U64,
    "chain_start": _I32, "chain_broken": _B, "chain_key_max": _U64,
    "r_ts": _U64, "r_status": _U32,
}


def inputs_to_device(inputs: dict, device) -> dict:
    """Prefetched numpy inputs -> the sequential kernels' inputs `tin`:
    arrays as tensors on `device` (u64 as their int64 bit patterns, u32 /
    i32 widened to int64, bool as bool), scalars as Python ints."""
    return {k: ({n: carrier(a, device) for n, a in v.items()}
                if isinstance(v, dict) else int(v))
            for k, v in inputs.items()}


def outputs_to_numpy(out: dict, dtypes: dict) -> dict:
    """A sequential kernel's output tensors -> numpy in the JAX package's
    dtypes (what apply_create_* reads)."""
    res = {}
    for k, dt in dtypes.items():
        a = out[k].cpu().numpy()
        if dt == _U64:
            a = a.view(np.uint64)
        elif dt != _B:
            a = a.astype(dt)
        res[k] = a
    return res


def _scalar(x: int, device):
    return torch.tensor(s64(x), dtype=torch.int64, device=device)


# ================================= create_transfers: the plain twin
#
# Two stages, the CUDA kernel's own (csrc/create_seq.cu):
#
# 1. `_ct_prepass`, every lane at once: what reads only immutable inputs
#    (the event fields, the committed-cache rows `e` and `p` where they
#    come from that cache, the accounts' existence, ledger and
#    timestamp), and for the post/void and regular paths a bit mask of
#    the checks that fail on those inputs alone (bit k: check k of the
#    path's list below, in the reference's order).
# 2. `_ct_walk`, in event order on Python ints: only what depends on
#    earlier events (the batch store, pending statuses, account balances
#    and closed bits, key_max, the chain). It branches on the event's
#    path, ORs the bits of that path's mutable checks into the pre-pass
#    mask, and takes the lowest set bit as the status, so the first
#    failing check still wins.

_M64 = (1 << 64) - 1
_U128_MAX = (1 << 128) - 1

# The post/void checks (reference :4053-4299) and the regular checks
# (:3748-3904), in order: bit k of a mask is check k failing.
_PV_CODES = tuple(_TS[s] for s in (
    "flags_are_mutually_exclusive", "flags_are_mutually_exclusive",
    "pending_id_must_not_be_zero", "pending_id_must_not_be_int_max",
    "pending_id_must_be_different", "timeout_reserved_for_pending_transfer",
    "pending_transfer_not_found", "pending_transfer_not_pending",
    "pending_transfer_has_different_debit_account_id",
    "pending_transfer_has_different_credit_account_id",
    "pending_transfer_has_different_ledger",
    "pending_transfer_has_different_code",
    "exceeds_pending_transfer_amount",
    "pending_transfer_has_different_amount",
    "pending_transfer_already_posted", "pending_transfer_already_voided",
    "pending_transfer_expired", "pending_transfer_expired",
    "imported_event_timestamp_must_not_regress",
    "debit_account_already_closed", "credit_account_already_closed"))
_REG_CODES = tuple(_TS[s] for s in (
    "debit_account_id_must_not_be_zero",
    "debit_account_id_must_not_be_int_max",
    "credit_account_id_must_not_be_zero",
    "credit_account_id_must_not_be_int_max", "accounts_must_be_different",
    "pending_id_must_be_zero", "timeout_reserved_for_pending_transfer",
    "closing_transfer_must_be_pending", "ledger_must_not_be_zero",
    "code_must_not_be_zero", "debit_account_not_found",
    "credit_account_not_found", "accounts_must_have_the_same_ledger",
    "transfer_must_have_the_same_ledger_as_accounts",
    "imported_event_timestamp_must_not_regress",
    "imported_event_timestamp_must_postdate_debit_account",
    "imported_event_timestamp_must_postdate_credit_account",
    "imported_event_timeout_must_be_zero", "debit_account_already_closed",
    "credit_account_already_closed", "overflows_debits_pending",
    "overflows_credits_pending", "overflows_debits_posted",
    "overflows_credits_posted", "overflows_debits", "overflows_credits",
    "overflows_timeout", "exceeds_credits", "exceeds_debits"))

# A transfer row's fields: u128 ones, then u64 / u32 / i32 ones.
_ROW_U128 = ("amt", "dr", "cr", "pid", "ud128")
_ROW_U64 = ("ud64", "ud32", "timeout", "ledger", "code", "flags", "ts",
            "expires", "dr_idx", "cr_idx")


def _first_code(mask: int, codes, ok: int) -> int:
    """The code of the lowest set bit of `mask`; `ok` when none is."""
    return codes[(mask & -mask).bit_length() - 1] if mask else ok


def _bits(checks) -> torch.Tensor:
    """(cond, bit) pairs -> an int64 mask a lane."""
    mask = torch.zeros_like(checks[0][0], dtype=torch.int64)
    for cond, bit in checks:
        mask = mask | (cond.to(torch.int64) << bit)
    return mask


def _uints(t: torch.Tensor) -> list:
    """An int64-carried u64 (or widened u32 / i32) column -> Python
    ints, u64 read unsigned."""
    return t.numpy().view(np.uint64).tolist()


def _u128s(hi: torch.Tensor, lo: torch.Tensor) -> list:
    return [(h << 64) | l for h, l in zip(_uints(hi), _uints(lo))]


def _tc_gather(tc: dict, idx: torch.Tensor) -> dict:
    """Committed-cache rows at `idx`, one a lane, under _ct_eval_exists's
    field names."""
    row = {f: tc[f][idx] for f in (
        "amt_hi", "amt_lo", "dr_hi", "dr_lo", "cr_hi", "cr_lo", "pid_hi",
        "pid_lo", "ud128_hi", "ud128_lo", "ud64", "ud32", "timeout",
        "ledger", "code", "flags", "ts", "dr_idx", "cr_idx")}
    row["expires"] = tc["expires_at"][idx]
    return row


def _ct_prepass(tin: dict) -> dict:
    """Stage 1: every lane at once. Returns the walk's record, one column
    a field (Python ints; u64 unsigned, u128 whole)."""
    ev, tc, acct = tin["event"], tin["tc"], tin["acct"]
    n = tin["n_events"]
    N = ev["id_lo"].shape[0]
    flags = ev["flags"]
    lane = torch.arange(N, dtype=torch.int64)
    ts_event = _scalar(tin["timestamp"] - n + 1, "cpu") + lane
    linked = _flag(flags, _F_LINKED)
    imported = _flag(flags, _F_IMPORTED)
    is_post, is_void = _flag(flags, _F_POST), _flag(flags, _F_VOID)
    pv = is_post | is_void
    pending = _flag(flags, _F_PENDING)
    ts_act = torch.where(imported, ev["ts"], ts_event)
    timeout_ns = ev["timeout"] * _NSPS
    collision = imported & ev["acct_ts_collision"]

    # The exists path, whole where it reads only the committed cache.
    e_cache = ev["exists_idx"] >= 0
    p_cache = ev["pending_cache_idx"] >= 0
    e = _tc_gather(tc, ev["exists_idx"].clamp(min=0))
    p = _tc_gather(tc, ev["pending_cache_idx"].clamp(min=0))
    exists_status, exists_ts = _ct_eval_exists(ev, e, p)
    exists_pre = e_cache & (~pv | p_cache)

    id_zero = u128.is_zero(ev["id_hi"], ev["id_lo"])
    id_max = u128.is_max(ev["id_hi"], ev["id_lo"])
    pid_zero = u128.is_zero(ev["pid_hi"], ev["pid_lo"])
    pid_max = u128.is_max(ev["pid_hi"], ev["pid_lo"])

    # Post/void: bits 6-13 and 17 read the pending row, immutable when it
    # is in the committed cache (then bit 6, not found, is clear); bits
    # 14-16 (its status), 18 (against key_max) and 19-20 (closed
    # accounts) are the walk's, as are 6-13 and 17 otherwise.
    pv_amt_hi, pv_amt_lo = u128.select(
        torch.where(is_void, u128.is_zero(ev["amt_hi"], ev["amt_lo"]),
                    u128.is_max(ev["amt_hi"], ev["amt_lo"])),
        p["amt_hi"], p["amt_lo"], ev["amt_hi"], ev["amt_lo"])
    pv_mask = _bits([
        (is_post & is_void, 0),
        (pending | _flag(flags, _F_BAL_DR) | _flag(flags, _F_BAL_CR)
         | _flag(flags, _F_CLOSE_DR) | _flag(flags, _F_CLOSE_CR), 1),
        (pid_zero, 2),
        (pid_max, 3),
        (u128.eq(ev["pid_hi"], ev["pid_lo"], ev["id_hi"], ev["id_lo"]), 4),
        (ev["timeout"] != 0, 5),
        (p_cache & ~_flag(p["flags"], _F_PENDING), 7),
        (p_cache & ~u128.is_zero(ev["dr_hi"], ev["dr_lo"])
         & ~u128.eq(ev["dr_hi"], ev["dr_lo"], p["dr_hi"], p["dr_lo"]), 8),
        (p_cache & ~u128.is_zero(ev["cr_hi"], ev["cr_lo"])
         & ~u128.eq(ev["cr_hi"], ev["cr_lo"], p["cr_hi"], p["cr_lo"]), 9),
        (p_cache & (ev["ledger"] != 0) & (ev["ledger"] != p["ledger"]), 10),
        (p_cache & (ev["code"] != 0) & (ev["code"] != p["code"]), 11),
        (p_cache & u128.lt(p["amt_hi"], p["amt_lo"], pv_amt_hi, pv_amt_lo),
         12),
        (p_cache & is_void & u128.lt(pv_amt_hi, pv_amt_lo, p["amt_hi"],
                                     p["amt_lo"]), 13),
        (p_cache & (p["timeout"] != 0) & ule(p["expires"], ts_event), 17),
        (collision, 18),
    ])

    # Regular: bits 14 (against key_max), 18-25 and 27-28 are the walk's.
    dr_idx, cr_idx = ev["dr_idx"], ev["cr_idx"]
    dr_ledger, cr_ledger = acct["ledger"][dr_idx], acct["ledger"][cr_idx]
    reg_mask = _bits([
        (u128.is_zero(ev["dr_hi"], ev["dr_lo"]), 0),
        (u128.is_max(ev["dr_hi"], ev["dr_lo"]), 1),
        (u128.is_zero(ev["cr_hi"], ev["cr_lo"]), 2),
        (u128.is_max(ev["cr_hi"], ev["cr_lo"]), 3),
        (u128.eq(ev["dr_hi"], ev["dr_lo"], ev["cr_hi"], ev["cr_lo"]), 4),
        (~pid_zero, 5),
        (~pending & (ev["timeout"] != 0), 6),
        (~pending & (_flag(flags, _F_CLOSE_DR) | _flag(flags, _F_CLOSE_CR)),
         7),
        (ev["ledger"] == 0, 8),
        (ev["code"] == 0, 9),
        (~acct["exists"][dr_idx], 10),
        (~acct["exists"][cr_idx], 11),
        (dr_ledger != cr_ledger, 12),
        (ev["ledger"] != dr_ledger, 13),
        (collision, 14),
        (imported & ule(ev["ts"], acct["ts"][dr_idx]), 15),
        (imported & ule(ev["ts"], acct["ts"][cr_idx]), 16),
        (imported & (ev["timeout"] != 0), 17),
        (ult(_scalar(_U63, "cpu"), ts_act + timeout_ns), 26),
    ])

    # The checks before the paths, and the wrapper's (reference
    # execute_create :3033-3104) but for the chain's two.
    pre = _first_failure([
        ((flags & _TF_PADDING) != 0, _TS["reserved_flag"]),
        (id_zero, _TS["id_must_not_be_zero"]),
        (id_max, _TS["id_must_not_be_int_max"]),
    ])
    ts_valid = ule(_scalar(1, "cpu"), ev["ts"]) & ule(ev["ts"],
                                                      _scalar(_U63, "cpu"))
    batch_imported = _flag(flags[0], _F_IMPORTED) & (n > 0)
    ovr = torch.full_like(flags, _CREATED)
    ovr = torch.where(~imported & (ev["ts"] != 0),
                      _TS["timestamp_must_be_zero"], ovr)
    ovr = torch.where(imported & ts_valid
                      & ule(_scalar(tin["timestamp"], "cpu"), ev["ts"]),
                      _TS["imported_event_timestamp_must_not_advance"], ovr)
    ovr = torch.where(imported & ~ts_valid,
                      _TS["imported_event_timestamp_out_of_range"], ovr)
    ovr = torch.where(imported != batch_imported,
                      torch.where(imported, _TS["imported_event_not_expected"],
                                  _TS["imported_event_expected"]), ovr)

    rec = {
        "flags": flags, "valid": ev["valid"], "orphaned": ev["orphaned"],
        "chain_open": linked & (lane == n - 1),
        "slot": ev["slot"], "psl": ev["pending_slot"],
        "pci": ev["pending_cache_idx"], "ei": ev["exists_idx"],
        "dr_idx": dr_idx, "cr_idx": cr_idx,
        "ts": ev["ts"], "ts_event": ts_event, "ts_act": ts_act,
        "timeout": ev["timeout"], "timeout_ns": timeout_ns,
        "ud64": ev["ud64"], "ud32": ev["ud32"], "ledger": ev["ledger"],
        "code": ev["code"],
        "pv_mask": pv_mask, "reg_mask": reg_mask, "pre": pre, "ovr": ovr,
        "exists_pre": exists_pre, "exists_status": exists_status,
        "exists_ts": exists_ts,
    }
    out = {k: (v.tolist() if v.dtype == torch.bool else _uints(v))
           for k, v in rec.items()}
    for k in ("slot", "psl", "pci", "ei"):  # signed
        out[k] = rec[k].tolist()
    for f in _ROW_U128:
        out[f] = _u128s(ev[f"{f}_hi"], ev[f"{f}_lo"])
    return out


def _row_tensors(r: dict) -> dict:
    """A walk row (Python ints) as _ct_eval_exists's 0-d tensors."""
    t = {}
    for k, v in r.items():
        if k in _ROW_U128:
            t[f"{k}_hi"] = _scalar(v >> 64, "cpu")
            t[f"{k}_lo"] = _scalar(v & _M64, "cpu")
        else:
            t[k] = _scalar(v, "cpu")
    return t


def _ct_walk(tin: dict, x: dict) -> dict:
    """Stage 2: the events in order over the pre-pass record `x`; returns
    the carry as the JAX kernel's output dict."""
    tc, acct = tin["tc"], tin["acct"]
    N = len(x["flags"])
    n = tin["n_events"]
    dp = _u128s(acct["dp_hi"], acct["dp_lo"])
    dpos = _u128s(acct["dpos_hi"], acct["dpos_lo"])
    cp = _u128s(acct["cp_hi"], acct["cp_lo"])
    cpos = _u128s(acct["cpos_hi"], acct["cpos_lo"])
    a_flags = _uints(acct["flags"])
    tcr = {f: _u128s(tc[f"{f}_hi"], tc[f"{f}_lo"]) for f in _ROW_U128}
    tcr.update({f: _uints(tc[f]) for f in _ROW_U64 if f != "expires"})
    tcr["expires"] = _uints(tc["expires_at"])
    tc_pstat = _uints(tc["pending_status"])
    s = {f: [0] * N for f in _ROW_U128 + _ROW_U64 + ("pstat",)}
    s_created, s_orphaned = [False] * N, [False] * N
    rb = {f: [0] * N for f in ("kind", "dr_idx", "cr_idx", "amt", "pamt",
                               "p_idx")}
    rb.update({f: [False] * N for f in ("p_batch", "dr_closed",
                                        "cr_closed")})
    r_ts, r_status = [0] * N, [0] * N
    key_max, pulse_next = tin["transfers_key_max"], tin["pulse_next"]
    chain_start, chain_broken, chain_key_max = -1, False, 0

    def row(from_cache: bool, c: int, sl: int) -> dict:
        if from_cache:
            r = {f: v[c] for f, v in tcr.items()}
            r["pstat"] = tc_pstat[c]
        else:
            r = {f: v[sl] for f, v in s.items()}
        return r

    def rollback(j: int) -> None:
        """Undo chain member j (LIFO: closed bits and pending statuses
        are absolute pre-event snapshots)."""
        kind = rb["kind"][j]
        dri, cri = rb["dr_idx"][j], rb["cr_idx"][j]
        amt, pamt = rb["amt"][j], rb["pamt"][j]
        if kind in (1, 3):
            dpos[dri] = (dpos[dri] - amt) & _U128_MAX
            cpos[cri] = (cpos[cri] - amt) & _U128_MAX
        if kind == 2:
            dp[dri] = (dp[dri] - amt) & _U128_MAX
            cp[cri] = (cp[cri] - amt) & _U128_MAX
        if kind in (3, 4):
            dp[dri] = (dp[dri] + pamt) & _U128_MAX
            cp[cri] = (cp[cri] + pamt) & _U128_MAX
            if rb["p_batch"][j]:
                s["pstat"][rb["p_idx"][j]] = _PS_PENDING
            else:
                tc_pstat[rb["p_idx"][j]] = _PS_PENDING
        if kind > 0:
            for idx, closed in ((dri, rb["dr_closed"][j]),
                                (cri, rb["cr_closed"][j])):
                a_flags[idx] = (a_flags[idx] | _A_CLOSED if closed
                                else a_flags[idx] & ~_A_CLOSED)
            s_created[x["slot"][j]] = False
        rb["kind"][j] = 0
        r_status[j] = _TS["linked_event_failed"]

    for i in range(N):
        f = x["flags"][i]
        valid = x["valid"][i]
        linked = bool(f & _F_LINKED)
        imported = bool(f & _F_IMPORTED)
        is_post, is_void = bool(f & _F_POST), bool(f & _F_VOID)
        pv = is_post or is_void
        pending = bool(f & _F_PENDING)

        # --- chain open (reference :3033-3043) ---
        chain_active = chain_start >= 0
        if linked and not chain_active and valid:
            chain_start, chain_key_max = i, key_max
            chain_active = True

        # --- the pending row: committed cache or batch store ---
        slot = x["slot"][i]
        p_cache = x["pci"][i] >= 0
        pci, psl = max(x["pci"][i], 0), max(x["psl"][i], 0)
        p = row(p_cache, pci, psl)
        p_found = p_cache or (x["psl"][i] >= 0 and s_created[psl])
        regress = imported and x["ts"][i] <= key_max

        # --- the amount: pv_amt, or the balancing clamp (:3840-3853) ---
        ev_amt = x["amt"][i]
        dr_idx, cr_idx = x["dr_idx"][i], x["cr_idx"][i]
        if pv:
            full = ev_amt == 0 if is_void else ev_amt == _U128_MAX
            f_amt = p["amt"] if full else ev_amt
            s_dr, s_cr = p["dr_idx"], p["cr_idx"]
        else:
            f_amt = ev_amt
            if f & _F_BAL_DR:
                f_amt = min(f_amt, max(cpos[dr_idx] - (
                    (dpos[dr_idx] + dp[dr_idx]) & _U128_MAX), 0))
            if f & _F_BAL_CR:
                f_amt = min(f_amt, max(dpos[cr_idx] - (
                    (cpos[cr_idx] + cp[cr_idx]) & _U128_MAX), 0))
            s_dr, s_cr = dr_idx, cr_idx

        # --- the path's status (reference :3729-3746) ---
        e_found = x["ei"][i] >= 0 or s_created[slot]
        exists_ts = 0
        inner = x["pre"][i]
        if inner != _CREATED:
            pass
        elif e_found:
            if x["exists_pre"][i]:
                inner, exists_ts = x["exists_status"][i], x["exists_ts"][i]
            else:
                e = row(x["ei"][i] >= 0, max(x["ei"][i], 0), slot)
                inner = int(_ct_eval_exists(
                    {k: v[i] for k, v in tin["event"].items()},
                    _row_tensors(e), _row_tensors(p))[0])
                exists_ts = e["ts"]
        elif x["orphaned"][i] or s_orphaned[slot]:
            inner = _TS["id_already_failed"]
        elif pv:
            m = x["pv_mask"][i]
            if not p_cache:
                m |= (not p_found) << 6
                m |= (not p["flags"] & _F_PENDING) << 7
                for bit, k in ((8, "dr"), (9, "cr"), (10, "ledger"),
                               (11, "code")):
                    t = x[k][i]
                    m |= (t != 0 and t != p[k]) << bit
                m |= (p["amt"] < f_amt) << 12
                m |= (is_void and f_amt < p["amt"]) << 13
                m |= (p["timeout"] != 0
                      and p["expires"] <= x["ts_event"][i]) << 17
            m |= (p["pstat"] == _PS_POSTED) << 14
            m |= (p["pstat"] == _PS_VOIDED) << 15
            m |= (p["pstat"] == _PS_EXPIRED) << 16
            m |= regress << 18
            m |= (bool(a_flags[s_dr] & _A_CLOSED) and not is_void) << 19
            m |= (bool(a_flags[s_cr] & _A_CLOSED) and not is_void) << 20
            inner = _first_code(m, _PV_CODES, _CREATED)
        else:
            m = x["reg_mask"][i] | (regress << 14)
            m |= bool(a_flags[dr_idx] & _A_CLOSED) << 18
            m |= bool(a_flags[cr_idx] & _A_CLOSED) << 19
            d_dp, d_dpos = dp[dr_idx], dpos[dr_idx]
            c_cp, c_cpos = cp[cr_idx], cpos[cr_idx]
            m |= (pending and f_amt + d_dp > _U128_MAX) << 20
            m |= (pending and f_amt + c_cp > _U128_MAX) << 21
            m |= (f_amt + d_dpos > _U128_MAX) << 22
            m |= (f_amt + c_cpos > _U128_MAX) << 23
            m |= (f_amt + d_dp > _U128_MAX or ((f_amt + d_dp) & _U128_MAX)
                  + d_dpos > _U128_MAX) << 24
            m |= (f_amt + c_cp > _U128_MAX or ((f_amt + c_cp) & _U128_MAX)
                  + c_cpos > _U128_MAX) << 25
            m |= (bool(a_flags[dr_idx] & _A_DR_LIMIT) and cpos[dr_idx] < (
                (d_dp + d_dpos + f_amt) & _U128_MAX)) << 27
            m |= (bool(a_flags[cr_idx] & _A_CR_LIMIT) and dpos[cr_idx] < (
                (c_cp + c_cpos + f_amt) & _U128_MAX)) << 28
            inner = _first_code(m, _REG_CODES, _CREATED)

        if e_found and inner == _TS["exists"]:
            ts_actual_inner = exists_ts
        elif inner == _CREATED:
            ts_actual_inner = x["ts_act"][i]
        else:
            ts_actual_inner = x["ts_event"][i]

        # --- wrapper checks (reference execute_create :3033-3104) ---
        status = inner
        if x["ovr"][i] != _CREATED:
            status = x["ovr"][i]
        if chain_broken:
            status = _TS["linked_event_failed"]
        if x["chain_open"][i]:
            status = _TS["linked_event_chain_open"]
        ts_actual = ts_actual_inner if status == inner else x["ts_event"][i]

        # --- application ---
        created = status == _CREATED and valid
        ap_pv = created and pv
        ap_reg = created and not pv
        ap_pending = ap_reg and pending
        f_ts = x["ts_act"][i]
        if ap_pending:
            dp[dr_idx] = (dp[dr_idx] + f_amt) & _U128_MAX
            cp[cr_idx] = (cp[cr_idx] + f_amt) & _U128_MAX
        if ap_reg and not pending:
            dpos[dr_idx] = (dpos[dr_idx] + f_amt) & _U128_MAX
            cpos[cr_idx] = (cpos[cr_idx] + f_amt) & _U128_MAX
        rb_dr_closed = bool(a_flags[s_dr] & _A_CLOSED)
        rb_cr_closed = bool(a_flags[s_cr] & _A_CLOSED)
        if ap_reg and f & _F_CLOSE_DR:
            a_flags[dr_idx] |= _A_CLOSED
        if ap_reg and f & _F_CLOSE_CR:
            a_flags[cr_idx] |= _A_CLOSED
        if ap_pv:
            pdr, pcr = p["dr_idx"], p["cr_idx"]
            dp[pdr] = (dp[pdr] - p["amt"]) & _U128_MAX
            cp[pcr] = (cp[pcr] - p["amt"]) & _U128_MAX
            if is_post:
                dpos[pdr] = (dpos[pdr] + f_amt) & _U128_MAX
                cpos[pcr] = (cpos[pcr] + f_amt) & _U128_MAX
            if is_void and p["flags"] & _F_CLOSE_DR:
                a_flags[pdr] &= ~_A_CLOSED
            if is_void and p["flags"] & _F_CLOSE_CR:
                a_flags[pcr] &= ~_A_CLOSED
            new_pstat = _PS_POSTED if is_post else _PS_VOIDED
            if p_cache:
                tc_pstat[pci] = new_pstat
            else:
                s["pstat"][psl] = new_pstat

        # Insert the stored transfer into the batch store at `slot`.
        timeout_ns = x["timeout_ns"][i]
        if created:
            def pick(k):
                t = x[k][i]
                return p[k] if pv and t == 0 else t

            for k, v in (
                    ("amt", f_amt), ("dr_idx", s_dr), ("cr_idx", s_cr),
                    ("dr", p["dr"] if pv else x["dr"][i]),
                    ("cr", p["cr"] if pv else x["cr"][i]),
                    ("pid", x["pid"][i]), ("ud128", pick("ud128")),
                    ("ud64", pick("ud64")), ("ud32", pick("ud32")),
                    ("timeout", 0 if pv else x["timeout"][i]),
                    ("ledger", p["ledger"] if pv else x["ledger"][i]),
                    ("code", p["code"] if pv else x["code"][i]),
                    ("flags", f), ("ts", f_ts),
                    ("pstat", _PS_PENDING if ap_pending else 0),
                    ("expires", (f_ts + timeout_ns) & _M64
                     if ap_pending and x["timeout"][i] != 0 else 0)):
                s[k][slot] = v
            s_created[slot] = True
            key_max = max(key_max, f_ts)

        # Pulse scheduling (reference :3975-3981 add, :4227-4230 reset).
        expires_new = (f_ts + timeout_ns) & _M64
        if ap_pending and x["timeout"][i] != 0 and expires_new < pulse_next:
            pulse_next = expires_new
        if ap_pv and p["timeout"] != 0 and pulse_next == p["expires"]:
            pulse_next = 1

        # Undo log record.
        rb["kind"][i] = (0 if not created else 3 if is_post else 4
                         if is_void else 2 if pending else 1)
        rb["dr_idx"][i], rb["cr_idx"][i] = s_dr, s_cr
        rb["amt"][i], rb["pamt"][i] = f_amt, p["amt"]
        rb["p_batch"][i] = not p_cache
        rb["p_idx"][i] = pci if p_cache else psl
        rb["dr_closed"][i], rb["cr_closed"][i] = rb_dr_closed, rb_cr_closed

        # Orphan transient failures (reference transient_error :3215-3252).
        if valid and status in _TRANSIENT_CODES:
            s_orphaned[slot] = True
        if valid:
            r_ts[i], r_status[i] = ts_actual, status

        # --- chain break: roll back the applied prefix (:3116-3150) ---
        if status != _CREATED and chain_active and not chain_broken \
                and valid:
            for j in range(i - 1, max(chain_start, 0) - 1, -1):
                rollback(j)
            key_max = chain_key_max
            chain_broken = True
        # Chain close (reference :3196-3207).
        if chain_active and (not linked
                             or status == _TS["linked_event_chain_open"]):
            chain_start, chain_broken = -1, False

    def col(v):
        return torch.from_numpy(np.array(v, dtype=np.uint64).view(np.int64))

    def limbs(prefix, v):
        return {f"{prefix}_hi": col([a >> 64 for a in v]),
                f"{prefix}_lo": col([a & _M64 for a in v])}

    out = {**limbs("a_dp", dp), **limbs("a_dpos", dpos), **limbs("a_cp", cp),
           **limbs("a_cpos", cpos), "a_flags": col(a_flags)}
    for k, v in s.items():
        out.update(limbs(f"s_{k}", v) if k in _ROW_U128 else {f"s_{k}": col(v)})
    out["s_created"] = torch.tensor(s_created, dtype=torch.bool)
    out["s_orphaned"] = torch.tensor(s_orphaned, dtype=torch.bool)
    out["tc_pstat"] = col(tc_pstat)
    for k, v in rb.items():
        if k in ("amt", "pamt"):
            out.update(limbs(f"rb_{k}", v))
        elif isinstance(v[0], bool):
            out[f"rb_{k}"] = torch.tensor(v, dtype=torch.bool)
        else:
            out[f"rb_{k}"] = col(v)
    out["r_ts"], out["r_status"] = col(r_ts), col(r_status)
    out["key_max"] = _scalar(key_max, "cpu")
    out["pulse_next"] = _scalar(pulse_next, "cpu")
    out["chain_key_max"] = _scalar(chain_key_max, "cpu")
    out["chain_start"] = _scalar(chain_start, "cpu")
    out["chain_broken"] = torch.tensor(chain_broken)
    return out


def create_transfers_seq_plain(tin: dict) -> dict:
    """The create_transfers sequential kernel, plain: every event of the
    padded batch in order (the JAX package's `create_transfers_kernel`),
    as a pre-pass over all lanes and a walk in event order. `tin` is
    `inputs_to_device(prefetch...)` on the CPU."""
    return _ct_walk(tin, _ct_prepass(tin))


# ================================== create_accounts: the plain twin
#
# The CUDA kernel's stages again (csrc/create_seq.cu):
#
# 1. `_ca_prepass`, every lane at once: each event's static statuses, in
#    the reference's order. `s0`: the first failing check before the
#    exists check, else, where the committed cache holds the id, the
#    exists status against that row. `post`: the first failing check
#    after it but for `regress` against the running key_max (an imported
#    event whose timestamp a transfer holds already fails `regress`
#    here). `ovr`: the wrapper's timestamp and imported override that
#    wins. 0 is "none" in each. An event's id is found in the batch
#    store only if an earlier event of the batch has it (`slot`, the
#    id's first lane, is not the event's own), so `s0` decides every
#    other event's exists check.
# 2. `_ca_walk`, in event order on Python ints: what depends on earlier
#    events. That is a repeated id (the batch store: its slot's last
#    writer and created bit), `regress` against the running key_max, and
#    the chain. (The kernel's warp takes some chunks of 32 events in one
#    step; the twin walks every event, and the kernel is held to it.)

# create_account_exists (reference :3691-3703): the fields it compares
# (the key below), in order, and the code of each.
_CA_EXISTS_CODES = tuple(_AS[s] for s in (
    "exists_with_different_flags", "exists_with_different_user_data_128",
    "exists_with_different_user_data_64",
    "exists_with_different_user_data_32", "exists_with_different_ledger",
    "exists_with_different_code"))


def _ca_exists(key, e_key) -> int:
    """The exists status of an event with fields `key` against a stored
    account with `e_key` (each `_ca_prepass`'s "key" tuple)."""
    for a, b, code in zip(key, e_key, _CA_EXISTS_CODES):
        if a != b:
            return code
    return _AS["exists"]


def _ca_prepass(tin: dict) -> dict:
    """Stage 1: every lane at once. Returns the walk's record, one list
    a field (Python ints; u64 unsigned, u128 whole)."""
    ev, ac = tin["event"], tin["ac"]
    n = tin["n_events"]
    N = ev["id_lo"].shape[0]
    flags = ev["flags"]
    lane = torch.arange(N, dtype=torch.int64)
    ts_event = _scalar(tin["timestamp"] - n + 1, "cpu") + lane
    imported = _flag(flags, _A_IMPORTED)
    ts_act = torch.where(imported, ev["ts"], ts_event)

    e_cache = ev["exists_idx"] >= 0
    ci = ev["exists_idx"].clamp(min=0)
    e = {k: ac[k][ci] for k in ac}
    exists = _first_failure([
        ((flags & 0xFFFF) != (e["flags"] & 0xFFFF), _CA_EXISTS_CODES[0]),
        (~u128.eq(ev["ud128_hi"], ev["ud128_lo"], e["ud128_hi"],
                  e["ud128_lo"]), _CA_EXISTS_CODES[1]),
        (ev["ud64"] != e["ud64"], _CA_EXISTS_CODES[2]),
        (ev["ud32"] != e["ud32"], _CA_EXISTS_CODES[3]),
        (ev["ledger"] != e["ledger"], _CA_EXISTS_CODES[4]),
        (ev["code"] != e["code"], _CA_EXISTS_CODES[5]),
    ], created=_AS["exists"])

    # create_account (reference :3613-3689), split at the exists check.
    pre = _first_failure([
        (ev["reserved"] != 0, _AS["reserved_field"]),
        ((flags & _AF_PADDING) != 0, _AS["reserved_flag"]),
        (u128.is_zero(ev["id_hi"], ev["id_lo"]), _AS["id_must_not_be_zero"]),
        (u128.is_max(ev["id_hi"], ev["id_lo"]),
         _AS["id_must_not_be_int_max"]),
    ], created=0)
    s0 = torch.where(pre != 0, pre, torch.where(e_cache, exists, 0))
    post = _first_failure([
        (_flag(flags, _A_DR_LIMIT) & _flag(flags, _A_CR_LIMIT),
         _AS["flags_are_mutually_exclusive"]),
        (~u128.is_zero(ev["dp_hi"], ev["dp_lo"]),
         _AS["debits_pending_must_be_zero"]),
        (~u128.is_zero(ev["dpos_hi"], ev["dpos_lo"]),
         _AS["debits_posted_must_be_zero"]),
        (~u128.is_zero(ev["cp_hi"], ev["cp_lo"]),
         _AS["credits_pending_must_be_zero"]),
        (~u128.is_zero(ev["cpos_hi"], ev["cpos_lo"]),
         _AS["credits_posted_must_be_zero"]),
        (ev["ledger"] == 0, _AS["ledger_must_not_be_zero"]),
        (ev["code"] == 0, _AS["code_must_not_be_zero"]),
        (imported & ev["transfer_ts_collision"],
         _AS["imported_event_timestamp_must_not_regress"]),
    ], created=0)

    # The wrapper's overrides (reference execute_create :3033-3104) but
    # for the chain's two; a later one wins.
    ts_valid = ule(_scalar(1, "cpu"), ev["ts"]) & ule(ev["ts"],
                                                      _scalar(_U63, "cpu"))
    batch_imported = _flag(flags[0], _A_IMPORTED) & (n > 0)
    ovr = torch.zeros_like(flags)
    ovr = torch.where(~imported & (ev["ts"] != 0),
                      _AS["timestamp_must_be_zero"], ovr)
    ovr = torch.where(imported & ts_valid
                      & ule(_scalar(tin["timestamp"], "cpu"), ev["ts"]),
                      _AS["imported_event_timestamp_must_not_advance"], ovr)
    ovr = torch.where(imported & ~ts_valid,
                      _AS["imported_event_timestamp_out_of_range"], ovr)
    ovr = torch.where(imported != batch_imported,
                      torch.where(imported, _AS["imported_event_not_expected"],
                                  _AS["imported_event_expected"]), ovr)

    rec = {
        "valid": ev["valid"], "linked": _flag(flags, _A_LINKED),
        "imported": imported,
        "chain_open": _flag(flags, _A_LINKED) & (lane == n - 1),
        "s0": s0, "post": post, "ovr": ovr, "slot": ev["slot"],
        "ts_act": ts_act, "exists_ts": e["ts"], "flags": flags,
        "ud64": ev["ud64"], "ud32": ev["ud32"], "ledger": ev["ledger"],
        "code": ev["code"],
    }
    x = {k: (v.tolist() if v.dtype == torch.bool else _uints(v))
         for k, v in rec.items()}
    x["ud128"] = _u128s(ev["ud128_hi"], ev["ud128_lo"])
    x["key"] = list(zip([f & 0xFFFF for f in x["flags"]], x["ud128"],
                        x["ud64"], x["ud32"], x["ledger"], x["code"]))
    return x


def _ca_walk(tin: dict, x: dict) -> dict:
    """Stage 2: the events in order over the pre-pass record `x`; returns
    the carry as the JAX kernel's output dict. The batch store keeps, a
    slot, its last writer (the last event created there: a chain's
    rollback clears the created bit but leaves the row, as the
    reference's does) and a created bit."""
    N = len(x["slot"])
    n = tin["n_events"]
    ts_event0 = tin["timestamp"] - n + 1
    writer, created = [-1] * N, [False] * N
    r_ts, r_status = [0] * N, [0] * N
    key_max = tin["accounts_key_max"]
    chain_start, chain_broken, chain_key_max = -1, False, 0
    exists, lef = _AS["exists"], _AS["linked_event_failed"]
    leco = _AS["linked_event_chain_open"]

    for i in range(N):
        valid, linked, sl = x["valid"][i], x["linked"][i], x["slot"][i]
        # --- chain open (reference :3033-3043) ---
        chain_active = chain_start >= 0
        if linked and not chain_active and valid:
            chain_start, chain_key_max = i, key_max
            chain_active = True
        # --- the inner status: the pre-pass's, or the exists status
        # against the batch store's row ---
        inner, e_ts = x["s0"][i], x["exists_ts"][i]
        if not inner:
            if sl != i and created[sl]:
                w = writer[sl]
                inner = _ca_exists(x["key"][i], x["key"][w])
                e_ts = x["ts_act"][w]
            elif x["post"][i]:
                inner = x["post"][i]
            elif (x["imported"][i] and key_max != 0
                  and x["ts_act"][i] <= key_max):
                inner = _AS["imported_event_timestamp_must_not_regress"]
            else:
                inner = _CREATED
        # --- wrapper checks (reference execute_create :3033-3104) ---
        status = x["ovr"][i] or inner
        if chain_broken:
            status = lef
        if x["chain_open"][i]:
            status = leco
        if valid:
            if status != inner:
                r_ts[i] = (ts_event0 + i) & _M64
            elif inner == exists:
                r_ts[i] = e_ts
            elif inner == _CREATED:
                r_ts[i] = x["ts_act"][i]
            else:
                r_ts[i] = (ts_event0 + i) & _M64
            r_status[i] = status
            if status == _CREATED:
                writer[sl], created[sl] = i, True
                key_max = max(key_max, x["ts_act"][i])
        # --- chain break: roll back the chain's prefix (:3116-3150) ---
        if status != _CREATED and chain_active and not chain_broken \
                and valid:
            for j in range(max(chain_start, 0), i):
                created[x["slot"][j]] = False
                r_status[j] = lef
            key_max = chain_key_max
            chain_broken = True
        # Chain close (reference :3196-3207).
        if chain_active and (not linked or status == leco):
            chain_start, chain_broken = -1, False

    def col(v):
        return torch.from_numpy(np.array(v, dtype=np.uint64).view(np.int64))

    def field(k):
        return [x[k][w] if w >= 0 else 0 for w in writer]

    ud128 = field("ud128")
    return {
        "s_created": torch.tensor(created, dtype=torch.bool),
        "s_ud128_hi": col([v >> 64 for v in ud128]),
        "s_ud128_lo": col([v & _M64 for v in ud128]),
        **{f"s_{k}": col(field(k)) for k in ("ud64", "ud32", "ledger",
                                             "code", "flags")},
        "s_ts": col(field("ts_act")),
        "key_max": _scalar(key_max, "cpu"),
        "chain_start": _scalar(chain_start, "cpu"),
        "chain_broken": torch.tensor(chain_broken),
        "chain_key_max": _scalar(chain_key_max, "cpu"),
        "r_ts": col(r_ts), "r_status": col(r_status),
    }


def create_accounts_seq_plain(tin: dict) -> dict:
    """The create_accounts sequential kernel, plain: every event of the
    padded batch in order (the JAX package's `create_accounts_kernel`),
    as a pre-pass over all lanes and a walk in event order. `tin` is
    `inputs_to_device(prefetch...)` on the CPU."""
    return _ca_walk(tin, _ca_prepass(tin))


# ======================================================== host application

def _u128_of(hi, lo, idx) -> int:
    return (int(hi[idx]) << 64) | int(lo[idx])


def apply_create_transfers(state, inputs, aux, out) -> list:
    """Apply a create_transfers kernel's outputs (numpy, in the JAX
    package's dtypes: `outputs_to_numpy`) to the host state — the groove
    inserts and updates inside the reference hot loop."""
    n = aux["n"]
    r_status = np.asarray(out["r_status"][:n])
    r_ts = np.asarray(out["r_ts"][:n])
    event_ids = aux["event_ids"]
    ev = inputs["event"]

    # Orphan transient failures.
    for i in np.nonzero(np.isin(r_status, list(_TRANSIENT_CODES)))[0]:
        state.orphaned.add(event_ids[int(i)])

    # Write back only the accounts the kernel changed.
    acct_in = inputs["acct"]
    dirty = (
        (out["a_dp_hi"] != acct_in["dp_hi"])
        | (out["a_dp_lo"] != acct_in["dp_lo"])
        | (out["a_dpos_hi"] != acct_in["dpos_hi"])
        | (out["a_dpos_lo"] != acct_in["dpos_lo"])
        | (out["a_cp_hi"] != acct_in["cp_hi"])
        | (out["a_cp_lo"] != acct_in["cp_lo"])
        | (out["a_cpos_hi"] != acct_in["cpos_hi"])
        | (out["a_cpos_lo"] != acct_in["cpos_lo"])
        | (out["a_flags"] != acct_in["flags"])
    )
    for aid, idx in aux["acct_id_to_idx"].items():
        if not (dirty[idx] and acct_in["exists"][idx]):
            continue
        a = state.accounts[aid]
        state.accounts[aid] = dataclasses.replace(
            a,
            debits_pending=_u128_of(out["a_dp_hi"], out["a_dp_lo"], idx),
            debits_posted=_u128_of(out["a_dpos_hi"], out["a_dpos_lo"], idx),
            credits_pending=_u128_of(out["a_cp_hi"], out["a_cp_lo"], idx),
            credits_posted=_u128_of(out["a_cpos_hi"], out["a_cpos_lo"], idx),
            flags=int(out["a_flags"][idx]),
        )

    # Committed pending-status flips (post/void). Expiry-index removal
    # happens in the in-order walk below for exact pulse_next parity.
    tc_pstat = out["tc_pstat"]
    for idx, t in enumerate(aux["tc_rows"]):
        old = int(inputs["tc"]["pending_status"][idx])
        new = int(tc_pstat[idx])
        if new != old:
            state.pending_status[t.timestamp] = TransferPendingStatus(new)

    # Materialize batch-created transfers.
    for slot in np.nonzero(out["s_created"][:n])[0]:
        slot = int(slot)
        t = Transfer(
            id=event_ids[slot],
            debit_account_id=_u128_of(out["s_dr_hi"], out["s_dr_lo"], slot),
            credit_account_id=_u128_of(out["s_cr_hi"], out["s_cr_lo"], slot),
            amount=_u128_of(out["s_amt_hi"], out["s_amt_lo"], slot),
            pending_id=_u128_of(out["s_pid_hi"], out["s_pid_lo"], slot),
            user_data_128=_u128_of(out["s_ud128_hi"], out["s_ud128_lo"],
                                   slot),
            user_data_64=int(out["s_ud64"][slot]),
            user_data_32=int(out["s_ud32"][slot]),
            timeout=int(out["s_timeout"][slot]),
            ledger=int(out["s_ledger"][slot]),
            code=int(out["s_code"][slot]),
            flags=int(out["s_flags"][slot]),
            timestamp=int(out["s_ts"][slot]),
        )
        state.transfers[t.id] = t
        state.transfer_by_timestamp[t.timestamp] = t.id
        pstat = int(out["s_pstat"][slot])
        if pstat != 0:
            state.pending_status[t.timestamp] = TransferPendingStatus(pstat)

    # Expiry-index maintenance in event order. pulse_next_timestamp comes
    # from the kernel scalar, which tracks the reference's sequential
    # updates exactly (add at :3975-3981, remove-and-reset at
    # :4227-4230), rolled-back chains not restoring it included.
    flags = np.asarray(ev["flags"][:n])
    created_mask = r_status == _CREATED
    pending_add = (created_mask & ((flags & _F_PENDING) != 0)
                   & (np.asarray(ev["timeout"][:n]) != 0))
    pv_mask = created_mask & ((flags & (_F_POST | _F_VOID)) != 0)
    for i in np.nonzero(pending_add | pv_mask)[0]:
        i = int(i)
        if pending_add[i]:
            ts = int(r_ts[i])
            state.expiry[ts] = ts + int(ev["timeout"][i]) * NS_PER_S
        else:
            p = state.transfers[aux["event_pids"][i]]
            state.expiry.pop(p.timestamp, None)
    state.pulse_next_timestamp = int(out["pulse_next"])

    # Account-event rows (CDC + balance history; reference account_event()
    # src/state_machine.zig:4384-4470): replay created events' balance
    # deltas from the prefetched snapshot so each row captures both
    # accounts after its event, like the sequential path.
    idx_to_id = {v: k for k, v in aux["acct_id_to_idx"].items()}
    rb_kind = out["rb_kind"][:n]
    slot_arr = np.asarray(ev["slot"][:n])
    running: dict[int, list] = {}  # acct idx -> [dp, dpos, cp, cpos, flags]

    def _running(idx: int) -> list:
        if idx not in running:
            running[idx] = [
                _u128_of(acct_in["dp_hi"], acct_in["dp_lo"], idx),
                _u128_of(acct_in["dpos_hi"], acct_in["dpos_lo"], idx),
                _u128_of(acct_in["cp_hi"], acct_in["cp_lo"], idx),
                _u128_of(acct_in["cpos_hi"], acct_in["cpos_lo"], idx),
                int(acct_in["flags"][idx]),
            ]
        return running[idx]

    for i in np.nonzero(created_mask)[0]:
        i = int(i)
        kind = int(rb_kind[i])  # 1 regular, 2 pending, 3 post, 4 void
        assert kind in (1, 2, 3, 4)
        # Stored-transfer fields live at the event's first-occurrence
        # slot (the batch store is slot-indexed); rb_* / r_* by event.
        sl = int(slot_arr[i])
        amt = _u128_of(out["s_amt_hi"], out["s_amt_lo"], sl)
        dr = _running(int(out["s_dr_idx"][sl]))
        cr = _running(int(out["s_cr_idx"][sl]))
        flags_t = int(flags[i])
        p = None
        if kind == 1:
            dr[1] += amt
            cr[3] += amt
        elif kind == 2:
            dr[0] += amt
            cr[2] += amt
            if flags_t & _F_CLOSE_DR:
                dr[4] |= _A_CLOSED
            if flags_t & _F_CLOSE_CR:
                cr[4] |= _A_CLOSED
        else:
            p = state.transfers[aux["event_pids"][i]]
            dr[0] -= p.amount
            cr[2] -= p.amount
            if kind == 3:
                dr[1] += amt
                cr[3] += amt
            else:
                if p.flags & _F_CLOSE_DR:
                    dr[4] &= ~_A_CLOSED
                if p.flags & _F_CLOSE_CR:
                    cr[4] &= ~_A_CLOSED
        pstatus = {
            1: TransferPendingStatus.none,
            2: TransferPendingStatus.pending,
            3: TransferPendingStatus.posted,
            4: TransferPendingStatus.voided,
        }[kind]
        dr_snap = dataclasses.replace(
            state.accounts[idx_to_id[int(out["s_dr_idx"][sl])]],
            debits_pending=dr[0], debits_posted=dr[1],
            credits_pending=dr[2], credits_posted=dr[3], flags=dr[4])
        cr_snap = dataclasses.replace(
            state.accounts[idx_to_id[int(out["s_cr_idx"][sl])]],
            debits_pending=cr[0], debits_posted=cr[1],
            credits_pending=cr[2], credits_posted=cr[3], flags=cr[4])
        state.account_events.append(AccountEventRecord(
            timestamp=int(r_ts[i]),
            dr_account=dr_snap,
            cr_account=cr_snap,
            transfer_flags=flags_t,
            transfer_pending_status=pstatus,
            transfer_pending=p,
            amount_requested=_u128_of(ev["amt_hi"], ev["amt_lo"], i),
            amount=amt,
        ))

    key_max = int(out["key_max"])
    state.transfers_key_max = key_max or None
    if created_mask.any():
        state.commit_timestamp = int(r_ts[np.nonzero(created_mask)[0][-1]])

    return [CreateTransferResult(timestamp=int(r_ts[i]),
                                 status=CreateTransferStatus(int(r_status[i])))
            for i in range(n)]


def apply_create_accounts(state, inputs, aux, out) -> list:
    """Apply a create_accounts kernel's outputs (numpy) to the host
    state."""
    n = aux["n"]
    r_status = np.asarray(out["r_status"][:n])
    r_ts = np.asarray(out["r_ts"][:n])
    event_ids = aux["event_ids"]

    for slot in np.nonzero(out["s_created"][:n])[0]:
        slot = int(slot)
        a = Account(
            id=event_ids[slot],
            user_data_128=_u128_of(out["s_ud128_hi"], out["s_ud128_lo"],
                                   slot),
            user_data_64=int(out["s_ud64"][slot]),
            user_data_32=int(out["s_ud32"][slot]),
            ledger=int(out["s_ledger"][slot]),
            code=int(out["s_code"][slot]),
            flags=int(out["s_flags"][slot]),
            timestamp=int(out["s_ts"][slot]),
        )
        state.accounts[a.id] = a
        state.account_by_timestamp[a.timestamp] = a.id
    key_max = int(out["key_max"])
    state.accounts_key_max = key_max or None
    created_mask = r_status == _CREATED
    if created_mask.any():
        state.commit_timestamp = int(r_ts[np.nonzero(created_mask)[0][-1]])

    return [CreateAccountResult(timestamp=int(r_ts[i]),
                                status=CreateAccountStatus(int(r_status[i])))
            for i in range(n)]
