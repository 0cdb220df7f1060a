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
twins, `create_transfers_seq_plain` / `create_accounts_seq_plain`: a
Python loop over the events on 0-d / 1-d CPU tensors, the JAX package's
`_ct_body` / `_ca_body` statement for statement. On the card the same
function is one hand-written CUDA kernel (`create_seq.py`,
`csrc/create_seq.cu`). Both return the same dict of tensors (the JAX
kernels' carry: u64 lanes as int64 bit patterns, u32 / i32 lanes
widened to int64, bool lanes as bool), which `apply_create_*` applies to
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
from .u64 import carrier, s64, ule, ult, umax

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


def _ct_init_state(tin: dict) -> dict:
    """The create_transfers kernel's carry, initialised (on the inputs'
    device): the mutable account cache, the batch store `s_*` indexed by
    slot, the committed pending statuses, the undo log `rb_*`, the
    scalars and the results."""
    ev, acct = tin["event"], tin["acct"]
    N = ev["id_lo"].shape[0]
    dev = ev["id_lo"].device

    def z():
        return torch.zeros(N, dtype=torch.int64, device=dev)

    def zb():
        return torch.zeros(N, dtype=torch.bool, device=dev)

    st = {f"a_{k}": acct[k].clone() for k in (
        "dp_hi", "dp_lo", "dpos_hi", "dpos_lo", "cp_hi", "cp_lo",
        "cpos_hi", "cpos_lo", "flags")}
    for k, dt in CT_OUT_DTYPES.items():
        if k.startswith(("s_", "rb_", "r_")):
            st[k] = zb() if dt == _B else z()
    st["tc_pstat"] = tin["tc"]["pending_status"].clone()
    st["key_max"] = _scalar(tin["transfers_key_max"], dev)
    # pulse_next_timestamp is NOT restored on chain rollback (it is
    # state-machine state, not groove state — see the oracle's _Scope).
    st["pulse_next"] = _scalar(tin["pulse_next"], dev)
    st["chain_start"] = _scalar(-1, dev)
    st["chain_broken"] = torch.zeros((), dtype=torch.bool, device=dev)
    st["chain_key_max"] = _scalar(0, dev)
    return st


def _ca_init_state(tin: dict) -> dict:
    ev = tin["event"]
    N = ev["id_lo"].shape[0]
    dev = ev["id_lo"].device
    st = {}
    for k, dt in CA_OUT_DTYPES.items():
        if k.startswith(("s_", "r_")):
            st[k] = torch.zeros(N, dtype=torch.bool if dt == _B
                                else torch.int64, device=dev)
    st["key_max"] = _scalar(tin["accounts_key_max"], dev)
    st["chain_start"] = _scalar(-1, dev)
    st["chain_broken"] = torch.zeros((), dtype=torch.bool, device=dev)
    st["chain_key_max"] = _scalar(0, dev)
    return st


# ================================= create_transfers: the plain twin

def _limb_add_at(st, hi_key, lo_key, idx: int, d_hi, d_lo, mask):
    """Masked u128 read-modify-write add at st[hi_key/lo_key][idx]."""
    h, l, _ = u128.add(st[hi_key][idx], st[lo_key][idx], d_hi, d_lo)
    st[hi_key][idx] = torch.where(mask, h, st[hi_key][idx])
    st[lo_key][idx] = torch.where(mask, l, st[lo_key][idx])


def _limb_sub_at(st, hi_key, lo_key, idx: int, d_hi, d_lo, mask):
    """Masked u128 read-modify-write subtract at st[hi_key/lo_key][idx]."""
    h, l = u128.sub(st[hi_key][idx], st[lo_key][idx], d_hi, d_lo)
    st[hi_key][idx] = torch.where(mask, h, st[hi_key][idx])
    st[lo_key][idx] = torch.where(mask, l, st[lo_key][idx])


def _acct_row(st, tin, idx: int) -> dict:
    """One account-cache row: balances and flags as they stand now
    (copied: the carry is updated in place later in the event), the rest
    as prefetched."""
    acct = tin["acct"]
    row = {k: st[f"a_{k}"][idx].clone() for k in (
        "dp_hi", "dp_lo", "dpos_hi", "dpos_lo", "cp_hi", "cp_lo",
        "cpos_hi", "cpos_lo", "flags")}
    for k in ("exists", "ledger", "code", "ts"):
        row[k] = acct[k][idx]
    return row


_P_FIELDS = (
    "amt_hi", "amt_lo", "dr_hi", "dr_lo", "cr_hi", "cr_lo",
    "ud128_hi", "ud128_lo", "ud64", "ud32", "timeout", "ledger", "code",
    "flags", "ts", "dr_idx", "cr_idx", "pid_hi", "pid_lo",
)


def _transfer_row(st, tin, from_cache, cache_idx: int, slot: int) -> dict:
    """A stored transfer from either the committed cache or the batch
    store (reference: grooves.transfers.get, src/state_machine.zig:3734)."""
    ci, sl = max(cache_idx, 0), max(slot, 0)
    tc = tin["tc"]
    row = {f: torch.where(from_cache, tc[f][ci], st[f"s_{f}"][sl])
           for f in _P_FIELDS}
    row["pstat"] = torch.where(from_cache, st["tc_pstat"][ci],
                               st["s_pstat"][sl])
    row["expires"] = torch.where(from_cache, tc["expires_at"][ci],
                                 st["s_expires"][sl])
    return row


def _ct_body(tin, i: int, st) -> None:
    """Event i of a create_transfers batch: the JAX package's `_ct_body`,
    statement for statement, updating the carry `st` in place."""
    evs = tin["event"]
    ev = {k: v[i] for k, v in evs.items()}
    n = tin["n_events"]
    timestamp = _scalar(tin["timestamp"], "cpu")
    timestamp_event = _scalar(tin["timestamp"] - n + i + 1, "cpu")
    valid = ev["valid"]

    linked = _flag(ev["flags"], _F_LINKED)
    imported = _flag(ev["flags"], _F_IMPORTED)
    is_post = _flag(ev["flags"], _F_POST)
    is_void = _flag(ev["flags"], _F_VOID)
    pv = is_post | is_void
    pending = _flag(ev["flags"], _F_PENDING)
    batch_imported = _flag(evs["flags"][0], _F_IMPORTED) & (n > 0)

    # --- chain open (reference :3033-3043) ---
    chain_active = st["chain_start"] >= 0
    opening = linked & ~chain_active & valid
    st["chain_start"] = torch.where(opening, i, st["chain_start"])
    st["chain_key_max"] = torch.where(opening, st["key_max"],
                                      st["chain_key_max"])
    chain_active = chain_active | opening

    # --- transfer lookup: committed cache / orphan / batch store ---
    slot = int(ev["slot"])
    e_from_cache = ev["exists_idx"] >= 0
    e_from_batch = ~e_from_cache & st["s_created"][slot]
    e_found = e_from_cache | e_from_batch
    orphan = ev["orphaned"] | st["s_orphaned"][slot]
    e_row = _transfer_row(st, tin, e_from_cache, int(ev["exists_idx"]),
                          slot)

    # --- pending transfer lookup ---
    p_from_cache = ev["pending_cache_idx"] >= 0
    psl = max(int(ev["pending_slot"]), 0)
    pci = max(int(ev["pending_cache_idx"]), 0)
    p_from_batch = (~p_from_cache & (ev["pending_slot"] >= 0)
                    & st["s_created"][psl])
    p_found = p_from_cache | p_from_batch
    p_row = _transfer_row(st, tin, p_from_cache,
                          int(ev["pending_cache_idx"]),
                          int(ev["pending_slot"]))
    p_dr_idx, p_cr_idx = int(p_row["dr_idx"]), int(p_row["cr_idx"])
    p_dr = _acct_row(st, tin, p_dr_idx)
    p_cr = _acct_row(st, tin, p_cr_idx)
    dr_idx, cr_idx = int(ev["dr_idx"]), int(ev["cr_idx"])
    dr = _acct_row(st, tin, dr_idx)
    cr = _acct_row(st, tin, cr_idx)

    exists_status, exists_ts = _ct_eval_exists(ev, e_row, p_row)

    id_zero = u128.is_zero(ev["id_hi"], ev["id_lo"])
    id_max = u128.is_max(ev["id_hi"], ev["id_lo"])
    pid_zero = u128.is_zero(ev["pid_hi"], ev["pid_lo"])
    pid_max = u128.is_max(ev["pid_hi"], ev["pid_lo"])

    # ---------------- post/void path (reference :4053-4299) ----------------
    pv_amt_hi, pv_amt_lo = u128.select(
        torch.where(is_void, u128.is_zero(ev["amt_hi"], ev["amt_lo"]),
                    u128.is_max(ev["amt_hi"], ev["amt_lo"])),
        p_row["amt_hi"], p_row["amt_lo"], ev["amt_hi"], ev["amt_lo"])
    p_expires_due = (p_row["timeout"] != 0) & ule(p_row["expires"],
                                                  timestamp_event)
    pv_regress = imported & (ule(ev["ts"], st["key_max"])
                             | ev["acct_ts_collision"])
    pv_ts_actual = torch.where(imported, ev["ts"], timestamp_event)
    pv_checks = [
        (is_post & is_void, _TS["flags_are_mutually_exclusive"]),
        (pending | _flag(ev["flags"], _F_BAL_DR)
         | _flag(ev["flags"], _F_BAL_CR) | _flag(ev["flags"], _F_CLOSE_DR)
         | _flag(ev["flags"], _F_CLOSE_CR),
         _TS["flags_are_mutually_exclusive"]),
        (pid_zero, _TS["pending_id_must_not_be_zero"]),
        (pid_max, _TS["pending_id_must_not_be_int_max"]),
        (u128.eq(ev["pid_hi"], ev["pid_lo"], ev["id_hi"], ev["id_lo"]),
         _TS["pending_id_must_be_different"]),
        (ev["timeout"] != 0, _TS["timeout_reserved_for_pending_transfer"]),
        (~p_found, _TS["pending_transfer_not_found"]),
        (~_flag(p_row["flags"], _F_PENDING),
         _TS["pending_transfer_not_pending"]),
        (~u128.is_zero(ev["dr_hi"], ev["dr_lo"])
         & ~u128.eq(ev["dr_hi"], ev["dr_lo"], p_row["dr_hi"],
                    p_row["dr_lo"]),
         _TS["pending_transfer_has_different_debit_account_id"]),
        (~u128.is_zero(ev["cr_hi"], ev["cr_lo"])
         & ~u128.eq(ev["cr_hi"], ev["cr_lo"], p_row["cr_hi"],
                    p_row["cr_lo"]),
         _TS["pending_transfer_has_different_credit_account_id"]),
        ((ev["ledger"] != 0) & (ev["ledger"] != p_row["ledger"]),
         _TS["pending_transfer_has_different_ledger"]),
        ((ev["code"] != 0) & (ev["code"] != p_row["code"]),
         _TS["pending_transfer_has_different_code"]),
        (u128.lt(p_row["amt_hi"], p_row["amt_lo"], pv_amt_hi, pv_amt_lo),
         _TS["exceeds_pending_transfer_amount"]),
        (is_void & u128.lt(pv_amt_hi, pv_amt_lo, p_row["amt_hi"],
                           p_row["amt_lo"]),
         _TS["pending_transfer_has_different_amount"]),
        (p_row["pstat"] == _PS_POSTED, _TS["pending_transfer_already_posted"]),
        (p_row["pstat"] == _PS_VOIDED,
         _TS["pending_transfer_already_voided"]),
        (p_row["pstat"] == _PS_EXPIRED, _TS["pending_transfer_expired"]),
        (p_expires_due, _TS["pending_transfer_expired"]),
        (pv_regress, _TS["imported_event_timestamp_must_not_regress"]),
        (_flag(p_dr["flags"], _A_CLOSED) & ~is_void,
         _TS["debit_account_already_closed"]),
        (_flag(p_cr["flags"], _A_CLOSED) & ~is_void,
         _TS["credit_account_already_closed"]),
    ]
    pv_status = _first_failure(pv_checks)

    # ---------------- regular path (reference :3748-3904) ----------------
    dr_zero = u128.is_zero(ev["dr_hi"], ev["dr_lo"])
    dr_max = u128.is_max(ev["dr_hi"], ev["dr_lo"])
    cr_zero = u128.is_zero(ev["cr_hi"], ev["cr_lo"])
    cr_max = u128.is_max(ev["cr_hi"], ev["cr_lo"])
    same_acct = u128.eq(ev["dr_hi"], ev["dr_lo"], ev["cr_hi"], ev["cr_lo"])

    reg_regress = imported & (ule(ev["ts"], st["key_max"])
                              | ev["acct_ts_collision"])
    reg_ts_actual = torch.where(imported, ev["ts"], timestamp_event)

    # Balancing clamp (reference :3840-3853).
    amt_hi, amt_lo = ev["amt_hi"], ev["amt_lo"]
    dr_bal_hi, dr_bal_lo, _ = u128.add(dr["dpos_hi"], dr["dpos_lo"],
                                       dr["dp_hi"], dr["dp_lo"])
    dr_avail_hi, dr_avail_lo = u128.sat_sub(dr["cpos_hi"], dr["cpos_lo"],
                                            dr_bal_hi, dr_bal_lo)
    bal_dr_hi, bal_dr_lo = u128.min_(amt_hi, amt_lo, dr_avail_hi,
                                     dr_avail_lo)
    amt_hi, amt_lo = u128.select(_flag(ev["flags"], _F_BAL_DR), bal_dr_hi,
                                 bal_dr_lo, amt_hi, amt_lo)
    cr_bal_hi, cr_bal_lo, _ = u128.add(cr["cpos_hi"], cr["cpos_lo"],
                                       cr["cp_hi"], cr["cp_lo"])
    cr_avail_hi, cr_avail_lo = u128.sat_sub(cr["dpos_hi"], cr["dpos_lo"],
                                            cr_bal_hi, cr_bal_lo)
    bal_cr_hi, bal_cr_lo = u128.min_(amt_hi, amt_lo, cr_avail_hi,
                                     cr_avail_lo)
    amt_hi, amt_lo = u128.select(_flag(ev["flags"], _F_BAL_CR), bal_cr_hi,
                                 bal_cr_lo, amt_hi, amt_lo)

    # Overflow checks (reference :3856-3901).
    _, _, ovf_dp = u128.add(amt_hi, amt_lo, dr["dp_hi"], dr["dp_lo"])
    _, _, ovf_cp = u128.add(amt_hi, amt_lo, cr["cp_hi"], cr["cp_lo"])
    _, _, ovf_dpos = u128.add(amt_hi, amt_lo, dr["dpos_hi"], dr["dpos_lo"])
    _, _, ovf_cpos = u128.add(amt_hi, amt_lo, cr["cpos_hi"], cr["cpos_lo"])
    _, _, ovf_d = u128.add3(amt_hi, amt_lo, dr["dp_hi"], dr["dp_lo"],
                            dr["dpos_hi"], dr["dpos_lo"])
    _, _, ovf_c = u128.add3(amt_hi, amt_lo, cr["cp_hi"], cr["cp_lo"],
                            cr["cpos_hi"], cr["cpos_lo"])
    timeout_ns = ev["timeout"] * _NSPS
    ovf_timeout = ult(_scalar(_U63, "cpu"), reg_ts_actual + timeout_ns)

    # Balance limits (reference tigerbeetle.zig:34-42).
    dr_tot_hi, dr_tot_lo, _ = u128.add3(dr["dp_hi"], dr["dp_lo"],
                                        dr["dpos_hi"], dr["dpos_lo"],
                                        amt_hi, amt_lo)
    exceeds_credits = _flag(dr["flags"], _A_DR_LIMIT) & u128.lt(
        dr["cpos_hi"], dr["cpos_lo"], dr_tot_hi, dr_tot_lo)
    cr_tot_hi, cr_tot_lo, _ = u128.add3(cr["cp_hi"], cr["cp_lo"],
                                        cr["cpos_hi"], cr["cpos_lo"],
                                        amt_hi, amt_lo)
    exceeds_debits = _flag(cr["flags"], _A_CR_LIMIT) & u128.lt(
        cr["dpos_hi"], cr["dpos_lo"], cr_tot_hi, cr_tot_lo)

    close_flags = (_flag(ev["flags"], _F_CLOSE_DR)
                   | _flag(ev["flags"], _F_CLOSE_CR))
    reg_checks = [
        (dr_zero, _TS["debit_account_id_must_not_be_zero"]),
        (dr_max, _TS["debit_account_id_must_not_be_int_max"]),
        (cr_zero, _TS["credit_account_id_must_not_be_zero"]),
        (cr_max, _TS["credit_account_id_must_not_be_int_max"]),
        (same_acct, _TS["accounts_must_be_different"]),
        (~pid_zero, _TS["pending_id_must_be_zero"]),
        (~pending & (ev["timeout"] != 0),
         _TS["timeout_reserved_for_pending_transfer"]),
        (~pending & close_flags, _TS["closing_transfer_must_be_pending"]),
        (ev["ledger"] == 0, _TS["ledger_must_not_be_zero"]),
        (ev["code"] == 0, _TS["code_must_not_be_zero"]),
        (~dr["exists"], _TS["debit_account_not_found"]),
        (~cr["exists"], _TS["credit_account_not_found"]),
        (dr["ledger"] != cr["ledger"],
         _TS["accounts_must_have_the_same_ledger"]),
        (ev["ledger"] != dr["ledger"],
         _TS["transfer_must_have_the_same_ledger_as_accounts"]),
        (reg_regress, _TS["imported_event_timestamp_must_not_regress"]),
        (imported & ule(ev["ts"], dr["ts"]),
         _TS["imported_event_timestamp_must_postdate_debit_account"]),
        (imported & ule(ev["ts"], cr["ts"]),
         _TS["imported_event_timestamp_must_postdate_credit_account"]),
        (imported & (ev["timeout"] != 0),
         _TS["imported_event_timeout_must_be_zero"]),
        (_flag(dr["flags"], _A_CLOSED), _TS["debit_account_already_closed"]),
        (_flag(cr["flags"], _A_CLOSED),
         _TS["credit_account_already_closed"]),
        (pending & ovf_dp, _TS["overflows_debits_pending"]),
        (pending & ovf_cp, _TS["overflows_credits_pending"]),
        (ovf_dpos, _TS["overflows_debits_posted"]),
        (ovf_cpos, _TS["overflows_credits_posted"]),
        (ovf_d, _TS["overflows_debits"]),
        (ovf_c, _TS["overflows_credits"]),
        (ovf_timeout, _TS["overflows_timeout"]),
        (exceeds_credits, _TS["exceeds_credits"]),
        (exceeds_debits, _TS["exceeds_debits"]),
    ]
    reg_status = _first_failure(reg_checks)

    # ------- combine the three evaluation paths (reference :3729-3746) -------
    inner_status = torch.where(
        e_found, exists_status,
        torch.where(orphan, _TS["id_already_failed"],
                    torch.where(pv, pv_status, reg_status)))
    pre_status = _first_failure([
        ((ev["flags"] & _TF_PADDING) != 0, _TS["reserved_flag"]),
        (id_zero, _TS["id_must_not_be_zero"]),
        (id_max, _TS["id_must_not_be_int_max"]),
    ])
    inner_status = torch.where(pre_status != _CREATED, pre_status,
                               inner_status)

    ts_actual_inner = torch.where(
        e_found & (inner_status == _TS["exists"]), exists_ts,
        torch.where(inner_status == _CREATED,
                    torch.where(pv, pv_ts_actual, reg_ts_actual),
                    timestamp_event))

    # ------- wrapper checks (reference execute_create :3033-3104) -------
    ts_valid = ule(_scalar(1, "cpu"), ev["ts"]) & ule(ev["ts"],
                                                      _scalar(_U63, "cpu"))
    status = inner_status
    status = torch.where(~imported & (ev["ts"] != 0),
                         _TS["timestamp_must_be_zero"], status)
    status = torch.where(imported & ts_valid & ule(timestamp, ev["ts"]),
                         _TS["imported_event_timestamp_must_not_advance"],
                         status)
    status = torch.where(imported & ~ts_valid,
                         _TS["imported_event_timestamp_out_of_range"], status)
    status = torch.where(imported != batch_imported,
                         torch.where(imported,
                                     _TS["imported_event_not_expected"],
                                     _TS["imported_event_expected"]), status)
    status = torch.where(st["chain_broken"], _TS["linked_event_failed"],
                         status)
    status = torch.where(linked & (i == n - 1),
                         _TS["linked_event_chain_open"], status)

    ts_actual = torch.where(status == inner_status, ts_actual_inner,
                            timestamp_event)

    # ---------------- application (masked) ----------------
    created = (status == _CREATED) & valid
    ap_pv = created & pv
    ap_reg = created & ~pv
    ap_pending = ap_reg & pending

    f_amt_hi = torch.where(pv, pv_amt_hi, amt_hi)
    f_amt_lo = torch.where(pv, pv_amt_lo, amt_lo)
    f_ts = torch.where(pv, pv_ts_actual, reg_ts_actual)

    # Regular/pending application (reference :3909-3985).
    _limb_add_at(st, "a_dp_hi", "a_dp_lo", dr_idx, f_amt_hi, f_amt_lo,
                 ap_pending)
    _limb_add_at(st, "a_cp_hi", "a_cp_lo", cr_idx, f_amt_hi, f_amt_lo,
                 ap_pending)
    _limb_add_at(st, "a_dpos_hi", "a_dpos_lo", dr_idx, f_amt_hi, f_amt_lo,
                 ap_reg & ~pending)
    _limb_add_at(st, "a_cpos_hi", "a_cpos_lo", cr_idx, f_amt_hi, f_amt_lo,
                 ap_reg & ~pending)

    s_dr_idx = p_dr_idx if bool(pv) else dr_idx
    s_cr_idx = p_cr_idx if bool(pv) else cr_idx
    rb_dr_closed = _flag(st["a_flags"][s_dr_idx], _A_CLOSED)
    rb_cr_closed = _flag(st["a_flags"][s_cr_idx], _A_CLOSED)

    close_dr = ap_reg & _flag(ev["flags"], _F_CLOSE_DR)
    close_cr = ap_reg & _flag(ev["flags"], _F_CLOSE_CR)
    a_flags = st["a_flags"]
    a_flags[dr_idx] = torch.where(close_dr, a_flags[dr_idx] | _A_CLOSED,
                                  a_flags[dr_idx])
    a_flags[cr_idx] = torch.where(close_cr, a_flags[cr_idx] | _A_CLOSED,
                                  a_flags[cr_idx])

    # Post/void application (reference :4195-4283).
    _limb_sub_at(st, "a_dp_hi", "a_dp_lo", p_dr_idx, p_row["amt_hi"],
                 p_row["amt_lo"], ap_pv)
    _limb_sub_at(st, "a_cp_hi", "a_cp_lo", p_cr_idx, p_row["amt_hi"],
                 p_row["amt_lo"], ap_pv)
    _limb_add_at(st, "a_dpos_hi", "a_dpos_lo", p_dr_idx, f_amt_hi, f_amt_lo,
                 ap_pv & is_post)
    _limb_add_at(st, "a_cpos_hi", "a_cpos_lo", p_cr_idx, f_amt_hi, f_amt_lo,
                 ap_pv & is_post)
    reopen_dr = ap_pv & is_void & _flag(p_row["flags"], _F_CLOSE_DR)
    reopen_cr = ap_pv & is_void & _flag(p_row["flags"], _F_CLOSE_CR)
    a_flags[p_dr_idx] = torch.where(reopen_dr,
                                    a_flags[p_dr_idx] & ~_A_CLOSED,
                                    a_flags[p_dr_idx])
    a_flags[p_cr_idx] = torch.where(reopen_cr,
                                    a_flags[p_cr_idx] & ~_A_CLOSED,
                                    a_flags[p_cr_idx])

    # Flip p's pending status (reference :4233-4238).
    new_pstat = torch.where(is_post, _PS_POSTED, _PS_VOIDED)
    st["tc_pstat"][pci] = torch.where(ap_pv & p_from_cache, new_pstat,
                                      st["tc_pstat"][pci])
    st["s_pstat"][psl] = torch.where(ap_pv & ~p_from_cache, new_pstat,
                                     st["s_pstat"][psl])

    # Insert the stored transfer into the batch store at `slot`.
    ud128_zero = u128.is_zero(ev["ud128_hi"], ev["ud128_lo"])
    stores = dict(
        amt_hi=f_amt_hi, amt_lo=f_amt_lo,
        dr_idx=torch.where(pv, p_row["dr_idx"], ev["dr_idx"]),
        cr_idx=torch.where(pv, p_row["cr_idx"], ev["cr_idx"]),
        dr_hi=torch.where(pv, p_row["dr_hi"], ev["dr_hi"]),
        dr_lo=torch.where(pv, p_row["dr_lo"], ev["dr_lo"]),
        cr_hi=torch.where(pv, p_row["cr_hi"], ev["cr_hi"]),
        cr_lo=torch.where(pv, p_row["cr_lo"], ev["cr_lo"]),
        pid_hi=ev["pid_hi"], pid_lo=ev["pid_lo"],
        ud128_hi=torch.where(pv & ud128_zero, p_row["ud128_hi"],
                             ev["ud128_hi"]),
        ud128_lo=torch.where(pv & ud128_zero, p_row["ud128_lo"],
                             ev["ud128_lo"]),
        ud64=torch.where(pv & (ev["ud64"] == 0), p_row["ud64"], ev["ud64"]),
        ud32=torch.where(pv & (ev["ud32"] == 0), p_row["ud32"], ev["ud32"]),
        timeout=torch.where(pv, 0, ev["timeout"]),
        ledger=torch.where(pv, p_row["ledger"], ev["ledger"]),
        code=torch.where(pv, p_row["code"], ev["code"]),
        flags=ev["flags"],
        ts=f_ts,
        pstat=torch.where(ap_pending, _PS_PENDING, 0),
        expires=torch.where(ap_pending & (ev["timeout"] != 0),
                            f_ts + timeout_ns, 0),
    )
    for k, v in stores.items():
        st[f"s_{k}"][slot] = torch.where(created, v, st[f"s_{k}"][slot])
    st["s_created"][slot] = st["s_created"][slot] | created

    st["key_max"] = torch.where(created, umax(st["key_max"], f_ts),
                                st["key_max"])

    # Pulse scheduling (reference :3975-3981 add, :4227-4230 remove-reset).
    expires_new = f_ts + timeout_ns
    st["pulse_next"] = torch.where(
        ap_pending & (ev["timeout"] != 0)
        & ult(expires_new, st["pulse_next"]),
        expires_new, st["pulse_next"])
    st["pulse_next"] = torch.where(
        ap_pv & (p_row["timeout"] != 0)
        & (st["pulse_next"] == p_row["expires"]),
        1, st["pulse_next"])

    # Undo log record.
    st["rb_kind"][i] = torch.where(
        ~created, 0, torch.where(is_post, 3, torch.where(
            is_void, 4, torch.where(pending, 2, 1))))
    st["rb_dr_idx"][i] = s_dr_idx
    st["rb_cr_idx"][i] = s_cr_idx
    st["rb_amt_hi"][i] = f_amt_hi
    st["rb_amt_lo"][i] = f_amt_lo
    st["rb_pamt_hi"][i] = p_row["amt_hi"]
    st["rb_pamt_lo"][i] = p_row["amt_lo"]
    st["rb_p_batch"][i] = ~p_from_cache
    st["rb_p_idx"][i] = pci if bool(p_from_cache) else psl
    st["rb_dr_closed"][i] = rb_dr_closed
    st["rb_cr_closed"][i] = rb_cr_closed

    # Orphan transient failures (reference transient_error :3215-3252).
    transient = torch.zeros((), dtype=torch.bool)
    for code in _TRANSIENT_CODES:
        transient = transient | (status == code)
    st["s_orphaned"][slot] = st["s_orphaned"][slot] | (transient & valid)

    # Results.
    st["r_ts"][i] = torch.where(valid, ts_actual, st["r_ts"][i])
    st["r_status"][i] = torch.where(valid, status, st["r_status"][i])

    # ------- chain break: roll back the applied prefix (reference :3116-3150)
    breaking = (status != _CREATED) & chain_active & ~st["chain_broken"] \
        & valid
    count = i - max(int(st["chain_start"]), 0) if bool(breaking) else 0
    for k in range(count):
        _ct_rollback(tin, st, i - 1 - k)
    st["key_max"] = torch.where(breaking, st["chain_key_max"], st["key_max"])
    st["chain_broken"] = st["chain_broken"] | breaking

    # Chain close (reference :3196-3207).
    closing = chain_active & (~linked
                              | (status == _TS["linked_event_chain_open"]))
    st["chain_start"] = torch.where(closing, -1, st["chain_start"])
    st["chain_broken"] = torch.where(closing, False, st["chain_broken"])


def _ct_rollback(tin, st, j: int) -> None:
    """Undo chain member j. LIFO: balance undos are deltas, but the
    closed bits and pending statuses are absolute pre-event snapshots,
    so members unwind newest-first (two members touching one account's
    closed bit — close, then void-reopen — would otherwise resurrect the
    wrong snapshot)."""
    kind = st["rb_kind"][j].clone()
    applied = kind > 0
    a_hi, a_lo = st["rb_amt_hi"][j], st["rb_amt_lo"][j]
    pa_hi, pa_lo = st["rb_pamt_hi"][j], st["rb_pamt_lo"][j]
    dri, cri = int(st["rb_dr_idx"][j]), int(st["rb_cr_idx"][j])
    posted = applied & ((kind == 1) | (kind == 3))
    was_pv = applied & ((kind == 3) | (kind == 4))

    _limb_sub_at(st, "a_dpos_hi", "a_dpos_lo", dri, a_hi, a_lo, posted)
    _limb_sub_at(st, "a_cpos_hi", "a_cpos_lo", cri, a_hi, a_lo, posted)
    _limb_sub_at(st, "a_dp_hi", "a_dp_lo", dri, a_hi, a_lo,
                 applied & (kind == 2))
    _limb_sub_at(st, "a_cp_hi", "a_cp_lo", cri, a_hi, a_lo,
                 applied & (kind == 2))
    _limb_add_at(st, "a_dp_hi", "a_dp_lo", dri, pa_hi, pa_lo, was_pv)
    _limb_add_at(st, "a_cp_hi", "a_cp_lo", cri, pa_hi, pa_lo, was_pv)

    # Restore closed bits to their pre-event values.
    a_flags = st["a_flags"]
    for idx, prev_key in ((dri, "rb_dr_closed"), (cri, "rb_cr_closed")):
        prev = st[prev_key][j]
        cur = a_flags[idx]
        restored = torch.where(prev, cur | _A_CLOSED, cur & ~_A_CLOSED)
        a_flags[idx] = torch.where(applied, restored, cur)

    # Restore p's pending status to pending for post/void.
    p_idx = int(st["rb_p_idx"][j])
    p_batch = st["rb_p_batch"][j]
    st["tc_pstat"][p_idx] = torch.where(was_pv & ~p_batch, _PS_PENDING,
                                        st["tc_pstat"][p_idx])
    st["s_pstat"][p_idx] = torch.where(was_pv & p_batch, _PS_PENDING,
                                       st["s_pstat"][p_idx])

    # Un-create and rewrite the result status (FIFO, reference :3123-3145).
    slot_j = int(tin["event"]["slot"][j])
    st["s_created"][slot_j] = torch.where(applied, False,
                                          st["s_created"][slot_j])
    st["rb_kind"][j] = 0
    st["r_status"][j] = _TS["linked_event_failed"]


def create_transfers_seq_plain(tin: dict) -> dict:
    """The create_transfers sequential kernel, plain: every event of the
    padded batch in order (the JAX package's `create_transfers_kernel`).
    `tin` is `inputs_to_device(prefetch...)` on the CPU."""
    st = _ct_init_state(tin)
    for i in range(tin["event"]["id_lo"].shape[0]):
        _ct_body(tin, i, st)
    return st


# ================================== create_accounts: the plain twin

def _ca_body(tin, i: int, st) -> None:
    """Event i of a create_accounts batch: the JAX package's `_ca_body`."""
    evs = tin["event"]
    ev = {k: v[i] for k, v in evs.items()}
    n = tin["n_events"]
    timestamp = _scalar(tin["timestamp"], "cpu")
    timestamp_event = _scalar(tin["timestamp"] - n + i + 1, "cpu")
    valid = ev["valid"]

    linked = _flag(ev["flags"], _A_LINKED)
    imported = _flag(ev["flags"], _A_IMPORTED)
    batch_imported = _flag(evs["flags"][0], _A_IMPORTED) & (n > 0)

    chain_active = st["chain_start"] >= 0
    opening = linked & ~chain_active & valid
    st["chain_start"] = torch.where(opening, i, st["chain_start"])
    st["chain_key_max"] = torch.where(opening, st["key_max"],
                                      st["chain_key_max"])
    chain_active = chain_active | opening

    slot = int(ev["slot"])
    e_from_cache = ev["exists_idx"] >= 0
    e_from_batch = ~e_from_cache & st["s_created"][slot]
    e_found = e_from_cache | e_from_batch
    ci = max(int(ev["exists_idx"]), 0)
    ac = tin["ac"]

    def e_field(name):
        return torch.where(e_from_cache, ac[name][ci], st[f"s_{name}"][slot])

    # create_account_exists (reference :3691-3703).
    exists_checks = [
        ((ev["flags"] & 0xFFFF) != (e_field("flags") & 0xFFFF),
         _AS["exists_with_different_flags"]),
        (~u128.eq(ev["ud128_hi"], ev["ud128_lo"], e_field("ud128_hi"),
                  e_field("ud128_lo")),
         _AS["exists_with_different_user_data_128"]),
        (ev["ud64"] != e_field("ud64"),
         _AS["exists_with_different_user_data_64"]),
        (ev["ud32"] != e_field("ud32"),
         _AS["exists_with_different_user_data_32"]),
        (ev["ledger"] != e_field("ledger"),
         _AS["exists_with_different_ledger"]),
        (ev["code"] != e_field("code"), _AS["exists_with_different_code"]),
    ]
    exists_status = _first_failure(exists_checks, created=_AS["exists"])
    exists_ts = e_field("ts")

    regress = imported & (((st["key_max"] != 0)
                           & ule(ev["ts"], st["key_max"]))
                          | ev["transfer_ts_collision"])
    ts_actual_created = torch.where(imported, ev["ts"], timestamp_event)

    # create_account (reference :3613-3689); the 0 code stands in for
    # exists_status below.
    checks = [
        (ev["reserved"] != 0, _AS["reserved_field"]),
        ((ev["flags"] & _AF_PADDING) != 0, _AS["reserved_flag"]),
        (u128.is_zero(ev["id_hi"], ev["id_lo"]), _AS["id_must_not_be_zero"]),
        (u128.is_max(ev["id_hi"], ev["id_lo"]),
         _AS["id_must_not_be_int_max"]),
        (e_found, 0),
        (_flag(ev["flags"], _A_DR_LIMIT) & _flag(ev["flags"], _A_CR_LIMIT),
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
        (regress, _AS["imported_event_timestamp_must_not_regress"]),
    ]
    inner_status = _first_failure(checks)
    inner_status = torch.where(inner_status == 0, exists_status,
                               inner_status)

    ts_actual_inner = torch.where(
        inner_status == _AS["exists"], exists_ts,
        torch.where(inner_status == _CREATED, ts_actual_created,
                    timestamp_event))

    ts_valid = ule(_scalar(1, "cpu"), ev["ts"]) & ule(ev["ts"],
                                                      _scalar(_U63, "cpu"))
    status = inner_status
    status = torch.where(~imported & (ev["ts"] != 0),
                         _AS["timestamp_must_be_zero"], status)
    status = torch.where(imported & ts_valid & ule(timestamp, ev["ts"]),
                         _AS["imported_event_timestamp_must_not_advance"],
                         status)
    status = torch.where(imported & ~ts_valid,
                         _AS["imported_event_timestamp_out_of_range"], status)
    status = torch.where(imported != batch_imported,
                         torch.where(imported,
                                     _AS["imported_event_not_expected"],
                                     _AS["imported_event_expected"]), status)
    status = torch.where(st["chain_broken"], _AS["linked_event_failed"],
                         status)
    status = torch.where(linked & (i == n - 1),
                         _AS["linked_event_chain_open"], status)
    ts_actual = torch.where(status == inner_status, ts_actual_inner,
                            timestamp_event)

    created = (status == _CREATED) & valid
    for name in ("ud128_hi", "ud128_lo", "ud64", "ud32", "ledger", "code",
                 "flags"):
        st[f"s_{name}"][slot] = torch.where(created, ev[name],
                                            st[f"s_{name}"][slot])
    st["s_ts"][slot] = torch.where(created, ts_actual_created,
                                   st["s_ts"][slot])
    st["s_created"][slot] = st["s_created"][slot] | created
    st["key_max"] = torch.where(created,
                                umax(st["key_max"], ts_actual_created),
                                st["key_max"])

    st["r_ts"][i] = torch.where(valid, ts_actual, st["r_ts"][i])
    st["r_status"][i] = torch.where(valid, status, st["r_status"][i])

    breaking = (status != _CREATED) & chain_active & ~st["chain_broken"] \
        & valid
    if bool(breaking):
        for j in range(max(int(st["chain_start"]), 0), i):
            st["s_created"][int(evs["slot"][j])] = False
            st["r_status"][j] = _AS["linked_event_failed"]
    st["key_max"] = torch.where(breaking, st["chain_key_max"], st["key_max"])
    st["chain_broken"] = st["chain_broken"] | breaking

    closing = chain_active & (~linked
                              | (status == _AS["linked_event_chain_open"]))
    st["chain_start"] = torch.where(closing, -1, st["chain_start"])
    st["chain_broken"] = torch.where(closing, False, st["chain_broken"])


def create_accounts_seq_plain(tin: dict) -> dict:
    """The create_accounts sequential kernel, plain (the JAX package's
    `create_accounts_kernel`)."""
    st = _ca_init_state(tin)
    for i in range(tin["event"]["id_lo"].shape[0]):
        _ca_body(tin, i, st)
    return st


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
