"""Host-side packing of event objects into SoA numpy arrays, and the
prefetch that builds the sequential kernels' inputs (a port of the JAX
package's `ops/batch.py`).

The arrays keep the JAX package's host dtypes (u64 limbs as uint64, the
32-bit fields as uint32), so one dict feeds either ledger; the device
side converts them to its int64 carriers (`ledger.events_to_device`,
`create_kernels.inputs_to_device`).

Prefetch (reference: src/state_machine.zig:1146-1226, the prefetch
fan-out; src/lsm/groove.zig:996-1450) loads every object a batch could
touch from a host state into caches, so the sequential kernel never
needs a hash lookup: an account cache (the batch's dr/cr accounts and
those of the committed transfers it references), a committed-transfer
cache (rows for event ids, the exists path, and pending ids, the
post/void path), and per-event indexes into both plus the in-batch
first-occurrence slots. The state is anything with the oracle's
`.accounts` / `.transfers` / `.orphaned` / `.pending_status` /
`.transfers_key_max` / `.account_by_timestamp` containers (the port's
`StateMachineOracle`). Every shape is bucketed to a power of two as in
the JAX package (there to bound recompiles), so both packages' prefetch
give identical arrays.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..constants import NS_PER_S, U128_MAX
from ..types import Transfer, TransferPendingStatus

_MASK64 = (1 << 64) - 1


def _split(x: int):
    """Python int -> (hi, lo) numpy uint64 scalars."""
    return np.uint64(x >> 64), np.uint64(x & _MASK64)


def _pad(arr: np.ndarray, n: int, fill=0):
    if len(arr) == n:
        return arr
    out = np.full(n, fill, dtype=arr.dtype)
    out[: len(arr)] = arr
    return out


def _limbs(xs):
    hi = np.array([x >> 64 for x in xs], dtype=np.uint64)
    lo = np.array([x & _MASK64 for x in xs], dtype=np.uint64)
    return hi, lo


def transfers_to_arrays(transfers) -> dict:
    """Transfer objects -> SoA numpy arrays (create_transfers input)."""
    id_hi, id_lo = _limbs([t.id for t in transfers])
    dr_hi, dr_lo = _limbs([t.debit_account_id for t in transfers])
    cr_hi, cr_lo = _limbs([t.credit_account_id for t in transfers])
    amt_hi, amt_lo = _limbs([t.amount for t in transfers])
    pid_hi, pid_lo = _limbs([t.pending_id for t in transfers])
    ud128_hi, ud128_lo = _limbs([t.user_data_128 for t in transfers])
    return dict(
        id_hi=id_hi, id_lo=id_lo,
        dr_hi=dr_hi, dr_lo=dr_lo,
        cr_hi=cr_hi, cr_lo=cr_lo,
        amt_hi=amt_hi, amt_lo=amt_lo,
        pid_hi=pid_hi, pid_lo=pid_lo,
        ud128_hi=ud128_hi, ud128_lo=ud128_lo,
        ud64=np.array([t.user_data_64 for t in transfers], dtype=np.uint64),
        ud32=np.array([t.user_data_32 for t in transfers], dtype=np.uint32),
        timeout=np.array([t.timeout for t in transfers], dtype=np.uint32),
        ledger=np.array([t.ledger for t in transfers], dtype=np.uint32),
        code=np.array([t.code for t in transfers], dtype=np.uint32),
        flags=np.array([t.flags for t in transfers], dtype=np.uint32),
        ts=np.array([t.timestamp for t in transfers], dtype=np.uint64),
    )


def transfers_from_arrays(ev: dict) -> list[Transfer]:
    """SoA numpy arrays -> Transfer objects (transfers_to_arrays'
    inverse)."""

    def u128_at(name, i):
        return (int(ev[f"{name}_hi"][i]) << 64) | int(ev[f"{name}_lo"][i])

    return [
        Transfer(
            id=u128_at("id", i),
            debit_account_id=u128_at("dr", i),
            credit_account_id=u128_at("cr", i),
            amount=u128_at("amt", i),
            pending_id=u128_at("pid", i),
            user_data_128=u128_at("ud128", i),
            user_data_64=int(ev["ud64"][i]),
            user_data_32=int(ev["ud32"][i]),
            timeout=int(ev["timeout"][i]),
            ledger=int(ev["ledger"][i]),
            code=int(ev["code"][i]),
            flags=int(ev["flags"][i]),
            timestamp=int(ev["ts"][i]),
        )
        for i in range(len(ev["id_lo"]))
    ]


def accounts_to_arrays(accounts) -> dict:
    """Account objects -> SoA numpy arrays (create_accounts input)."""
    id_hi, id_lo = _limbs([a.id for a in accounts])
    dp_hi, dp_lo = _limbs([a.debits_pending for a in accounts])
    dpos_hi, dpos_lo = _limbs([a.debits_posted for a in accounts])
    cp_hi, cp_lo = _limbs([a.credits_pending for a in accounts])
    cpos_hi, cpos_lo = _limbs([a.credits_posted for a in accounts])
    ud128_hi, ud128_lo = _limbs([a.user_data_128 for a in accounts])
    return dict(
        id_hi=id_hi, id_lo=id_lo,
        dp_hi=dp_hi, dp_lo=dp_lo,
        dpos_hi=dpos_hi, dpos_lo=dpos_lo,
        cp_hi=cp_hi, cp_lo=cp_lo,
        cpos_hi=cpos_hi, cpos_lo=cpos_lo,
        ud128_hi=ud128_hi, ud128_lo=ud128_lo,
        ud64=np.array([a.user_data_64 for a in accounts], dtype=np.uint64),
        ud32=np.array([a.user_data_32 for a in accounts], dtype=np.uint32),
        reserved=np.array([a.reserved for a in accounts], dtype=np.uint32),
        ledger=np.array([a.ledger for a in accounts], dtype=np.uint32),
        code=np.array([a.code for a in accounts], dtype=np.uint32),
        flags=np.array([a.flags for a in accounts], dtype=np.uint32),
        ts=np.array([a.timestamp for a in accounts], dtype=np.uint64),
    )


def _account_cache(state, account_ids: list[int]) -> tuple[dict, dict]:
    """Build the account-cache SoA. Row 0 is a dummy non-existent row."""
    id_to_idx: dict[int, int] = {}
    rows = [None]  # dummy
    for aid in account_ids:
        if aid in id_to_idx:
            continue
        id_to_idx[aid] = len(rows)
        rows.append(state.accounts.get(aid))

    n = len(rows)
    exists = np.zeros(n, dtype=bool)
    dp = np.zeros((2, n), dtype=np.uint64)   # debits_pending (hi, lo)
    dpos = np.zeros((2, n), dtype=np.uint64)  # debits_posted
    cp = np.zeros((2, n), dtype=np.uint64)
    cpos = np.zeros((2, n), dtype=np.uint64)
    ledger = np.zeros(n, dtype=np.uint32)
    code = np.zeros(n, dtype=np.uint32)
    flags = np.zeros(n, dtype=np.uint32)
    ts = np.zeros(n, dtype=np.uint64)
    for idx, a in enumerate(rows):
        if a is None:
            continue
        exists[idx] = True
        dp[0][idx], dp[1][idx] = _split(a.debits_pending)
        dpos[0][idx], dpos[1][idx] = _split(a.debits_posted)
        cp[0][idx], cp[1][idx] = _split(a.credits_pending)
        cpos[0][idx], cpos[1][idx] = _split(a.credits_posted)
        ledger[idx] = a.ledger
        code[idx] = a.code
        flags[idx] = a.flags
        ts[idx] = a.timestamp
    cache = dict(
        exists=exists,
        dp_hi=dp[0], dp_lo=dp[1], dpos_hi=dpos[0], dpos_lo=dpos[1],
        cp_hi=cp[0], cp_lo=cp[1], cpos_hi=cpos[0], cpos_lo=cpos[1],
        ledger=ledger, code=code, flags=flags, ts=ts,
    )
    return cache, id_to_idx


def prefetch_create_transfers(state, ev: dict, timestamp: int,
                              n_pad: Optional[int] = None):
    """Build the create_transfers sequential kernel's inputs.

    ev: SoA numpy dict from transfers_to_arrays (length n). Returns
    (inputs, aux): `inputs` are the kernel's numpy arrays and scalars,
    `aux` the host-side mappings apply_create_transfers needs."""
    n = len(ev["id_lo"])
    N = n_pad or next_pow2(n)
    assert N >= n

    def u128_at(i, name):
        return (int(ev[f"{name}_hi"][i]) << 64) | int(ev[f"{name}_lo"][i])

    event_ids = [u128_at(i, "id") for i in range(n)]
    event_pids = [u128_at(i, "pid") for i in range(n)]
    event_drs = [u128_at(i, "dr") for i in range(n)]
    event_crs = [u128_at(i, "cr") for i in range(n)]

    # Committed transfers referenced by id (exists path) or pending_id
    # (post/void path).
    tc_rows: list[Transfer] = []
    tc_id_to_idx: dict[int, int] = {}
    for tid in event_ids + event_pids:
        if tid in tc_id_to_idx or tid == 0:
            continue
        t = state.transfers.get(tid)
        if t is not None:
            tc_id_to_idx[tid] = len(tc_rows)
            tc_rows.append(t)

    # Account cache: event dr/cr accounts + committed transfers' accounts.
    acct_ids = []
    for aid in event_drs + event_crs:
        if 0 < aid < U128_MAX:
            acct_ids.append(aid)
    for t in tc_rows:
        acct_ids.append(t.debit_account_id)
        acct_ids.append(t.credit_account_id)
    acct, acct_id_to_idx = _account_cache(state, acct_ids)
    acct = pad_cache(acct, next_pow2(len(acct["exists"])))

    # Committed-transfer cache SoA.
    C = max(1, len(tc_rows))
    tc = dict(
        dr_idx=np.zeros(C, dtype=np.int32),
        cr_idx=np.zeros(C, dtype=np.int32),
        dr_hi=np.zeros(C, dtype=np.uint64), dr_lo=np.zeros(C, dtype=np.uint64),
        cr_hi=np.zeros(C, dtype=np.uint64), cr_lo=np.zeros(C, dtype=np.uint64),
        amt_hi=np.zeros(C, dtype=np.uint64),
        amt_lo=np.zeros(C, dtype=np.uint64),
        pid_hi=np.zeros(C, dtype=np.uint64),
        pid_lo=np.zeros(C, dtype=np.uint64),
        ud128_hi=np.zeros(C, dtype=np.uint64),
        ud128_lo=np.zeros(C, dtype=np.uint64),
        ud64=np.zeros(C, dtype=np.uint64),
        ud32=np.zeros(C, dtype=np.uint32),
        timeout=np.zeros(C, dtype=np.uint32),
        ledger=np.zeros(C, dtype=np.uint32),
        code=np.zeros(C, dtype=np.uint32),
        flags=np.zeros(C, dtype=np.uint32),
        ts=np.zeros(C, dtype=np.uint64),
        pending_status=np.zeros(C, dtype=np.int32),
        expires_at=np.zeros(C, dtype=np.uint64),
    )
    for idx, t in enumerate(tc_rows):
        tc["dr_idx"][idx] = acct_id_to_idx.get(t.debit_account_id, 0)
        tc["cr_idx"][idx] = acct_id_to_idx.get(t.credit_account_id, 0)
        tc["dr_hi"][idx], tc["dr_lo"][idx] = _split(t.debit_account_id)
        tc["cr_hi"][idx], tc["cr_lo"][idx] = _split(t.credit_account_id)
        tc["amt_hi"][idx], tc["amt_lo"][idx] = _split(t.amount)
        tc["pid_hi"][idx], tc["pid_lo"][idx] = _split(t.pending_id)
        tc["ud128_hi"][idx], tc["ud128_lo"][idx] = _split(t.user_data_128)
        tc["ud64"][idx] = t.user_data_64
        tc["ud32"][idx] = t.user_data_32
        tc["timeout"][idx] = t.timeout
        tc["ledger"][idx] = t.ledger
        tc["code"][idx] = t.code
        tc["flags"][idx] = t.flags
        tc["ts"][idx] = t.timestamp
        status = state.pending_status.get(t.timestamp,
                                          TransferPendingStatus.none)
        tc["pending_status"][idx] = int(status)
        if t.timeout:
            tc["expires_at"][idx] = t.timestamp + t.timeout * NS_PER_S
    tc = pad_cache(tc, next_pow2(C))

    # Per-event indices.
    dr_idx = np.array(
        [acct_id_to_idx.get(a, 0) for a in event_drs], dtype=np.int32)
    cr_idx = np.array(
        [acct_id_to_idx.get(a, 0) for a in event_crs], dtype=np.int32)
    exists_idx = np.array(
        [tc_id_to_idx.get(i, -1) for i in event_ids], dtype=np.int32)
    orphaned = np.array([i in state.orphaned for i in event_ids], dtype=bool)
    first_occurrence: dict[int, int] = {}
    slot = np.zeros(n, dtype=np.int32)
    for i, tid in enumerate(event_ids):
        slot[i] = first_occurrence.setdefault(tid, i)
    pending_cache_idx = np.array(
        [tc_id_to_idx.get(p, -1) for p in event_pids], dtype=np.int32)
    pending_slot = np.array(
        [first_occurrence.get(p, -1) for p in event_pids], dtype=np.int32)
    acct_ts_collision = np.array(
        [int(t) in state.account_by_timestamp for t in ev["ts"][:n]],
        dtype=bool)

    valid = np.zeros(N, dtype=bool)
    valid[:n] = True

    event = {k: _pad(v, N) for k, v in ev.items()}
    event.update(
        valid=valid,
        dr_idx=_pad(dr_idx, N),
        cr_idx=_pad(cr_idx, N),
        exists_idx=_pad(exists_idx, N, fill=-1),
        orphaned=_pad(orphaned, N),
        slot=_pad_slot(slot, N),
        pending_cache_idx=_pad(pending_cache_idx, N, fill=-1),
        pending_slot=_pad(pending_slot, N, fill=-1),
        acct_ts_collision=_pad(acct_ts_collision, N),
    )

    inputs = dict(
        event=event,
        acct=acct,
        tc=tc,
        transfers_key_max=np.uint64(state.transfers_key_max or 0),
        pulse_next=np.uint64(state.pulse_next_timestamp),
        timestamp=np.uint64(timestamp),
        n_events=np.int32(n),
    )
    aux = dict(
        acct_id_to_idx=acct_id_to_idx,
        tc_rows=tc_rows,
        event_ids=event_ids,
        event_pids=event_pids,
        n=n,
    )
    return inputs, aux


def _pad_slot(slot: np.ndarray, N: int) -> np.ndarray:
    out = np.arange(N, dtype=np.int32)
    out[: len(slot)] = slot
    return out


def next_pow2(n: int) -> int:
    return 1 << max(3, (n - 1).bit_length())


def pad_cache(cache: dict, target: int) -> dict:
    """Pad every cache array to `target` rows (appended rows are inert
    dummies)."""
    n = len(next(iter(cache.values())))
    if n == target:
        return cache
    return {k: _pad(v, target) for k, v in cache.items()}


def prefetch_create_accounts(state, ev: dict, timestamp: int,
                             n_pad: Optional[int] = None):
    """Build the create_accounts sequential kernel's inputs (a smaller
    surface: exists comparisons, imported-timestamp rules, chains)."""
    n = len(ev["id_lo"])
    N = n_pad or next_pow2(n)
    assert N >= n

    event_ids = [
        (int(ev["id_hi"][i]) << 64) | int(ev["id_lo"][i]) for i in range(n)
    ]

    # Committed account cache rows for the exists path.
    ac_rows = []
    ac_id_to_idx: dict[int, int] = {}
    for aid in event_ids:
        if aid in ac_id_to_idx or aid == 0:
            continue
        a = state.accounts.get(aid)
        if a is not None:
            ac_id_to_idx[aid] = len(ac_rows)
            ac_rows.append(a)
    C = max(1, len(ac_rows))
    ac = dict(
        ud128_hi=np.zeros(C, dtype=np.uint64),
        ud128_lo=np.zeros(C, dtype=np.uint64),
        ud64=np.zeros(C, dtype=np.uint64),
        ud32=np.zeros(C, dtype=np.uint32),
        ledger=np.zeros(C, dtype=np.uint32),
        code=np.zeros(C, dtype=np.uint32),
        flags=np.zeros(C, dtype=np.uint32),
        ts=np.zeros(C, dtype=np.uint64),
    )
    for idx, a in enumerate(ac_rows):
        ac["ud128_hi"][idx], ac["ud128_lo"][idx] = _split(a.user_data_128)
        ac["ud64"][idx] = a.user_data_64
        ac["ud32"][idx] = a.user_data_32
        ac["ledger"][idx] = a.ledger
        ac["code"][idx] = a.code
        ac["flags"][idx] = a.flags
        ac["ts"][idx] = a.timestamp
    ac = pad_cache(ac, next_pow2(C))

    exists_idx = np.array(
        [ac_id_to_idx.get(i, -1) for i in event_ids], dtype=np.int32)
    first_occurrence: dict[int, int] = {}
    slot = np.zeros(n, dtype=np.int32)
    for i, aid in enumerate(event_ids):
        slot[i] = first_occurrence.setdefault(aid, i)
    transfer_ts_collision = np.array(
        [int(t) in state.transfer_by_timestamp for t in ev["ts"][:n]],
        dtype=bool)

    valid = np.zeros(N, dtype=bool)
    valid[:n] = True
    event = {k: _pad(v, N) for k, v in ev.items()}
    event.update(
        valid=valid,
        exists_idx=_pad(exists_idx, N, fill=-1),
        slot=_pad_slot(slot, N),
        transfer_ts_collision=_pad(transfer_ts_collision, N),
    )
    inputs = dict(
        event=event,
        ac=ac,
        accounts_key_max=np.uint64(state.accounts_key_max or 0),
        timestamp=np.uint64(timestamp),
        n_events=np.int32(n),
    )
    aux = dict(ac_id_to_idx=ac_id_to_idx, event_ids=event_ids, n=n)
    return inputs, aux
