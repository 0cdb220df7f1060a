"""Host-side packing of event objects into SoA numpy arrays (a port of
the JAX package's `ops/batch.py` packers).

The arrays keep the JAX package's host dtypes (u64 limbs as uint64, the
32-bit fields as uint32), so one dict feeds either ledger; the device
side converts them to its int64 carriers (`ledger.events_to_device`).
"""

from __future__ import annotations

import numpy as np

_MASK64 = (1 << 64) - 1


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
