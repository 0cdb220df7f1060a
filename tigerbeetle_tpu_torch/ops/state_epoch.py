"""The ledger state digest: the parity witness of the port.

A port of the fold in the JAX package's `ops/state_epoch.py`
(`_mix64`, `_matrix_digest`, `_digest_components`,
`device_state_digest`), on int64-carried u64 tensors. It computes the
same bits as the JAX package's `device_state_digest` and
`oracle_state_digest`, so a port state compares directly with a JAX
state or an oracle state.

Covered: the accounts u64 matrix, the balance-limb matrix, the
transfers u64 matrix (minus the non-canonical `expires` and row-cache
columns) and the scalar vector (row counts, key maxima, commit_ts).
Excluded: the hash tables, the event ring and pulse_next.

The fold is sum-of-mixed-rows: per row, a column-Horner fold is mixed
(splitmix64 finalizer) with the row index and a per-component salt,
rows at/after `count` are zeroed, and the rows are summed with u64
wrap-around.
"""

from __future__ import annotations

import torch

from .ev_layout import XF_NCOLS, XF_P32_POS, XF_U64_IDX
from .u64 import MASK64, s64, srl, u64

_PHI = s64(0x9E3779B97F4A7C15)
_MIX1 = s64(0xBF58476D1CE4E5B9)
_MIX2 = s64(0x94D049BB133111EB)

AC_COL_MASKS = None


def _xf_col_masks() -> tuple:
    masks = [MASK64] * XF_NCOLS
    masks[XF_U64_IDX["expires"]] = 0
    masks[XF_P32_POS["dr_row"][0]] = 0  # the (dr_row, cr_row) word
    return tuple(masks)


XF_COL_MASKS = _xf_col_masks()


def _mix64(x):
    """splitmix64 finalizer over an int64-carried u64 tensor."""
    x = x ^ srl(x, 30)
    x = x * _MIX1
    x = x ^ srl(x, 27)
    x = x * _MIX2
    x = x ^ srl(x, 31)
    return x


def _matrix_digest(m, count, col_masks, salt: int):
    """Sum over rows < count of mix(column-Horner(row) ^ row-index ^ salt)
    as a 0-dim int64 tensor (u64 bits)."""
    rows = m.shape[0]
    acc = torch.zeros(rows, dtype=torch.int64, device=m.device)
    for j in range(m.shape[1]):
        mask = MASK64 if col_masks is None else col_masks[j]
        if mask == 0:
            continue
        col = m[:, j]
        if mask != MASK64:
            col = col & s64(mask)
        acc = acc * _PHI + col
    iota = torch.arange(rows, dtype=torch.int64, device=m.device)
    rowd = _mix64(acc ^ (iota * _PHI) ^ s64(salt))
    live = iota < count
    return torch.sum(torch.where(live, rowd, 0))


_SALT = {"accounts_u64": 0xA1, "accounts_bal": 0xB2,
         "transfers_u64": 0xC3, "scalars": 0xD4}


def _digest_components(state: dict) -> dict:
    acc = state["accounts"]
    xfr = state["transfers"]
    comps = {
        "accounts_u64": _matrix_digest(
            acc["u64"], acc["count"], AC_COL_MASKS, _SALT["accounts_u64"]),
        "accounts_bal": _matrix_digest(
            acc["bal"], acc["count"], None, _SALT["accounts_bal"]),
        "transfers_u64": _matrix_digest(
            xfr["u64"], xfr["count"], XF_COL_MASKS,
            _SALT["transfers_u64"]),
    }
    scalars = torch.stack([
        state["acct_key_max"].to(torch.int64),
        state["xfer_key_max"].to(torch.int64),
        state["commit_ts"].to(torch.int64),
        acc["count"].to(torch.int64),
        xfr["count"].to(torch.int64),
    ])
    comps["scalars"] = _matrix_digest(scalars[None, :], 1, None,
                                      _SALT["scalars"])
    return comps


def device_state_digest(state: dict) -> dict:
    """Digest a port ledger state: named u64 component digests as Python
    ints (one host sync)."""
    comps = _digest_components(state)
    names = sorted(comps)
    vals = torch.stack([comps[k] for k in names]).cpu().tolist()
    return {k: u64(v) for k, v in zip(names, vals)}
