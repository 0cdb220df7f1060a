"""Packed store layouts shared by the kernels and the ledger.

A port of the JAX package's `ops/ev_layout.py`: one u64 matrix per
store (int64-carried, see `u64.py`) with every 32-bit column pair-packed
into a u64 lane (low half | high half << 32). Logical column ->
(matrix column, half) maps; `*_col()`/`*_named()` give named access to
torch int64 tensors (or int64 numpy arrays) and hide the packing.

Packing rules the writers rely on:
  - a 32-bit field that takes partial-row updates after insert (the
    transfer pstat flip) lives alone in its packed column;
  - signed 32-bit fields are stored as their uint32 bit pattern and
    sign-restored on read.

Reference data model: the account_events groove row
(src/state_machine.zig:104-220), Account (src/tigerbeetle.zig:10-43)
and Transfer (src/tigerbeetle.zig:85-116).
"""

from __future__ import annotations

_M32 = 0xFFFFFFFF
_SIGN32 = 0x80000000


def _p32_maps(u64_names, p32_pairs):
    """(field -> (column, half)) for the packed 32-bit tail columns."""
    pos = {}
    for j, pair in enumerate(p32_pairs):
        for h, name in enumerate(pair):
            pos[name] = (len(u64_names) + j, h)
    return pos


def _read32(mat, name, pos, signed):
    col, half = pos[name]
    w = mat[:, col]
    v = ((w >> 32) & _M32) if half else (w & _M32)
    if name in signed:
        v = (v ^ _SIGN32) - _SIGN32
    return v


def pack32(lo, hi=None):
    """Pack one or two 32-bit columns (int64-carried, signed or unsigned)
    into a u64 word column: each goes through its uint32 bit pattern, so
    a negative value never smears into its partner's half."""
    w = lo & _M32
    if hi is not None:
        w = w | ((hi & _M32) << 32)
    return w


# ------------------------------------------------- account_events ring
EV_U64 = ("ts", "amt_hi", "amt_lo", "areq_hi", "areq_lo") + tuple(
    f"{side}_{f}_{half}"
    for side in ("dr", "cr")
    for f in ("dp", "dpos", "cp", "cpos")
    for half in ("hi", "lo"))
EV_I32 = ("pstat", "p_row", "dr_row", "cr_row")
EV_U32 = ("tflags", "dr_flags", "cr_flags")
EV_P32 = (("pstat", "p_row"), ("dr_row", "cr_row"),
          ("tflags", "dr_flags"), ("cr_flags",))
EV_U64_IDX = {n: i for i, n in enumerate(EV_U64)}
EV_P32_POS = _p32_maps(EV_U64, EV_P32)
EV_NCOLS = len(EV_U64) + len(EV_P32)
_EV_SIGNED = frozenset(EV_I32)


def ev_col(evr: dict, name: str):
    """Named column of a packed events ring."""
    if name in EV_U64_IDX:
        return evr["u64"][:, EV_U64_IDX[name]]
    return _read32(evr["u64"], name, EV_P32_POS, _EV_SIGNED)


def ev_cap(evr: dict) -> int:
    return evr["u64"].shape[0] - 1


def ev_named(rows: dict) -> dict:
    """Packed event rows ({'u64'} matrix) -> named column dict."""
    out = {n: rows["u64"][:, i] for n, i in EV_U64_IDX.items()}
    for n in EV_P32_POS:
        out[n] = _read32(rows["u64"], n, EV_P32_POS, _EV_SIGNED)
    return out


# Packed account balances: acc["bal"] is (rows, 16) — four u128 fields x
# four u32-normalized limbs. Column = BAL_FIELDS index * 4 + limb.
BAL_FIELDS = ("dp", "dpos", "cp", "cpos")
BAL_IDX = {f: i * 4 for i, f in enumerate(BAL_FIELDS)}


def bal_col(field: str, limb: int) -> int:
    return BAL_IDX[field] + limb


# ------------------------------------------------------- accounts store
AC_U64 = ("id_hi", "id_lo", "ud128_hi", "ud128_lo", "ud64", "ts")
AC_U32 = ("ud32", "ledger", "code", "flags")
AC_P32 = (("ud32", "ledger"), ("code", "flags"))
AC_U64_IDX = {n: i for i, n in enumerate(AC_U64)}
AC_P32_POS = _p32_maps(AC_U64, AC_P32)
AC_NCOLS = len(AC_U64) + len(AC_P32)
_AC_SIGNED = frozenset()


def ac_col(acc: dict, name: str):
    """Named column of a packed accounts store."""
    if name in AC_U64_IDX:
        return acc["u64"][:, AC_U64_IDX[name]]
    return _read32(acc["u64"], name, AC_P32_POS, _AC_SIGNED)


def ac_named(rows: dict) -> dict:
    """Packed account rows ({'u64'[, 'bal']}) -> named column dict; the
    balance limb matrix passes through under 'bal' when present."""
    out = {n: rows["u64"][:, i] for n, i in AC_U64_IDX.items()}
    for n in AC_P32_POS:
        out[n] = _read32(rows["u64"], n, AC_P32_POS, _AC_SIGNED)
    if "bal" in rows:
        out["bal"] = rows["bal"]
    return out


# ------------------------------------------------------ transfers store
XF_U64 = ("id_hi", "id_lo", "dr_hi", "dr_lo", "cr_hi", "cr_lo",
          "amt_hi", "amt_lo", "pid_hi", "pid_lo", "ud128_hi", "ud128_lo",
          "ud64", "ts", "expires")
XF_U32 = ("ud32", "timeout", "ledger", "code", "flags")
XF_I32 = ("pstat", "dr_row", "cr_row")
XF_P32 = (("ud32", "timeout"), ("ledger", "code"), ("dr_row", "cr_row"),
          ("flags",), ("pstat",))
XF_U64_IDX = {n: i for i, n in enumerate(XF_U64)}
XF_P32_POS = _p32_maps(XF_U64, XF_P32)
XF_NCOLS = len(XF_U64) + len(XF_P32)
_XF_SIGNED = frozenset(XF_I32)


def xf_col(xfr: dict, name: str):
    """Named column of a packed transfers store."""
    if name in XF_U64_IDX:
        return xfr["u64"][:, XF_U64_IDX[name]]
    return _read32(xfr["u64"], name, XF_P32_POS, _XF_SIGNED)


def xf_named(rows: dict) -> dict:
    """Packed transfer rows ({'u64'} matrix) -> named column dict."""
    out = {n: rows["u64"][:, i] for n, i in XF_U64_IDX.items()}
    for n in XF_P32_POS:
        out[n] = _read32(rows["u64"], n, XF_P32_POS, _XF_SIGNED)
    return out
