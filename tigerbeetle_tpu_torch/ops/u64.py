"""Unsigned 64-bit lanes carried in int64 tensors.

PyTorch's uint64 lacks `+`, `<`, `>>`, `max`, `cummax` and `scatter_add`
on the CPU, so every u64 lane of the JAX package rides here as int64 in
two's complement: the same 64 bits. Addition, subtraction,
multiplication, xor/and/or and equality then wrap and compare exactly as
u64 does. Three things differ and go through this module:

  - right shift: torch's `>>` on int64 is arithmetic; `srl` masks the
    sign copies back off (a logical shift);
  - ordering: `ult`/`ule`/`umax`/... flip bit 63 on both sides, which
    maps unsigned order onto signed order;
  - constants at or above 2^63 (hash multipliers, u64::MAX sentinels)
    are written through `s64`, their int64 bit pattern.

Values that are u32 in the JAX package (flags, ledger, code, timeout,
statuses) ride as int64 zero-extended, so signed int64 order is their
unsigned order.
"""

from __future__ import annotations

import numpy as np
import torch

MASK64 = (1 << 64) - 1
M32 = 0xFFFFFFFF
_SIGN = -(1 << 63)
U64_MAX = -1  # the int64 pattern of u64::MAX


def s64(x: int) -> int:
    """Python int (any sign, taken mod 2^64) -> its int64 bit pattern."""
    x &= MASK64
    return x - (1 << 64) if x >> 63 else x


def u64(x) -> int:
    """int64 bit pattern (Python int or 0-dim tensor) -> u64 value."""
    return int(x) & MASK64


def carrier(a, device):
    """A host numpy array in the JAX package's dtypes -> its carrier
    tensor on `device`: u64 as the int64 bit patterns, other integers
    widened to int64, bool as bool."""
    a = np.asarray(a)
    if a.dtype == np.bool_:
        t = torch.from_numpy(a)
    elif a.dtype == np.uint64:
        t = torch.from_numpy(a.view(np.int64))
    else:
        t = torch.from_numpy(a.astype(np.int64))
    return t.to(device)


def srl(x, k: int):
    """Logical right shift of an int64-carried u64."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _flip(x):
    if isinstance(x, int):
        return s64(x) ^ _SIGN
    return x ^ _SIGN


def ult(a, b):
    return _flip(a) < _flip(b)


def ule(a, b):
    return _flip(a) <= _flip(b)


def ugt(a, b):
    return _flip(a) > _flip(b)


def umax(a, b):
    return torch.where(ugt(a, b), a, b)


def umin(a, b):
    return torch.where(ult(a, b), a, b)


def umax_reduce(x, dim=None):
    """Unsigned max over `dim` (all elements when None)."""
    m = torch.amax(_flip(x)) if dim is None else torch.amax(_flip(x), dim=dim)
    return _flip(m)


def umin_reduce(x, dim=None):
    m = torch.amin(_flip(x)) if dim is None else torch.amin(_flip(x), dim=dim)
    return _flip(m)


def ucummin(x, dim: int = -1):
    return _flip(torch.cummin(_flip(x), dim=dim).values)


def ucummax(x, dim: int = -1):
    return _flip(torch.cummax(_flip(x), dim=dim).values)


def usearchsorted(sorted_u, x):
    """Left insertion points of the u64 values `x` in the ascending u64
    column `sorted_u` (torch.searchsorted in signed order, on the
    bit-63-flipped keys: unflipped, u64::MAX padding is -1 and would sort
    first)."""
    return torch.searchsorted(_flip(sorted_u).contiguous(),
                              _flip(x).contiguous())
