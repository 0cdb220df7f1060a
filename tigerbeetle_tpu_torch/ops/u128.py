"""Exact unsigned 128-bit arithmetic as (hi, lo) limb pairs, each limb a
u64 carried in an int64 tensor (see `u64.py`).

A port of the JAX package's `ops/u128.py`: balances use the whole u128
range, so every carry and borrow test is an unsigned compare. All
functions are elementwise and broadcast like the tensors they get.
"""

from __future__ import annotations

import numpy as np
import torch

from .u64 import MASK64, U64_MAX, s64, ule, ult


def from_int(x: int):
    """Python int -> (hi, lo) int64 bit patterns."""
    return s64(x >> 64), s64(x & MASK64)


def from_ints(xs):
    """Iterable of Python ints -> (hi, lo) int64 numpy arrays."""
    xs = list(xs)
    hi = np.array([x >> 64 for x in xs], dtype=np.uint64).view(np.int64)
    lo = np.array([x & MASK64 for x in xs], dtype=np.uint64).view(np.int64)
    return hi, lo


def to_int(hi, lo) -> int:
    return ((int(hi) & MASK64) << 64) | (int(lo) & MASK64)


def add(a_hi, a_lo, b_hi, b_lo):
    """(a + b) mod 2^128 plus an overflow flag."""
    lo = a_lo + b_lo
    carry = ult(lo, a_lo).to(torch.int64)
    hi_sum = a_hi + b_hi
    ovf1 = ult(hi_sum, a_hi)
    hi = hi_sum + carry
    ovf2 = ult(hi, hi_sum)
    return hi, lo, ovf1 | ovf2


def add3(a_hi, a_lo, b_hi, b_lo, c_hi, c_lo):
    """a + b + c with the combined overflow flag."""
    hi1, lo1, o1 = add(a_hi, a_lo, b_hi, b_lo)
    hi2, lo2, o2 = add(hi1, lo1, c_hi, c_lo)
    return hi2, lo2, o1 | o2


def sub(a_hi, a_lo, b_hi, b_lo):
    """(a - b) mod 2^128."""
    lo = a_lo - b_lo
    borrow = ult(a_lo, b_lo).to(torch.int64)
    hi = a_hi - b_hi - borrow
    return hi, lo


def lt(a_hi, a_lo, b_hi, b_lo):
    return ult(a_hi, b_hi) | ((a_hi == b_hi) & ult(a_lo, b_lo))


def le(a_hi, a_lo, b_hi, b_lo):
    return ult(a_hi, b_hi) | ((a_hi == b_hi) & ule(a_lo, b_lo))


def eq(a_hi, a_lo, b_hi, b_lo):
    return (a_hi == b_hi) & (a_lo == b_lo)


def is_zero(hi, lo):
    return (hi == 0) & (lo == 0)


def is_max(hi, lo):
    return (hi == U64_MAX) & (lo == U64_MAX)


def min_(a_hi, a_lo, b_hi, b_lo):
    take_a = lt(a_hi, a_lo, b_hi, b_lo)
    return torch.where(take_a, a_hi, b_hi), torch.where(take_a, a_lo, b_lo)


def sat_sub(a_hi, a_lo, b_hi, b_lo):
    """max(a - b, 0): Zig's -| saturating subtraction."""
    underflow = lt(a_hi, a_lo, b_hi, b_lo)
    hi, lo = sub(a_hi, a_lo, b_hi, b_lo)
    zero = torch.zeros_like(hi)
    return torch.where(underflow, zero, hi), torch.where(underflow, zero, lo)


def select(cond, a_hi, a_lo, b_hi, b_lo):
    """where(cond, a, b) on limb pairs."""
    return torch.where(cond, a_hi, b_hi), torch.where(cond, a_lo, b_lo)
