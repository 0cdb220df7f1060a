"""EWAH word-aligned RLE bitset codec.

reference: src/ewah.zig (used to persist the grid free set compactly,
src/vsr/free_set.zig). Layout: a stream of u64 words — a marker word
followed by that marker's literal words.

marker bit 0      : run value (all-zero or all-one words)
marker bits 1..32 : run length in words
marker bits 33..63: number of literal words following
"""

from __future__ import annotations

import struct

WORD_BITS = 64
_RUN_MAX = (1 << 32) - 1
_LIT_MAX = (1 << 31) - 1


def encode(words: list[int]) -> bytes:
    """Compress a list of u64 words."""
    out: list[int] = []
    i = 0
    n = len(words)
    while i < n:
        # Run of identical all-0 / all-1 words.
        run_value = 0
        run_len = 0
        if words[i] in (0, (1 << 64) - 1):
            run_value = 1 if words[i] else 0
            target = words[i]
            while (i < n and words[i] == target and run_len < _RUN_MAX):
                run_len += 1
                i += 1
        # Literals until the next run candidate.
        lit_start = i
        while (i < n and words[i] not in (0, (1 << 64) - 1)
               and i - lit_start < _LIT_MAX):
            i += 1
        literals = words[lit_start:i]
        marker = run_value | (run_len << 1) | (len(literals) << 33)
        out.append(marker)
        out.extend(literals)
    return struct.pack(f"<{len(out)}Q", *out)


def decode(data: bytes) -> list[int]:
    """Decompress back to the list of u64 words."""
    count = len(data) // 8
    stream = list(struct.unpack(f"<{count}Q", data))
    out: list[int] = []
    pos = 0
    while pos < len(stream):
        marker = stream[pos]
        pos += 1
        run_value = marker & 1
        run_len = (marker >> 1) & _RUN_MAX
        lit_count = marker >> 33
        out.extend([((1 << 64) - 1) if run_value else 0] * run_len)
        out.extend(stream[pos:pos + lit_count])
        pos += lit_count
    return out


def encode_bitset(bits: list[bool]) -> bytes:
    """Convenience: booleans -> words -> EWAH (the free-set use case)."""
    words = []
    for base in range(0, len(bits), WORD_BITS):
        word = 0
        for j, bit in enumerate(bits[base:base + WORD_BITS]):
            if bit:
                word |= 1 << j
        words.append(word)
    return struct.pack("<Q", len(bits)) + encode(words)


def decode_bitset(data: bytes) -> list[bool]:
    (nbits,) = struct.unpack_from("<Q", data)
    words = decode(data[8:])
    out = []
    for word in words:
        for j in range(WORD_BITS):
            out.append(bool(word >> j & 1))
    return out[:nbits]
