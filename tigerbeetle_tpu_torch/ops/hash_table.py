"""Device-resident bucketized two-choice hash table for u128 keys.

A port of the JAX package's `ops/hash_table.py` (the analog of the
reference's set-associative object cache, src/lsm/set_associative_cache.zig):
id -> row lookups on the device with no data-dependent control flow.
Every lookup is exactly two bucket reads.

Layout: ONE int64-carried u64 matrix (B+1, 3*SLOTS) per table, column
groups [key_hi x 8 | key_lo x 8 | val x 8]; bucket B is a write-dump
row that absorbs masked scatter lanes. Key 0 is the empty sentinel. A
key lives in one of two buckets chosen by independent hashes; inserts
fill a bucket as a prefix of its slots.

Batch inserts rank intra-batch contenders with a stable sort on
(bucket, batch index), so the live buckets are bit-identical to the JAX
package's for identical inputs. Only the dump bucket differs: masked
lanes all scatter there and the winner among them is not fixed on CUDA,
so it is never read and never compared.

`ht_write` (and so `ht_insert`) updates the table in place and returns
it: the port's analog of the JAX package's donated buffers.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .row_gather import row_gather
from .u64 import s64, srl

SLOTS = 8

# Stored val of an orphaned (transiently failed) transfer id; live row
# indexes are >= 0.
ORPHAN_VAL = -2

_C1 = s64(0x9E3779B97F4A7C15)
_C2 = s64(0xBF58476D1CE4E5B9)
_C3 = s64(0xD6E8FEB86659FD93)
_C4 = s64(0x2545F4914F6CDD1D)


def ht_init(cap: int, device=None) -> dict:
    """cap: a power of two >= 2*SLOTS; B = cap // SLOTS buckets (+ one
    dump bucket), on `device` (None: the card)."""
    assert cap & (cap - 1) == 0 and cap >= 2 * SLOTS
    b = cap // SLOTS
    return dict(packed=torch.zeros((b + 1, 3 * SLOTS), dtype=torch.int64,
                                   device=resolve_device(device)))


def _buckets(k_hi, k_lo, b: int):
    """Two independent bucket choices in [0, b) (int64 indexes). The
    multiplications wrap mod 2^64 and the shifts are logical, as in u64."""
    h1 = (k_lo ^ (k_hi * _C1)) * _C2
    h1 = h1 ^ srl(h1, 31)
    h2 = (k_hi ^ (k_lo * _C3)) * _C4
    h2 = h2 ^ srl(h2, 29)
    mask = b - 1
    return h1 & mask, h2 & mask


def _low_i32(x):
    """The int32 value of a u64 lane's low half (the JAX package's
    `astype(int32)` of a stored val)."""
    return ((x & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000


def match_bucket(g, k_hi, k_lo, querying):
    """Slot match + value select over one gathered packed-row block
    (N, 3*SLOTS): the one source of truth for probe semantics, shared by
    the plain lookup and (as its CUDA transcription) the fused kernel."""
    s_hi = g[:, :SLOTS]
    s_lo = g[:, SLOTS:2 * SLOTS]
    s_val = _low_i32(g[:, 2 * SLOTS:])
    match = ((s_hi == k_hi[:, None]) & (s_lo == k_lo[:, None])
             & querying[:, None])
    hit = torch.any(match, dim=1)
    lane_val = torch.amax(torch.where(match, s_val, -1), dim=1)
    return hit, lane_val


def ht_lookup(table: dict, k_hi, k_lo):
    """Plain lookup. Returns (found: bool[N], val: int32[N]).

    Keys equal to the sentinel (0) are absent. A stored negative val
    (ORPHAN_VAL) surfaces as -1: the miss filler wins the lane max, so
    test `found & (val >= 0)` for a live row and `found & (val < 0)` for
    an orphan."""
    packed = table["packed"]
    b = packed.shape[0] - 1
    querying = ~((k_hi == 0) & (k_lo == 0))
    b1, b2 = _buckets(k_hi, k_lo, b)
    found = torch.zeros_like(querying)
    val = torch.full(k_hi.shape, -1, dtype=torch.int64, device=k_hi.device)
    for rows in (b1, b2):
        hit, lane_val = match_bucket(packed[rows], k_hi, k_lo, querying)
        found = found | hit
        val = torch.where(hit, lane_val, val)
    return found, val.to(torch.int32)


def _rank_within(bucket, active, n: int):
    """Stable rank of each active lane among active lanes with the same
    bucket (0-based, in batch order): one stable argsort of
    (bucket, lane) with inactive lanes pushed to the end."""
    dev = bucket.device
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    key = torch.where(active, (bucket << 32) | idx, (1 << 62) + idx)
    order = torch.argsort(key, stable=True)
    b_sorted = bucket[order]
    a_sorted = active[order]
    is_start = torch.cat([
        torch.ones(1, dtype=torch.bool, device=dev),
        (b_sorted[1:] != b_sorted[:-1]) | ~a_sorted[:-1]])
    seg_start = torch.cummax(torch.where(is_start, idx, -1), dim=0).values
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[order] = idx - seg_start
    return torch.where(active, rank, 0)


def _occupancy(g):
    return ((g[:, :SLOTS] != 0) | (g[:, SLOTS:2 * SLOTS] != 0)).sum(dim=1)


def ht_plan(table: dict, k_hi, k_lo, mask):
    """Plan a batch insert without touching the table: returns
    (pos: int64[N] flat slot index, ok: bool scalar tensor). The caller
    guarantees masked keys are unique and absent.

    Round 1 places each key at the tail of its less-loaded bucket,
    ranking intra-batch contenders stably by batch index; lanes that
    overflow SLOTS retry their other bucket in round 2. ok=False if any
    masked lane stays unplaced (a capacity fallback)."""
    packed = table["packed"]
    b = packed.shape[0] - 1
    n = k_hi.shape[0]
    dump = b * SLOTS
    b1, b2 = _buckets(k_hi, k_lo, b)
    # Both choices' bucket rows in one row gather.
    occ = _occupancy(row_gather(packed, torch.cat([b1, b2])))
    occ1, occ2 = occ[:n], occ[n:]

    take1 = occ1 <= occ2
    tgt = torch.where(take1, b1, b2)
    alt = torch.where(take1, b2, b1)
    occ_t = torch.where(take1, occ1, occ2)
    occ_a = torch.where(take1, occ2, occ1)

    r1 = _rank_within(tgt, mask, n)
    slot1 = occ_t + r1
    placed1 = mask & (slot1 < SLOTS)

    retry = mask & ~placed1
    placed1_per_bucket = torch.zeros(b + 1, dtype=torch.int64,
                                     device=packed.device)
    placed1_per_bucket.index_add_(0, torch.where(placed1, tgt, b),
                                  placed1.to(torch.int64))
    r2 = _rank_within(alt, retry, n)
    slot2 = occ_a + placed1_per_bucket[alt] + r2
    placed2 = retry & (slot2 < SLOTS)

    pos = torch.where(placed1, tgt * SLOTS + slot1,
                      torch.where(placed2, alt * SLOTS + slot2, dump))
    ok = torch.all(placed1 | placed2 | ~mask)
    return pos, ok


def ht_write(table: dict, pos, k_hi, k_lo, vals, mask):
    """Apply a planned insert in place: ONE masked scatter into the
    packed matrix (the dump bucket absorbs masked lanes). The flat index
    per column group is bucket*(3*SLOTS) + group*SLOTS + slot."""
    packed = table["packed"]
    b = packed.shape[0] - 1
    wpos = torch.where(mask, pos, b * SLOTS)
    base = (wpos // SLOTS) * (3 * SLOTS) + wpos % SLOTS
    idx = torch.cat([base, base + SLOTS, base + 2 * SLOTS])
    data = torch.cat([k_hi, k_lo, vals.to(torch.int64)])
    packed.view(-1)[idx] = data
    return table


def ht_insert(table: dict, k_hi, k_lo, vals, mask):
    """plan + write. Returns (table, ok); on ok=False no live bucket is
    written (the masked set is rejected atomically)."""
    pos, ok = ht_plan(table, k_hi, k_lo, mask)
    table = ht_write(table, pos, k_hi, k_lo, vals, mask & ok)
    return table, ok


def ht_live_items(table: dict):
    """Host helper: (key_hi, key_lo, val) numpy arrays of all live slots
    (dump bucket excluded); keys as uint64, val as int32."""
    p = table["packed"][:-1].cpu().numpy().view(np.uint64)
    kh = p[:, :SLOTS].reshape(-1)
    kl = p[:, SLOTS:2 * SLOTS].reshape(-1)
    v = p[:, 2 * SLOTS:].reshape(-1).astype(np.int64).astype(np.int32)
    live = (kh != 0) | (kl != 0)
    return kh[live], kl[live], v[live]
