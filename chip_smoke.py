#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py        # from the repo root, on a machine with a card

Drives the port's main paths — create_accounts and create_transfers on a
`tigerbeetle_tpu_torch.DeviceLedger`, through the plain tier (BASELINE
config 2) and through the limit fixpoint tiers and their escalation
ladder (BASELINE config 4) — at the ledger's default capacities, and
holds its two CUDA kernels against their plain PyTorch twins. Phases,
each failing the run with a nonzero exit:

  1. device   a CUDA card is present; its name and power limit are
              printed as nvidia-smi gives them;
  2. build    csrc/ht_probe.cu and csrc/row_gather.cu are compiled by
              nvcc for sm_90a, all at once;
  3. probe    the fused probe against the plain lookup, bit for bit, on
              a filled transfer-table shape (B = 2^20 buckets) and an
              account-table shape (B = 2^15), 16 sets of 16,384 queries
              of present, orphaned, absent, zero and bit-edge keys, one
              table a launch and both tables in one launch (as
              per_event_status probes them); timed on the device
              (torch.profiler) and on the stream (CUDA events), cycling
              through the sets; a floor sweep of 1 to 32,768 cold
              transfer-table queries a call;
  4. gather   the row gather against its plain twin, bit for bit, at the
              TPU probes' own shape ((4097, 48) u32, 8,192 rows, both
              masks), the account-balance shape (2^17 + 1 rows, 32,768
              gathered) alone and with the account meta matrix in one
              launch (the account-role gather), both account matrices at
              8,190 rows (lookup_accounts), the transfer shape (2^21 + 1
              rows, 16,384 gathered, row sets cycling through more than
              the L2) and with out-of-range rows; timed beside the plain
              twin and torch.index_select (one call a table); a floor
              sweep of 1 to 32,768 cold transfer rows a call; checked
              only, a four-segment launch mixing 16-byte and 32-bit-word
              items, int32 and int64 rows, both masks and an empty
              segment;
  5. config 2 10,000 accounts, a pendings batch, a mixed batch (posts and
              voids of committed pendings, a linked chain with a failing
              member, failing lanes) and 8 batches of the uniform
              workload (8,190 transfers over 10,000 accounts, no flags),
              on the card and, as the reference, on the CPU; statuses,
              timestamps, row counts and state digests must be equal
              after every batch, the mixed batch must give its expected
              statuses, no batch may fall back, each kernel must launch
              as often as the plain tier predicts, and debits must equal
              credits. Then 64 more uniform batches are timed on the
              card alone;
  6. config 4 two-phase transfers under balance limits: 64 accounts, the
              even ones debit-limited, pairs of 8,190-event batches (a
              pend batch, then a post/void batch of its pendings). Six
              pairs on the card and on the CPU, equal after every batch,
              with the JAX package's created counts and ladder counters;
              an in-batch two-phase batch; the 12-wave limit cascade on a
              small ledger (exactly one deep escalation); the launch
              counts each tier run predicts. Then 16 more pairs are
              timed on the card alone and one pend batch is profiled.

Prints the card line, `{"config2": ...}`, `{"config4": ...}` and
`{"kernels": [...]}` lines, and last
`{"ok": true, "device": {...}}`. Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import itertools
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

A_CAP = 1 << 17
T_CAP = 1 << 21
N_ACCOUNTS = 10_000
BATCH = 8190
N_CHECKED = 8
N_TIMED = 64
N_QUERIES = 16_384
N_QUERY_SETS = 16
# Rows (queries) a call in the kernels' floor sweeps; the first is the
# floor, a launch's fixed cost.
SWEEP_COUNTS = (1, 1024, 8192, 16_384, 32_768)
FULL_MASK = 0xFFFFFFFF
# Row-gather shapes that are held against the plain twin but not timed.
CHECKED_ONLY = ("clamped", "mixed4")
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
ROW_KEY_BYTES = 16 * 8      # the key_hi and key_lo halves of a bucket row
SECTOR_BYTES = 32           # the least a read from HBM moves
U128_MAX = (1 << 128) - 1

# Config 4 (the JAX package's benchmark.py bench_config4, W_PAIRS = 1).
C4_ACCOUNTS = 64
C4_CHECKED_PAIRS = 6
C4_TIMED_PAIRS = 16
# The JAX package's DeviceLedger on this workload (8,190-event pairs,
# default_rng(4), a_cap 2^12 / t_cap 2^17, JAX on the CPU): transfers
# created by each of the first six pend batches (each post/void batch
# creates as many), and the counters after the accounts batch and the
# six pairs (fast_batches, fixpoint_batches, deep_fixpoint_batches,
# escalations, fallbacks).
C4_JAX_CREATED = (4095, 5306, 6000, 6598, 6998, 7255)
C4_JAX_COUNTERS = (13, 12, 8, 10, 0)

# Kernel launches of one run of each tier, read from the code:
#   create_accounts_fast: the id probe; the meta-row gather and the insert
#     plan's bucket-row gather;
#   create_transfers_fast, plain tier: one two-table probe (account ids,
#     transfer and pending ids); the transfer-role gather, the two-table
#     account-role gather (balances and meta in one launch), the balance
#     base of the application, the insert plan's bucket rows;
#   a fixpoint tier (8 or 32 rounds): the same plus the in-window
#     pending view (the application reuses the rounds' balance base).
PROBES_PER_RUN = {"accounts": 1, "plain": 1, "fixpoint": 1}
GATHERS_PER_RUN = {"accounts": 2, "plain": 4, "fixpoint": 5}

# The TPU kernels that row_gather replaces: eight formulations of one
# function, table[rows] on a (4097, 48) u32 table (two of them of its
# low 16-bit limb).
GATHER_REPLACES = [
    "onchip/gather_probe.py:31", "onchip/gather_probe.py:35",
    "onchip/gather_probe.py:40", "onchip/gather_probe.py:47",
    "onchip/gather_probe2.py:31", "onchip/gather_probe2.py:56",
    "onchip/gather_probe2.py:74", "onchip/gather_probe2.py:101",
]


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


# ------------------------------------------------------------- workloads

def config2_batch(rng, b: int) -> dict:
    """One BASELINE config-2 batch: uniform random transfers over
    N_ACCOUNTS accounts, no flags (the JAX package's bench_config2)."""
    ids = np.arange(10**7 + b * BATCH, 10**7 + (b + 1) * BATCH,
                    dtype=np.uint64)
    dr = rng.integers(1, N_ACCOUNTS + 1, BATCH, dtype=np.uint64)
    cr = rng.integers(1, N_ACCOUNTS + 1, BATCH, dtype=np.uint64)
    clash = dr == cr
    cr[clash] = dr[clash] % N_ACCOUNTS + 1
    z = np.zeros(BATCH, dtype=np.uint64)
    z32 = np.zeros(BATCH, dtype=np.uint32)
    return dict(
        id_hi=z.copy(), id_lo=ids, dr_hi=z.copy(), dr_lo=dr,
        cr_hi=z.copy(), cr_lo=cr, amt_hi=z.copy(),
        amt_lo=rng.integers(1, 10**6, BATCH).astype(np.uint64),
        pid_hi=z.copy(), pid_lo=z.copy(), ud128_hi=z.copy(),
        ud128_lo=z.copy(), ud64=z.copy(), ud32=z32.copy(),
        timeout=z32.copy(), ledger=np.ones(BATCH, dtype=np.uint32),
        code=np.ones(BATCH, dtype=np.uint32), flags=z32.copy(),
        ts=z.copy())


def mixed_batches(Transfer, TF):
    """(events, expected status names) for the pendings batch and the
    mixed batch, on accounts 1..N_ACCOUNTS of ledger 1."""
    P, POST, VOID, L = (TF.pending, TF.post_pending_transfer,
                        TF.void_pending_transfer, TF.linked)

    def x(i, dr=0, cr=0, amount=0, ledger=1, code=1, **kw):
        return Transfer(id=i, debit_account_id=dr, credit_account_id=cr,
                        amount=amount, ledger=ledger, code=code, **kw)

    pend = [x(2_000_000 + i, 1 + i, 101 + i, 1000 + i, flags=P,
              timeout=(3600 if i % 2 else 0)) for i in range(40)]
    pend.append(x(2_000_100, 7, 8, 55, user_data_64=9))
    pend.append(x(2_000_101, 7, N_ACCOUNTS + 77, 5))
    pend.append(x(2_000_102, 9, 10, 66))
    pend_expect = (["created"] * 41 + ["credit_account_not_found"]
                   + ["created"])
    mixed = [
        x(2_100_000, 0, 0, U128_MAX, ledger=0, code=0, flags=POST,
          pending_id=2_000_000),
        x(2_100_001, 0, 0, 500, flags=POST, pending_id=2_000_001),
        x(2_100_002, 0, 0, 0, flags=VOID, pending_id=2_000_002),
        x(2_100_003, 0, 0, 0, flags=VOID, pending_id=2_000_003),
        x(2_100_004, 0, 0, 0, flags=POST, pending_id=2_000_004),
        x(2_100_005, 0, 0, 5000, flags=POST, pending_id=2_000_005),
        x(2_100_006, 0, 0, 1, flags=VOID, pending_id=2_000_006),
        x(2_100_007, 0, 0, 0, flags=POST, pending_id=2_000_102),
        x(2_100_008, 0, 0, 0, flags=POST, pending_id=2_999_999),
        x(2_100_009, 11, 12, 20, flags=L),
        x(2_100_010, 12, 13, 20, ledger=2, flags=L),
        x(2_100_011, 13, 14, 20),
        x(2_100_012, N_ACCOUNTS + 5, 3, 20),
        x(2_100_013, 3, 4, 20, ledger=2),
        x(2_100_014, 3, 4, 20, code=0),
        x(2_000_101, 7, 8, 5),
        x(2_000_100, 7, 8, 55, user_data_64=9),
        x(2_100_015, 21, 22, 300, flags=P, timeout=60),
        x(2_100_016, 23, 24, 7),
    ]
    mixed_expect = [
        "created", "created", "created", "created", "created",
        "exceeds_pending_transfer_amount",
        "pending_transfer_has_different_amount",
        "pending_transfer_not_pending", "pending_transfer_not_found",
        "linked_event_failed",
        "transfer_must_have_the_same_ledger_as_accounts",
        "linked_event_failed",
        "debit_account_not_found",
        "transfer_must_have_the_same_ledger_as_accounts",
        "code_must_not_be_zero", "id_already_failed", "exists",
        "created", "created",
    ]
    return [(pend, pend_expect), (mixed, mixed_expect)]


def soa(ids, dr, cr, amount, flags, pid=None) -> dict:
    """Transfer events as the SoA dict of the JAX package's benchmark
    `_soa`: ledger 1, code 1, no user data, no timeout."""
    n = len(ids)
    z = np.zeros(n, dtype=np.uint64)
    z32 = np.zeros(n, dtype=np.uint32)
    return dict(
        id_hi=z.copy(), id_lo=np.asarray(ids, dtype=np.uint64),
        dr_hi=z.copy(), dr_lo=np.asarray(dr, dtype=np.uint64),
        cr_hi=z.copy(), cr_lo=np.asarray(cr, dtype=np.uint64),
        amt_hi=z.copy(), amt_lo=np.asarray(amount, dtype=np.uint64),
        pid_hi=z.copy(),
        pid_lo=z.copy() if pid is None else np.asarray(pid, dtype=np.uint64),
        ud128_hi=z.copy(), ud128_lo=z.copy(), ud64=z.copy(),
        ud32=z32.copy(), timeout=z32.copy(),
        ledger=np.ones(n, dtype=np.uint32), code=np.ones(n, dtype=np.uint32),
        flags=np.asarray(flags, dtype=np.uint32), ts=z.copy())


def config4_accounts(Account, AccountFlags) -> list:
    """C4_ACCOUNTS accounts, the even ones debits_must_not_exceed_credits."""
    limit = int(AccountFlags.debits_must_not_exceed_credits)
    return [Account(id=i, ledger=1, code=1,
                    flags=limit if i % 2 == 0 else 0)
            for i in range(1, C4_ACCOUNTS + 1)]


def config4_pair(rng, next_id: int, TransferFlags, n: int = BATCH):
    """One config-4 pair, as the JAX package's bench_config4 makes it:
    n pendings of 1-99 between random distinct accounts, then a batch
    that posts the even lanes' pendings (the U128_MAX sentinel amount:
    post the full amount) and voids the odd ones', ledger and code 0
    (inherited from the pending). Returns (pend, post_void, next_id)."""
    pend_base = next_id
    dr = rng.integers(1, C4_ACCOUNTS + 1, n, dtype=np.uint64)
    cr = rng.integers(1, C4_ACCOUNTS + 1, n, dtype=np.uint64)
    clash = dr == cr
    cr[clash] = dr[clash] % C4_ACCOUNTS + 1
    pend = soa(np.arange(pend_base, pend_base + n), dr, cr,
               rng.integers(1, 100, n),
               np.full(n, int(TransferFlags.pending), dtype=np.uint32))
    even = np.arange(n) % 2 == 0
    top = np.uint64((1 << 64) - 1)
    z = np.zeros(n, dtype=np.uint64)
    rev = soa(np.arange(pend_base + n, pend_base + 2 * n), z, z,
              np.where(even, top, np.uint64(0)),
              np.where(even, int(TransferFlags.post_pending_transfer),
                       int(TransferFlags.void_pending_transfer)),
              pid=np.arange(pend_base, pend_base + n))
    rev["amt_hi"] = np.where(even, top, np.uint64(0))
    rev["ledger"] = np.zeros(n, dtype=np.uint32)
    rev["code"] = np.zeros(n, dtype=np.uint32)
    return pend, rev, pend_base + 2 * n


def in_batch_two_phase(Transfer, TF):
    """(events, expected status names) of one batch whose pendings are
    posted and voided later in the same batch, with a post of a failed
    pend, a post before its pend, a partial post and a post of a post.
    Debits go to odd (unlimited) accounts of config 4, so the statuses do
    not depend on the balances."""
    P, POST, VOID = (TF.pending, TF.post_pending_transfer,
                     TF.void_pending_transfer)
    base = 900_000_000

    def x(i, dr=0, cr=0, amount=0, ledger=1, code=1, **kw):
        return Transfer(id=base + i, debit_account_id=dr,
                        credit_account_id=cr, amount=amount, ledger=ledger,
                        code=code, **kw)

    events = [
        x(1, 1, 2, 100, flags=P),
        x(2, 3, 4, 50, flags=P, timeout=60),
        x(3, 5, 10_000_000, 10, flags=P),          # credit account missing
        x(4, 0, 0, U128_MAX, ledger=0, code=0, flags=POST,
          pending_id=base + 6),                    # before its pend
        x(5, 0, 0, U128_MAX, ledger=0, code=0, flags=POST,
          pending_id=base + 1),
        x(6, 7, 8, 30, flags=P),
        x(7, 0, 0, 0, flags=VOID, pending_id=base + 2),
        x(8, 0, 0, U128_MAX, flags=POST, pending_id=base + 3),
        x(9, 9, 10, 100, flags=P),
        x(10, 0, 0, 40, flags=POST, pending_id=base + 9),   # partial
        x(11, 0, 0, U128_MAX, flags=POST, pending_id=base + 5),
        x(12, 11, 12, 5),
    ]
    expect = [
        "created", "created", "credit_account_not_found",
        "pending_transfer_not_found", "created", "created", "created",
        "pending_transfer_not_found", "created", "created",
        "pending_transfer_not_pending", "created",
    ]
    return events, expect


def cascade_steps(Account, Transfer, AccountFlags, TransferFlags,
                  k_chains: int = 12):
    """(accounts, funding transfers, cascade batch) of the k-wave limit
    cascade of the JAX package's tests/test_fixpoint_escalation.py:
    account 1 unlimited, 2..k + 5 debit-limited with a credit of 10
    each; chain k debits account k + 2 by 20 (its credit plus the relief
    credit the previous chain's second member would land) and credits
    the next one by 10; chain 0's credit names a missing account, so the
    sequential truth unwinds one chain a wave."""
    n_limited = k_chains + 4
    limit = AccountFlags.debits_must_not_exceed_credits
    accounts = [Account(id=1, ledger=1, code=1)] + [
        Account(id=i, ledger=1, code=1, flags=limit)
        for i in range(2, n_limited + 2)]
    funds = [Transfer(id=100 + i, debit_account_id=1, credit_account_id=i,
                      amount=10, ledger=1, code=1)
             for i in range(2, n_limited + 2)]
    cascade = []
    for k in range(k_chains):
        cascade.append(Transfer(id=10_000 + 2 * k, debit_account_id=2 + k,
                                credit_account_id=1, amount=20, ledger=1,
                                code=1, flags=TransferFlags.linked))
        cascade.append(Transfer(id=10_001 + 2 * k, debit_account_id=1,
                                credit_account_id=(999_999 if k == 0
                                                   else 3 + k),
                                amount=10, ledger=1, code=1))
    return accounts, funds, cascade


# ------------------------------------------------------------ the phases

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 50, rounds: int = 5) -> float:
    """Stream time per call of fn() in ms: CUDA events around `reps`
    back-to-back calls, median over `rounds` (after warm-up). Where the
    host issues calls slower than the device runs them, this is the
    host's issue time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / reps)
    return float(np.median(per))


def device_profile(fn, reps: int = 20, attempts: int = 3):
    """(device-busy ms per call, {name: (ms per call, launches per
    call)}) of fn() from a torch.profiler trace of `reps` calls;
    (None, {}) when the trace holds no device time. A trace that comes
    back empty (the profiler now and then drops a short window's device
    events) is taken again, up to `attempts` traces."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    by_name = {}
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            if us:
                ms, n = by_name.get(e.key, (0.0, 0.0))
                by_name[e.key] = (ms + us / 1e3 / reps, n + e.count / reps)
        if by_name:
            break
    if not by_name:
        return None, {}
    return sum(v[0] for v in by_name.values()), by_name


def kernel_ms(fn, tag: str, attempts: int = 3) -> float:
    """Device ms per call of the one kernel named like `tag` that fn()
    launches once a call, from a torch.profiler trace. A trace that
    holds the kernel fewer or more times than the calls made (the
    profiler now and then drops device events) is taken again, up to
    `attempts` traces."""
    for _ in range(attempts):
        _, names = device_profile(fn, attempts=1)
        hits = [v for k, v in names.items() if tag in k]
        if len(hits) == 1 and abs(hits[0][1] - 1) < 1e-9:
            return hits[0][0]
    check(False, f"the traces of {tag} never held its kernel once a call: "
          f"{ {k: v[1] for k, v in names.items()} }")


def cycling(fn, arg_sets):
    """A call that applies fn to the next of arg_sets each time."""
    it = itertools.cycle(arg_sets)
    return lambda: fn(*next(it))


def measure(kern, plain, tag: str, library=None) -> dict:
    """The kernel's device ms per call (torch.profiler) beside its plain
    twin's (and one library call's), and each one's stream ms per call
    (CUDA events), taken in turns within this call: plain, kernel,
    kernel, plain."""
    p_ms = time_ms(plain)
    k_ms = time_ms(kern)
    k_ms2 = time_ms(kern)
    p_ms2 = time_ms(plain)
    p_dev, _ = device_profile(plain)
    check(p_dev is not None, f"{tag}: the trace holds no device time for "
          "the plain twin")
    res = dict(ms=kernel_ms(kern, tag), plain_ms=p_dev,
               stream_ms=min(k_ms, k_ms2), plain_stream_ms=min(p_ms, p_ms2),
               stream_ms_turns=[k_ms, k_ms2],
               plain_stream_ms_turns=[p_ms, p_ms2],
               library_ms=None, library_stream_ms=None)
    if library is not None:
        res["library_ms"], _ = device_profile(library)
        res["library_stream_ms"] = time_ms(library)
    return res


def sweep(calls: dict, tag: str) -> dict:
    """{count: device ms per call} of the kernel over the calls made for
    each count in SWEEP_COUNTS; SWEEP_COUNTS[0] (one row or query) is the
    kernel's floor, the fixed cost of a launch."""
    return {n: kernel_ms(calls[n], tag) for n in SWEEP_COUNTS}


def query_set(rng, k_hi, k_lo, vals, n_keys, dev):
    """N_QUERIES probe keys on a table holding (k_hi, k_lo) -> vals, the
    last len(k_hi) - n_keys of them the bit-edge keys: present live and
    orphaned keys, every bit-edge key, absent keys (hi above 2^63, never
    inserted), zero keys. Returns the keys on `dev` and the expected
    (found, val)."""
    n_edge = len(k_hi) - n_keys
    pick = rng.choice(n_keys, 9000, replace=False)
    n_abs = N_QUERIES - 9000 - n_edge - 300
    q_hi = np.concatenate([
        k_hi[pick], k_hi[n_keys:],
        rng.integers(2**63 + 1, 2**64 - 2, n_abs, dtype=np.uint64),
        np.zeros(300, dtype=np.uint64)])
    q_lo = np.concatenate([
        k_lo[pick], k_lo[n_keys:],
        rng.integers(1, 2**64 - 2, n_abs, dtype=np.uint64),
        np.zeros(300, dtype=np.uint64)])
    want_found = np.concatenate([
        np.ones(9000 + n_edge, dtype=bool),
        np.zeros(n_abs + 300, dtype=bool)])
    want_val = np.full(N_QUERIES, -1, dtype=np.int64)
    sel = np.concatenate([pick, np.arange(n_keys, len(k_hi))])
    want_val[:9000 + n_edge] = np.where(vals[sel] >= 0, vals[sel], -1)
    return (torch.from_numpy(q_hi.view(np.int64)).to(dev),
            torch.from_numpy(q_lo.view(np.int64)).to(dev),
            want_found, want_val)


def probe_bytes(qh, ql, want_found, buckets: int) -> int:
    """The bytes one probe of these keys must move: the keys in and
    (found, val) out once each; the key halves (8 hi + 8 lo slots, 128 B)
    of every distinct bucket row a non-zero key hashes to; one 32-byte
    sector of the val half per key found."""
    from tigerbeetle_tpu_torch.ops.hash_table import _buckets

    b1, b2 = _buckets(qh, ql, buckets)
    live = (qh != 0) | (ql != 0)
    rows = int((live.to(torch.int64) * (1 + (b1 != b2).to(torch.int64)))
               .sum())
    return (qh.numel() * (16 + 5) + rows * ROW_KEY_BYTES
            + int(want_found.sum()) * SECTOR_BYTES)


def probe_fixtures(dev) -> dict:
    """The default ledger's two probe tables, filled, each with
    N_QUERY_SETS query sets: {name: (table, sets, buckets)}. The
    transfer table (B = 2^20, 201 MB) holds 2^21 keys, the account table
    (B = 2^15) 100,000; both also every bit-edge key, ~10% of the keys
    orphaned, inserted a batch at a time as the ledger inserts them.

    The transfer-table sets' rows together (~100 MB) exceed the 50 MB L2,
    so a call cycling through them reads cold rows from HBM as a batch
    on the main path does; the account table (6 MB) stays in L2, as it
    does on the main path."""
    from tigerbeetle_tpu_torch.ops.hash_table import (
        ORPHAN_VAL, ht_init, ht_insert)

    edges = [0, 1, 2**63 - 1, 2**63, 2**64 - 1]
    edge_keys = [(h, l) for h in edges for l in edges if (h, l) != (0, 0)]
    fixtures = {}
    for name, cap, n_keys, seed in (("xfer_ht", 1 << 23, 1 << 21, 11),
                                    ("acct_ht", 1 << 18, 100_000, 12)):
        rng = np.random.default_rng(seed)
        # Unique keys: random hi below 2^63-1 (never an edge value), lo
        # the key's index; the bit-edge keys follow.
        k_hi = np.concatenate([
            rng.integers(2, 2**63 - 2, n_keys, dtype=np.uint64),
            np.array([k[0] for k in edge_keys], dtype=np.uint64)])
        k_lo = np.concatenate([
            np.arange(1, n_keys + 1, dtype=np.uint64),
            np.array([k[1] for k in edge_keys], dtype=np.uint64)])
        total = len(k_hi)
        vals = np.arange(total, dtype=np.int64)
        orphan = rng.random(total) < 0.1
        vals[orphan] = ORPHAN_VAL
        table = ht_init(cap, dev)
        th = torch.from_numpy(k_hi.view(np.int64)).to(dev)
        tl = torch.from_numpy(k_lo.view(np.int64)).to(dev)
        tv = torch.from_numpy(vals).to(dev)
        for lo in range(0, total, BATCH):
            sl = slice(lo, lo + BATCH)
            table, ok = ht_insert(table, th[sl], tl[sl], tv[sl],
                                  torch.ones_like(th[sl], dtype=torch.bool))
            check(bool(ok), f"{name}: insert overflowed")
        sets = [query_set(rng, k_hi, k_lo, vals, n_keys, dev)
                for _ in range(N_QUERY_SETS)]
        fixtures[name] = (table, sets, cap // 8)
    return fixtures


def probe_phase(fx) -> dict:
    """Kernel against plain, bit for bit, on the two table shapes of the
    default ledger one at a time, then on both in one launch as
    per_event_status probes them (the account table at 16,384 keys, the
    transfer table at 16,384 keys); timed, and swept over SWEEP_COUNTS
    queries on the transfer table. Returns the kernels-line numbers."""
    from tigerbeetle_tpu_torch.ops import fused_probe
    from tigerbeetle_tpu_torch.ops.hash_table import ht_lookup

    results = {}
    for name, (table, sets, buckets) in fx.items():
        max_err = 0
        for qh, ql, want_found, want_val in sets:
            got_f, got_v = fused_probe.ht_lookup_fused(table, qh, ql)
            ref_f, ref_v = ht_lookup(table, qh, ql)
            check(torch.equal(got_f, ref_f) and torch.equal(got_v, ref_v),
                  f"{name}: kernel disagrees with the plain lookup")
            check(np.array_equal(got_f.cpu().numpy(), want_found)
                  and np.array_equal(got_v.cpu().numpy(), want_val),
                  f"{name}: lookup disagrees with the inserted keys")
            max_err = max(max_err, int((got_v.to(torch.int64)
                                        - ref_v.to(torch.int64)).abs().max())
                          + int((got_f != ref_f).sum()))
        bound_bytes = np.mean([probe_bytes(qh, ql, wf, buckets)
                               for qh, ql, wf, _ in sets])
        args = [(table, qh, ql) for qh, ql, _, _ in sets]
        res = measure(cycling(fused_probe.ht_lookup_fused, args),
                      cycling(ht_lookup, args), "ht_probe_kernel")
        res.update(bound_ms=bound_bytes / HBM_BYTES_PER_S * 1e3,
                   max_abs_err=max_err, segments=1)
        results[name] = res
        print(f"probe {name}: B={buckets} keys, {N_QUERY_SETS} query sets "
              f"of {N_QUERIES} in turn; device per call: kernel {res['ms']} "
              f"ms, plain {res['plain_ms']} ms; stream per call: kernel "
              f"{res['stream_ms_turns']} ms, plain "
              f"{res['plain_stream_ms_turns']} ms; bound {bound_bytes:.0f} "
              f"B = {res['bound_ms']} ms", flush=True)

    # Both tables in one launch, as per_event_status probes them.
    a_table, a_sets, a_b = fx["acct_ht"]
    x_table, x_sets, x_b = fx["xfer_ht"]
    pairs = [(((a_table, ah, al), (x_table, xh, xl)),)
             for (ah, al, _, _), (xh, xl, _, _) in zip(a_sets, x_sets)]
    max_err = 0
    for (segs,) in pairs:
        got = fused_probe.ht_lookup_fused_multi(segs)
        for (gf, gv), seg in zip(got, segs):
            rf, rv = ht_lookup(*seg)
            check(torch.equal(gf, rf) and torch.equal(gv, rv),
                  "two-table probe: kernel disagrees with the plain lookup")
            max_err = max(max_err, int((gv.to(torch.int64)
                                        - rv.to(torch.int64)).abs().max())
                          + int((gf != rf).sum()))
    bound_bytes = np.mean([
        probe_bytes(ah, al, af, a_b) + probe_bytes(xh, xl, xf, x_b)
        for (ah, al, af, _), (xh, xl, xf, _) in zip(a_sets, x_sets)])
    res = measure(cycling(fused_probe.ht_lookup_fused_multi, pairs),
                  cycling(lambda segs: [ht_lookup(*s) for s in segs], pairs),
                  "ht_probe_kernel")
    res.update(bound_ms=bound_bytes / HBM_BYTES_PER_S * 1e3,
               max_abs_err=max_err, segments=2)
    results["two_tables"] = res
    print(f"probe two tables in one launch (acct_ht + xfer_ht, "
          f"{N_QUERIES} keys each): device per call: kernel {res['ms']} ms, "
          f"plain {res['plain_ms']} ms; stream per call: kernel "
          f"{res['stream_ms_turns']} ms, plain "
          f"{res['plain_stream_ms_turns']} ms; bound {bound_bytes:.0f} B = "
          f"{res['bound_ms']} ms", flush=True)

    # The floor sweep: cold transfer-table queries, 1 to 32,768 a call.
    wide = [(torch.cat([a[0], b[0]]), torch.cat([a[1], b[1]]))
            for a, b in zip(x_sets, x_sets[1:] + x_sets[:1])]
    calls = {n: cycling(fused_probe.ht_lookup_fused,
                        [(x_table, qh[:n], ql[:n]) for qh, ql in wide])
             for n in SWEEP_COUNTS}
    results["sweep"] = sweep(calls, "ht_probe_kernel")
    print(f"probe sweep (xfer_ht, queries: device ms per call): "
          f"{results['sweep']}", flush=True)
    return results


def gather_bytes(tables, rows) -> int:
    """The bytes one row gather of `tables` at `rows` must move: the
    indexes read once, and for each table the output written once and
    each distinct gathered row read once in 32-byte sectors (a masked
    gather reads the row's words all the same)."""
    total = rows.numel() * rows.element_size()
    for table in tables:
        b = table.shape[0]
        row_bytes = table.shape[1] * table.element_size()
        distinct = int(torch.unique(
            rows.to(torch.int64).clamp(0, b - 1)).numel())
        sectors = -(-row_bytes // SECTOR_BYTES)
        total += rows.numel() * row_bytes + distinct * sectors * SECTOR_BYTES
    return total


def gather_fixtures(dev) -> dict:
    """The row gather's shapes: {name: (tables, row sets, masks, library
    call timed)}. The TPU probes' (4097, 48) u32 table at 8,192 rows with
    both masks; the account balances (2^17 + 1, 16) int64 at 32,768 rows
    alone, and with the account meta matrix (2^17 + 1, 8) in one launch
    as the account-role gather reads them; both account matrices at
    8,190 rows, as lookup_accounts reads them; the transfer store
    (2^21 + 1, 20) int64 at 16,384 rows, cycling through 32 row sets
    (~84 MB of rows, more than the 50 MB L2, so its rows are read cold
    as a batch's are), and at out-of-range rows; and, checked only, a
    four-segment launch mixing 16-byte and 32-bit-word items (a 7-word
    table), int32 and int64 rows, both masks and an empty segment."""
    from tigerbeetle_tpu_torch.ops.ev_layout import AC_NCOLS, XF_NCOLS

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)

    def rand_table(rows, width):
        return torch.randint(-2**63, 2**63 - 1, (rows, width),
                             dtype=torch.int64, device=dev, generator=gen)

    def rand_rows(n, hi, sets, lo=0):
        return [torch.randint(lo, hi, (n,), dtype=torch.int64, device=dev,
                              generator=gen) for _ in range(sets)]

    probe_table = torch.arange(4097 * 48, dtype=torch.int32,
                               device=dev).reshape(4097, 48)
    probe_rows = [((torch.arange(8192, device=dev) * 7) % 4097).to(
        torch.int32)]
    bal = rand_table(A_CAP + 1, 16)
    meta = rand_table(A_CAP + 1, AC_NCOLS)
    xfr = rand_table(T_CAP + 1, XF_NCOLS)
    acct_rows = rand_rows(4 * 8192, A_CAP + 1, 4)
    words = torch.arange(4097 * 7, dtype=torch.int32,
                         device=dev).reshape(4097, 7) * -40503
    mixed = [rand_rows(8192, T_CAP + 1, 1)[0],
             rand_rows(8192, 1 << 20, 1, lo=-(1 << 20))[0],
             torch.empty(0, dtype=torch.int64, device=dev),
             probe_rows[0]]
    return {
        "probe": ([probe_table], probe_rows, None, True),
        "probe_low16": ([probe_table], probe_rows, [0xFFFF], False),
        "account": ([bal], acct_rows, None, True),
        "account2": ([bal, meta], acct_rows, None, True),
        "lookup": ([bal, meta], rand_rows(BATCH, A_CAP + 1, 4), None, True),
        "transfer": ([xfr], rand_rows(2 * 8192, T_CAP + 1, 32), None, True),
        "clamped": ([xfr], rand_rows(2 * 8192, 1 << 40, 2, lo=-(1 << 40)),
                    None, False),
        "mixed4": ([xfr, words, bal, probe_table], [mixed],
                   [None, 0xFFFF, None, FULL_MASK], False),
        # The floor sweep's rows: 32 sets of 32,768, cut to each count.
        "sweep": ([xfr], rand_rows(max(SWEEP_COUNTS), T_CAP + 1, 32), None,
                  False),
    }


def gather_phase(fx) -> dict:
    """Row-gather kernel against its plain twin, bit for bit, at every
    shape of `fx`; timed on the device (torch.profiler) and on the stream
    (CUDA events) beside the plain twin and torch.index_select (one
    PyTorch call a table computing the same function, timed as a
    yardstick only); swept over SWEEP_COUNTS rows at the transfer
    shape. Returns {shape: numbers}."""
    from tigerbeetle_tpu_torch.ops import row_gather as RG

    results = {}
    for name, (tables, row_sets, masks, library) in fx.items():
        if name == "sweep":
            continue
        max_err = 0
        for rows in row_sets:
            got = RG.row_gather_multi(tables, rows, masks)
            want = RG.row_gather_multi_plain(tables, rows, masks)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                check(g.dtype == w.dtype and g.shape == w.shape
                      and torch.equal(g, w),
                      f"row_gather {name}: kernel disagrees with the plain "
                      "twin")
                diff = (g.view(torch.int32).to(torch.int64)
                        - w.view(torch.int32).to(torch.int64)).abs()
                max_err = max(max_err, int(diff.max()) if diff.numel() else 0)
        if name in CHECKED_ONLY:
            results[name] = dict(max_abs_err=max_err, segments=len(tables))
            continue
        if len(tables) == 1:
            mask = None if masks is None else masks[0]
            kern = cycling(lambda r: RG.row_gather(tables[0], r, mask),
                           [(r,) for r in row_sets])
        else:
            kern = cycling(lambda r: RG.row_gather_multi(tables, r, masks),
                           [(r,) for r in row_sets])
        plain = cycling(lambda r: RG.row_gather_multi_plain(tables, r, masks),
                        [(r,) for r in row_sets])
        lib = cycling(lambda r: [torch.index_select(t, 0, r) for t in tables],
                      [(r,) for r in row_sets]) if library else None
        res = measure(kern, plain, "row_gather", lib)
        bound = float(np.mean([gather_bytes(tables, r) for r in row_sets]))
        res.update(
            bound_ms=bound / HBM_BYTES_PER_S * 1e3, max_abs_err=max_err,
            segments=len(tables), tables=[list(t.shape) for t in tables],
            dtype=str(tables[0].dtype).split(".")[-1],
            rows=int(row_sets[0].numel()),
            mask=None if masks is None else hex(masks[0]))
        results[name] = res
        print(f"row_gather {name}: tables {res['tables']} {res['dtype']}, "
              f"{res['rows']} rows x {len(row_sets)} sets, mask "
              f"{res['mask']}; device per call: kernel {res['ms']} ms, plain "
              f"{res['plain_ms']} ms, index_select {res['library_ms']} ms; "
              f"stream per call: kernel {res['stream_ms_turns']} ms, plain "
              f"{res['plain_stream_ms_turns']} ms; bound {bound:.0f} B = "
              f"{res['bound_ms']} ms", flush=True)

    (xfr,), wide, _, _ = fx["sweep"]
    calls = {n: cycling(RG.row_gather, [(xfr, r[:n]) for r in wide])
             for n in SWEEP_COUNTS}
    results["sweep"] = sweep(calls, "row_gather")
    print(f"row_gather sweep (transfer store, rows: device ms per call): "
          f"{results['sweep']}", flush=True)
    return results


def ledger_digest(led):
    from tigerbeetle_tpu_torch.ops.state_epoch import device_state_digest
    return device_state_digest(led.state)


def double_entry(led) -> None:
    """Sum of debits equals sum of credits, posted and pending, over the
    account rows (the double-entry identity)."""
    from tigerbeetle_tpu_torch.ops.ev_layout import BAL_IDX

    acc = led.state["accounts"]
    n = int(acc["count"])
    sums = acc["bal"][:n].sum(dim=0).cpu().tolist()

    def total(f):
        return sum(int(sums[BAL_IDX[f] + j]) << (32 * j) for j in range(4))

    check(total("dpos") == total("cpos") and total("dp") == total("cp"),
          "debits and credits do not balance")


def main_path_phase(dev):
    """BASELINE config 2 through the plain tier; returns (probe launches,
    row-gather launches, the probe's device ms per launch, the timing and
    trace numbers)."""
    from tigerbeetle_tpu_torch import DeviceLedger
    from tigerbeetle_tpu_torch.ops import fused_probe
    from tigerbeetle_tpu_torch.ops import row_gather as RG
    from tigerbeetle_tpu_torch.ops.batch import transfers_to_arrays
    from tigerbeetle_tpu_torch.types import (
        Account, CreateTransferStatus, Transfer, TransferFlags)

    t0 = time.perf_counter()
    gpu = DeviceLedger(a_cap=A_CAP, t_cap=T_CAP)
    check(gpu.device.type == "cuda", "the default ledger is not on the card")
    cpu = DeviceLedger(a_cap=A_CAP, t_cap=T_CAP, device="cpu")
    print(f"ledgers up in {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(2)
    created = int(CreateTransferStatus.created)
    ts = 10**12

    def compare(label, got, want):
        check(np.array_equal(got[0], want[0])
              and np.array_equal(got[1], want[1]),
              f"{label}: card and CPU results differ")
        for k in ("accounts", "transfers"):
            check(int(gpu.state[k]["count"]) == int(cpu.state[k]["count"]),
                  f"{label}: {k} counts differ")
        check(ledger_digest(gpu) == ledger_digest(cpu),
              f"{label}: state digests differ")
        check(gpu.fallbacks == 0 and cpu.fallbacks == 0,
              f"{label}: a batch fell back")
        double_entry(gpu)

    def transfer_step(label, ev):
        nonlocal ts
        ts += BATCH + 1000
        before = (fused_probe.LAUNCHES, RG.LAUNCHES)
        got = gpu.create_transfers_soa(ev, ts)
        ran = (fused_probe.LAUNCHES - before[0], RG.LAUNCHES - before[1])
        check(ran == (PROBES_PER_RUN["plain"], GATHERS_PER_RUN["plain"]),
              f"{label}: probe and row gather launched {ran} times, not "
              f"{PROBES_PER_RUN['plain']} and {GATHERS_PER_RUN['plain']}")
        compare(label, got, cpu.create_transfers_soa(ev, ts))
        return got

    # The kernel counts start from zero just before the main path runs.
    fused_probe.LAUNCHES = 0
    RG.LAUNCHES = 0
    accounts = [Account(id=i, ledger=1, code=1)
                for i in range(1, N_ACCOUNTS + 1)]
    for lo in range(0, N_ACCOUNTS, BATCH):
        chunk = accounts[lo:lo + BATCH]
        ts += len(chunk)
        g = gpu.create_accounts(chunk, ts)
        c = cpu.create_accounts(chunk, ts)
        check([(r.timestamp, r.status) for r in g]
              == [(r.timestamp, r.status) for r in c],
              "create_accounts: card and CPU results differ")
        check(all(r.status.name == "created" for r in g),
              "create_accounts: not every account was created")
    launches_accounts = fused_probe.LAUNCHES
    gathers_accounts = RG.LAUNCHES
    check(launches_accounts == 2 * PROBES_PER_RUN["accounts"]
          and gathers_accounts == 2 * GATHERS_PER_RUN["accounts"],
          "create_accounts did not launch the probe and the row gather "
          "as predicted")

    for i, (events, expect) in enumerate(mixed_batches(Transfer,
                                                       TransferFlags)):
        st, _ = transfer_step(f"mixed batch {i}", transfers_to_arrays(events))
        names = [CreateTransferStatus(int(s)).name for s in st]
        check(names == expect, f"mixed batch {i}: statuses {names}")
    for b in range(N_CHECKED):
        st, _ = transfer_step(f"config-2 batch {b}", config2_batch(rng, b))
        check(bool((st == created).all()),
              f"config-2 batch {b}: not every transfer was created")
    for k in ("acct_ht", "xfer_ht"):
        check(torch.equal(gpu.state[k]["packed"][:-1].cpu(),
                          cpu.state[k]["packed"][:-1]),
              f"{k}: card and CPU hash tables differ")
    print(f"main path checked against the CPU: {N_CHECKED + 2} transfer "
          f"batches in {time.perf_counter() - t0:.1f} s", flush=True)
    del cpu

    timed = [config2_batch(rng, N_CHECKED + b) for b in range(N_TIMED)]
    rows_before = int(gpu.state["transfers"]["count"])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for ev in timed:
        ts += BATCH + 1000
        st, _ = gpu.create_transfers_soa(ev, ts)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t1
    rows = int(gpu.state["transfers"]["count"]) - rows_before
    check(rows == N_TIMED * BATCH and gpu.fallbacks == 0,
          f"timed run created {rows} of {N_TIMED * BATCH} transfers")
    double_entry(gpu)
    launches = fused_probe.LAUNCHES
    gathers = RG.LAUNCHES
    batches = 2 + N_CHECKED + N_TIMED
    want = (launches_accounts + PROBES_PER_RUN["plain"] * batches,
            gathers_accounts + GATHERS_PER_RUN["plain"] * batches)
    check((launches, gathers) == want,
          f"probe and row gather launches {(launches, gathers)}, expected "
          f"{want}")
    tps = N_TIMED * BATCH / elapsed
    print(f"main path: {N_TIMED} config-2 batches of {BATCH} in "
          f"{elapsed:.4f} s = {tps:.0f} validated transfers/s "
          f"({elapsed / N_TIMED * 1e3:.3f} ms/batch)", flush=True)

    # Where a batch's time goes (after the launch count was read): the
    # device-busy share of the wall time, and the kernels that fill it.
    extra = iter(range(N_CHECKED + N_TIMED, N_CHECKED + N_TIMED + 64))

    def one_batch():
        nonlocal ts
        ts += BATCH + 1000
        gpu.create_transfers_soa(config2_batch(rng, next(extra)), ts)

    reps = 8
    busy, by_name = device_profile(one_batch, reps=reps)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for _ in range(reps):
        one_batch()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t2) / reps * 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    launches_per_batch = sum(v[1] for v in by_name.values())
    print(f"main path breakdown: wall {wall:.3f} ms/batch (batch built "
          f"inside), device busy {busy} ms/batch, {launches_per_batch:.1f} "
          f"device ops/batch under {len(by_name)} names; top (ms, count): "
          + "; ".join(f"{k[:70]} {v[0]:.4f} x{v[1]:.1f}" for k, v in top),
          flush=True)

    probe = [v for k, v in by_name.items() if "ht_probe_kernel" in k]
    check(len(probe) == 1 and probe[0][1] > 0,
          "the main path's trace holds no device time for the probe")
    probe_ms = probe[0][0] / probe[0][1]
    gather = [v for k, v in by_name.items() if "row_gather" in k]
    check(gather and sum(v[1] for v in gather) > 0,
          "the main path's trace holds no device time for the row gather")
    gather_n = sum(v[1] for v in gather)
    print(f"main path probe: {probe[0][1]:.1f} launches/batch, "
          f"{probe_ms} ms device per launch (transfer and account "
          f"tables); row gather {gather_n:.1f} launches/batch, "
          f"{sum(v[0] for v in gather) / gather_n} ms device per launch",
          flush=True)
    numbers = dict(
        elapsed_s=elapsed, batches=N_TIMED, transfers_per_s=tps,
        batch_ms=elapsed / N_TIMED * 1e3, wall_ms=wall, busy_ms=busy,
        ops=launches_per_batch, idle_share=1 - busy / wall,
        probe_ms=probe_ms, probe_launches=probe[0][1],
        gather_ms=sum(v[0] for v in gather) / gather_n,
        gather_launches=gather_n)
    return launches, gathers, probe_ms, numbers


def ladder_counters(led) -> tuple:
    return (led.fast_batches, led.fixpoint_batches,
            led.deep_fixpoint_batches, led.escalations, led.fallbacks)


def run_tiers(led, call):
    """Run one create_transfers call on `led`; returns (its result, (plain
    tier runs, fixpoint tier runs)), read from the ladder's state before
    the call and its counters after (ops/ledger.py
    create_transfers_arrays): off the fixpoint-first regime the plain
    tier runs and each escalation reruns the batch one tier deeper; in
    the deep-first regime only the 32-round tier runs; otherwise the
    8-round tier, and the 32-round one after it if it escalated."""
    first, deep_first = led._fixpoint_first, led._deep_first
    esc, deep = led.escalations, led.deep_fixpoint_batches
    out = call()
    if not first:
        return out, (1, led.escalations - esc)
    if deep_first > 0:
        return out, (0, 1)
    return out, (0, 1 + led.deep_fixpoint_batches - deep)


def config4_phase(dev):
    """BASELINE config 4 through the limit fixpoint tiers and the
    escalation ladder. Returns the kernels' launches in the phase and the
    timing and trace numbers."""
    from torch.profiler import ProfilerActivity, profile

    from tigerbeetle_tpu_torch import DeviceLedger
    from tigerbeetle_tpu_torch.ops import fused_probe
    from tigerbeetle_tpu_torch.ops import row_gather as RG
    from tigerbeetle_tpu_torch.ops.batch import transfers_to_arrays
    from tigerbeetle_tpu_torch.types import (
        Account, AccountFlags, CreateTransferStatus, Transfer, TransferFlags)

    created = int(CreateTransferStatus.created)
    t0 = time.perf_counter()
    gpu = DeviceLedger(a_cap=A_CAP, t_cap=T_CAP)
    cpu = DeviceLedger(a_cap=A_CAP, t_cap=T_CAP, device="cpu")
    predicted = [0, 0]   # probe, row gather launches the tier runs predict

    def predict(kind, runs=1):
        predicted[0] += PROBES_PER_RUN[kind] * runs
        predicted[1] += GATHERS_PER_RUN[kind] * runs

    def accounts_step(label, card, ref, accounts, ts):
        g = card.create_accounts(accounts, ts)
        c = ref.create_accounts(accounts, ts)
        predict("accounts")
        check([(r.timestamp, r.status) for r in g]
              == [(r.timestamp, r.status) for r in c]
              and all(r.status.name == "created" for r in g),
              f"{label}: accounts differ or were not created")

    def step(label, card, ref, ev, ts, checked=True):
        """One batch on the card (and on the CPU reference, unless None):
        launches as the tier runs predict, and card equal to CPU. A
        checked batch also proves double entry on the card."""
        before = (fused_probe.LAUNCHES, RG.LAUNCHES)
        got, (plain, fix) = run_tiers(
            card, lambda: card.create_transfers_soa(ev, ts))
        predict("plain", plain)
        predict("fixpoint", fix)
        ran = (fused_probe.LAUNCHES - before[0], RG.LAUNCHES - before[1])
        want = (PROBES_PER_RUN["plain"] * plain
                + PROBES_PER_RUN["fixpoint"] * fix,
                GATHERS_PER_RUN["plain"] * plain
                + GATHERS_PER_RUN["fixpoint"] * fix)
        check(ran == want, f"{label}: probe and row gather launched {ran} "
              f"times; {plain} plain and {fix} fixpoint runs predict {want}")
        check(card.fallbacks == 0, f"{label}: a batch fell back")
        if ref is not None:
            exp = ref.create_transfers_soa(ev, ts)
            check(np.array_equal(got[0], exp[0])
                  and np.array_equal(got[1], exp[1]),
                  f"{label}: card and CPU results differ")
            check(ladder_counters(card) == ladder_counters(ref)
                  and card._fixpoint_first == ref._fixpoint_first
                  and card._deep_first == ref._deep_first,
                  f"{label}: card and CPU ladders differ")
            for k in ("accounts", "transfers", "events"):
                check(int(card.state[k]["count"])
                      == int(ref.state[k]["count"]),
                      f"{label}: {k} counts differ")
            check(ledger_digest(card) == ledger_digest(ref),
                  f"{label}: state digests differ")
        if checked:
            double_entry(card)
        return got[0]

    # The kernel counts start from zero just before the path runs.
    fused_probe.LAUNCHES = 0
    RG.LAUNCHES = 0
    accounts_step("config-4 accounts", gpu, cpu,
                  config4_accounts(Account, AccountFlags), C4_ACCOUNTS)
    rng = np.random.default_rng(4)
    ts = 10**12
    next_id = 10**7
    pend_created = []
    for i in range(C4_CHECKED_PAIRS):
        pend, rev, next_id = config4_pair(rng, next_id, TransferFlags)
        st = step(f"config-4 pend {i}", gpu, cpu, pend, ts + BATCH + 10)
        st2 = step(f"config-4 post/void {i}", gpu, cpu, rev,
                   ts + 2 * (BATCH + 10))
        ts += 2 * (BATCH + 10)
        n_pend = int((st == created).sum())
        check(int((st2 == created).sum()) == n_pend,
              f"config-4 pair {i}: the post/void batch created "
              f"{int((st2 == created).sum())}, the pend batch {n_pend}")
        pend_created.append(n_pend)
        print(f"config-4 pair {i}: {n_pend} pendings created and resolved; "
              f"counters {ladder_counters(gpu)}", flush=True)
    check(tuple(pend_created) == C4_JAX_CREATED,
          f"config-4 created {pend_created}, the JAX package "
          f"{list(C4_JAX_CREATED)}")
    check(ladder_counters(gpu) == C4_JAX_COUNTERS,
          f"config-4 counters {ladder_counters(gpu)}, the JAX package "
          f"{C4_JAX_COUNTERS}")

    events, expect = in_batch_two_phase(Transfer, TransferFlags)
    ts += 1000
    st = step("in-batch two-phase", gpu, cpu, transfers_to_arrays(events),
              ts)
    names = [CreateTransferStatus(int(v)).name for v in st]
    check(names == expect, f"in-batch two-phase: statuses {names}")

    small = (DeviceLedger(a_cap=1 << 10, t_cap=1 << 12),
             DeviceLedger(a_cap=1 << 10, t_cap=1 << 12, device="cpu"))
    accounts, funds, cascade = cascade_steps(Account, Transfer, AccountFlags,
                                             TransferFlags)
    accounts_step("cascade accounts", *small, accounts, 10**13)
    step("cascade funds", *small, transfers_to_arrays(funds), 10**13 + 1000)
    step("12-wave cascade", *small, transfers_to_arrays(cascade),
         10**13 + 5000)
    check(ladder_counters(small[0])[2:] == (1, 2, 0),
          f"12-wave cascade: counters {ladder_counters(small[0])}, "
          "expected one deep escalation and no fallback")
    print(f"config 4 checked against the CPU: {2 * C4_CHECKED_PAIRS + 1} "
          f"batches, the cascade's 3, in {time.perf_counter() - t0:.1f} s; "
          f"counters {ladder_counters(gpu)}", flush=True)
    del cpu, small

    # Timed: the card alone, one sync after every batch so pend and
    # post/void batches are timed apart.
    pairs = []
    for _ in range(C4_TIMED_PAIRS):
        pend, rev, next_id = config4_pair(rng, next_id, TransferFlags)
        pairs.append((pend, rev))
    counters_before = ladder_counters(gpu)
    ms = {"pend": [], "post/void": []}
    n_created = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i, (pend, rev) in enumerate(pairs):
        for kind, ev, at in (("pend", pend, ts + BATCH + 10),
                             ("post/void", rev, ts + 2 * (BATCH + 10))):
            tb = time.perf_counter()
            st = step(f"timed {kind} {i}", gpu, None, ev, at,
                      checked=False)
            torch.cuda.synchronize()
            ms[kind].append((time.perf_counter() - tb) * 1e3)
            n_created += int((st == created).sum())
        ts += 2 * (BATCH + 10)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t1
    double_entry(gpu)
    delta = tuple(a - b for a, b in zip(ladder_counters(gpu),
                                        counters_before))
    timing = dict(
        elapsed_s=elapsed, batches=2 * C4_TIMED_PAIRS,
        transfers_per_s=2 * C4_TIMED_PAIRS * BATCH / elapsed,
        created_per_s=n_created / elapsed,
        pend_ms=float(np.mean(ms["pend"])),
        post_void_ms=float(np.mean(ms["post/void"])),
        counters_delta=delta)
    print(f"config 4: {C4_TIMED_PAIRS} pairs of {BATCH} in {elapsed:.4f} s = "
          f"{timing['transfers_per_s']:.0f} validated transfers/s "
          f"({timing['created_per_s']:.0f} created/s); pend "
          f"{timing['pend_ms']:.3f} ms/batch "
          f"({BATCH / timing['pend_ms'] * 1e3:.0f} transfers/s), post/void "
          f"{timing['post_void_ms']:.3f} ms/batch "
          f"({BATCH / timing['post_void_ms'] * 1e3:.0f} transfers/s); "
          f"counters over the timed run (fast, fixpoint, deep, escalations, "
          f"fallbacks) {delta}", flush=True)

    # One pend batch's trace (three in a row, their post/voids after).
    reps = 3
    prof_pairs = []
    for _ in range(reps):
        pend, rev, next_id = config4_pair(rng, next_id, TransferFlags)
        prof_pairs.append((pend, rev))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for pend, _ in prof_pairs:
            ts += BATCH + 10
            step("profiled pend", gpu, None, pend, ts, checked=False)
        torch.cuda.synchronize()
    for _, rev in prof_pairs:
        ts += BATCH + 10
        step("profiled post/void", gpu, None, rev, ts)
    by_name = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us:
            m, n = by_name.get(e.key, (0.0, 0.0))
            by_name[e.key] = (m + us / 1e3 / reps, n + e.count / reps)
    check(by_name, "the config-4 trace holds no device time")
    busy = sum(v[0] for v in by_name.values())
    ops = sum(v[1] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]

    def per_launch(tag):
        hits = [v for k, v in by_name.items() if tag in k]
        check(hits and sum(v[1] for v in hits) > 0,
              f"the config-4 trace holds no device time for {tag}")
        return (sum(v[0] for v in hits) / sum(v[1] for v in hits),
                sum(v[1] for v in hits))

    gather_ms, gather_n = per_launch("row_gather")
    probe_ms, probe_n = per_launch("ht_probe_kernel")
    trace = dict(busy_ms=busy, ops=ops, wall_ms=timing["pend_ms"],
                 idle_share=1 - busy / timing["pend_ms"],
                 gather_ms=gather_ms, gather_launches=gather_n,
                 probe_ms=probe_ms, probe_launches=probe_n)
    print(f"config-4 pend batch breakdown: wall {timing['pend_ms']:.3f} "
          f"ms/batch (timed run), device busy {busy} ms/batch, {ops:.1f} "
          f"device ops/batch under {len(by_name)} names; row_gather "
          f"{gather_n:.1f} launches x {gather_ms} ms, probe {probe_n:.1f} x "
          f"{probe_ms} ms; top (ms, count): "
          + "; ".join(f"{k[:70]} {v[0]:.4f} x{v[1]:.1f}" for k, v in top),
          flush=True)

    launches = (fused_probe.LAUNCHES, RG.LAUNCHES)
    check(launches == tuple(predicted),
          f"config 4: probe and row gather launches {launches}, the tier "
          f"runs predict {tuple(predicted)}")
    check(all(n > 0 for n in launches), "config 4 launched no kernel")
    print(f"config 4 launches: probe {launches[0]}, row gather "
          f"{launches[1]} (as the tier runs predict)", flush=True)
    return dict(probe_launches=launches[0], gather_launches=launches[1],
                timing=timing, trace=trace)


def build_all():
    """Compile both kernel sources at once (one nvcc each) and load them;
    prints each build time."""
    from tigerbeetle_tpu_torch.ops import _build

    names = ("ht_probe", "row_gather")
    took, errors = {}, {}

    def one(name):
        t = time.perf_counter()
        try:
            _build.build(name)
        except Exception as exc:   # re-raised below, in the main thread
            errors[name] = exc
        took[name] = time.perf_counter() - t

    threads = [threading.Thread(target=one, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name in names:
        if name in errors:
            raise errors[name]
        print(f"built {_build.library_path(name).name} in {took[name]:.1f} s",
              flush=True)
    _build.load_ht_probe()
    _build.load_row_gather()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    sys.path.insert(0, str(Path(__file__).resolve().parent))

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    build_all()
    probe_fx = probe_fixtures(dev)
    gather_fx = gather_fixtures(dev)
    probe = probe_phase(probe_fx)
    gather = gather_phase(gather_fx)
    del probe_fx, gather_fx
    launches, c2_gathers, main_probe_ms, c2 = main_path_phase(dev)
    c4 = config4_phase(dev)
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # ms / plain_ms / library_ms: device time per call from the profiler
    # trace (the probe on the transfer table with cold rows, the gather
    # at the transfer shape with cold rows); *stream_ms: CUDA-event time
    # per call on the stream, host issue included; main_path_ms: the
    # kernel's device time per launch in a main path's own trace;
    # floor_ms: the device time of a one-row (one-query) call, the
    # launch's fixed cost; segments: the most tables one launch serves
    # on the main path.
    x, a, two = probe["xfer_ht"], probe["acct_ht"], probe["two_tables"]
    g = gather["transfer"]
    shapes = {k: v for k, v in gather.items() if "ms" in v}
    kernels = [{
        "name": "ht_lookup_fused",
        "route": "cuda",
        "source": "tigerbeetle_tpu_torch/csrc/ht_probe.cu",
        "replaces": "tigerbeetle_tpu/ops/pallas_kernels.py:80",
        "launches": launches,
        "launches_config4": c4["probe_launches"],
        "max_abs_err": max(x["max_abs_err"], a["max_abs_err"],
                           two["max_abs_err"]),
        "ms": x["ms"],
        "plain_ms": x["plain_ms"],
        "bound_ms": x["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "stream_ms": x["stream_ms"],
        "plain_stream_ms": x["plain_stream_ms"],
        "main_path_ms": main_probe_ms,
        "main_path_ms_config4": c4["trace"]["probe_ms"],
        "floor_ms": probe["sweep"][SWEEP_COUNTS[0]],
        "segments": two["segments"],
        "acct_ht_ms": a["ms"],
        "acct_ht_plain_ms": a["plain_ms"],
        "acct_ht_bound_ms": a["bound_ms"],
        "two_tables_ms": two["ms"],
        "two_tables_plain_ms": two["plain_ms"],
        "two_tables_bound_ms": two["bound_ms"],
        "two_tables_stream_ms": two["stream_ms"],
        "sweep_ms": probe["sweep"],
    }, {
        "name": "row_gather",
        "route": "cuda",
        "source": "tigerbeetle_tpu_torch/csrc/row_gather.cu",
        "replaces": ", ".join(GATHER_REPLACES),
        "launches": c4["gather_launches"],
        "launches_config2": c2_gathers,
        "max_abs_err": max(v["max_abs_err"] for k, v in gather.items()
                           if k != "sweep"),
        "ms": g["ms"],
        "plain_ms": g["plain_ms"],
        "bound_ms": g["bound_ms"],
        "bound_by": "bytes",
        "library_ms": g["library_ms"],
        "stream_ms": g["stream_ms"],
        "plain_stream_ms": g["plain_stream_ms"],
        "library_stream_ms": g["library_stream_ms"],
        "main_path_ms": c4["trace"]["gather_ms"],
        "main_path_ms_config2": c2["gather_ms"],
        "floor_ms": gather["sweep"][SWEEP_COUNTS[0]],
        "segments": max(v["segments"] for v in shapes.values()),
        "sweep_ms": gather["sweep"],
        "shapes": shapes,
    }]
    print(json.dumps({"config2": c2}), flush=True)
    print(json.dumps({"config4": {**c4["timing"], **c4["trace"]}}),
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    # One card is what this run used, whatever the machine shows.
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
