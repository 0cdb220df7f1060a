#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py        # from the repo root, on a machine with a card

Drives the port's main paths — create_accounts and create_transfers on a
`tigerbeetle_tpu_torch.DeviceLedger`, through the plain tier (BASELINE
config 2), through the limit fixpoint tiers and their escalation ladder
(BASELINE config 4), through the exact path (the host-mirror regime) and
through the commit-window routes (config 2 and config 4 as windows, each
a replayed CUDA graph), through the imported and balancing tiers (per
batch and as windows), `run_create_*` through the sequential kernel,
the serving path (`tigerbeetle_tpu_torch.StateMachine`, wire bodies
in, reply bytes out, on the device engine with its write-through mirror
and on the kernel engine) and the serving supervisor in front of it
(`tigerbeetle_tpu_torch.ServingSupervisor`: verified epochs, injected
faults and bounded replay recovery, the chaos seeds, the admission
plane) — at the ledger's default capacities, and
holds its three CUDA kernels against their plain PyTorch twins. Phases,
each failing the run with a nonzero exit:

  1. device   a CUDA card is present; its name and power limit are
              printed as nvidia-smi gives them;
  2. build    csrc/ht_probe.cu, csrc/row_gather.cu and csrc/create_seq.cu
              are compiled by nvcc for sm_90a, all at once;
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
              timed on the card alone and one pend batch is profiled;
  7. exact    the exact path on a ledger on the card beside one on the
              CPU and the port's oracle: 10,000 accounts, 8 config-2
              batches, then a batch of each kind no device tier runs
              (config 2 imported with a linked pair, accounts with a
              repeated id, the pair-sum overflow, 8,190 pendings with a 1 s
              timeout and their expiry, the 40-wave limit cascade as the
              mirror's probe) and the config-2 batches over which the
              probe returns the ledger to its device tiers; after every
              batch, statuses and timestamps equal to the oracle's and
              the digest and counters to the CPU ledger's; to_host, the
              oracle's apply and the push timed;
  8. seq      the sequential kernel against its plain twin, bit for bit
              on every output, on 512-event mixed batches (chains,
              two-phase, balancing, closing, repeated ids, imported; and
              accounts), then `run_create_accounts` (10,000 accounts)
              and `run_create_transfers` at 8,190 events (config-3
              linked pairs, a config-4 pend batch and its post/void
              batch) equal to a second oracle; the kernel's device time
              on a config-3 batch beside the twin's (on the CPU).

  9. config-2 windows  config 2 as commit windows on the chain route, on
              the card one replay of a captured CUDA graph a window from a
              key's second window on: 2 windows of 8 prepares on the card
              and on the CPU (results, route counters and digests equal
              after each), then windows of 32 (the JAX package's
              SUPERBATCH_MAX) submitted and resolved two deep and timed,
              beside the same prepares one batch at a time and one window
              through the eager chain function; one window profiled (its
              kernels counted against the route's prediction);
 10. config-4 windows  windows of 4 pend/post-void pairs on the
              super_deep route, two deep: 2 checked against the CPU, 4
              timed, one profiled;
 11. window fallbacks  a window with a balancing prepare (on
              super_balancing, the JAX ledger's route for it) and
              a pipelined window that falls back and poisons its
              successor, each against a CPU ledger and the port's oracle;
 12. imported  an imported migration beside a CPU ledger and the port's
              oracle: 10,000 accounts imported at their user timestamps,
              8,190-event imported batches (1 in 64 a pending posted in a
              later batch) on the imported tier, one with regress lanes,
              a lane at key_max, an account-timestamp collision and a
              closing_debit pending (escalating to the imported fixpoint
              tier); timed batches, one profiled; windows of 8 prepares
              on super_imported (2 checked, 3 timed, one profiled); an
              imported batch with a linked pair, on the exact path;
 13. balancing  config 4's accounts and pairs with 1 pend event in 8 a
              balancing_debit or _credit above the headroom, up the
              balancing ladder (8, then 32 rounds), beside a CPU ledger
              and the oracle; timed pairs, one pend batch profiled;
              windows of 8 prepares on super_balancing (24 rounds), two
              deep (2 checked, 3 timed, one profiled).
 14. serving  `StateMachine(engine="device")` at the ledger's default
              capacities, wire bodies of 8,189 events in, reply bytes
              out, with its write-through host mirror, beside the port's
              "oracle"-engine StateMachine on the CPU (every reply equal
              byte for byte; the mirror's digest equal to the device's
              after every checked body and window): config-2 bodies one
              at a time (timed beside a ledger without write-through),
              commit windows of 8 synchronous and pipelined two deep with
              staging (recycle_events on for part), config-4 bodies, a
              hard body on the mirror, a pulse, every query; then
              "kernel"-engine commits of config-3 bodies (create_seq).
 15. supervisor  `ServingSupervisor` at the ledger's default capacities
              with VERIFY on, fed windows of 8,190-event config-2
              prepares over 10,000 accounts: (a) clean, windows of 4 and
              of 8 synchronous and pipelined two deep, each timed beside
              the same window on a bare write-through ledger, an epoch
              verified after each width (its drain, oracle replay, two
              digests and mirror audit timed), zero recoveries; (b)
              injected faults on windows of 2 (an in-place bit flip after
              a graph capture, a poisoned delta chunk, dispatches failing
              within and past the retry budget, a fallback storm), each
              recovered to parity, memory read after each recovery; (c)
              the chaos harness's gate seeds on the card, each summary
              equal to the CPU's; (d) the admission plane at the JAX
              package's bench_admission parameters. (a) and (b) end with
              an independent oracle replay of everything submitted.
The window phases print the memory the caching allocator holds after
each graph capture.

Prints the card line, `{"config2": ...}`, `{"config4": ...}`,
`{"exact_path": ...}`, `{"config2_window": ...}`,
`{"config4_window": ...}`, `{"window_fallbacks": ...}`,
`{"imported": ...}`, `{"balancing": ...}`, `{"serving": ...}`,
`{"supervisor": ...}` and `{"kernels": [...]}` lines, and last `{"ok": true, "device": {...}}`.
Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import dataclasses
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
CHECKED_ONLY = ("clamped", "mixed4", "window_account", "window_transfer")
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
ROW_KEY_BYTES = 16 * 8      # the key_hi and key_lo halves of a bucket row
SECTOR_BYTES = 32           # the least a read from HBM moves
U128_MAX = (1 << 128) - 1

# The exact path: setup batches before the first hard batch, and the
# waves of its limit cascade (more than the 32-round tier resolves).
X_SETUP_BATCHES = 8
X_CASCADE_CHAINS = 40
# The sequential kernel: events of each batch held against the plain
# twin, and the full-width batches (config 3 and a config-4 pair).
SEQ_CHECKED = 512
SEQ_CONFIG3_BATCHES = 2

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
#     pending view (the application reuses the rounds' balance base);
#   an imported tier, plain or fixpoint (8 or 32 rounds): the plain
#     tier's four (no in-window pending join, so no view); imported
#     accounts run create_accounts_fast's two;
#   a balancing tier (8 or 32 rounds): the fixpoint tier's five.
PROBES_PER_RUN = {"accounts": 1, "plain": 1, "fixpoint": 1, "imported": 1,
                  "balancing": 1}
GATHERS_PER_RUN = {"accounts": 2, "plain": 4, "fixpoint": 5, "imported": 4,
                   "balancing": 5}

# Commit windows (the JAX package's benchmark.py): config 2 as chain
# windows of SUPERBATCH_MAX prepares (:111, :125-189), config 4 as
# windows of W_PAIRS pend/post-void pairs on the deep window tier,
# submitted and resolved two deep (:338-420). Checked: W_CHECKED-deep
# config-2 windows and C4_W_CHECKED config-4 windows against a CPU
# ledger; timed: W_TIMED_WINDOWS config-2 windows and C4_W_TIMED config-4
# windows on the card's graph route. The fallback windows are FB_W deep.
SUPERBATCH_MAX = 32
W_CHECKED = 8
W_CHECKED_WINDOWS = 2
W_TIMED_WINDOWS = 3
C4_W_PAIRS = 4
C4_W_CHECKED = 2
C4_W_TIMED = 4
FB_W = 4
# The flat window tiers run the kernels at W·n_pad lanes: config 4's
# window of 8 prepares is 65,536 lanes, so the probe takes 2 x 65,536
# keys a table and the account-role gather 4 x 65,536 rows.
WINDOW_LANES = C4_W_PAIRS * 2 * 8192

# Imported migration (the JAX package's tests/test_imported_fast.py at
# full width): 10,000 accounts imported at user timestamps from
# IMP_A_TS0, then 8,190-event imported batches, 1 event in
# IMP_PEND_EVERY a pending whose imported post comes in a later batch:
# IMP_CHECKED batches against a CPU ledger and the oracle (the last with
# the regress, key_max, collision and closing lanes), IMP_TIMED timed,
# then windows of IMP_W prepares on super_imported (IMP_W_CHECKED
# checked, IMP_W_TIMED timed).
IMP_A_TS0 = 10**6
IMP_PEND_EVERY = 64
IMP_CHECKED = 3
IMP_TIMED = 8
IMP_W = 8
IMP_W_CHECKED = 2
IMP_W_TIMED = 3
# Balancing: config 4's accounts and pairs, 1 pend event in BAL_EVERY a
# balancing_debit or balancing_credit of BAL_AMOUNT, above any headroom
# the pairs build; BAL_CHECKED pairs checked, BAL_TIMED timed, then
# windows of BAL_W_PAIRS pairs on super_balancing, two deep.
BAL_EVERY = 8
BAL_AMOUNT = 10**9
BAL_CHECKED = 3
BAL_TIMED = 4
BAL_W_PAIRS = 4
BAL_W_CHECKED = 2
BAL_W_TIMED = 3
# The serving phase: bodies of SV_BODY events (a multi-batch body's
# trailer takes one 128-byte element of the 1 MiB message: BATCH - 1
# events fit, as in the JAX package's serving benchmark); windows of SV_W
# bodies; 1 account in SV_HISTORY_EVERY keeps history; config 4's
# accounts from SV_C4_ACCT0 + 1.
SV_BODY = BATCH - 1
SV_CHECKED = 3
SV_TIMED = 6
SV_W = 8
SV_W_SYNC = 3
SV_W_PIPED = 2
SV_C4_PAIRS = 2
SV_KERNEL = 2
SV_HISTORY_EVERY = 64
SV_C4_ACCT0 = 20_000
# The supervisor phase: (a)'s window widths (prepares a window), (c)'s
# chaos seeds (the chaos harness's gate seeds).
SP_WIDTHS = (4, 8)
SP_CHAOS_SEEDS = (1, 2, 3, 7)

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
    return uniform_batch(rng, 10**7 + b * BATCH, BATCH, N_ACCOUNTS)


def uniform_batch(rng, first_id: int, n: int, n_accounts: int) -> dict:
    """n uniform random transfers (ids first_id...) over accounts
    1..n_accounts, amounts 1..10^6 - 1, no flags."""
    ids = np.arange(first_id, first_id + n, dtype=np.uint64)
    dr = rng.integers(1, n_accounts + 1, n, dtype=np.uint64)
    cr = rng.integers(1, n_accounts + 1, n, dtype=np.uint64)
    clash = dr == cr
    cr[clash] = dr[clash] % n_accounts + 1
    z = np.zeros(n, dtype=np.uint64)
    z32 = np.zeros(n, dtype=np.uint32)
    return dict(
        id_hi=z.copy(), id_lo=ids, dr_hi=z.copy(), dr_lo=dr,
        cr_hi=z.copy(), cr_lo=cr, amt_hi=z.copy(),
        amt_lo=rng.integers(1, 10**6, n).astype(np.uint64),
        pid_hi=z.copy(), pid_lo=z.copy(), ud128_hi=z.copy(),
        ud128_lo=z.copy(), ud64=z.copy(), ud32=z32.copy(),
        timeout=z32.copy(), ledger=np.ones(n, dtype=np.uint32),
        code=np.ones(n, dtype=np.uint32), flags=z32.copy(),
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


def shifted(objs, acct_off: int, xfer_off: int = 0) -> list:
    """Accounts or transfers with every account id moved up by acct_off
    and every transfer id (and pending id) by xfer_off; zero ids stay."""
    out = []
    for o in objs:
        if hasattr(o, "debit_account_id"):
            o = dataclasses.replace(
                o, id=o.id + xfer_off,
                debit_account_id=o.debit_account_id + acct_off,
                credit_account_id=o.credit_account_id + acct_off,
                pending_id=o.pending_id + xfer_off if o.pending_id else 0)
        else:
            o = dataclasses.replace(o, id=o.id + acct_off)
        out.append(o)
    return out


def exact_path_plan(Account, Transfer, AccountFlags, TransferFlags, rng,
                    n_accounts: int = N_ACCOUNTS, batch: int = BATCH,
                    setup_batches: int = X_SETUP_BATCHES):
    """The exact-path workload: (label, op, events, timestamp, hard)
    steps, op one of "accounts", "transfers" (events as SoA) or "expire"
    (events None), hard for the steps of the hard sequence. n_accounts accounts and setup_batches uniform batches; then a
    batch of each hard kind, in the host-mirror regime the first one
    opens: uniform traffic imported at ascending user timestamps with
    one linked pair (an imported batch with a chain: the imported tiers
    fall back, as the JAX package's do); new accounts with one id repeated (the
    cascade's and the overflow's accounts among them); the cascade's
    funding; the pair-sum overflow of the JAX package's
    tests/test_fast_path.py (pend 2^127, post it, pend 2^127 - 10, then
    100 more debits: overflows_debits) on accounts of its own; `batch`
    pendings with timeout 1 s, then their expiry once the pulse is due;
    uniform batches up to the mirror's probe, which meets the
    X_CASCADE_CHAINS-wave limit cascade (deeper than the 32-round tier);
    then MIRROR_PROBE_INTERVAL + 1 uniform batches, over which the probe
    returns the ledger to its device tiers. Hard batches are filled to
    `batch` events with uniform traffic."""
    from tigerbeetle_tpu_torch.ops.batch import transfers_to_arrays
    from tigerbeetle_tpu_torch.ops.ledger import DeviceLedger

    TF = TransferFlags
    probe_interval = DeviceLedger.MIRROR_PROBE_INTERVAL
    steps = []
    ts = 10**13
    next_id = [10**7]

    def uniform(n):
        ev = uniform_batch(rng, next_id[0], n, n_accounts)
        next_id[0] += n
        return ev

    def filled(objs):
        ev = transfers_to_arrays(objs)
        if len(objs) < batch:
            ev = {k: np.concatenate([ev[k], v])
                  for k, v in uniform(batch - len(objs)).items()}
        return ev

    def add(label, op, events, gap, hard=False):
        nonlocal ts
        ts += gap
        steps.append((label, op, events, ts, hard))

    accounts = [Account(id=i, ledger=1, code=1)
                for i in range(1, n_accounts + 1)]
    for lo in range(0, n_accounts, batch):
        chunk = accounts[lo:lo + batch]
        add(f"accounts {lo}", "accounts", chunk, len(chunk))
    for b in range(setup_batches):
        add(f"setup {b}", "transfers", uniform(batch), batch + 1000)

    ev = uniform(batch)
    ev["flags"][:] = int(TF.imported)
    ev["flags"][10] |= int(TF.linked)
    ev["ts"] = np.arange(ts + 1, ts + 1 + batch, dtype=np.uint64)
    add("imported chain", "transfers", ev, batch + 1000, hard=True)

    c_acc, c_funds, c_events = cascade_steps(
        Account, Transfer, AccountFlags, TF, k_chains=X_CASCADE_CHAINS)
    off = n_accounts
    c_acc = shifted(c_acc, off)
    o_first = off + len(c_acc) + 1
    o_acc = [Account(id=o_first + j, ledger=1, code=1) for j in range(3)]
    fill_first = o_first + 3
    fill = [Account(id=fill_first + j, ledger=1, code=1, user_data_64=j)
            for j in range(batch - len(c_acc) - len(o_acc) - 1)]
    new_accounts = c_acc + o_acc + fill + [fill[len(fill) // 2]]
    add("repeated account id", "accounts", new_accounts, batch + 1000,
        hard=True)
    add("cascade funds", "transfers",
        filled(shifted(c_funds, off, 5 * 10**8)), batch + 1000)

    big = 1 << 127
    o1, o2, o3 = (a.id for a in o_acc)
    x0 = 6 * 10**8
    overflow = [
        Transfer(id=x0, debit_account_id=o1, credit_account_id=o2,
                 amount=big, ledger=1, code=1, flags=TF.pending),
        Transfer(id=x0 + 1, pending_id=x0, amount=(1 << 128) - 1,
                 flags=TF.post_pending_transfer),
        Transfer(id=x0 + 2, debit_account_id=o1, credit_account_id=o2,
                 amount=big - 10, ledger=1, code=1, flags=TF.pending),
        Transfer(id=x0 + 3, debit_account_id=o1, credit_account_id=o3,
                 amount=100, ledger=1, code=1),
    ]
    add("pair-sum overflow", "transfers", filled(overflow), batch + 1000,
        hard=True)

    ev = uniform(batch)
    ev["flags"][:] = int(TF.pending)
    ev["timeout"][:] = 1
    add("pendings, timeout 1 s", "transfers", ev, batch + 1000, hard=True)
    add("expiry", "expire", None, 2 * 10**9, hard=True)
    # The mirror's batches so far: the five hard ones; the probe comes
    # with batch probe_interval + 1.
    for b in range(probe_interval - 5):
        add(f"mirror {b}", "transfers", uniform(batch), batch + 1000)
    add("cascade (the probe)", "transfers",
        filled(shifted(c_events, off, 5 * 10**8)), batch + 1000, hard=True)
    for b in range(probe_interval + 1):
        add(f"recovery {b}", "transfers", uniform(batch), batch + 1000)
    return steps


def config3_batch(rng, b: int, n: int = BATCH, n_accounts: int = 1000):
    """One BASELINE config-3 batch (the JAX package's bench_config3):
    linked pairs (even lanes head, odd lanes terminator) over n_accounts
    accounts, ~25% of the chains poisoned by a terminator that debits a
    missing account."""
    ev = uniform_batch(rng, 10**7 + b * n, n, n_accounts)
    ev["flags"][0::2] = 1  # TransferFlags.linked
    bad = rng.random(n // 2) < 0.25
    dr = ev["dr_lo"]
    dr[1::2][bad] = n_accounts + 10**6
    ev["amt_lo"] = rng.integers(1, 1000, n).astype(np.uint64)
    return ev


def seq_mixed_transfers(Transfer, TF, rng, n: int, first_id: int,
                        n_accounts: int, pend_ids: list,
                        imported_after: int | None = None) -> list:
    """n events that reach every path of the sequential kernel: linked
    chains (some broken by a missing account), pendings with and without
    timeout, posts and voids of committed pendings (pend_ids) and of
    pendings earlier in the batch (full, partial, over-amount, twice),
    balancing debits and credits, closing pendings and voids of them,
    repeated ids (in the batch and committed), failing lanes (ledger 0,
    code 0, same accounts, u128 overflow). With imported_after set, every
    event is imported with strictly increasing timestamps from it (a few
    regress or carry no flag)."""
    evs = []
    nid = first_id
    in_batch_pend = []
    P, POST, VOID, L = (TF.pending, TF.post_pending_transfer,
                        TF.void_pending_transfer, TF.linked)

    def pair():
        d, c = rng.choice(np.arange(1, n_accounts + 1), 2, replace=False)
        return int(d), int(c)

    def x(**kw):
        nonlocal nid
        kw.setdefault("ledger", 1)
        kw.setdefault("code", 1)
        t = Transfer(id=kw.pop("id", nid), **kw)
        nid += 1
        evs.append(t)
        return t

    while len(evs) < n:
        r = rng.random()
        amt = int(rng.integers(1, 1000))
        if r < 0.15:
            for j in range(int(rng.integers(2, 5))):
                d, c = pair()
                if rng.random() < 0.15:
                    c = n_accounts + 5000
                x(debit_account_id=d, credit_account_id=c, amount=amt,
                  flags=L if j < 3 and rng.random() < 0.8 else 0)
        elif r < 0.3:
            d, c = pair()
            t = x(debit_account_id=d, credit_account_id=c, amount=amt,
                  flags=P, timeout=int(rng.integers(0, 2)) * 3600)
            in_batch_pend.append(t.id)
        elif r < 0.42:
            pool = pend_ids if (rng.random() < 0.6 or not in_batch_pend) \
                else in_batch_pend
            pid = pool[int(rng.integers(0, len(pool)))] if pool else 1
            kind = rng.random()
            f = POST if kind < 0.5 else VOID
            a = (1 << 128) - 1 if f == POST else 0
            if kind < 0.15:
                a = int(rng.integers(1, 10))         # partial post
            elif kind > 0.95:
                a = 10**9                            # over the amount
            x(pending_id=pid, amount=a, flags=f, ledger=0, code=0)
        elif r < 0.52:
            d, c = pair()
            x(debit_account_id=d, credit_account_id=c,
              amount=int(rng.integers(1, 10**6)),
              flags=TF.balancing_debit if r < 0.47 else TF.balancing_credit)
        elif r < 0.57:
            d, c = pair()
            t = x(debit_account_id=d, credit_account_id=c, amount=amt,
                  flags=P | (TF.closing_debit if r < 0.55
                             else TF.closing_credit))
            if rng.random() < 0.5:
                x(pending_id=t.id, flags=VOID, ledger=0, code=0)
        elif r < 0.63 and evs:
            # A repeated id: an event of this batch, or a committed one.
            src = evs[int(rng.integers(0, len(evs)))]
            if rng.random() < 0.3 and pend_ids:
                src = dataclasses.replace(
                    src, id=pend_ids[int(rng.integers(0, len(pend_ids)))])
            x(**{**dataclasses.asdict(src), "id": src.id})
        elif r < 0.7:
            d, c = pair()
            bad = int(rng.integers(0, 4))
            x(debit_account_id=d, credit_account_id=d if bad == 0 else c,
              amount=(1 << 128) - 1 if bad == 1 else amt,
              ledger=0 if bad == 2 else 1, code=0 if bad == 3 else 1)
        else:
            d, c = pair()
            x(debit_account_id=d, credit_account_id=c, amount=amt)
    evs = evs[:n]
    if imported_after is not None:
        for j, t in enumerate(evs):
            t.flags |= TF.imported
            t.timeout = 0
            t.timestamp = imported_after + 1 + j
            if j % 50 == 7:
                t.timestamp = imported_after - 5       # regresses
            if j % 97 == 11:
                t.flags &= ~TF.imported                # not imported
                t.timestamp = 0
    return evs


def seq_mixed_accounts(Account, AF, rng, n: int, first_id: int,
                       imported_after: int | None = None) -> list:
    """n account events: linked chains (some broken), repeated ids
    (identical and different), mutually exclusive flags, nonzero
    balances, ledger or code 0, a reserved flag; imported with increasing
    timestamps when imported_after is set."""
    evs = []
    for j in range(n):
        r = rng.random()
        a = Account(id=first_id + j, ledger=1, code=1,
                    user_data_64=int(rng.integers(0, 3)),
                    flags=int(AF.debits_must_not_exceed_credits)
                    if r < 0.2 else 0)
        if r < 0.12:
            a.flags |= AF.linked
        elif r < 0.16 and evs:
            src = evs[int(rng.integers(0, len(evs)))]
            a = dataclasses.replace(src, flags=src.flags & ~AF.linked)
            if rng.random() < 0.5:
                a.user_data_64 += 1
        elif r < 0.18:
            a.flags |= AF.credits_must_not_exceed_debits
        elif r < 0.2:
            a.debits_posted = 5
        elif r < 0.22:
            a.ledger = 0
        elif r < 0.23:
            a.flags |= 1 << 9
        evs.append(a)
    if imported_after is not None:
        for j, a in enumerate(evs):
            a.flags |= AF.imported
            a.timestamp = imported_after + 1 + j
            if j % 40 == 9:
                a.timestamp = imported_after - 3
    return evs


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

    # Checked only: both tables at a flat window's width, 2 x
    # WINDOW_LANES keys each, as per_event_status probes config 4's
    # window of 8 prepares.
    n_sets = 2 * WINDOW_LANES // N_QUERIES
    segs = tuple((table, torch.cat([q[0] for q in sets[:n_sets]]),
                  torch.cat([q[1] for q in sets[:n_sets]]))
                 for table, sets in ((a_table, a_sets), (x_table, x_sets)))
    win_err = 0
    for (gf, gv), seg in zip(fused_probe.ht_lookup_fused_multi(segs), segs):
        rf, rv = ht_lookup(*seg)
        check(torch.equal(gf, rf) and torch.equal(gv, rv),
              "window-width probe: kernel disagrees with the plain lookup")
        win_err = max(win_err, int((gv.to(torch.int64)
                                    - rv.to(torch.int64)).abs().max())
                      + int((gf != rf).sum()))
    results["window"] = dict(max_abs_err=win_err, segments=2,
                             keys=[int(sg[1].numel()) for sg in segs])
    print(f"probe at a window's width (acct_ht + xfer_ht, "
          f"{results['window']['keys']} keys in one launch): equal to the "
          "plain lookup", flush=True)
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
        # A flat window's widths (config 4's 8 prepares): the
        # account-role gather at 4 x WINDOW_LANES rows, the transfer-role
        # gather at 2 x WINDOW_LANES.
        "window_account": ([bal, meta],
                           rand_rows(4 * WINDOW_LANES, A_CAP + 1, 1), None,
                           False),
        "window_transfer": ([xfr], rand_rows(2 * WINDOW_LANES, T_CAP + 1, 1),
                            None, False),
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


def exact_path_phase(dev, n_accounts: int = N_ACCOUNTS, batch: int = BATCH,
                     setup_batches: int = X_SETUP_BATCHES,
                     caps: tuple = (A_CAP, T_CAP)):
    """The exact path: the hard batches no device tier can run, the
    host-mirror regime that answers them, the expiry pulse and the
    probe's return to the device tiers (exact_path_plan), on a ledger on
    `dev` beside one on the CPU and the port's oracle fed the same
    batches. After every batch: statuses and timestamps equal to the
    oracle's, state digests and counters equal to the CPU ledger's.
    Returns the probe and row-gather launches and the timings."""
    from tigerbeetle_tpu_torch import DeviceLedger
    from tigerbeetle_tpu_torch.oracle import StateMachineOracle
    from tigerbeetle_tpu_torch.ops import fused_probe
    from tigerbeetle_tpu_torch.ops import row_gather as RG
    from tigerbeetle_tpu_torch.ops.batch import transfers_from_arrays
    from tigerbeetle_tpu_torch.ops.ledger import results_to_arrays
    from tigerbeetle_tpu_torch.types import (
        Account, AccountFlags, Transfer, TransferFlags)

    t0 = time.perf_counter()
    card = DeviceLedger(a_cap=caps[0], t_cap=caps[1], device=dev)
    ref = DeviceLedger(a_cap=caps[0], t_cap=caps[1], device="cpu")
    sm = StateMachineOracle()
    steps = exact_path_plan(Account, Transfer, AccountFlags, TransferFlags,
                            np.random.default_rng(5), n_accounts, batch,
                            setup_batches)

    # Host timings of the card ledger's mirror work: to_host, the
    # oracle's apply and the push of what it dirtied.
    spans = {"to_host": [], "apply": [], "push": []}

    def timed(fn, key):
        def call(*args):
            t = time.perf_counter()
            out = fn(*args)
            sync(dev)
            spans[key].append((time.perf_counter() - t) * 1e3)
            return out
        return call

    to_host = card.to_host

    def to_host_timed():
        sm_dev = timed(to_host, "to_host")()
        for name in ("create_accounts", "create_transfers",
                     "expire_pending_transfers"):
            setattr(sm_dev, name, timed(getattr(sm_dev, name), "apply"))
        return sm_dev

    card.to_host = to_host_timed
    card._push_dirty = timed(card._push_dirty, "push")

    fused_probe.LAUNCHES = 0
    RG.LAUNCHES = 0
    per_batch, hard = [], []
    for label, op, events, ts, is_hard in steps:
        fb = card.fallbacks
        n_spans = {k: len(v) for k, v in spans.items()}
        t = time.perf_counter()
        if op == "accounts":
            got = results_to_arrays(card.create_accounts(events, ts))
            sync(dev)
            wall = (time.perf_counter() - t) * 1e3
            exp = results_to_arrays(ref.create_accounts(events, ts))
            want = results_to_arrays(sm.create_accounts(events, ts))
        elif op == "transfers":
            got = card.create_transfers_soa(events, ts)
            sync(dev)
            wall = (time.perf_counter() - t) * 1e3
            exp = ref.create_transfers_soa(events, ts)
            want = results_to_arrays(sm.create_transfers(
                transfers_from_arrays(events), ts))
        else:
            check(card.pulse_needed(ts) and ref.pulse_needed(ts)
                  and sm.pulse_needed(ts), f"{label}: no pulse is due")
            n = card.expire_pending_transfers(ts)
            sync(dev)
            wall = (time.perf_counter() - t) * 1e3
            got = exp = want = (np.array([n]), np.array([n]))
            check(n == ref.expire_pending_transfers(ts)
                  == sm.expire_pending_transfers(ts) == batch,
                  f"{label}: expired {n}, not {batch} on every engine")
        for name, res in (("the oracle", want), ("the CPU ledger", exp)):
            check(np.array_equal(got[0], res[0])
                  and np.array_equal(got[1], res[1]),
                  f"{label}: statuses or timestamps differ from {name}'s")
        check(ledger_digest(card) == ledger_digest(ref),
              f"{label}: state digests differ")
        counters = (ladder_counters(card), dict(card.fallback_causes))
        check(counters == (ladder_counters(ref), dict(ref.fallback_causes)),
              f"{label}: counters differ: card {counters}, CPU "
              f"{(ladder_counters(ref), ref.fallback_causes)}")
        mirror = card.fallbacks > fb or op == "expire"
        if mirror:
            per_batch.append(wall)
        new = {k: v[n_spans[k]:] for k, v in spans.items()}
        check(not mirror or (new["apply"] and new["push"]),
              f"{label}: a mirror batch recorded no apply or push span")
        if is_hard:
            hard.append(dict(label=label, wall_ms=wall,
                             to_host_ms=sum(new["to_host"]),
                             apply_ms=sum(new["apply"]),
                             push_ms=sum(new["push"])))
        print(f"exact path {label}: {'mirror' if mirror else 'device'} "
              f"{wall:.1f} ms; fallbacks {card.fallbacks}, causes "
              f"{dict(card.fallback_causes)}", flush=True)
    launches = (fused_probe.LAUNCHES, RG.LAUNCHES)

    check(card.mirror is None and ref.mirror is None,
          "the probe did not return the ledger to its device tiers")
    check(torch.device(dev).type != "cuda" or all(n > 0 for n in launches),
          f"the exact path launched probe / row gather {launches} times")
    double_entry(card)
    timing = dict(
        to_host_ms=spans["to_host"][0], hard=hard,
        mirror_batch_ms=float(np.mean(per_batch)),
        mirror_batches=len(per_batch), fallbacks=card.fallbacks,
        causes=dict(card.fallback_causes), counters=ladder_counters(card),
        elapsed_s=time.perf_counter() - t0)
    print(f"exact path: {len(steps)} steps in {timing['elapsed_s']:.1f} s, "
          f"equal to the oracle and the CPU ledger after each; first "
          f"to_host {timing['to_host_ms']:.1f} ms; "
          f"{len(per_batch)} mirror batches at "
          f"{timing['mirror_batch_ms']:.1f} ms each; hard batches (ms: "
          f"wall, to_host, oracle apply, push): "
          + "; ".join(f"{h['label']} {h['wall_ms']:.1f} "
                      f"{h['to_host_ms']:.1f} {h['apply_ms']:.1f} "
                      f"{h['push_ms']:.1f}" for h in hard)
          + f"; counters {timing['counters']}, causes {timing['causes']}; "
          f"probe {launches[0]}, row gather {launches[1]} launches",
          flush=True)
    return launches, timing


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def seq_compare(label, got: dict, want: dict) -> int:
    """Every output tensor of the kernel equal to the plain twin's;
    returns the largest absolute difference over them (0 when equal)."""
    check(set(got) == set(want), f"{label}: output keys differ")
    err = 0
    for k in want:
        g, w = got[k].cpu(), want[k]
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"{label}: output {k} has another dtype or shape")
        diff = (g.to(torch.int64) - w.to(torch.int64)).abs()
        err = max(err, int(diff.max()) if diff.numel() else 0)
        check(torch.equal(g, w),
              f"{label}: output {k} differs from the plain twin's")
    return err


def seq_bytes(tin: dict, out: dict) -> int:
    """Bytes the kernel must move: every input array read once, every
    output written once."""
    n = sum(t.numel() * t.element_size() for g in tin.values()
            if isinstance(g, dict) for t in g.values())
    return n + sum(t.numel() * t.element_size() for t in out.values())


def seq_phase(dev, n_full: int = BATCH, n_checked: int = SEQ_CHECKED,
              n_accounts: int = N_ACCOUNTS,
              config3_batches: int = SEQ_CONFIG3_BATCHES):
    """The sequential kernel. Checked: mixed batches (chains, two-phase,
    balancing, closing, repeated ids, imported) through the CUDA kernel
    and through the plain twin on the same prefetched inputs, bit-equal
    on every output. Then the path a user calls, run_create_accounts
    (n_accounts accounts) and run_create_transfers at n_full events
    (config-3 batches, and a config-4 pend batch and its post/void
    batch), on the card and held against a second oracle fed the same
    batches. Returns the kernel's launches on that path and the
    numbers."""
    from tigerbeetle_tpu_torch.oracle import StateMachineOracle
    from tigerbeetle_tpu_torch.ops import create_kernels as CK
    from tigerbeetle_tpu_torch.ops import create_seq
    from tigerbeetle_tpu_torch.ops.batch import (
        accounts_to_arrays, prefetch_create_accounts,
        prefetch_create_transfers, transfers_from_arrays,
        transfers_to_arrays)
    from tigerbeetle_tpu_torch.ops.ledger import results_to_arrays
    from tigerbeetle_tpu_torch.types import (
        Account, AccountFlags, Transfer, TransferFlags)

    t0 = time.perf_counter()
    rng = np.random.default_rng(6)
    sm = StateMachineOracle()
    n_small = 200
    ts = 10**12
    accounts = seq_mixed_accounts(Account, AccountFlags, rng, n_small, 1)
    for a in accounts:
        a.flags &= ~int(AccountFlags.linked)
    sm.create_accounts(accounts, ts)
    pend = [Transfer(id=10**6 + j, debit_account_id=1 + j % n_small,
                     credit_account_id=1 + (j + 7) % n_small,
                     amount=100 + j, ledger=1, code=1,
                     flags=TransferFlags.pending,
                     timeout=(3600 if j % 3 else 0)) for j in range(300)]
    ts += 1000
    sm.create_transfers(pend, ts)
    pend_ids = [t.id for t in pend]

    cases = []
    ts += 10**4
    cases.append(("mixed transfers", "transfers", seq_mixed_transfers(
        Transfer, TransferFlags, rng, n_checked, 2 * 10**6, n_small,
        pend_ids), ts))
    ts += 10**4
    cases.append(("imported transfers", "transfers", seq_mixed_transfers(
        Transfer, TransferFlags, rng, n_checked, 3 * 10**6, n_small,
        pend_ids, imported_after=ts - 5000), ts))
    ts += 10**4
    cases.append(("mixed accounts", "accounts", seq_mixed_accounts(
        Account, AccountFlags, rng, n_checked, 10**5), ts))
    ts += 10**4
    cases.append(("imported accounts", "accounts", seq_mixed_accounts(
        Account, AccountFlags, rng, n_checked, 2 * 10**5,
        imported_after=ts - 5000), ts))
    err = 0
    for label, kind, events, at in cases:
        if kind == "transfers":
            inputs, aux = prefetch_create_transfers(
                sm, transfers_to_arrays(events), at)
            kern, plain = (create_seq.create_transfers_seq,
                           CK.create_transfers_seq_plain)
            dtypes, apply = CK.CT_OUT_DTYPES, CK.apply_create_transfers
        else:
            inputs, aux = prefetch_create_accounts(
                sm, accounts_to_arrays(events), at)
            kern, plain = (create_seq.create_accounts_seq,
                           CK.create_accounts_seq_plain)
            dtypes, apply = CK.CA_OUT_DTYPES, CK.apply_create_accounts
        want = plain(CK.inputs_to_device(inputs, "cpu"))
        got = kern(CK.inputs_to_device(inputs, dev))
        err = max(err, seq_compare(label, got, want))
        res = apply(sm, inputs, aux, CK.outputs_to_numpy(want, dtypes))
        names = {r.status.name for r in res}
        print(f"sequential kernel vs plain twin, {label}: {len(events)} "
              f"events bit-equal on {len(want)} outputs; {len(names)} "
              f"distinct statuses", flush=True)

    # The path a user calls, counted: run_create_* on the card against a
    # second oracle. Prefetch, kernel and apply ms are the spans each
    # run_create_* call records itself.
    spans = {"prefetch": [], "kernel": [], "apply": [], "events": []}

    def step(label, a, b, kind, events, at):
        create_seq.SPANS.clear()
        if kind == "accounts":
            got = create_seq.run_create_accounts(a, events, at, device=dev)
            want = b.create_accounts(events, at)
        else:
            got = create_seq.run_create_transfers(a, events, at, device=dev)
            want = b.create_transfers(events, at)
        check(set(create_seq.SPANS) == {"prefetch", "kernel", "apply"},
              f"{label}: run_create_{kind} recorded no spans")
        for k, v in create_seq.SPANS.items():
            spans[k].append(v)
        spans["events"].append(len(events))
        g, w = results_to_arrays(got), results_to_arrays(want)
        check(np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1]),
              f"{label}: run_create_{kind} differs from the oracle")
        return g[0]

    created = int(CK._CREATED)
    create_seq.LAUNCHES = 0
    runs = 0
    a, b = StateMachineOracle(), StateMachineOracle()
    ts = 10**12
    accounts = [Account(id=i, ledger=1, code=1)
                for i in range(1, n_accounts + 1)]
    for lo in range(0, n_accounts, n_full):
        chunk = accounts[lo:lo + n_full]
        ts += len(chunk)
        st = step("accounts", a, b, "accounts", chunk, ts)
        runs += 1
        check(bool((st == created).all()), "accounts not created")
    c3 = []
    for k in range(config3_batches):
        ev = config3_batch(rng, k, n_full, min(1000, n_accounts))
        ts += n_full + 1000
        st = step(f"config-3 batch {k}", a, b, "transfers",
                  transfers_from_arrays(ev), ts)
        runs += 1
        c3.append(int((st == created).sum()))
    a, b = StateMachineOracle(), StateMachineOracle()
    c4_acc = config4_accounts(Account, AccountFlags)
    step("config-4 accounts", a, b, "accounts", c4_acc, C4_ACCOUNTS)
    pend, rev, _ = config4_pair(np.random.default_rng(4), 10**7,
                                TransferFlags, n_full)
    ts = 10**12
    st_p = step("config-4 pend", a, b, "transfers",
                transfers_from_arrays(pend), ts + n_full + 10)
    st_r = step("config-4 post/void", a, b, "transfers",
                transfers_from_arrays(rev), ts + 2 * (n_full + 10))
    runs += 3
    launches = create_seq.LAUNCHES
    check(launches == (runs if torch.device(dev).type == "cuda" else 0),
          f"run_create_* launched the kernel {launches} times in {runs} "
          "calls")
    n_pend = int((st_p == created).sum())
    check(int((st_r == created).sum()) == n_pend,
          "the config-4 post/void batch did not resolve every pending")

    numbers = dict(
        launches=launches, max_abs_err=err, kernel_ms=spans["kernel"],
        events=spans["events"], prefetch_ms=spans["prefetch"],
        apply_ms=spans["apply"], config3_created=c3,
        config4_created=n_pend)
    if torch.device(dev).type != "cuda":
        return numbers

    # The kernels line: device time of the transfers kernel on the first
    # config-3 batch's inputs (profiler), the plain twin's on the same
    # inputs (CPU), and the bound.
    rng3 = np.random.default_rng(3)
    o = StateMachineOracle()
    o.create_accounts([Account(id=i, ledger=1, code=1)
                       for i in range(1, 1001)], 1000)
    inputs, _ = prefetch_create_transfers(
        o, config3_batch(rng3, 0, n_full, 1000), 10**7)
    tin_g = CK.inputs_to_device(inputs, dev)
    tin_c = CK.inputs_to_device(inputs, "cpu")
    t = time.perf_counter()
    want = CK.create_transfers_seq_plain(tin_c)
    plain_ms = (time.perf_counter() - t) * 1e3
    got = create_seq.create_transfers_seq(tin_g)
    err = max(err, seq_compare("config-3 full width", got, want))
    bound_ms = seq_bytes(tin_g, got) / HBM_BYTES_PER_S * 1e3
    busy, by_name = device_profile(
        lambda: create_seq.create_transfers_seq(tin_g), reps=3)
    hits = [v for k, v in by_name.items() if "create_transfers_seq" in k]
    check(len(hits) == 1 and abs(hits[0][1] - 1) < 1e-9,
          f"the trace holds the kernel {hits} times a call")
    ms = hits[0][0]
    numbers.update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, ns_per_event=ms * 1e6 / n_full,
                   elapsed_s=time.perf_counter() - t0)
    print(f"sequential kernel: {launches} launches on run_create_* "
          f"({runs} calls), equal to the oracle; device {ms:.3f} ms a "
          f"{n_full}-event config-3 batch ({numbers['ns_per_event']:.0f} "
          f"ns/event; bound {bound_ms:.4f} ms, bytes), plain twin "
          f"{plain_ms:.0f} ms on the CPU; run_create_* kernel spans "
          f"(launch to outputs on the host, ms / events): "
          + ", ".join(f"{m:.2f}/{n}" for m, n in zip(spans["kernel"],
                                                     spans["events"]))
          + f"; prefetch ms {[round(x, 1) for x in spans['prefetch']]}, "
          f"apply ms {[round(x, 1) for x in spans['apply']]}; config 3 "
          f"created {c3}, config 4 {n_pend} pendings resolved; "
          f"{numbers['elapsed_s']:.1f} s", flush=True)
    return numbers


# ------------------------------------------------------------ commit windows

def window_launches(route: str, W: int) -> tuple:
    """(probe, row gather) launches of one window on `route`: one tier
    run a prepare on the chain (plain tier), one over all W·n_pad lanes
    on a flat tier."""
    if route == "chain":
        return PROBES_PER_RUN["plain"] * W, GATHERS_PER_RUN["plain"] * W
    kind = {"super_deep": "fixpoint", "super_imported": "imported",
            "super_balancing": "balancing"}.get(route, "plain")
    return PROBES_PER_RUN[kind], GATHERS_PER_RUN[kind]


def graph_launches(wg) -> tuple:
    """(launches the wrappers counted, launches the device ran), each a
    (probe, row gather) pair, over one ledger's window graphs: an eager
    window and a capture call the wrappers; an eager window and every
    replay (the one after a capture included) run the kernels."""
    counted, ran = [0, 0], [0, 0]
    for key in set(wg.eager) | set(wg.replays):
        per = window_launches(key[0], key[1])
        calls = wg.eager.get(key, 0) + wg.captures.get(key, 0)
        runs = wg.eager.get(key, 0) + wg.replays.get(key, 0)
        for i in range(2):
            counted[i] += calls * per[i]
            ran[i] += runs * per[i]
    return tuple(counted), tuple(ran)


def route_counters(led) -> tuple:
    return (dict(led.window_routes), dict(led.chain_batch_fallbacks),
            led.last_window_route, led.last_window_tier,
            led.window_fallbacks, ladder_counters(led),
            dict(led.fallback_causes))


def compare_windows(label, card, ref, got, want) -> None:
    """A window's results, route counters and state digest: card equal to
    the reference ledger."""
    check(len(got) == len(want), f"{label}: {len(got)} prepares answered, "
          f"the reference {len(want)}")
    for b, ((gs, gt), (ws, wt)) in enumerate(zip(got, want)):
        check(np.array_equal(gs, ws) and np.array_equal(gt, wt),
              f"{label}: prepare {b} differs from the reference's")
    check(route_counters(card) == route_counters(ref),
          f"{label}: route counters {route_counters(card)}, the reference "
          f"{route_counters(ref)}")
    check(ledger_digest(card) == ledger_digest(ref),
          f"{label}: state digests differ")


def drive_pipelined(led, windows) -> list:
    """Windows submitted and resolved two deep (submit k + 1, then resolve
    k), as the JAX package's config-4 benchmark drives them; returns each
    window's results in order. A window submit_window declines runs on
    the synchronous path after the pipeline drains."""
    pending, results = [], []
    for evs, tss in windows:
        tk = led.submit_window(evs, tss)
        if tk is None:
            led.resolve_windows()
            results.extend(p.results[1] for p in pending)
            pending = []
            results.append(led.create_transfers_window(evs, tss))
            continue
        pending.append(tk)
        if len(pending) > 1:
            led.resolve_windows(count=1)
            while pending and pending[0].results is not None:
                results.append(pending.pop(0).results[1])
    led.resolve_windows()
    results.extend(p.results[1] for p in pending)
    return results


def window_trace(dev, fn, label: str) -> dict:
    """One call of fn() under torch.profiler: its device-busy ms, its
    device ops and its probe and row-gather kernel counts (None where the
    trace holds no device time, and on the CPU)."""
    if torch.device(dev).type != "cuda":
        fn()
        return dict(busy_ms=None, ops=None, probes=None, gathers=None)
    from torch.profiler import ProfilerActivity, profile

    sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        sync(dev)
    by_name = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us:
            m, n = by_name.get(e.key, (0.0, 0))
            by_name[e.key] = (m + us / 1e3, n + e.count)
    if not by_name:
        print(f"{label}: the trace holds no device time", flush=True)
        return dict(busy_ms=None, ops=None, probes=None, gathers=None)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    out = dict(busy_ms=sum(v[0] for v in by_name.values()),
               ops=sum(v[1] for v in by_name.values()),
               probes=sum(v[1] for k, v in by_name.items()
                          if "ht_probe_kernel" in k),
               gathers=sum(v[1] for k, v in by_name.items()
                           if "row_gather" in k))
    print(f"{label}: device busy {out['busy_ms']} ms, {out['ops']} device "
          f"ops, probe kernels {out['probes']}, row-gather kernels "
          f"{out['gathers']}; top (ms, count): "
          + "; ".join(f"{k[:60]} {v[0]:.4f} x{v[1]}" for k, v in top),
          flush=True)
    return out


def check_trace(label, trace, route, W) -> None:
    if trace["busy_ms"] is None:
        return
    want = window_launches(route, W)
    check((trace["probes"], trace["gathers"]) == want,
          f"{label}: the trace holds {trace['probes']} probe and "
          f"{trace['gathers']} row-gather kernels, the route predicts {want}")


def window_breakdown(dev, led, route: str, window) -> dict:
    """Where a window's time goes, taken after the timed run on the ledger
    that ran it. Host: the window's per-window steps (the pre-route
    scans, stacking, packing the lane matrix, the copy to the card, the
    copy of the outputs back), host clock with a sync around each. Card:
    the span of one replay of the route's graph between CUDA events,
    replayed poisoned (force_fallback set: every prepare falls back and
    the state is untouched, which the digest is held to) and so running
    the kernels a committing window runs. (None on the CPU.)"""
    from tigerbeetle_tpu_torch.ops.ledger import (
        _WINDOW_OUTS, _evs_pend_refs, _has_balancing, _has_closing,
        _has_imported, _pad_bucket)
    from tigerbeetle_tpu_torch.ops.window_graph import Harvest

    evs, tss = window
    n_pad = _pad_bucket(max(len(e["id_lo"]) for e in evs))
    host = {}

    def timed(name, fn):
        sync(dev)
        t = time.perf_counter()
        out = fn()
        sync(dev)
        host[name] = (time.perf_counter() - t) * 1e3
        return out

    timed("pre_route", lambda: (_has_imported(evs), _has_balancing(evs),
                                _has_closing(evs), _evs_pend_refs(evs)))
    lanes = timed("pack_copy_in",
                  lambda: led._pack(route, evs, tss, n_pad))
    out = dict(host_ms=host, replay_span_ms=None, replay_spans_ms=None)
    key = (route, len(evs), n_pad)
    if torch.device(dev).type != "cuda":
        return out
    graph, outs = led.windows._graphs[key]
    before = ledger_digest(led)
    spans = []
    led.windows._ff.fill_(True)
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        spans.append(start.elapsed_time(end))
    # The host's side of one poisoned window, as submit_window issues it:
    # the input copy, the replay and the output copies, host clock until
    # the calls return (no sync), then until the card is done.
    sync(dev)
    t = time.perf_counter()
    led._pack(route, evs, tss, n_pad)
    t_put = time.perf_counter()
    graph.replay()
    t_replay = time.perf_counter()
    harvest = Harvest(outs, _WINDOW_OUTS)
    t_issue = time.perf_counter()
    sync(dev)
    t_done = time.perf_counter()
    issue = dict(put=(t_put - t) * 1e3, replay=(t_replay - t_put) * 1e3,
                 harvest=(t_issue - t_replay) * 1e3,
                 drain=(t_done - t_issue) * 1e3)
    harvest.get()
    led.windows._ff.fill_(False)
    got = timed("copy_out", lambda: Harvest(outs, _WINDOW_OUTS).get())
    check(bool(np.all(got["fallback"])) and ledger_digest(led) == before,
          f"{key}: a poisoned replay did not fall back whole or changed "
          "the state")
    out.update(replay_span_ms=float(np.median(spans)), replay_spans_ms=spans,
               issue_ms=issue)
    return out


def funded_ledger(dev, caps, accounts, ts0: int):
    from tigerbeetle_tpu_torch import DeviceLedger

    led = DeviceLedger(a_cap=caps[0], t_cap=caps[1], device=dev)
    for lo in range(0, len(accounts), BATCH):
        chunk = accounts[lo:lo + BATCH]
        res = led.create_accounts(chunk, ts0 + lo + len(chunk))
        check(all(r.status.name == "created" for r in res),
              "window phase: an account was not created")
    return led


def config2_window_phase(dev, n_accounts: int = N_ACCOUNTS,
                         batch: int = BATCH, w_checked: int = W_CHECKED,
                         w_timed: int = SUPERBATCH_MAX,
                         timed_windows: int = W_TIMED_WINDOWS,
                         caps: tuple = (A_CAP, T_CAP)) -> dict:
    """Config 2 as commit windows on the chain route.

    Checked: W_CHECKED_WINDOWS windows of w_checked prepares on `dev` and
    on a CPU ledger (the first window of the key runs eagerly, the second
    is captured and replayed on the card); after each, statuses,
    timestamps, route counters and state digest equal.

    Timed: windows of w_timed prepares on a card ledger G (an eager
    window, a captured one, timed_windows windows submitted and resolved
    two deep, one profiled, one last), beside the same prepares one batch
    at a time on a second ledger P (equal results, timed over the same
    prepares), and the last window through the eager chain function on
    P's state, called directly. Returns the numbers, with the launches
    the wrappers counted and the device ran."""
    from tigerbeetle_tpu_torch.ops import fused_probe
    from tigerbeetle_tpu_torch.ops import row_gather as RG
    from tigerbeetle_tpu_torch.ops.fast_kernels import create_transfers_chain
    from tigerbeetle_tpu_torch.ops.ledger import (
        _pad_bucket, events_to_device, stack_chain_window)
    from tigerbeetle_tpu_torch.types import Account, CreateTransferStatus

    t0 = time.perf_counter()
    created = int(CreateTransferStatus.created)
    accounts = [Account(id=i, ledger=1, code=1)
                for i in range(1, n_accounts + 1)]
    rng = np.random.default_rng(20)
    counter = itertools.count()
    clock = [10**12]

    def window(W):
        evs, tss = [], []
        for _ in range(W):
            evs.append(uniform_batch(rng, 10**7 + next(counter) * batch,
                                     batch, n_accounts))
            clock[0] += batch + 1000
            tss.append(clock[0])
        return evs, tss

    fused_probe.LAUNCHES = 0
    RG.LAUNCHES = 0
    counted = [0, 0]    # wrapper calls outside the window graphs

    def add(kind, runs=1):
        counted[0] += PROBES_PER_RUN[kind] * runs
        counted[1] += GATHERS_PER_RUN[kind] * runs

    n_acc_batches = -(-n_accounts // BATCH)
    card = funded_ledger(dev, caps, accounts, 10**11)
    ref = funded_ledger("cpu", caps, accounts, 10**11)
    add("accounts", n_acc_batches)
    for w in range(W_CHECKED_WINDOWS):
        evs, tss = window(w_checked)
        got = card.create_transfers_window(evs, tss)
        want = ref.create_transfers_window(evs, tss)
        compare_windows(f"config-2 window {w}", card, ref, got, want)
        check(all(bool((st == created).all()) for st, _ in got)
              and card.window_routes == {"chain": w + 1},
              f"config-2 window {w}: not every transfer created on the "
              f"chain route ({card.window_routes})")
    n_pad = _pad_bucket(batch)
    key = ("chain", w_checked, n_pad)
    if torch.device(dev).type == "cuda":
        check((card.windows.eager, card.windows.captures,
               card.windows.replays) == ({key: 1}, {key: 1}, {key: 1}),
              f"config-2 windows: eager {card.windows.eager}, captures "
              f"{card.windows.captures}, replays {card.windows.replays}")
    double_entry(card)
    checked_s = time.perf_counter() - t0
    print(f"config-2 windows checked against the CPU: "
          f"{W_CHECKED_WINDOWS} windows of {w_checked} in {checked_s:.1f} s "
          f"(graphs: eager {card.windows.eager}, captures "
          f"{card.windows.captures}, replays {card.windows.replays})",
          flush=True)
    graphs = [graph_launches(card.windows)]
    memory = graph_memory(card)
    # The CPU reference's plain-twin calls (a rehearsal on the CPU counts
    # them beside the card ledger's).
    ref_calls = tuple(graph_launches(ref.windows)[0][i]
                      + n_acc_batches * (PROBES_PER_RUN["accounts"],
                                         GATHERS_PER_RUN["accounts"])[i]
                      for i in (0, 1))
    del ref

    G = funded_ledger(dev, caps, accounts, 10**11)
    P = funded_ledger(dev, caps, accounts, 10**11)
    add("accounts", 2 * n_acc_batches)
    windows = [window(w_timed) for _ in range(timed_windows + 4)]
    eager_w, capture_w, timed_ws = windows[0], windows[1], windows[2:-2]
    prof_w, last_w = windows[-2], windows[-1]

    def on_g(evs, tss):
        t = time.perf_counter()
        res = G.create_transfers_window(evs, tss)
        return res, (time.perf_counter() - t) * 1e3

    g_res = {}
    g_res[0], eager_ms = on_g(*eager_w)
    g_res[1], capture_ms = on_g(*capture_w)
    sync(dev)
    t1 = time.perf_counter()
    piped = drive_pipelined(G, timed_ws)
    sync(dev)
    g_elapsed = time.perf_counter() - t1
    for i, res in enumerate(piped):
        g_res[2 + i] = res

    def profiled():
        g_res[len(windows) - 2] = G.create_transfers_window(*prof_w)

    trace = window_trace(dev, profiled,
                         f"config-2 window of {w_timed} (one replay)")
    check_trace("config-2 window", trace, "chain", w_timed)

    # The same prepares one batch at a time on P (timed over the windows
    # G timed), equal to G's results.
    p_elapsed = 0.0
    for w, (evs, tss) in enumerate(windows[:-1]):
        sync(dev)
        t = time.perf_counter()
        res = [P.create_transfers_soa(ev, ts) for ev, ts in zip(evs, tss)]
        sync(dev)
        if 2 <= w < 2 + timed_windows:
            p_elapsed += time.perf_counter() - t
        add("plain", len(evs))
        for b, ((gs, gt), (ps, pt)) in enumerate(zip(g_res[w], res)):
            check(np.array_equal(gs, ps) and np.array_equal(gt, pt)
                  and bool((gs == created).all()),
                  f"config-2 window {w} prepare {b}: the graph route and "
                  "the per-batch path differ")

    # The last window: a replay on G, and the eager chain function on P's
    # state, called directly.
    g_last, last_ms = on_g(*last_w)
    ev, seg = stack_chain_window(*last_w, n_pad=n_pad)
    ev = events_to_device(ev, P.device)
    seg = events_to_device(seg, P.device)
    sync(dev)
    t = time.perf_counter()
    _, out = create_transfers_chain(P.state, ev, seg)
    st = out["r_status"].cpu().numpy()
    eager_fn_ms = (time.perf_counter() - t) * 1e3
    add("plain", w_timed)
    check(not bool(out["fallback"].any()), "the eager chain fell back")
    for b, (gs, _) in enumerate(g_last):
        check(np.array_equal(gs, st[b, :batch].astype(np.uint32)),
              f"last window prepare {b}: replay and eager chain differ")
    check(ledger_digest(G) == ledger_digest(P),
          "the graph route's ledger and the per-batch ledger differ")
    double_entry(G)
    parts = window_breakdown(dev, G, "chain", last_w)
    graphs.append(graph_launches(G.windows))
    check(G.window_routes == {"chain": len(windows)}
          and G.window_fallbacks == 0 and G.fallbacks == 0,
          f"config-2 windows: routes {G.window_routes}, fallbacks "
          f"{G.window_fallbacks} / {G.fallbacks}")
    gkey = ("chain", w_timed, n_pad)
    if torch.device(dev).type == "cuda":
        check(G.windows.replays.get(gkey) == len(windows) - 1
              and G.windows.captures.get(gkey) == 1,
              f"config-2 timed windows: replays {G.windows.replays}, "
              f"captures {G.windows.captures}")

    wrap = tuple(counted[i] + sum(g[0][i] for g in graphs) for i in (0, 1))
    ran = tuple(counted[i] + sum(g[1][i] for g in graphs) for i in (0, 1))
    launches = (fused_probe.LAUNCHES, RG.LAUNCHES)
    if torch.device(dev).type == "cuda":
        check(launches == wrap, f"config-2 windows: the wrappers counted "
              f"{launches} launches, the routes predict {wrap}")
    n = timed_windows * w_timed * batch
    numbers = dict(
        window=w_timed, windows=timed_windows,
        transfers_per_s=n / g_elapsed, window_ms=g_elapsed / timed_windows
        * 1e3, per_batch_transfers_per_s=n / p_elapsed,
        per_batch_window_ms=p_elapsed / timed_windows * 1e3,
        per_batch_ms=p_elapsed / (timed_windows * w_timed) * 1e3,
        eager_window_ms=eager_ms, capture_window_ms=capture_ms,
        last_window_ms=last_ms, eager_chain_fn_ms=eager_fn_ms,
        busy_ms=trace["busy_ms"], ops=trace["ops"],
        idle_share=(None if trace["busy_ms"] is None else
                    1 - trace["busy_ms"] / (g_elapsed / timed_windows
                                            * 1e3)),
        trace_probes=trace["probes"], trace_gathers=trace["gathers"],
        breakdown=parts,
        launches_counted=wrap, launches_ran=ran, cpu_ref_calls=ref_calls,
        reserved_at_capture={**memory, **graph_memory(G)},
        checked_s=checked_s, elapsed_s=time.perf_counter() - t0)
    print(f"config-2 windows of {w_timed}: {timed_windows} windows (two "
          f"deep) in {g_elapsed:.4f} s = {numbers['transfers_per_s']:.0f} "
          f"transfers/s, {numbers['window_ms']:.3f} ms/window; the same "
          f"prepares one batch at a time {p_elapsed:.4f} s = "
          f"{numbers['per_batch_transfers_per_s']:.0f} transfers/s "
          f"({numbers['per_batch_ms']:.3f} ms/batch); eager window "
          f"{eager_ms:.1f} ms, capture window {capture_ms:.1f} ms, last "
          f"replay {last_ms:.3f} ms, eager chain function {eager_fn_ms:.1f} "
          f"ms; idle share {numbers['idle_share']}; launches counted {wrap}"
          f", run {ran}; a window's host steps (ms) {parts['host_ms']}, "
          f"its replay's span on the card {parts['replay_spans_ms']} ms, "
          f"issue (ms) {parts.get('issue_ms')}; memory reserved before and "
          f"after each capture {numbers['reserved_at_capture']}",
          flush=True)
    return numbers


def config4_window_phase(dev, batch: int = BATCH, pairs: int = C4_W_PAIRS,
                         n_checked: int = C4_W_CHECKED,
                         n_timed: int = C4_W_TIMED,
                         caps: tuple = (A_CAP, T_CAP)) -> dict:
    """Config 4 as windows of `pairs` pend/post-void pairs (2 x pairs
    prepares, each post/void batch referring to the pend batch before it,
    so every window takes the super_deep route), submitted and resolved
    two deep as the JAX package's benchmark does. Checked: n_checked
    windows on `dev` and on a CPU ledger driven alike, results, route
    counters and state digest equal. Timed: n_timed more windows on the
    card; then one window profiled. Returns the numbers."""
    from tigerbeetle_tpu_torch.ops import fused_probe
    from tigerbeetle_tpu_torch.ops import row_gather as RG
    from tigerbeetle_tpu_torch.types import (
        Account, AccountFlags, CreateTransferStatus, TransferFlags)

    t0 = time.perf_counter()
    created = int(CreateTransferStatus.created)
    rng = np.random.default_rng(40)
    state = dict(ts=10**12, next_id=10**7)

    def window():
        evs, tss = [], []
        for _ in range(pairs):
            pend, rev, state["next_id"] = config4_pair(
                rng, state["next_id"], TransferFlags, batch)
            evs += [pend, rev]
            tss += [state["ts"] + batch + 10, state["ts"] + 2 * (batch + 10)]
            state["ts"] += 2 * (batch + 10)
        return evs, tss

    fused_probe.LAUNCHES = 0
    RG.LAUNCHES = 0
    accounts = config4_accounts(Account, AccountFlags)
    card = funded_ledger(dev, caps, accounts, 0)
    ref = funded_ledger("cpu", caps, accounts, 0)
    checked = [window() for _ in range(n_checked)]
    got = drive_pipelined(card, checked)
    want = drive_pipelined(ref, checked)
    compare_windows("config-4 windows", card, ref,
                    [p for w in got for p in w], [p for w in want for p in w])
    check(card.window_routes == {"super_deep": n_checked},
          f"config-4 windows: routes {card.window_routes}")
    n_created = [int((st == created).sum()) for w in got for st, _ in w]
    check(n_created[0::2] == n_created[1::2],
          f"config-4 windows: created {n_created}: a post/void batch did "
          "not resolve every pending of its pend batch")
    double_entry(card)
    checked_s = time.perf_counter() - t0
    print(f"config-4 windows checked against the CPU: {n_checked} windows "
          f"of {2 * pairs} prepares in {checked_s:.1f} s; created "
          f"{n_created}; counters {route_counters(card)}", flush=True)
    ref_calls = tuple(graph_launches(ref.windows)[0][i]
                      + (PROBES_PER_RUN["accounts"],
                         GATHERS_PER_RUN["accounts"])[i] for i in (0, 1))
    del ref

    timed = [window() for _ in range(n_timed)]
    sync(dev)
    t1 = time.perf_counter()
    res = drive_pipelined(card, timed)
    sync(dev)
    elapsed = time.perf_counter() - t1
    n_timed_created = sum(int((st == created).sum())
                          for w in res for st, _ in w)
    prof_w = window()
    trace = window_trace(dev, lambda: card.create_transfers_window(*prof_w),
                         f"config-4 window of {2 * pairs} (one replay)")
    check_trace("config-4 window", trace, "super_deep", 2 * pairs)
    double_entry(card)
    parts = window_breakdown(dev, card, "super_deep", prof_w)
    check(card.window_routes == {"super_deep": n_checked + n_timed + 1}
          and card.window_fallbacks == 0 and card.fallbacks == 0,
          f"config-4 windows: counters {route_counters(card)}")
    counted, ran = graph_launches(card.windows)
    counted = (counted[0] + PROBES_PER_RUN["accounts"],
               counted[1] + GATHERS_PER_RUN["accounts"])
    ran = (ran[0] + PROBES_PER_RUN["accounts"],
           ran[1] + GATHERS_PER_RUN["accounts"])
    launches = (fused_probe.LAUNCHES, RG.LAUNCHES)
    if torch.device(dev).type == "cuda":
        check(launches == counted, f"config-4 windows: the wrappers counted "
              f"{launches} launches, the routes predict {counted}")
    window_ms = elapsed / n_timed * 1e3
    numbers = dict(
        window=2 * pairs, windows=n_timed, elapsed_s=elapsed,
        window_ms=window_ms,
        transfers_per_s=n_timed * 2 * pairs * batch / elapsed,
        created_per_s=n_timed_created / elapsed,
        busy_ms=trace["busy_ms"], ops=trace["ops"],
        idle_share=(None if trace["busy_ms"] is None
                    else 1 - trace["busy_ms"] / window_ms),
        trace_probes=trace["probes"], trace_gathers=trace["gathers"],
        breakdown=parts,
        launches_counted=counted, launches_ran=ran, cpu_ref_calls=ref_calls,
        graphs=dict(eager=len(card.windows.eager),
                    captures=sum(card.windows.captures.values()),
                    replays=sum(card.windows.replays.values())),
        reserved_at_capture=graph_memory(card),
        checked_s=checked_s, elapsed_total_s=time.perf_counter() - t0)
    print(f"config-4 windows of {2 * pairs}: {n_timed} windows (two deep) "
          f"in {elapsed:.4f} s = {window_ms:.3f} ms/window, "
          f"{numbers['transfers_per_s']:.0f} validated transfers/s, "
          f"{numbers['created_per_s']:.0f} created/s; idle share "
          f"{numbers['idle_share']}; launches counted {counted}, run {ran}; "
          f"a window's host steps (ms) {parts['host_ms']}, its replay's "
          f"span on the card {parts['replay_spans_ms']} ms, issue (ms) "
          f"{parts.get('issue_ms')}; memory reserved before and after each "
          f"capture {numbers['reserved_at_capture']}", flush=True)
    return numbers


def window_fallback_phase(dev, n_accounts: int = N_ACCOUNTS,
                          batch: int = BATCH, depth: int = FB_W,
                          caps: tuple = (A_CAP, T_CAP)) -> dict:
    """The window fallbacks, each on a fresh ledger on `dev` beside one on
    the CPU and the port's oracle fed the same prepares:

      balancing  a window whose prepare 1 carries a balancing_credit
                 lane: the JAX ledger's route, its balancing window tier
                 (super_balancing), takes it whole on the device;
      poisoned   two windows in flight, the first with a repeated id in
                 its prepare 2: the chain commits prepares 0-1, prepare 2
                 replays per batch and the rest re-windows, and the
                 second window, poisoned on the device, replays whole.

    Results equal the CPU ledger's and the oracle's, and so do the route
    counters and the digest (the CPU ledger's)."""
    from tigerbeetle_tpu_torch.oracle import StateMachineOracle
    from tigerbeetle_tpu_torch.ops.batch import transfers_from_arrays
    from tigerbeetle_tpu_torch.ops.ledger import results_to_arrays
    from tigerbeetle_tpu_torch.types import Account, TransferFlags

    t0 = time.perf_counter()
    accounts = [Account(id=i, ledger=1, code=1)
                for i in range(1, n_accounts + 1)]
    rng = np.random.default_rng(30)
    counter = itertools.count()
    clock = [10**12]

    def window():
        evs, tss = [], []
        for _ in range(depth):
            evs.append(uniform_batch(rng, 10**7 + next(counter) * batch,
                                     batch, n_accounts))
            clock[0] += batch + 1000
            tss.append(clock[0])
        return evs, tss

    def trio():
        sm = StateMachineOracle()
        for lo in range(0, n_accounts, BATCH):
            chunk = accounts[lo:lo + BATCH]
            sm.create_accounts(chunk, 10**11 + lo + len(chunk))
        return (funded_ledger(dev, caps, accounts, 10**11),
                funded_ledger("cpu", caps, accounts, 10**11), sm)

    def oracle(sm, windows):
        return [[results_to_arrays(sm.create_transfers(
            transfers_from_arrays(ev), ts)) for ev, ts in zip(*w)]
            for w in windows]

    out = {}
    card, ref, sm = trio()
    evs, tss = window()
    evs[1]["flags"][5] = np.uint32(int(TransferFlags.balancing_credit))
    got = card.create_transfers_window(evs, tss)
    want = ref.create_transfers_window(evs, tss)
    compare_windows("balancing window", card, ref, got, want)
    compare_windows("balancing window (oracle)", card, card, got,
                    oracle(sm, [(evs, tss)])[0])
    check(card.window_routes == {"super_balancing": 1}
          and card.window_fallbacks == 0 and card.fallbacks == 0,
          f"balancing window: counters {route_counters(card)}")
    out["balancing"] = route_counters(card)[:5]
    print(f"balancing window: on super_balancing whole; counters "
          f"{route_counters(card)}", flush=True)

    card, ref, sm = trio()
    windows = [window(), window()]
    evs0 = windows[0][0]
    evs0[2]["id_lo"][7] = evs0[2]["id_lo"][3]
    got = drive_pipelined(card, windows)
    want = drive_pipelined(ref, windows)
    compare_windows("poisoned windows", card, ref,
                    [p for w in got for p in w], [p for w in want for p in w])
    compare_windows("poisoned windows (oracle)", card, card,
                    [p for w in got for p in w],
                    [p for w in oracle(sm, windows) for p in w])
    check(card.chain_batch_fallbacks.get("e2_collision", 0) >= 1
          and card.window_routes.get("chain", 0) >= 2,
          f"poisoned windows: counters {route_counters(card)}")
    out["poisoned"] = route_counters(card)[:5]
    out["elapsed_s"] = time.perf_counter() - t0
    print(f"poisoned windows: the first falls back at prepare 2, the "
          f"second replays; counters {route_counters(card)}; both cases in "
          f"{out['elapsed_s']:.1f} s", flush=True)
    return out


class ImportedFeed:
    """An imported migration's traffic: accounts 1..n_accounts imported
    at user timestamps IMP_A_TS0 + id, then uniform batches imported at
    strictly ascending user timestamps, each batch's between the last
    prepare timestamp and its own. 1 event in IMP_PEND_EVERY is an
    imported pending; a batch made with post=True first posts (imported,
    the whole amount) the pendings not posted yet."""

    def __init__(self, rng, n_accounts: int, batch: int, TF):
        self.rng = rng
        self.n_accounts = n_accounts
        self.batch = batch
        self.TF = TF
        self.next_id = 10**7
        self.ts = 10**12     # the last prepare timestamp
        self.pool = []       # pendings not posted yet

    def accounts(self, Account, AccountFlags):
        imp = int(AccountFlags.imported)
        return [Account(id=i, ledger=1, code=1, flags=imp,
                        timestamp=IMP_A_TS0 + i)
                for i in range(1, self.n_accounts + 1)]

    def next_batch(self, post: bool = True):
        """(SoA events, prepare timestamp) of the next batch."""
        TF, n = self.TF, self.batch
        ev = uniform_batch(self.rng, self.next_id, n, self.n_accounts)
        self.next_id += n
        lane = np.arange(n)
        pend = lane % IMP_PEND_EVERY == IMP_PEND_EVERY - 1
        ev["flags"][:] = int(TF.imported)
        ev["flags"][pend] |= int(TF.pending)
        posts = self.pool[:n // 2] if post else []
        k = len(posts)
        if k:
            self.pool = self.pool[k:]
            top = np.uint64((1 << 64) - 1)
            ev["flags"][:k] = int(TF.imported | TF.post_pending_transfer)
            ev["pid_lo"][:k] = posts
            for f in ("dr_lo", "cr_lo"):
                ev[f][:k] = 0
            ev["amt_hi"][:k] = top
            ev["amt_lo"][:k] = top
            ev["ledger"][:k] = 0
            ev["code"][:k] = 0
        self.pool += ev["id_lo"][pend & (lane >= k)].tolist()
        ev["ts"] = np.arange(self.ts + 1, self.ts + 1 + n, dtype=np.uint64)
        self.ts += n + 1000
        return ev, self.ts


def tier_runs(led, ev, call):
    """Run call(), one create_transfers call of the events `ev` on `led`;
    returns (its result,
    {tier kind: runs}), read from the ladder's state before the call and
    its counters after (ops/ledger.py create_transfers_arrays): an
    imported batch runs the imported tier and one tier deeper a rung it
    escalates; a balancing batch the balancing tier (its deep one alone
    in the deep-first regime) and one deeper a rung; any other batch the
    plain / fixpoint ladder (`run_tiers`)."""
    from tigerbeetle_tpu_torch.ops.ledger import _has_balancing, _has_imported

    esc = led.escalations
    if _has_imported([ev]):
        out = call()
        return out, {"imported": 1 + led.escalations - esc}
    if _has_balancing([ev]):
        deep_first = led._bal_deep_first
        out = call()
        return out, {"balancing": 1 if deep_first
                     else 1 + led.escalations - esc}
    out, (plain, fix) = run_tiers(led, call)
    return out, {"plain": plain, "fixpoint": fix}


def predicted(runs: dict) -> tuple:
    return (sum(PROBES_PER_RUN[k] * n for k, n in runs.items()),
            sum(GATHERS_PER_RUN[k] * n for k, n in runs.items()))


class Trio:
    """A ledger on `dev`, one on the CPU and the port's oracle, fed the
    same batches: every batch's statuses and timestamps equal on all
    three, the digest and the counters equal between the ledgers, and
    the kernels launched as the tier runs predict (the card's wrappers;
    none on the CPU)."""

    def __init__(self, dev, caps, label):
        from tigerbeetle_tpu_torch import DeviceLedger
        from tigerbeetle_tpu_torch.oracle import StateMachineOracle

        self.card = DeviceLedger(a_cap=caps[0], t_cap=caps[1], device=dev)
        self.ref = DeviceLedger(a_cap=caps[0], t_cap=caps[1], device="cpu")
        self.sm = StateMachineOracle()
        self.label = label
        self.cuda = torch.device(dev).type == "cuda"
        self.predicted = [0, 0]

    def _launches(self):
        from tigerbeetle_tpu_torch.ops import fused_probe
        from tigerbeetle_tpu_torch.ops import row_gather as RG
        return fused_probe.LAUNCHES, RG.LAUNCHES

    def _check(self, label, got, exp, want):
        for name, res in (("the oracle", want), ("the CPU ledger", exp)):
            check(np.array_equal(got[0], res[0])
                  and np.array_equal(got[1], res[1]),
                  f"{label}: statuses or timestamps differ from {name}'s")
        counters = (ladder_counters(self.card), self.card._bal_deep_first,
                    dict(self.card.fallback_causes))
        check(counters == (ladder_counters(self.ref),
                           self.ref._bal_deep_first,
                           dict(self.ref.fallback_causes)),
              f"{label}: counters differ: card {counters}")
        check(ledger_digest(self.card) == ledger_digest(self.ref),
              f"{label}: state digests differ")

    def accounts(self, label, accounts, ts):
        from tigerbeetle_tpu_torch.ops.ledger import results_to_arrays

        before = self._launches()
        got = results_to_arrays(self.card.create_accounts(accounts, ts))
        ran = tuple(a - b for a, b in zip(self._launches(), before))
        want_runs = predicted({"accounts": 1})
        check(not self.cuda or ran == want_runs,
              f"{label}: probe and row gather launched {ran}, the tier "
              f"predicts {want_runs}")
        self.predicted = [a + b for a, b in zip(self.predicted, want_runs)]
        self._check(label, got,
                    results_to_arrays(self.ref.create_accounts(accounts, ts)),
                    results_to_arrays(self.sm.create_accounts(accounts, ts)))
        return got

    def transfers(self, label, ev, ts, mirror=False):
        """One batch; returns (its statuses, {tier kind: runs})."""
        from tigerbeetle_tpu_torch.ops.batch import transfers_from_arrays
        from tigerbeetle_tpu_torch.ops.ledger import results_to_arrays

        before = self._launches()
        fb = self.card.fallbacks
        got, runs = tier_runs(self.card, ev, lambda: (
            self.card.create_transfers_soa(ev, ts)))
        ran = tuple(a - b for a, b in zip(self._launches(), before))
        check((self.card.fallbacks > fb) == mirror,
              f"{label}: {'no' if mirror else 'a'} mirror batch, "
              f"counters {ladder_counters(self.card)}")
        if not mirror:
            check(not self.cuda or ran == predicted(runs),
                  f"{label}: probe and row gather launched {ran}, the tier "
                  f"runs {runs} predict {predicted(runs)}")
            self.predicted = [a + b for a, b in
                              zip(self.predicted, predicted(runs))]
        self._check(label, got, self.ref.create_transfers_soa(ev, ts),
                    results_to_arrays(self.sm.create_transfers(
                        transfers_from_arrays(ev), ts)))
        return got[0], runs

    def windows(self, label, windows, pipelined=False):
        """Windows on the card and the CPU ledger (two deep when
        pipelined, else one at a time), each prepare also on the
        oracle; returns the card's results."""
        from tigerbeetle_tpu_torch.ops.batch import transfers_from_arrays
        from tigerbeetle_tpu_torch.ops.ledger import results_to_arrays

        def drive(led):
            if pipelined:
                return drive_pipelined(led, windows)
            return [led.create_transfers_window(*w) for w in windows]

        got = drive(self.card)
        want = drive(self.ref)
        flat = [p for w in got for p in w]
        compare_windows(label, self.card, self.ref, flat,
                        [p for w in want for p in w])
        compare_windows(f"{label} (oracle)", self.card, self.card, flat,
                        [results_to_arrays(self.sm.create_transfers(
                            transfers_from_arrays(ev), ts))
                         for evs, tss in windows
                         for ev, ts in zip(evs, tss)])
        return got


def timed_batches(dev, trio, batches, label):
    """Each batch on the trio's card ledger alone, synced around each;
    its tier runs join the trio's launch prediction. Returns (ms per
    batch, validated transfers/s, {tier kind: runs})."""
    ms, n_events, runs = [], 0, {}
    for ev, ts in batches:
        sync(dev)
        t = time.perf_counter()
        (st, _), r = tier_runs(trio.card, ev, lambda: (
            trio.card.create_transfers_soa(ev, ts)))
        sync(dev)
        ms.append((time.perf_counter() - t) * 1e3)
        n_events += len(st)
        for k, v in r.items():
            runs[k] = runs.get(k, 0) + v
        trio.predicted = [a + b for a, b in zip(trio.predicted,
                                                predicted(r))]
    total = sum(ms) / 1e3
    print(f"{label}: {len(ms)} batches in {total:.4f} s = "
          f"{n_events / total:.0f} validated transfers/s "
          f"({np.mean(ms):.3f} ms/batch; each {[round(m, 3) for m in ms]}); "
          f"tier runs {runs}", flush=True)
    return float(np.mean(ms)), n_events / total, runs


class counted_replays:
    """While open, the trio's card ledger's create_transfers_soa (what a
    window that falls back whole replays per batch) counts its tier runs
    into the trio's launch prediction."""

    def __init__(self, trio):
        self.trio = trio

    def __enter__(self):
        trio = self.trio
        soa = trio.card.create_transfers_soa

        def counted(ev, ts):
            out, runs = tier_runs(trio.card, ev, lambda: soa(ev, ts))
            trio.predicted = [a + b for a, b in zip(trio.predicted,
                                                    predicted(runs))]
            return out

        trio.card.create_transfers_soa = counted

    def __exit__(self, *exc):
        del self.trio.card.create_transfers_soa


def poisoned_replay(led, key) -> None:
    """One replay of the ledger's graph for `key` with force_fallback set:
    the window's kernels run, every prepare falls back and the state is
    left as it was (checked). On the CPU (no graphs) nothing runs."""
    if key not in led.windows._graphs:
        return
    graph, outs = led.windows._graphs[key]
    before = ledger_digest(led)
    led.windows._ff.fill_(True)
    graph.replay()
    led.windows._ff.fill_(False)
    check(bool(outs["fallback"].all()) and ledger_digest(led) == before,
          f"{key}: a poisoned replay committed or changed the state")


def graph_memory(led) -> dict:
    """The bytes the caching allocator held just before and just after
    each of the ledger's graph captures, by key (empty on the CPU)."""
    return {",".join(map(str, k)): list(v)
            for k, v in led.windows.reserved.items()}


def imported_phase(dev, n_accounts: int = N_ACCOUNTS, batch: int = BATCH,
                   n_checked: int = IMP_CHECKED, n_timed: int = IMP_TIMED,
                   w: int = IMP_W, w_checked: int = IMP_W_CHECKED,
                   w_timed: int = IMP_W_TIMED,
                   caps: tuple = (A_CAP, T_CAP)) -> dict:
    """An imported migration (ImportedFeed) on a ledger on `dev` beside
    one on the CPU and the port's oracle (Trio): the accounts on the
    imported accounts tier; n_checked imported batches on the imported
    tier, the last with in-batch regress lanes, a lane at the state's
    key_max, one at the user timestamp of an account imported just
    before it (the collision), and a closing_debit pending (which
    escalates to the imported fixpoint tier); n_timed batches on the
    card alone and one profiled; windows of w prepares on super_imported
    (w_checked checked, w_timed timed, one profiled), each a replay of
    its graph from the key's second window on; last, an imported batch
    with a linked pair, which falls back to the exact path. Returns the
    numbers."""
    from tigerbeetle_tpu_torch.ops import fused_probe
    from tigerbeetle_tpu_torch.ops import row_gather as RG
    from tigerbeetle_tpu_torch.types import (
        Account, AccountFlags, CreateAccountStatus, CreateTransferStatus,
        TransferFlags)

    t0 = time.perf_counter()
    TF = TransferFlags
    names = {int(s): s.name for s in CreateTransferStatus}
    feed = ImportedFeed(np.random.default_rng(60), n_accounts, batch, TF)
    fused_probe.LAUNCHES = 0
    RG.LAUNCHES = 0
    trio = Trio(dev, caps, "imported")
    accounts = feed.accounts(Account, AccountFlags)
    for lo in range(0, n_accounts, BATCH):
        chunk = accounts[lo:lo + BATCH]
        st, ts = trio.accounts(f"imported accounts {lo}", chunk,
                               10**11 + lo + len(chunk))
        check(bool((st == int(CreateAccountStatus.created)).all())
              and ts.tolist() == [a.timestamp for a in chunk],
              f"imported accounts {lo}: not created at their user "
              "timestamps")
    check(trio.card.fast_batches == -(-n_accounts // BATCH)
          and trio.card.fallbacks == 0,
          f"imported accounts: counters {ladder_counters(trio.card)}")

    for b in range(n_checked - 1):
        st, runs = trio.transfers(f"imported batch {b}", *feed.next_batch())
        check(runs == {"imported": 1},
              f"imported batch {b}: tier runs {runs}")
    # The checked batch with the extras. Its lanes' user timestamps will
    # be base + lane.
    key_max = int(trio.card.state["xfer_key_max"]) & ((1 << 64) - 1)
    base = feed.ts + 1
    coll_lane, close_lane = 500 % batch, 700 % batch
    x_acct = Account(id=n_accounts + 1, ledger=1, code=1,
                     flags=int(AccountFlags.imported),
                     timestamp=base + coll_lane)
    trio.accounts("imported account in the transfers' range", [x_acct],
                  base + coll_lane + 1)
    ev, ts = feed.next_batch()
    regress = [r % batch for r in (200, 201, 202)]
    for r in regress:
        ev["ts"][r] = ev["ts"][r - 7]
    at_key_max = 300 % batch
    ev["ts"][at_key_max] = key_max
    ev["flags"][close_lane] = int(TF.imported | TF.pending
                                  | TF.closing_debit)
    closed = ev["dr_lo"][close_lane]
    for i in (close_lane + 3, close_lane + 5):
        ev["dr_lo"][i % batch] = closed
        ev["cr_lo"][i % batch] = closed % n_accounts + 1
    st, runs = trio.transfers("imported extras", ev, ts)
    got = {k: names[int(st[i])] for k, i in (
        ("regress", regress[0]), ("key_max", at_key_max),
        ("collision", coll_lane), ("closing", close_lane))}
    check(got == {"regress": "imported_event_timestamp_must_not_regress",
                  "key_max": "imported_event_timestamp_must_not_regress",
                  "collision": "imported_event_timestamp_must_not_regress",
                  "closing": "created"}
          and runs == {"imported": 2},
          f"imported extras: statuses {got}, tier runs {runs}")
    later = [i for i in range(close_lane + 1, batch)
             if ev["dr_lo"][i] == closed
             and int(ev["flags"][i]) & int(TF.post_pending_transfer) == 0]
    check(len(later) >= 2
          and all(names[int(st[i])] == "debit_account_already_closed"
                  for i in later),
          "imported extras: a debit of the closed account did not fail")
    checked_s = time.perf_counter() - t0
    print(f"imported: {n_checked} batches checked against the CPU and the "
          f"oracle in {checked_s:.1f} s; extras {got}, {len(later)} debits "
          f"of the closed account failed; counters "
          f"{ladder_counters(trio.card)}", flush=True)

    def window():
        evs, tss = [], []
        for j in range(w):
            ev, ts = feed.next_batch(post=j == 0)
            evs.append(ev)
            tss.append(ts)
        return evs, tss

    mem0 = torch.cuda.memory_reserved() if trio.cuda else None
    trio.windows(f"imported windows of {w}",
                 [window() for _ in range(w_checked)])
    check(trio.card.window_routes == {"super_imported": w_checked}
          and trio.card.window_fallbacks == 0,
          f"imported windows: counters {route_counters(trio.card)}")
    checked_s = time.perf_counter() - t0
    del trio.ref, trio.sm   # the card alone from here

    batch_ms, tps, runs = timed_batches(
        dev, trio, [feed.next_batch() for _ in range(n_timed)],
        f"imported batches of {batch} (card alone)")
    check(runs == {"imported": n_timed}, f"imported timed: tier runs {runs}")
    prof = [feed.next_batch()]
    trace = window_trace(
        dev, lambda: timed_batches(dev, trio, prof, "imported profiled"),
        f"imported batch of {batch} (profiled)")
    check(trace["busy_ms"] is None
          or (trace["probes"], trace["gathers"]) == predicted(
              {"imported": 1}),
          f"imported batch trace: {trace}")
    timed = [window() for _ in range(w_timed)]
    sync(dev)
    t1 = time.perf_counter()
    for evs, tss in timed:
        trio.card.create_transfers_window(evs, tss)
    sync(dev)
    w_elapsed = time.perf_counter() - t1
    prof_w = window()
    w_trace = window_trace(
        dev, lambda: trio.card.create_transfers_window(*prof_w),
        f"imported window of {w} (one replay)")
    check_trace("imported window", w_trace, "super_imported", w)
    check(trio.card.window_routes == {"super_imported": w_checked
                                      + w_timed + 1}
          and trio.card.window_fallbacks == 0
          and trio.card.fallbacks == 0,
          f"imported windows: counters {route_counters(trio.card)}")
    counted, ran = graph_launches(trio.card.windows)
    launches = (fused_probe.LAUNCHES, RG.LAUNCHES)
    want = tuple(a + b for a, b in zip(trio.predicted, counted))
    check(not trio.cuda or launches == want,
          f"imported: the wrappers counted {launches} launches, the tier "
          f"runs and windows predict {want}")
    double_entry(trio.card)
    counters = ladder_counters(trio.card)
    routes = dict(trio.card.window_routes)
    reserved = graph_memory(trio.card)
    pred = tuple(trio.predicted)
    del trio

    # Last, on fresh ledgers: an imported batch with a linked pair falls
    # back to the exact path, as on the JAX package's imported tiers.
    chain = Trio(dev, caps, "imported chain")
    feed = ImportedFeed(np.random.default_rng(61), n_accounts, batch, TF)
    for lo in range(0, n_accounts, BATCH):
        chunk = accounts[lo:lo + BATCH]
        chain.accounts(f"imported accounts {lo}", chunk,
                       10**11 + lo + len(chunk))
    ev, ts = feed.next_batch()
    ev["flags"][10] |= int(TF.linked)
    chain.transfers("imported chain", ev, ts, mirror=True)
    check(chain.card.fallback_causes == {"e1_hard_flags": 1},
          f"imported chain: causes {chain.card.fallback_causes}")
    del chain
    window_ms = w_elapsed / w_timed * 1e3
    numbers = dict(
        batch_ms=batch_ms, transfers_per_s=tps,
        batch_busy_ms=trace["busy_ms"],
        batch_idle_share=(None if trace["busy_ms"] is None
                          else 1 - trace["busy_ms"] / batch_ms),
        window=w, window_ms=window_ms,
        window_transfers_per_s=w_timed * w * batch / w_elapsed,
        window_busy_ms=w_trace["busy_ms"],
        window_idle_share=(None if w_trace["busy_ms"] is None
                           else 1 - w_trace["busy_ms"] / window_ms),
        launches=launches, launches_ran=tuple(
            a + b for a, b in zip(pred, ran)),
        counters=counters, routes=routes, reserved_before_windows=mem0,
        reserved_at_capture=reserved,
        checked_s=checked_s, elapsed_s=time.perf_counter() - t0)
    print(f"imported: {batch_ms:.3f} ms/batch ({tps:.0f} transfers/s), "
          f"batch busy {trace['busy_ms']} ms (idle "
          f"{numbers['batch_idle_share']}); windows of {w}: "
          f"{window_ms:.3f} ms/window "
          f"({numbers['window_transfers_per_s']:.0f} transfers/s), busy "
          f"{w_trace['busy_ms']} ms (idle {numbers['window_idle_share']}); "
          f"launches {launches} (as predicted), ran {numbers['launches_ran']}"
          f"; memory reserved before the windows {mem0}, before and after "
          f"each capture {numbers['reserved_at_capture']}; "
          f"{numbers['elapsed_s']:.1f} s; {card_line_or_cpu(dev)}",
          flush=True)
    return numbers


def card_line_or_cpu(dev) -> str:
    return card_line() if torch.device(dev).type == "cuda" else "CPU"


def balancing_pair(rng, next_id: int, TF, n: int = BATCH,
                   window: bool = False):
    """A config-4 pair (config4_pair) whose pend batch carries, 1 event
    in BAL_EVERY, a balancing_debit or balancing_credit (by turns) of
    BAL_AMOUNT, above any headroom: each clamps to what is left, so the
    clamps cascade through the batch. One batch at a time the post/void
    batch posts or voids the balancing pendings too (their stored
    amounts are the clamps). In a window (window=True) those lanes are
    plain transfers instead: a window whose post refers to a balancing
    pending of the same window falls back (the in-window view reads the
    nominal amount)."""
    pend, rev, nxt = config4_pair(rng, next_id, TF, n)
    lane = np.arange(n)
    bal = lane % BAL_EVERY == 0
    pend["flags"][bal] |= np.where(lane[bal] // BAL_EVERY % 2 == 0,
                                   int(TF.balancing_debit),
                                   int(TF.balancing_credit)).astype(np.uint32)
    pend["amt_lo"][bal] = BAL_AMOUNT
    if window:
        # Between odd (unlimited) accounts: no limit decision reads them.
        k = int(bal.sum())
        dr = 2 * rng.integers(0, C4_ACCOUNTS // 2, k, dtype=np.uint64) + 1
        rev["dr_lo"][bal] = dr
        rev["cr_lo"][bal] = (dr + 1) % C4_ACCOUNTS + 1
        rev["amt_hi"][bal] = 0
        rev["amt_lo"][bal] = rng.integers(1, 100, k).astype(np.uint64)
        rev["pid_lo"][bal] = 0
        rev["flags"][bal] = 0
        rev["ledger"][bal] = 1
        rev["code"][bal] = 1
    return pend, rev, nxt


def balancing_phase(dev, batch: int = BATCH, n_checked: int = BAL_CHECKED,
                    n_timed: int = BAL_TIMED, pairs: int = BAL_W_PAIRS,
                    w_checked: int = BAL_W_CHECKED,
                    w_timed: int = BAL_W_TIMED,
                    caps: tuple = (A_CAP, T_CAP)) -> dict:
    """Balancing on config 4's accounts (balancing_pair), on a ledger on
    `dev` beside one on the CPU and the port's oracle (Trio): n_checked
    pairs, each pend batch up the balancing ladder (8 rounds, then 32,
    then the 32-round tier first in its deep-first regime), each
    post/void batch up the limit ladder; n_timed pairs on the card alone
    and one pend batch profiled; then windows of `pairs` pairs on
    super_balancing (24 rounds), submitted and resolved two deep:
    w_checked checked, w_timed timed, one profiled. Returns the
    numbers."""
    from tigerbeetle_tpu_torch.ops import fused_probe
    from tigerbeetle_tpu_torch.ops import row_gather as RG
    from tigerbeetle_tpu_torch.ops.ledger import _pad_bucket
    from tigerbeetle_tpu_torch.types import (
        Account, AccountFlags, CreateTransferStatus, TransferFlags)

    t0 = time.perf_counter()
    TF = TransferFlags
    created = int(CreateTransferStatus.created)
    rng = np.random.default_rng(70)
    state = dict(ts=10**12, next_id=10**7)
    fused_probe.LAUNCHES = 0
    RG.LAUNCHES = 0
    trio = Trio(dev, caps, "balancing")
    trio.accounts("balancing accounts",
                  config4_accounts(Account, AccountFlags), C4_ACCOUNTS)

    def pair(window=False):
        pend, rev, state["next_id"] = balancing_pair(
            rng, state["next_id"], TF, batch, window)
        out = [(pend, state["ts"] + batch + 10),
               (rev, state["ts"] + 2 * (batch + 10))]
        state["ts"] += 2 * (batch + 10)
        return out

    all_runs = []
    for i in range(n_checked):
        (pend, t_p), (rev, t_r) = pair()
        st, runs = trio.transfers(f"balancing pend {i}", pend, t_p)
        all_runs.append(runs)
        st2, runs2 = trio.transfers(f"balancing post/void {i}", rev, t_r)
        print(f"balancing pair {i}: pend {int((st == created).sum())} "
              f"created on {runs}, post/void {int((st2 == created).sum())} "
              f"on {runs2}; counters {ladder_counters(trio.card)}, "
              f"balancing deep-first {trio.card._bal_deep_first}",
              flush=True)
    check(trio.card.fallbacks == 0 and trio.card.fixpoint_batches > 0,
          f"balancing: counters {ladder_counters(trio.card)}")
    double_entry(trio.card)

    def window():
        evs, tss = [], []
        for _ in range(pairs):
            for ev, ts in pair(window=True):
                evs.append(ev)
                tss.append(ts)
        return evs, tss

    mem0 = torch.cuda.memory_reserved() if trio.cuda else None
    with counted_replays(trio):
        trio.windows(f"balancing windows of {2 * pairs}",
                     [window() for _ in range(w_checked)], pipelined=True)
    checked_s = time.perf_counter() - t0
    del trio.ref, trio.sm   # the card alone from here

    timed = [pair() for _ in range(n_timed)]
    before = ladder_counters(trio.card)
    ms = {"pend": [], "post/void": []}
    for (pend, t_p), (rev, t_r) in timed:
        for kind, ev, at in (("pend", pend, t_p), ("post/void", rev, t_r)):
            ms[kind].append(timed_batches(dev, trio, [(ev, at)],
                                          f"balancing {kind}")[0])
    prof_pend, prof_rev = pair()
    trace = window_trace(
        dev, lambda: timed_batches(dev, trio, [prof_pend], "profiled"),
        f"balancing pend batch of {batch} (profiled)")
    timed_batches(dev, trio, [prof_rev], "balancing post/void")
    check(trio.card.fallbacks == 0,
          f"balancing timed: counters {ladder_counters(trio.card)}")
    delta = tuple(a - b for a, b in zip(ladder_counters(trio.card), before))

    timed_w = [window() for _ in range(w_timed)]
    sync(dev)
    t1 = time.perf_counter()
    with counted_replays(trio):
        res = drive_pipelined(trio.card, timed_w)
    sync(dev)
    w_elapsed = time.perf_counter() - t1
    n_w_created = sum(int((st == created).sum()) for w in res for st, _ in w)
    # A window whose clamp cascade outruns the 24 rounds falls back whole
    # (the state untouched), is dispatched again on the synchronous path,
    # falls back again and runs per batch: the JAX ledger's route.
    routes = dict(trio.card.window_routes)
    k = routes.get("per_batch", 0)
    n_windows = w_checked + w_timed
    check(routes == {"super_balancing": n_windows + k,
                     **({"per_batch": k} if k else {})}
          and trio.card.window_fallbacks == 2 * k and k < n_windows
          and trio.card.fallbacks == 0,
          f"balancing windows: counters {route_counters(trio.card)}")
    # One window's device work: a poisoned replay of the route's graph
    # (force_fallback set: every kernel of a committing window runs, the
    # state is untouched).
    w_trace = window_trace(
        dev, lambda: poisoned_replay(
            trio.card, ("super_balancing", 2 * pairs, _pad_bucket(batch))),
        f"balancing window of {2 * pairs} (one poisoned replay)")
    check_trace("balancing window", w_trace, "super_balancing", 2 * pairs)
    counted, ran = graph_launches(trio.card.windows)
    launches = (fused_probe.LAUNCHES, RG.LAUNCHES)
    want = tuple(a + b for a, b in zip(trio.predicted, counted))
    check(not trio.cuda or launches == want,
          f"balancing: the wrappers counted {launches} launches, the tier "
          f"runs and windows predict {want}")
    double_entry(trio.card)
    pend_mean = float(np.mean(ms["pend"]))
    window_ms = w_elapsed / w_timed * 1e3
    numbers = dict(
        pend_ms=pend_mean, post_void_ms=float(np.mean(ms["post/void"])),
        pend_transfers_per_s=batch / pend_mean * 1e3,
        pend_busy_ms=trace["busy_ms"],
        pend_idle_share=(None if trace["busy_ms"] is None
                         else 1 - trace["busy_ms"] / pend_mean),
        pend_runs=all_runs, counters_delta=delta,
        window=2 * pairs, window_ms=window_ms, window_fallbacks=k,
        window_transfers_per_s=w_timed * 2 * pairs * batch / w_elapsed,
        window_created_per_s=n_w_created / w_elapsed,
        window_busy_ms=w_trace["busy_ms"],
        window_idle_share=(None if w_trace["busy_ms"] is None
                           else 1 - w_trace["busy_ms"] / window_ms),
        launches=launches, launches_ran=tuple(
            a + b for a, b in zip(trio.predicted, ran)),
        window_launches_counted=counted, window_launches_ran=ran,
        counters=ladder_counters(trio.card),
        routes=dict(trio.card.window_routes),
        reserved_before_windows=mem0,
        reserved_at_capture=graph_memory(trio.card),
        checked_s=checked_s, elapsed_s=time.perf_counter() - t0)
    print(f"balancing: pend {pend_mean:.3f} ms/batch "
          f"({numbers['pend_transfers_per_s']:.0f} transfers/s), post/void "
          f"{numbers['post_void_ms']:.3f} ms/batch; pend busy "
          f"{trace['busy_ms']} ms (idle {numbers['pend_idle_share']}); "
          f"counters over the timed run {delta}; windows of {2 * pairs}: "
          f"{window_ms:.3f} ms/window, {k} of {n_windows} fell back to "
          f"the per-batch ladder "
          f"({numbers['window_transfers_per_s']:.0f} transfers/s), busy "
          f"{w_trace['busy_ms']} ms (idle {numbers['window_idle_share']}); "
          f"launches {launches} (as predicted), ran "
          f"{numbers['launches_ran']}; memory reserved "
          f"before the windows {mem0}, before and after each capture "
          f"{numbers['reserved_at_capture']}; "
          f"{numbers['elapsed_s']:.1f} s; {card_line_or_cpu(dev)}",
          flush=True)
    return numbers


# ------------------------------------------------------- the serving phase

def wire_body(evs) -> bytes:
    """Transfer events (SoA dicts, one an inner batch) -> one multi-batch
    create_transfers wire body."""
    from tigerbeetle_tpu_torch import multi_batch
    from tigerbeetle_tpu_torch.ops.batch import TRANSFER_WIRE

    parts = []
    for ev in evs:
        rec = np.zeros(len(ev["id_lo"]), dtype=TRANSFER_WIRE)
        for k in TRANSFER_WIRE.names:
            rec[k] = ev[k]
        parts.append(rec.tobytes())
    return multi_batch.encode(parts, 128)


def accounts_body(accounts) -> bytes:
    from tigerbeetle_tpu_torch import multi_batch
    return multi_batch.encode([b"".join(a.pack() for a in accounts)], 128)


def offset_accounts(ev: dict, off: int) -> dict:
    """The events with their non-zero account ids moved up by `off`."""
    ev = dict(ev)
    for k in ("dr_lo", "cr_lo"):
        ev[k] = np.where(ev[k] != 0, ev[k] + np.uint64(off), ev[k])
    return ev


class Serving:
    """A StateMachine on `dev` beside the port's "oracle"-engine
    StateMachine on the CPU, fed the same wire bodies: every reply equal
    byte for byte; `check_digest` holds the card's write-through mirror
    (drained) to the device state's digest and to the CPU engine's."""

    def __init__(self, card, ref, a_cap: int):
        self.card = card
        self.ref = ref
        self.a_cap = a_cap
        self.ts = 10**12
        self.bodies = 0

    def next_ts(self, n: int) -> int:
        self.ts += n + 1000
        return self.ts

    def same(self, label, got, want) -> None:
        check(got == want, f"{label}: the card's reply differs from the "
              "CPU oracle engine's")
        self.bodies += 1

    def commit(self, label, op, body, ts) -> bytes:
        got = self.card.commit(op, body, ts)
        self.same(label, got, self.ref.commit(op, body, ts))
        return got

    def check_digest(self, label, with_ref: bool = False) -> None:
        """The drained mirror's digest equal to the device state's (and,
        with_ref, to the CPU engine's state's: a second pack, ~8 µs a
        transfer on the host)."""
        from tigerbeetle_tpu_torch.ops.state_epoch import (
            device_state_digest, oracle_state_digest)

        mirror = oracle_state_digest(self.card.state, self.a_cap)
        check(mirror == device_state_digest(self.card.led.state),
              f"{label}: the mirror's digest differs from the device's")
        check(not with_ref
              or mirror == oracle_state_digest(self.ref.state, self.a_cap),
              f"{label}: the mirror's digest differs from the CPU engine's")


def drive_serving(card, windows, stage: bool) -> list:
    """Commit windows through stage_ / submit_ / resolve_commit_window[s],
    two deep (submit k, stage k + 1, resolve k - 1); a window the
    pipeline declines commits synchronously after it drains. Returns the
    replies of every window in order."""
    from tigerbeetle_tpu_torch.types import Operation

    op = Operation.create_transfers
    replies, in_flight = [], 0
    if stage and windows:
        card.stage_commit_window(op, *windows[0])
    for i, (bodies, tss) in enumerate(windows):
        rec = card.submit_commit_window(op, bodies, tss)
        if rec is None:
            replies.extend(r["replies"] for r in
                           card.resolve_commit_windows())
            in_flight = 0
            replies.append(card.commit_window(op, bodies, tss))
            continue
        in_flight += 1
        if stage and i + 1 < len(windows):
            card.stage_commit_window(op, *windows[i + 1])
        if in_flight > 1:
            done = card.resolve_commit_windows(count=1)
            in_flight -= len(done)
            replies.extend(r["replies"] for r in done)
    replies.extend(r["replies"] for r in card.resolve_commit_windows())
    return replies


def serving_phase(dev, n_accounts: int = N_ACCOUNTS, body: int = SV_BODY,
                  n_checked: int = SV_CHECKED, n_timed: int = SV_TIMED,
                  w: int = SV_W, w_sync: int = SV_W_SYNC,
                  w_piped: int = SV_W_PIPED, c4_pairs: int = SV_C4_PAIRS,
                  n_kernel: int = SV_KERNEL,
                  caps: tuple = (A_CAP, T_CAP)) -> dict:
    """The serving path: `StateMachine(engine="device")` at the ledger's
    full capacity on `dev`, wire bodies in and reply bytes out, beside
    the port's "oracle"-engine StateMachine on the CPU fed the same
    bodies (every reply equal byte for byte):

      - n_accounts accounts (1 in SV_HISTORY_EVERY with history);
      - n_checked config-2 bodies of `body` events one at a time, each
        checked (the kernels' launches as the plain tier and one delta
        gather predict; the mirror's digest against the device's), then
        n_timed bodies timed, each beside the same batch on a
        DeviceLedger without write-through (the write-through's cost),
        and the drain of their queued deltas;
      - w_sync synchronous commit_window windows of w bodies (the first
        checked by digest), timed, one more profiled; then windows
        through stage_ / submit_ / resolve_commit_window two deep: w_piped
        staged, 2 profiled; then with recycle_events on (the ring window
        kernels, their key warmed by 2 windows) w_piped a turn, staged,
        inline (overlap_staging off), inline, staged: transfers/s, idle
        share, host_stall_fraction and the drain for each;
      - c4_pairs config-4 pairs, a pend body with 1 s timeouts, then one
        hard body (a repeated id: the mirror, no to_host), a pulse past
        the timeouts, and one request of every query operation;
      - then n_kernel config-3 bodies on a "kernel"-engine StateMachine on
        `dev` (the sequential kernel, csrc/create_seq.cu) beside a CPU
        oracle engine.

    The mirror's digest is checked against the device's after every
    checked body and window. Returns the numbers."""
    from tigerbeetle_tpu_torch import DeviceLedger, StateMachine
    from tigerbeetle_tpu_torch import multi_batch
    from tigerbeetle_tpu_torch.ops import create_seq, fused_probe
    from tigerbeetle_tpu_torch.ops import ledger as L
    from tigerbeetle_tpu_torch.ops import row_gather as RG
    from tigerbeetle_tpu_torch.ops.batch import transfers_soa_from_bytes
    from tigerbeetle_tpu_torch.ops.batch import encode_create_results
    from tigerbeetle_tpu_torch.types import (
        Account, AccountFilter, AccountFilterFlags, AccountFlags,
        ChangeEventsFilter, Operation, QueryFilter, TransferFlags)

    t0 = time.perf_counter()
    cuda = torch.device(dev).type == "cuda"
    O = Operation
    TF = TransferFlags
    rng = np.random.default_rng(70)
    fused_probe.LAUNCHES = RG.LAUNCHES = create_seq.LAUNCHES = 0
    gathers0, d2h0 = L.DELTA_GATHERS, L.D2H_BYTES

    sv = Serving(StateMachine("device", a_cap=caps[0], t_cap=caps[1],
                              device=dev),
                 StateMachine("oracle", device="cpu"), caps[0])
    card, led = sv.card, sv.card.led
    plain = DeviceLedger(a_cap=caps[0], t_cap=caps[1], device=dev)
    hist = int(AccountFlags.history)
    accounts = [Account(id=i, ledger=1, code=1 + i % 3,
                        user_data_32=i % 7,
                        flags=hist if i % SV_HISTORY_EVERY == 0 else 0)
                for i in range(1, n_accounts + 1)]
    for lo in range(0, n_accounts, body):
        chunk = accounts[lo:lo + body]
        ts = sv.next_ts(len(chunk))
        sv.commit(f"accounts {lo}", O.create_accounts,
                  accounts_body(chunk), ts)
        plain.create_accounts(chunk, ts)
    sv.check_digest("accounts", with_ref=True)
    n_acct_bodies = -(-n_accounts // body)

    next_id = [10**8]

    def c2_body():
        ev = uniform_batch(rng, next_id[0], body, n_accounts)
        next_id[0] += body
        return ev, wire_body([ev])

    # ---- one body at a time: checked
    for b in range(n_checked):
        ev, raw = c2_body()
        ts = sv.next_ts(body)
        before = (fused_probe.LAUNCHES, RG.LAUNCHES)
        reply = card.commit(O.create_transfers, raw, ts)
        ran = (fused_probe.LAUNCHES - before[0], RG.LAUNCHES - before[1])
        want_ran = (PROBES_PER_RUN["plain"], GATHERS_PER_RUN["plain"] + 1)
        check(not cuda or ran == want_ran,
              f"serving body {b}: probe and row gather launched {ran}, the "
              f"plain tier and one delta gather predict {want_ran}")
        sv.same(f"serving body {b}", reply,
                sv.ref.commit(O.create_transfers, raw, ts))
        plain.create_transfers_soa(ev, ts)
        sv.check_digest(f"serving body {b}", with_ref=True)
    check(led.fallbacks == 0
          and led.fast_batches == n_acct_bodies + n_checked,
          f"serving: counters {ladder_counters(led)}")

    # ---- one body at a time: timed beside a ledger without write-through.
    # The previous body's delta drains (timed on its own) before each, as
    # a read between commits would drain it: its pinned buffers go back
    # to the caching host allocator for the next body's copy.
    wt_ms, plain_ms, drain_ms, timed = [], [], [], []
    d2h_batches = L.D2H_BYTES
    for b in range(n_timed):
        ev, raw = c2_body()
        ts = sv.next_ts(body)
        inner = transfers_soa_from_bytes(multi_batch.decode(raw, 128)[0])
        t = time.perf_counter()
        led.drain_mirror()
        drain_ms.append((time.perf_counter() - t) * 1e3)
        sync(dev)
        t = time.perf_counter()
        st, ts_out = plain.create_transfers_soa(inner, ts)
        sync(dev)
        plain_ms.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        reply = card.commit(O.create_transfers, raw, ts)
        sync(dev)
        wt_ms.append((time.perf_counter() - t) * 1e3)
        check(multi_batch.decode(reply, 16)[0]
              == encode_create_results(st, ts_out),
              f"serving timed body {b}: the card's reply differs from the "
              "ledger's without write-through")
        timed.append((raw, ts, reply))
    d2h_batch = (L.D2H_BYTES - d2h_batches) / max(1, n_timed)
    t = time.perf_counter()
    led.drain_mirror()
    drain_ms = drain_ms[1:] + [(time.perf_counter() - t) * 1e3]
    for b, (raw, ts, reply) in enumerate(timed):
        sv.same(f"serving timed body {b}", reply,
                sv.ref.commit(O.create_transfers, raw, ts))
    del plain, timed
    if cuda:
        torch.cuda.empty_cache()
    print(f"serving: one {body}-event body a commit: "
          f"{np.mean(wt_ms):.3f} ms with write-through (each "
          f"{[round(m, 3) for m in wt_ms]}), {np.mean(plain_ms):.3f} ms on "
          f"a ledger without (each {[round(m, 3) for m in plain_ms]}); "
          f"drain {np.mean(drain_ms):.3f} ms a batch (each "
          f"{[round(m, 3) for m in drain_ms]}); {d2h_batch:.0f} bytes "
          f"device to host a batch", flush=True)

    # ---- windows
    def c2_window():
        bodies, tss = [], []
        for _ in range(w):
            _, raw = c2_body()
            bodies.append(raw)
            tss.append(sv.next_ts(body))
        return bodies, tss

    def ref_window(label, window, replies):
        for k, (raw, ts) in enumerate(zip(*window)):
            sv.same(f"{label} body {k}", replies[k],
                    sv.ref.commit(O.create_transfers, raw, ts))

    sync_ms = []
    for i in range(w_sync):
        window = c2_window()
        d2h = L.D2H_BYTES
        sync(dev)
        t = time.perf_counter()
        replies = card.commit_window(O.create_transfers, *window)
        sync(dev)
        sync_ms.append((time.perf_counter() - t) * 1e3)
        d2h_window = L.D2H_BYTES - d2h
        ref_window(f"serving window {i}", window, replies)
        if i == 0:
            sv.check_digest("serving window 0", with_ref=True)
    # The profiler's own cost lands on the host clock of a traced run, so
    # walls come from untraced runs and busy ms from traced ones.
    window = c2_window()
    out = {}
    sync_trace = window_trace(dev, lambda: out.setdefault(
        "r", card.commit_window(O.create_transfers, *window)),
        "serving sync window traced")
    ref_window("serving traced window", window, out["r"])
    # The key's first window runs eagerly, its second is captured: the
    # last is a replay.
    sync_window_ms = sync_ms[-1]

    piped, busy_window = {}, None
    # Staging on and off with the ring kernels in turns: staged, inline,
    # inline, staged.
    for mode, recycle, stage, n_win in (
            ("staged", False, True, w_piped),
            ("traced", False, True, 2),
            ("ring_warmup", True, True, 2),
            ("staged_ring", True, True, w_piped),
            ("inline_ring", True, False, w_piped),
            ("inline_ring_2", True, False, w_piped),
            ("staged_ring_2", True, True, w_piped)):
        led.recycle_events = recycle
        led.overlap_staging = stage
        # The ring windows' key warms up (eager, then captured) before it
        # is timed.
        windows = [c2_window() for _ in range(n_win)]
        stats0 = dict(led.staging_stats)
        d2h = L.D2H_BYTES
        if mode == "traced":
            out = {}
            trace = window_trace(dev, lambda: out.setdefault(
                "r", drive_serving(card, windows, stage)),
                "serving pipelined (traced)")
            replies = out["r"]
            if trace["busy_ms"] is not None:
                busy_window = trace["busy_ms"] / n_win
        else:
            sync(dev)
            t = time.perf_counter()
            replies = drive_serving(card, windows, stage)
            sync(dev)
            wall = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        led.drain_mirror()
        drain = (time.perf_counter() - t) * 1e3
        st = {k: led.staging_stats[k] - stats0[k] for k in stats0}
        for k, (window, reply) in enumerate(zip(windows, replies)):
            ref_window(f"serving {mode} window {k}", window, reply)
        check(not recycle or int(led.state["events"]["count"]) == 0,
              f"serving {mode}: the ring was not recycled")
        if mode in ("traced", "ring_warmup"):
            continue
        piped[mode] = dict(
            ms_per_window=wall / n_win,
            transfers_per_s=n_win * w * body / (wall / 1e3),
            host_stall_fraction=(st["stall_ms"] / st["work_ms"]
                                 if st["work_ms"] else None),
            staged=st["staged"], misses=st["misses"],
            stall_ms=st["stall_ms"], work_ms=st["work_ms"],
            drain_ms_per_window=drain / n_win,
            d2h_bytes_per_window=(L.D2H_BYTES - d2h) / n_win)
        print(f"serving pipelined ({mode}): {piped[mode]}", flush=True)
    for v in piped.values():
        v["busy_ms_per_window"] = busy_window
        v["idle_share"] = (None if busy_window is None
                           else 1 - busy_window / v["ms_per_window"])
    sv.check_digest("serving pipelined windows")
    led.recycle_events = False
    led.overlap_staging = True
    reserved_at_capture = graph_memory(led)
    reserved = (torch.cuda.memory_reserved(dev) if cuda else None)

    # ---- config 4, a hard body, a pulse, the queries
    c4 = [Account(id=SV_C4_ACCT0 + i, ledger=1, code=1,
                  flags=(int(AccountFlags.debits_must_not_exceed_credits)
                         if i % 2 == 0 else 0))
          for i in range(1, C4_ACCOUNTS + 1)]
    sv.commit("config-4 accounts", O.create_accounts, accounts_body(c4),
              sv.next_ts(len(c4)))
    nid = 10**10
    for p in range(c4_pairs):
        pend, rev, nid = config4_pair(rng, nid, TF, body)
        for label, ev in (("pend", offset_accounts(pend, SV_C4_ACCT0)),
                          ("post/void", rev)):
            sv.commit(f"config-4 pair {p} {label}", O.create_transfers,
                      wire_body([ev]), sv.next_ts(body))
    fb0 = led.fallbacks
    expiring = uniform_batch(rng, nid, 64, n_accounts)
    nid += 64
    expiring["flags"][:] = int(TF.pending)
    expiring["timeout"][:] = 1
    sv.commit("expiring pendings", O.create_transfers, wire_body([expiring]),
              sv.next_ts(64))
    hard = uniform_batch(rng, nid, body, n_accounts)
    hard["id_lo"][-1] = hard["id_lo"][0]      # a repeated id: the mirror
    raw = wire_body([hard])
    ts = sv.next_ts(body)
    sync(dev)
    t = time.perf_counter()
    reply = card.commit(O.create_transfers, raw, ts)
    sync(dev)
    hard_ms = (time.perf_counter() - t) * 1e3
    sv.same("hard body", reply, sv.ref.commit(O.create_transfers, raw, ts))
    check(led.fallbacks == fb0 + 1, f"hard body: fallbacks {led.fallbacks}")
    sv.check_digest("hard body")
    ts = sv.ts + 2 * 10**9
    sv.ts = ts
    check(card.pulse_needed(ts) and sv.ref.pulse_needed(ts),
          "serving: no pulse is due past the pendings' timeouts")
    sv.commit("pulse", O.pulse, b"", ts)
    sv.check_digest("pulse")
    hist_id = SV_HISTORY_EVERY
    both = int(AccountFilterFlags.debits | AccountFilterFlags.credits)
    ids = [1, 2, hist_id, n_accounts + 5]
    xids = [10**8, 10**8 + 1, 10**8 + body, 12345]
    queries = [
        (O.lookup_accounts, multi_batch.encode(
            [b"".join(i.to_bytes(16, "little") for i in ids)], 16)),
        (O.lookup_transfers, multi_batch.encode(
            [b"".join(i.to_bytes(16, "little") for i in xids)], 16)),
        (O.get_account_transfers, multi_batch.encode([AccountFilter(
            account_id=hist_id, limit=50, flags=both).pack()], 128)),
        (O.get_account_balances, multi_batch.encode([AccountFilter(
            account_id=hist_id, limit=50, flags=both).pack()], 128)),
        (O.query_accounts, multi_batch.encode([QueryFilter(
            user_data_32=3, code=2, limit=40).pack()], 64)),
        (O.query_transfers, multi_batch.encode([QueryFilter(
            ledger=1, limit=40, flags=1).pack()], 64)),
        (O.get_change_events, ChangeEventsFilter(limit=60).pack()),
    ]
    q_bytes = {}
    t = time.perf_counter()
    for op, raw in queries:
        q_bytes[op.name] = len(sv.commit(f"query {op.name}", op, raw, ts))
    query_s = time.perf_counter() - t
    check(all(q_bytes.values()), f"serving queries: an empty reply {q_bytes}")
    launches = (fused_probe.LAUNCHES, RG.LAUNCHES)
    delta_gathers = L.DELTA_GATHERS - gathers0
    counters = ladder_counters(led)
    routes = dict(led.window_routes)
    evictions = led.windows.evictions
    host_mem = (torch.cuda.host_memory_stats()
                if cuda and hasattr(torch.cuda, "host_memory_stats") else {})
    led.shutdown_staging()
    sv_bodies = sv.bodies
    del sv, card, led
    if cuda:
        torch.cuda.empty_cache()

    # ---- the kernel engine
    kern = Serving(StateMachine("kernel", device=dev),
                   StateMachine("oracle", device="cpu"), caps[0])
    k_accounts = [Account(id=i, ledger=1, code=1) for i in range(1, 1001)]
    kern.commit("kernel accounts", O.create_accounts,
                accounts_body(k_accounts), kern.next_ts(len(k_accounts)))
    k_spans = []
    for b in range(n_kernel):
        ev = config3_batch(rng, b, n=body)
        kern.commit(f"kernel body {b}", O.create_transfers, wire_body([ev]),
                    kern.next_ts(body))
        k_spans.append(dict(create_seq.SPANS))
    kernel_launches = create_seq.LAUNCHES
    check(not cuda or (launches[0] > 0 and launches[1] > 0
                       and kernel_launches > 0),
          f"serving: launches probe/gather {launches}, create_seq "
          f"{kernel_launches}")
    numbers = dict(
        body_events=body, bodies_checked_against_cpu=sv_bodies + kern.bodies,
        commit_ms=float(np.mean(wt_ms)), commit_ms_each=wt_ms,
        no_write_through_ms=float(np.mean(plain_ms)),
        no_write_through_ms_each=plain_ms,
        write_through_cost_ms=float(np.mean(wt_ms) - np.mean(plain_ms)),
        drain_ms_per_batch=float(np.mean(drain_ms)),
        drain_ms_each=drain_ms, d2h_bytes_per_batch=d2h_batch,
        d2h_bytes_per_sync_window=d2h_window,
        sync_window_ms=sync_window_ms, sync_window_ms_each=sync_ms,
        sync_window_transfers_per_s=w * body / (sync_window_ms / 1e3),
        sync_window_busy_ms=sync_trace["busy_ms"],
        sync_window_idle_share=(None if sync_trace["busy_ms"] is None
                                else 1 - sync_trace["busy_ms"]
                                / sync_window_ms),
        pipelined=piped, hard_body_ms=hard_ms, query_s=query_s,
        query_reply_bytes=q_bytes,
        launches=launches, delta_gathers=delta_gathers,
        create_seq_launches=kernel_launches,
        create_seq_kernel_ms=[s["kernel"] for s in k_spans],
        create_seq_prefetch_ms=[s["prefetch"] for s in k_spans],
        create_seq_apply_ms=[s["apply"] for s in k_spans],
        counters=counters, routes=routes, graph_evictions=evictions,
        reserved_at_capture=reserved_at_capture, memory_reserved=reserved,
        pinned_host={k: v for k, v in host_mem.items() if "bytes" in k},
        elapsed_s=time.perf_counter() - t0)
    print(f"serving: {numbers['bodies_checked_against_cpu']} replies equal "
          f"to the CPU oracle engine's; launches probe/gather {launches} "
          f"(delta gathers {delta_gathers}), create_seq {kernel_launches}; "
          f"hard body {hard_ms:.1f} ms; sync window of {w} "
          f"{sync_window_ms:.3f} ms; routes {routes}, graph evictions "
          f"{evictions}; {numbers['elapsed_s']:.1f} s; "
          f"{card_line_or_cpu(dev)}", flush=True)
    return numbers


# ----------------------------------------------------- the supervisor phase

class SupervisedRun:
    """A ServingSupervisor at its own capacities on `dev`, the script of
    everything submitted to it (for the independent oracle audit) and the
    config-2 prepares it is fed: `body` uniform transfers over accounts
    1..n_accounts, as Transfer objects, the chaos harness's timestamps
    (each prepare's commit timestamp clears its events' by 10)."""

    def __init__(self, dev, caps, n_accounts: int, body: int, seed: int,
                 flight_dir: str, **kw):
        from tigerbeetle_tpu_torch import ServingSupervisor
        from tigerbeetle_tpu_torch.trace import FlightRecorder
        from tigerbeetle_tpu_torch.types import Account

        self.dev = dev
        self.sup = ServingSupervisor(
            caps[0], caps[1], device=dev, seed=seed, sleep=lambda s: None,
            flight_recorder=FlightRecorder(dump_dir=flight_dir), **kw)
        self.rng = np.random.default_rng(seed)
        self.n_accounts = n_accounts
        self.body = body
        self.script: list = []
        self.next_id = 10**8
        self.ts = 10**6
        self.accounts = [Account(id=i, ledger=1, code=1)
                         for i in range(1, n_accounts + 1)]
        for lo in range(0, n_accounts, BATCH):
            chunk = self.accounts[lo:lo + BATCH]
            self.ts += len(chunk) + 10
            self.sup.create_accounts(chunk, self.ts)
            self.script.append(("accounts", chunk, self.ts))

    def window(self, w: int):
        """(batches, timestamps) of one window of w config-2 prepares."""
        from tigerbeetle_tpu_torch.ops.batch import transfers_from_arrays

        batches, tss = [], []
        for _ in range(w):
            ev = uniform_batch(self.rng, self.next_id, self.body,
                               self.n_accounts)
            self.next_id += self.body
            self.ts += self.body + 10
            batches.append(transfers_from_arrays(ev))
            tss.append(self.ts)
        return batches, tss

    def commit(self, window) -> float:
        """create_transfers_window; its ms (host clock, synced)."""
        sync(self.dev)
        t = time.perf_counter()
        self.sup.create_transfers_window(*window)
        sync(self.dev)
        self.script.append(("window", *window))
        return (time.perf_counter() - t) * 1e3

    def pipelined(self, windows) -> float:
        """submit_transfers_window for each, then drain_pipeline (two deep:
        the supervisor resolves the oldest at depth); ms a window."""
        sync(self.dev)
        t = time.perf_counter()
        for window in windows:
            self.sup.submit_transfers_window(*window)
        self.sup.drain_pipeline()
        sync(self.dev)
        self.script.extend(("window", *window) for window in windows)
        return (time.perf_counter() - t) * 1e3 / len(windows)

    def audit(self, label) -> None:
        """The independent audit (the chaos harness's): a fresh oracle
        replays the whole script; the supervisor's history must equal its
        answers, and its state the verified epoch base, whose digest the
        last verify_epoch held the device state to."""
        from tigerbeetle_tpu_torch.testing.chaos import (AUDITED_FIELDS,
                                                         oracle_history)

        sup = self.sup
        check(not sup.log or sup.verify_epoch(),
              f"{label}: the last epoch did not verify")
        expected, oracle = oracle_history(self.script)
        check(sup.history == expected,
              f"{label}: the supervisor's history differs from an "
              "independent oracle replay of its script")
        for field in AUDITED_FIELDS:
            check(getattr(oracle, field) == getattr(sup.epoch_base, field),
                  f"{label}: the verified state differs from the "
                  f"independent oracle's on {field}")


def memory_now(dev) -> dict:
    """The caching allocator's bytes on the card: allocated, reserved,
    and the peak allocated since the last reading (which resets it)."""
    if torch.device(dev).type != "cuda":
        return {}
    out = {"allocated": torch.cuda.memory_allocated(dev),
           "reserved": torch.cuda.memory_reserved(dev),
           "peak_allocated": torch.cuda.max_memory_allocated(dev)}
    torch.cuda.reset_peak_memory_stats(dev)
    return out


def graph_counts(led) -> tuple:
    wg = led.windows
    return (sum(wg.eager.values()), sum(wg.captures.values()),
            sum(wg.replays.values()))


def window_kind(led, before: tuple) -> str:
    """How `led` ran the window since its graph counters read `before`:
    eager, capture (captured and replayed once), replay; "host" when no
    device window ran (the mirror's per-batch route)."""
    d = [a - b for a, b in zip(graph_counts(led), before)]
    return ("capture" if d[1] else "replay" if d[2] else "eager" if d[0]
            else "host")


def supervisor_clean(dev, caps, n_accounts, body, widths,
                     flight_dir) -> dict:
    """(a) The full-width supervisor, VERIFY on at the default spot rate,
    beside a bare write-through ledger fed the same windows in turns: for
    each width w, two windows to warm the graph key (eager, capture;
    their ms kept apart), two synchronous windows and two pipelined ones
    timed (bare, supervisor; supervisor, bare; supervisor, bare), then
    one verify_epoch, its parts timed. Zero recoveries; the independent
    audit at the end."""
    from tigerbeetle_tpu_torch import DeviceLedger
    from tigerbeetle_tpu_torch.ops import fused_probe
    from tigerbeetle_tpu_torch.ops import row_gather as RG
    from tigerbeetle_tpu_torch.ops.batch import transfers_to_arrays
    from tigerbeetle_tpu_torch.oracle.state_machine import (
        StateMachineOracle)

    run = SupervisedRun(dev, caps, n_accounts, body, seed=81,
                        flight_dir=flight_dir, epoch_interval=100)
    sup = run.sup
    bare = DeviceLedger(caps[0], caps[1], write_through=StateMachineOracle(),
                        device=dev)
    for kind, accounts, ts in run.script:
        bare.create_accounts(accounts, ts)

    def bare_sync(window) -> tuple:
        sync(dev)
        t = time.perf_counter()
        out = bare.create_transfers_window(
            [transfers_to_arrays(b) for b in window[0]], window[1])
        sync(dev)
        return (time.perf_counter() - t) * 1e3, out

    def bare_piped(windows) -> float:
        sync(dev)
        t = time.perf_counter()
        drive_pipelined(bare, [([transfers_to_arrays(b) for b in batches],
                                tss) for batches, tss in windows])
        sync(dev)
        return (time.perf_counter() - t) * 1e3 / len(windows)

    def sup_sync(window) -> tuple:
        before = graph_counts(sup.led)
        ms = run.commit(window)
        return ms, window_kind(sup.led, before)

    out = {}
    for w in widths:
        warm, kinds = [], []
        sync_ms = {"supervisor": [], "bare": []}
        for k in range(2):
            window = run.window(w)
            bare_ms, _ = bare_sync(window)
            warm.append(sup_sync(window) + (bare_ms,))
        for k in range(2):
            window = run.window(w)
            if k == 0:
                bare_ms, bare_out = bare_sync(window)
            ms, kind = sup_sync(window)
            if k == 1:
                bare_ms, bare_out = bare_sync(window)
            sync_ms["supervisor"].append(ms)
            sync_ms["bare"].append(bare_ms)
            kinds.append(kind)
            check(sup.history[-1] == [[(int(t), int(s)) for s, t in
                                       zip(st.tolist(), ts.tolist())]
                                      for st, ts in bare_out],
                  f"supervisor window of {w}: results differ from the bare "
                  "ledger's")
        piped_ms = {}
        windows = [run.window(w) for _ in range(2)]
        piped_ms["supervisor"] = run.pipelined(windows)
        piped_ms["bare"] = bare_piped(windows)
        before = (fused_probe.LAUNCHES, RG.LAUNCHES)
        t = time.perf_counter()
        check(sup.verify_epoch(), f"supervisor windows of {w}: the epoch "
              "did not verify")
        verify_ms = (time.perf_counter() - t) * 1e3
        verify_launches = (fused_probe.LAUNCHES - before[0],
                           RG.LAUNCHES - before[1])
        out[w] = dict(warm_ms_kind_bare_ms=warm, sync_kinds=kinds,
                      sync_ms=sync_ms, piped_ms=piped_ms,
                      sync_cost_ms=float(np.mean(sync_ms["supervisor"])
                                         - np.mean(sync_ms["bare"])),
                      piped_cost_ms=(piped_ms["supervisor"]
                                     - piped_ms["bare"]),
                      verify_ms=verify_ms, verify_parts_ms=dict(sup.epoch_ms),
                      verify_launches=verify_launches,
                      transfers=len(sup.epoch_base.transfers))
        print(f"supervisor (a) windows of {w}: {out[w]}", flush=True)
    run.audit("supervisor (a)")
    st = sup.stats()
    check(st["recoveries"] == {} and st["checksum_mismatches"] == 0
          and st["retries"] == 0 and st["ledger"]["host_fallbacks"] == 0,
          f"supervisor (a): a clean run recovered or fell back: {st}")
    out["epochs_verified"] = st["epochs_verified"]
    out["routes"] = st["ledger"]["routes"]["windows"]
    out["staging"] = st["ledger"]["staging"]
    sup.led.release()
    bare.release()
    return out


def supervisor_faults(dev, caps, n_accounts, body, flight_dir) -> dict:
    """(b) Injected faults at full width, windows of 2 config-2 prepares,
    an epoch every 2 windows, VERIFY on with every drained row audited:
    a dispatch failing three times (past the retry budget; first, while
    the state to rebuild is small), a bit flipped in place in a live
    account balance after the window key was captured (a replay then runs
    over it; the state digest catches it at the next epoch), a dispatch
    failing twice (within the budget), a poisoned delta chunk (the
    drain's spot audit catches it, naming the op and the field) and a
    fallback storm. Every fault recovers to parity; memory is read after
    each recovery; each window's ms is kept with how its ledger ran it
    and the ms of the epoch check it triggered."""
    from tigerbeetle_tpu_torch.serving import RetryPolicy
    from tigerbeetle_tpu_torch.testing.chaos import (
        ChaosDispatchFailure, inject_state_bitflip, poison_delta_fetch)

    fails = {"left": 0}

    def hook(win, what):
        if what == "window" and fails["left"]:
            fails["left"] -= 1
            raise ChaosDispatchFailure(f"injected (window {win})")

    run = SupervisedRun(
        dev, caps, n_accounts, body, seed=82, flight_dir=flight_dir,
        epoch_interval=2,
        retry=RetryPolicy(max_retries=2, base_delay_s=1e-3,
                          max_delay_s=4e-3), fault_hook=hook)
    sup = run.sup
    sup.led.verify_spot_rate = 1.0
    windows, memory = [], []

    def step(label, fail=0):
        """One window; its ms, how its ledger ran it, and the ms of the
        epoch check it triggered (None when none ran)."""
        fails["left"] = fail
        n_rec = len(sup.recovery_ms)
        led = sup.led
        before = graph_counts(led)
        sup.epoch_ms = {}
        ms = run.commit(run.window(2))
        kind = (window_kind(led, before) if sup.led is led
                else "recovered")
        windows.append((label, kind, ms,
                        sum(sup.epoch_ms.values()) if sup.epoch_ms
                        else None))
        if len(sup.recovery_ms) > n_rec:
            memory.append((sup.recovery_ms[-1]["cause"], memory_now(dev)))

    memory.append(("start", memory_now(dev)))
    step("w0 exhausted", fail=3)           # three failures: recovery
    check(sup.last_recovery["cause"] == "dispatch_exhausted",
          f"supervisor (b): {sup.last_recovery}")
    step("w1")                             # captured; the epoch verifies
    cuda = torch.device(dev).type == "cuda"
    led = sup.led
    wg = led.windows
    sig = led.state["accounts"]["bal"].data_ptr()
    replays = sum(wg.replays.values())
    check(sup.counters["epochs_verified"] == 1
          and (not cuda or sum(wg.captures.values()) == 1),
          "supervisor (b): no window key was captured before the bit flip")
    flip = {"target": "accounts_bal", "row_pick": 3, "col_pick": 5,
            "bit": 11}
    check(inject_state_bitflip(led, flip), "supervisor (b): nothing to flip")
    check(led.state["accounts"]["bal"].data_ptr() == sig,
          "supervisor (b): the bit flip moved the balance storage")
    step("w2 after the flip")              # a replay over the flipped cell
    check(not cuda or (sum(wg.replays.values()) > replays
                       and wg.drops == 0),
          "supervisor (b): no replay ran over the flipped state")
    step("w3")                             # the epoch: state_digest
    check(sup.last_recovery["cause"] == "state_digest"
          and sup.counters["checksum_mismatches"] == 1,
          f"supervisor (b): the bit flip was not caught by the digest: "
          f"{sup.last_recovery}")
    step("w4 after recovery", fail=2)      # two failures: retried
    poison = {"key": "amt_lo", "row_pick": 0, "bit": 3}
    check(poison_delta_fetch(sup.led, poison), "supervisor (b): no queued "
          "delta chunk to poison")
    step("w5 poisoned")                    # the epoch: mirror_divergence
    detail = sup.last_recovery["detail"]
    check(sup.last_recovery["cause"] == "mirror_divergence"
          and "op " in detail and "amount" in detail,
          f"supervisor (b): the poisoned chunk was not caught by the spot "
          f"audit: {sup.last_recovery}")
    led = sup.led
    led._hard_regime = True                # a fallback storm
    led._mirror_batches = led.MIRROR_PROBE_INTERVAL - 3
    fb0 = led.fallbacks
    step("w6 storm")
    check(sup.led.fallbacks >= fb0 + 2, "supervisor (b): the storm's "
          "prepares did not run on the mirror")
    step("w7 after the storm")             # the epoch verifies
    run.audit("supervisor (b)")
    st = sup.stats()
    want = {"state_digest": 1, "mirror_divergence": 1,
            "dispatch_exhausted": 1}
    check(st["recoveries"] == want and st["retries"] == 5
          and st["checksum_mismatches"] == 1
          and st["replayed_windows"] == 4,
          f"supervisor (b): counters {st}")
    alloc = [m["allocated"] for c, m in memory if m]
    if alloc:
        check(max(alloc[1:]) - alloc[1] < 512 << 20,
              f"supervisor (b): memory grows with the recoveries: {memory}")
    out = dict(windows=windows, recoveries=list(sup.recovery_ms),
               memory=memory, counters={k: st[k] for k in (
                   "retries", "backoff_s", "replayed_windows",
                   "epochs_verified", "checksum_mismatches", "recoveries")},
               flight_dumps=st["flight"]["dumps"])
    print(f"supervisor (b): {out}", flush=True)
    sup.led.release()
    return out


def supervisor_chaos(dev, seeds) -> dict:
    """(c) The chaos harness's seeds at its own size, every drained row
    audited, on `dev` and on the CPU: the card's summary must equal the
    CPU's (which the tests hold to the JAX package's)."""
    from tigerbeetle_tpu_torch.testing.chaos import run_chaos_seed

    out = {}
    for seed in seeds:
        t = time.perf_counter()
        got = run_chaos_seed(seed, device=dev)
        ms = (time.perf_counter() - t) * 1e3
        want = run_chaos_seed(seed, device="cpu")
        check(got == want, f"chaos seed {seed}: the card's summary {got} "
              f"differs from the CPU's {want}")
        out[seed] = dict(got, ms=ms)
    print(f"supervisor (c) chaos: {out}", flush=True)
    return out


def supervisor_admission(dev, flight_dir, rounds=24, sessions=100_000,
                         reqs_per_round=96, seed=83) -> dict:
    """(d) The admission plane at the JAX package's bench_admission
    parameters (tigerbeetle_tpu/benchmark.py:651-726) in front of a
    supervisor on `dev`: Zipfian sessions at ~2x the pump's capacity on a
    virtual clock. Conservation holds, the supervisor's history equals an
    oracle replay of the admitted script, the epoch verifies, nothing
    recovers."""
    from tigerbeetle_tpu_torch import ServingSupervisor
    from tigerbeetle_tpu_torch.admission import (AdmissionClass,
                                                 AdmissionPlane, VirtualClock)
    from tigerbeetle_tpu_torch.trace import FlightRecorder, Tracer
    from tigerbeetle_tpu_torch.types import Account, Transfer
    from tigerbeetle_tpu_torch.utils.zipfian import ZipfianGenerator

    n_accounts, txns_per_req, tick_s = 128, 4, 0.020
    classes = (
        AdmissionClass("critical", 0, slo_ms=100.0, deadline_ms=400.0),
        AdmissionClass("standard", 1, slo_ms=200.0, deadline_ms=600.0),
        AdmissionClass("batch", 2, slo_ms=300.0, deadline_ms=300.0),
    )
    clock = VirtualClock()
    sup = ServingSupervisor(a_cap=1 << 10, t_cap=1 << 15,
                            epoch_interval=16, sleep=lambda s: None,
                            seed=seed, tracer=Tracer(pid=0), device=dev,
                            flight_recorder=FlightRecorder(
                                dump_dir=flight_dir))
    plane = AdmissionPlane(
        sup, classes=classes, prepare_max=64, window_prepares=2,
        max_windows_per_pump=2, session_credits=4, max_queue=4096,
        burn_window_ticks=4, burn_budget=0.25, cool_ticks=4,
        clock=clock, seed=seed, head_rate=0.05)
    plane.open_accounts([Account(id=i, ledger=1, code=1)
                         for i in range(1, n_accounts + 1)],
                        n_accounts + 10)
    zipf = ZipfianGenerator(sessions, theta=1.1, seed=seed)
    rng = np.random.default_rng(seed)
    next_id = 10 ** 6
    t0 = time.perf_counter()
    for _round in range(rounds):
        for s in zipf.draw(reqs_per_round).tolist():
            sid = int(s) + 1
            m = sid % 10
            cls = ("critical" if m == 0
                   else "standard" if m <= 3 else "batch")
            evs = []
            for _ in range(txns_per_req):
                dr = int(rng.integers(1, n_accounts + 1))
                evs.append(Transfer(
                    id=next_id, debit_account_id=dr,
                    credit_account_id=dr % n_accounts + 1,
                    amount=int(rng.integers(1, 100)), ledger=1, code=1))
                next_id += 1
            plane.submit(sid, evs, cls=cls)
        plane.pump()
        clock.advance(tick_s)
    plane.drain()
    sync(dev)
    wall_s = time.perf_counter() - t0
    st = plane.stats()
    check(st["conservation"]["ok"] and st["conservation"]["queued"] == 0,
          f"admission: conservation {st['conservation']}")
    hist, _ = plane.oracle_history()
    check(hist == sup.history, "admission: the supervisor's history differs "
          "from an oracle replay of the admitted script")
    check(sup.verify_epoch() and sup.counters["recoveries"] == {},
          f"admission: {sup.stats()}")
    sup.led.release()
    out = dict(
        classes={k: {f: v[f] for f in ("submitted", "admitted", "shed")}
                 for k, v in st["classes"].items()},
        admit_wait_ms={k: v["admit_wait_ms"]
                       for k, v in st["classes"].items()},
        shed_level=st["shed_level"], conservation=st["conservation"],
        windows_dispatched=st["windows_dispatched"],
        events_admitted=st["events_admitted"],
        sustained_admitted_eps_virtual=st["events_admitted"]
        / (rounds * tick_s),
        admitted_eps_wall=st["events_admitted"] / wall_s, wall_s=wall_s)
    print(f"supervisor (d) admission: {out}", flush=True)
    return out


def supervisor_phase(dev, n_accounts: int = N_ACCOUNTS, body: int = BATCH,
                     caps: tuple = (A_CAP, T_CAP),
                     widths: tuple = SP_WIDTHS,
                     chaos_seeds: tuple = SP_CHAOS_SEEDS,
                     admission: dict | None = None) -> dict:
    """The serving supervisor (`tigerbeetle_tpu_torch.ServingSupervisor`)
    on `dev`: (a) clean at full width, (b) injected faults at full width,
    (c) the chaos seeds, (d) the admission plane. VERIFY is on for the
    phase; the flight dumps of (a), (b) and (d) go to a temporary
    directory, removed at the end (the chaos harness's to its default,
    under the temporary directory). The probe's and the row gather's
    launches count from 0 at the phase's start, the VERIFY audits'
    lookups among them (`verify_launches`: those of (a)'s epoch
    checks)."""
    import shutil
    import tempfile

    from tigerbeetle_tpu_torch import constants
    from tigerbeetle_tpu_torch.ops import fused_probe
    from tigerbeetle_tpu_torch.ops import row_gather as RG

    t0 = time.perf_counter()
    was_verify = constants.VERIFY
    constants.set_verify(True)
    flight_dir = tempfile.mkdtemp(prefix="tb_flight_")
    fused_probe.LAUNCHES = RG.LAUNCHES = 0
    try:
        clean = supervisor_clean(dev, caps, n_accounts, body, widths,
                                 flight_dir)
        faults = supervisor_faults(dev, caps, n_accounts, body, flight_dir)
        chaos = supervisor_chaos(dev, chaos_seeds)
        adm = supervisor_admission(dev, flight_dir, **(admission or {}))
        launches = (fused_probe.LAUNCHES, RG.LAUNCHES)
        dumps = len(list(Path(flight_dir).glob("FLIGHT_*.json")))
    finally:
        constants.set_verify(was_verify)
        shutil.rmtree(flight_dir, ignore_errors=True)
    launches = (fused_probe.LAUNCHES, RG.LAUNCHES)
    cuda = torch.device(dev).type == "cuda"
    check(not cuda or (launches[0] > 0 and launches[1] > 0),
          f"supervisor: launches probe/gather {launches}")
    check(dumps == 3, f"supervisor: {dumps} flight dumps, 3 recoveries")
    numbers = dict(clean=clean, faults=faults, chaos=chaos, admission=adm,
                   launches=launches, flight_dumps=dumps,
                   elapsed_s=time.perf_counter() - t0)
    print(f"supervisor: launches probe/gather {launches}; "
          f"{dumps} flight dumps; {numbers['elapsed_s']:.1f} s; "
          f"{card_line_or_cpu(dev)}", flush=True)
    return numbers


def build_all():
    """Compile every kernel source at once (one nvcc each) and load them;
    prints each build time."""
    from tigerbeetle_tpu_torch.ops import _build

    names = ("ht_probe", "row_gather", "create_seq")
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
    _build.load_create_seq("transfers")
    _build.load_create_seq("accounts")


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
    x_launches, exact = exact_path_phase(dev)
    seq = seq_phase(dev)
    w2 = config2_window_phase(dev)
    w4 = config4_window_phase(dev)
    wfb = window_fallback_phase(dev)
    imp = imported_phase(dev)
    bal = balancing_phase(dev)
    srv = serving_phase(dev)
    sup = supervisor_phase(dev)
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
        # On the window routes: launches the wrapper counted (eager
        # windows and captures) and launches the card ran (replays too).
        "launches_config2_window": w2["launches_counted"][0],
        "ran_config2_window": w2["launches_ran"][0],
        "launches_config4_window": w4["launches_counted"][0],
        "ran_config4_window": w4["launches_ran"][0],
        "launches_imported": imp["launches"][0],
        "ran_imported": imp["launches_ran"][0],
        "launches_balancing": bal["launches"][0],
        "ran_balancing": bal["launches_ran"][0],
        "launches_serving": srv["launches"][0],
        # The supervisor phase's launches, its VERIFY audits' lookups
        # among them.
        "launches_supervisor": sup["launches"][0],
        "max_abs_err": max(x["max_abs_err"], a["max_abs_err"],
                           two["max_abs_err"],
                           probe["window"]["max_abs_err"]),
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
        "launches_config2_window": w2["launches_counted"][1],
        "ran_config2_window": w2["launches_ran"][1],
        "launches_config4_window": w4["launches_counted"][1],
        "ran_config4_window": w4["launches_ran"][1],
        "launches_imported": imp["launches"][1],
        "ran_imported": imp["launches_ran"][1],
        "launches_balancing": bal["launches"][1],
        "ran_balancing": bal["launches_ran"][1],
        # The serving phase's launches, the write-through delta gathers
        # (one launch each) among them.
        "launches_serving": srv["launches"][1],
        "launches_serving_delta": srv["delta_gathers"],
        "launches_supervisor": sup["launches"][1],
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
    }, {
        # No Pallas counterpart: the JAX package's XLA sequential kernels.
        # ms / plain_ms / bound_ms: one 8,190-event config-3 batch (device
        # time from the profiler; the plain twin on the CPU, host clock);
        # kernel_ms / prefetch_ms / apply_ms: the spans each
        # run_create_* call recorded (create_seq.SPANS; events in
        # events).
        "name": "create_seq",
        "route": "cuda",
        "source": "tigerbeetle_tpu_torch/csrc/create_seq.cu",
        "replaces": "tigerbeetle_tpu/ops/create_kernels.py:664, "
                    "tigerbeetle_tpu/ops/create_kernels.py:792",
        "launches": seq["launches"],
        # The serving phase's "kernel"-engine commits.
        "launches_serving": srv["create_seq_launches"],
        "max_abs_err": seq["max_abs_err"],
        "ms": seq["ms"],
        "plain_ms": seq["plain_ms"],
        "bound_ms": seq["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "ns_per_event": seq["ns_per_event"],
        "kernel_ms": seq["kernel_ms"],
        "events": seq["events"],
        "prefetch_ms": seq["prefetch_ms"],
        "apply_ms": seq["apply_ms"],
    }]
    print(json.dumps({"config2": c2}), flush=True)
    print(json.dumps({"config4": {**c4["timing"], **c4["trace"]}}),
          flush=True)
    print(json.dumps({"exact_path": {**exact, "launches": x_launches}}),
          flush=True)
    print(json.dumps({"config2_window": w2}), flush=True)
    print(json.dumps({"config4_window": w4}), flush=True)
    print(json.dumps({"window_fallbacks": wfb}), flush=True)
    print(json.dumps({"imported": imp}), flush=True)
    print(json.dumps({"balancing": bal}), flush=True)
    print(json.dumps({"serving": srv}), flush=True)
    print(json.dumps({"supervisor": sup}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
