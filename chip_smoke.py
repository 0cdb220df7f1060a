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
plane) and the durable layer under it (the LSM forest in a data file,
checkpoints, a restart) and the replica server over it (`main.py
start`, clients over TCP, a crash and restart, a 3-replica cluster) and
the load harness (`main.py benchmark`), the test drivers, the
performance observatory and the replicated-state mesh route —
at the ledger's default capacities, and
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
              CPU and the port's oracle: 10,000 accounts, 4 config-2
              batches, then a batch of each kind no device tier runs
              (config 2 imported with a linked pair, accounts with a
              repeated id, the pair-sum overflow, 8,190 pendings with a 1 s
              timeout and their expiry, the 40-wave limit cascade as the
              mirror's probe) and the config-2 batches over which the
              probe returns the ledger to its device tiers; after every
              batch, statuses and timestamps equal to the oracle's and
              the digest and counters to the CPU ledger's; to_host, the
              oracle's apply and the push timed;
  8. seq      the sequential kernels against their plain twins, bit
              for bit on every output, on 512-event mixed batches
              (chains, two-phase, balancing, closing, repeated ids,
              imported; and accounts) and each kernel's hazard batches
              (`seq_hazard_cases`, `seq_account_hazard_cases`), then
              `run_create_accounts` (10,000 accounts) and
              `run_create_transfers` at 8,190 events (config-3 linked
              pairs, a config-4 pend batch and its post/void batch)
              equal to a second oracle; each kernel's device time and
              stage split: the transfers kernel's on a config-3 batch
              and on the config-4 pair (equal to the twin there), the
              accounts kernel's on 8,190 new accounts and on an
              8,190-event mixed batch, each beside its twin's (on the
              CPU, in a child process). Every phase that counts
              create_seq's launches also counts them by kernel.

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
              commit windows of 4 synchronous and pipelined two deep with
              staging (recycle_events on for part), config-4 bodies, a
              hard body on the mirror, a pulse, every query; then
              "kernel"-engine commits of config-3 bodies (create_seq).
 15. supervisor  `ServingSupervisor` at the ledger's default capacities
              with VERIFY on, fed windows of 8,190-event config-2
              prepares over 10,000 accounts: (a) clean, windows of 4
              synchronous and pipelined two deep, each timed beside
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
 16. durable  the durable layer, as a replica commits minus consensus:
              `StateMachine(engine="device")` at the ledger's default
              capacities with a `DurableState` on a `FileStorage` data
              file at the default `StorageLayout()` (a 512 MiB grid of
              64 KiB blocks), 10,000 accounts and 18 config-2 bodies of
              8,189 events (singles, windows of 4 pipelined two deep, a
              closing, an imported, a post/void and a hard body), after
              every op the replica's flush policy, a compaction beat, a
              checkpoint at op 16; beside two CPU twins, each in a
              process of its own: every reply equal to the oracle
              engine's, the data file equal byte for byte to the device
              engine's after the checkpoint; lookups and the five
              queries served from the forest; a restart from the file
              (digest held, ops 17-20 replayed).
 17. replica  the replica server through its entry points: `python -m
              tigerbeetle_tpu_torch format`, `main.main(["start", ...])`
              in a child process (the device engine on the card, the
              native storage engine's asynchronous WAL), 8 clients of
              `vsr/client.py` sending 24 bodies of 8,189 events after
              10,000 accounts, a SIGKILL after op 21 and a restart on the
              file, lookups, a query and a duplicate, SIGTERM, `inspect
              --digest`; every reply equal to a CPU oracle twin fed the
              WAL; a 3-replica cluster of device engines on the card (a
              primary crash, a view change, a catch-up) equal to an
              oracle cluster on the CPU. The server writes an AOF
              (`start --aof`), whose frames after the restart must be
              ops 1.. in order, each the WAL's prepare at its op, and
              serves /metrics (`--metrics-port 0`), scraped once: its
              exposition parses and its commit counter covers every op
              the restarted server committed.
 18. benchmark  the port's load harness through its entry points:
              `main.main(["benchmark", "--transfer-count", "98280"])`
              and the same with `--zipfian` (config 2 and the Zipfian
              workload, 12 batches of 8,190 as one window of 12 on the
              chain route, one graph replay after the warm-up): every
              transfer accepted, no fallback, debits equal to credits,
              the route and depths from `benchmark.CONFIG_ROUTES`;
              `parity_config5` on the card (the ledger equal to the
              oracle); `bench_config6_serving(batches=8)` (one pipelined
              window of 8 bodies) accepting 8 x 8,189 transfers.
 19. drivers  the test drivers on the card: (a) the VOPR swarm,
              `testing.vopr.run_swarm_seed` on the device engine (seeds
              515 and 626) and on the kernel engine (101 and 202), each
              a whole simulated cluster under crashes, partitions and
              packet loss, its summary and every audited (events,
              results) pair equal to an oracle-engine twin on the CPU;
              (b) the fuzzers `device_ledger` (seeds 4 and 5, 15
              iterations), `state_machine` (seed 9, 30), `durability`
              (seed 1, 6) and `storage_faults` (seed 1, 2) through
              `testing.fuzz.run`; (c) `python -m tigerbeetle_tpu_torch
              cfo --max-runs 8 --seed 7`, 8 clean runs of the JAX
              package's selection; (d) `devhub` recording the benchmark
              phase's line and rendering it with (c)'s artifact.
 20. observatory  the performance observatory (the JAX package's
              testing/observatory_smoke.py), each leg with its negative
              arm: (a) `DispatchProfiler` at 1/1 on the full-width
              supervisor, after a warm-up, chain windows of 4 (graph
              replays) and per-batch windows (a series each, a Chrome
              trace of a replayed window), the static cost model on the
              card at that shape (its launches counted apart) and the
              roofline fractions of the flat and chain tiers; (b) `MemWatch` green at the budget's caps, static
              equal to measured with the worst-case pack staged, the
              16-fold-t_cap leak red, the full caps' stores and the
              allocator's stats with the graph pools; (c) the alert
              engine's page, its resolution, its silent disabled arm and
              a dead rule's ValueError; (d) the observatory on against
              off, the median of 20 pairs of runs in turns within 1.05,
              and its own time within 1.05.
 21. sharded  `ShardedRouter` on meshes of 1 and 8 logical shards on the
              card, full-width batches of every mode (config 2, a
              config-4 pair, balancing, imported) from one 2^17 / 2^21
              state, each step equal to the single-chip step on the card
              and a CPU twin (results and digest), launches as
              `sharded_launches` predicts; `shard_loss_scenario` seeds 2
              and 10 (2 reroutes each).
 22. partitioned  the partitioned-state mesh route: `PartitionedRouter`
              on a mesh of 8 logical shards of the card at 2^17 / 2^21
              (config 4's accounts and 10,000 plain ones), a
              `DeviceLedger` attached (`attach_partitioned`): (a) 4
              config-2 chain windows of 8 x 8,190 through submit_window /
              resolve_windows (eager, captured, replayed; the last under
              torch.profiler for the idle share); (b) a window poisoned
              at prepare 3 by a config-4 limit cascade, a clean window in
              flight behind it (both replay; the telemetry names e3_limit
              then forced); (c) a balancing, an imported and a plain
              prepare through the synchronous path, per batch; every
              result equal to the port's oracle on the host and the
              partitioned digest to the oracle's after each window and
              leg, no host fallback; (d) the first window's telemetry
              block against a host count; (e) `shard_resync_scenario`
              seeds 2 and 10 on the card's default mesh; (f) the bytes a
              shard against the replicated route and memwatch's static
              ledger; (g) the launches as `partitioned_launches`
              predicts.
 23. reshard  live resharding and the multi-process mesh: (a) a
              `ServingSupervisor` at 2^17 / 2^21 (config 4's accounts and
              10,000 plain ones) attached to a `PartitionedRouter` of 8
              logical shards of the card (`attach_partitioned`; each
              window one captured CUDA graph), 2 config-2 windows of 4 x
              8,190, a live split of hash range [0, 2^63 - 1] of shard 0
              to shard 1 (the copy drained by a conflicting window, two
              double-write windows, the flip on equal range digests, the
              retire) and its `merge_back`, each controller call that
              writes the card held to a CPU twin (every shard's stores
              below their counts, the tables, the range digests), every
              window's results and the whole-state digest held to the
              oracle by the supervisor's epoch checks; (b) a corrupted
              chunk that aborts a second migration before its flip
              (digest_mismatch, a FLIGHT_*_reshard_* artifact, ownership
              back to the base, the next window exact); (c)
              `reshard_chaos_scenario` seeds 2 and 10 on 2 logical
              shards, equal to a CPU run; (d) `two_process_smoke()`: two
              processes, 4 shards each, one gloo group, "ok"; (e) the
              launches of (a) and (b) as `partitioned_launches` and
              `RESHARD_GATHERS` predict.
 24. trace coverage  the port's trace-catalog gate
              (`testing/trace_coverage.py` `coverage_main`) on the card:
              its 15 scenarios (clusters on the kernel and device
              engines, the chaos seeds, the sharded and partitioned
              routers on 8 logical shards, a live split on 2, the
              staging plane, admission, SLOs, the observatory, the
              causal plane) under recording tracers; rc 0, every one of
              the catalog's 56 events emitted, no off-catalog name, no
              emitted span or histogram event with an empty histogram;
              each scenario's seconds and newly emitted events printed;
              then `metrics_main` (a live /metrics scrape on 127.0.0.1)
              returns 0.
 25. clients  the port's C client (`clients.CClient` over
              csrc/tb_client.cpp, built by g++) against `main.py start
              --engine=device` on the card in a child process, beside a
              CPU oracle-engine twin server fed the same requests:
              10,000 accounts, config-2 transfer bodies of 8,189 events,
              one-transfer requests, lookup_accounts and
              lookup_transfers; every reply equal to the twin's with
              timestamps aside (each server's transfer timestamps equal
              to its own create results'); clients/cpp/example.cpp
              compiled against csrc/tb_client.cpp and run against the
              card's server; `main.py clients --out <tmp>` byte-equal to
              the committed clients/ tree; the client's latency p50 /
              p99 and the server's launches.
 26. static  the port's static verifier (`tigerbeetle_tpu_torch.
              torchhound`) as the gate's static leg,
              `testing.static_smoke.static_smoke(device=cuda)`, in a
              child process on the card that starts beside the durable
              phase: the four passes over the registry's 18 entries (the
              flat tiers, the chain and its ring, the sharded and
              partitioned steps and the partitioned chain on 8 logical
              shards of the card) clean, every negative proof red as
              required; a capture probe on a DeviceLedger at its default
              caps (chain and super windows at W = 4, then 8) captured
              once a key and replayed, with the launches the window
              routes predict; the census of create_transfers_fast on
              the card launching what a plain tier run predicts.
 27. gate    the JAX gate's seven device legs, the port's
              `tigerbeetle_tpu_torch.testing` chain, partitioned_chain,
              overlap, reshard, telemetry, overload and observatory
              smokes, at the JAX package's sizes, then the chain and
              overlap legs again at full width (prepares of 8,190 on
              DeviceLedger(2^17, 2^21)), then the op budget's census of
              every registry tier, `--check` against the committed
              trace/opbudget_r01.json (written on the CPU) and `--lint`,
              all in a child process on the card started beside the
              durable phase; the overlap leg at the JAX sizes runs last,
              once the script waits for the child (its 128-event
              windows' stall fraction reads whether the stager thread
              gets a core in the ~1 ms it has: beside the durable
              phase's CPU twins it once read 0.8787); each leg's
              negative arm red, its history
              equal to the oracle's, the stall fraction under 0.75 at
              both widths and both overhead ratios within their bounds
              (asserted in the legs), the kernels each leg ran
              (launches less those recorded into graphs, plus those the
              replays ran) equal to `gl_calls`, the CPU's kernel calls
              (but the overload leg's, which a wall clock steers), and
              each leg's launches equal to its calls.
The window phases print the memory the caching allocator holds after
each graph capture.

Prints the card line, `{"config2": ...}`, `{"config4": ...}`,
`{"exact_path": ...}`, `{"config2_window": ...}`,
`{"config4_window": ...}`, `{"window_fallbacks": ...}`,
`{"imported": ...}`, `{"balancing": ...}`, `{"serving": ...}`,
`{"supervisor": ...}`, `{"durable": ...}`, `{"replica": ...}`,
`{"benchmark": ...}`, `{"drivers": ...}`, `{"observatory": ...}`,
`{"sharded": ...}`, `{"partitioned": ...}`, `{"reshard": ...}`,
`{"trace_coverage": ...}`, `{"clients": ...}`, `{"static": ...}`,
`{"gate": ...}`, `{"phase_seconds": ...}`
and `{"kernels": [...]}` lines, and last
`{"ok": true, "device": {...}}`.
Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import glob
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
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
X_SETUP_BATCHES = 4         # 8 before the clients phase was added
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


# The replicated-state mesh route (parallel/full_sharded.py): a sharded
# step runs per_event_status once a shard (one probe launch, the
# transfer-role and the account-role gathers) and the single-chip tail
# once a distinct device, which re-gathers those two role rows, makes
# the tier's other gathers and launches no probe. So on S shards of one
# device a step launches S probes and 2S + G gathers, G the mode's
# GATHERS_PER_RUN (a mode is the tier of its name); an escalated step
# adds the fixpoint step's. A degraded (single-chip) step launches the
# tier's PROBES_PER_RUN / GATHERS_PER_RUN.
def sharded_launches(mode: str, shards: int) -> tuple:
    return shards, 2 * shards + GATHERS_PER_RUN[mode]


# The partitioned-state mesh route (parallel/partitioned.py), read from
# the code: a prepare on S logical shards of one device reads each
# shard's exchanged rows (a transfer-row gather a shard, an account- and
# balance-row gather a shard), plans each shard's id inserts (a
# bucket-row gather a shard: ht_plan), builds the mini-state's two hash
# tables (ht_insert: a bucket-row gather each), judges once on the mini
# (per_event_status: the probe and the transfer-role and account-role
# gathers; the tail: the mode's GATHERS_PER_RUN, its re-gathers among
# them), then reads the judged mini's rows for the write-back (one gather
# of four tables) and the flush (one gather). So a prepare launches the
# mode's PROBES_PER_RUN probes and 3S + G + 6 gathers, G the mode's
# GATHERS_PER_RUN; an escalated step adds the fixpoint step's; a chain
# window of W runs W plain prepares.
def partitioned_launches(mode: str, shards: int) -> tuple:
    return PROBES_PER_RUN[mode], 3 * shards + GATHERS_PER_RUN[mode] + 6

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
# accounts from SV_C4_ACCT0 + 1. SV_TIMED, SV_KERNEL and SP_WIDTHS are
# cut (from 6, 2 and (4, 8)) to keep the whole script within its time
# with the replica phase, SV_CHECKED, SV_TIMED and SV_C4_PAIRS (from 3, 4
# and 2) with the benchmark phase, and SV_W and SP_WIDTHS (from 8 and
# (8,)) with the reshard phase, which serves windows of 8 (PERF.md
# section 4). SV_W_SYNC stays 3: the third synchronous window is the
# first replay, the one timed.
SV_BODY = BATCH - 1
SV_CHECKED = 2
SV_TIMED = 2
SV_W = 4
SV_W_SYNC = 3
SV_W_PIPED = 2
SV_C4_PAIRS = 1
SV_KERNEL = 1
SV_HISTORY_EVERY = 64
SV_C4_ACCT0 = 20_000
# The supervisor phase: (a)'s window widths (prepares a window), (c)'s
# chaos seeds (the chaos harness's gate seeds).
SP_WIDTHS = (4,)
SP_CHAOS_SEEDS = (1, 2, 3, 7)

# The durable phase (the JAX package's replica commit loop minus
# consensus, vsr/replica.py:926-942 and :1084-1180): DU_OPS config-2
# bodies of SV_BODY events over N_ACCOUNTS accounts after the account
# bodies, a checkpoint every DU_CHECKPOINT ops (vsr/replica.py:87), DU_W
# bodies a window; 1 event in DU_PEND_EVERY a pending (a 1 s timeout on
# half of them); then a restart from the last checkpoint, the journal's
# later ops replayed, and DU_AFTER more ops; lookups of DU_LOOKUPS ids.
# A regression check of the stand-in, the replica phase carrying the
# full-size forest through the real loop: 33 bodies, checkpoints at 16
# and at 32 (the end of the forest's first bar), the restart replaying
# ops 33-36 and 2 ops after it (PERF.md section 4 lists the cut).
DU_OPS = 33
DU_CHECKPOINT = 16
DU_W = 4
DU_PEND_EVERY = 16
DU_AFTER = 2
DU_LOOKUPS = BATCH
DU_TURNS = 2

# The observatory phase: (a) the profiler on a full-width supervisor,
# OB_CHAIN_WINDOWS windows of OB_W prepares and OB_FLAT_WINDOWS of one;
# (b) and (d) at the caps of the port's budget (trace/membudget.json,
# the JAX package's perf/membudget_r01.json caps); (d) OB_WINDOWS windows
# of OB_SHAPE and an epoch a run, OB_OVERHEAD_PAIRS pairs of runs (one
# of each arm) after a warm pair (the JAX package's observatory smoke
# ran 5 reps an arm; a run's time moves ~12% between runs on the card's
# host, so a median resolves 5% only over many pairs; a full-width run's
# final verify_epoch alone costs 12-55 s of host Python, so (d) cannot
# run at full width).
OB_W = 4
OB_CHAIN_WINDOWS = 4
OB_FLAT_WINDOWS = 3
OB_WINDOWS = 6
OB_SHAPE = (48, 48)
OB_OVERHEAD_PAIRS = 20
# The sharded phase: meshes of 1 and 8 logical shards on the card,
# SH_C2_BATCHES config-2 batches, then one batch of each other mode;
# shard_loss_scenario's seeds.
SH_MESHES = (1, 8)
SH_C2_BATCHES = 2
SH_LOSS_SEEDS = (2, 10)
# The partitioned phase: a mesh of PT_SHARDS logical shards on the card,
# PT_WINDOWS config-2 chain windows of PT_W prepares (the first eager, the
# second captured, then replays), a window of PT_W poisoned at prepare
# PT_POISON_AT and a clean one in flight behind it, an imported, a
# balancing and a plain per-batch prepare; shard_resync_scenario's seeds.
PT_SHARDS = 8
PT_W = 8
PT_WINDOWS = 4
PT_POISON_AT = 3
PT_RESYNC_SEEDS = (2, 10)
# The reshard phase: a supervisor on RS_SHARDS logical shards of the
# card, RS_WARM config-2 windows of RS_W prepares before the first
# migration; reshard_chaos_scenario's seeds.
RS_SHARDS = 8
RS_W = 4                    # 8 before the clients phase was added
RS_WARM = 2
RS_CHAOS_SEEDS = (2, 10)
# Row-gather launches of the resharding kernels (parallel/resharding.py),
# read from the code: `_finalize_shard` permutes the account rows and
# balances (one launch) and the transfer rows (one), and plans three
# inserts (the staged account and transfer keys, the orphan markers: a
# bucket-row gather each); `_evict_range` permutes the account rows and
# balances and the transfer rows. None launches the probe (their key
# probes are the plain ht_lookup).
RESHARD_GATHERS = {"_finalize_shard": 5, "_evict_range": 2}

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


SEQ_HAZARD_TS = 10**12


def seq_hazard_setup(Account, AF, Transfer, TF) -> list:
    """The state the hazard batches start from, as (op, events,
    timestamp) steps: accounts 1-14 (9 debits_must_not_exceed_credits,
    10 credits_must_not_exceed_debits), 9 credited and 10 debited by 100,
    7 and 8 moved by 2^128 - 10, 13 and 14 by 2^127 - 1 posted and as
    much pending, committed pendings 500 (1 -> 2, 50) and 501 (3 -> 4,
    40, timeout 3600), a committed transfer 600."""
    limits = {9: AF.debits_must_not_exceed_credits,
              10: AF.credits_must_not_exceed_debits}
    accounts = [Account(id=i, ledger=1, code=1, flags=int(limits.get(i, 0)))
                for i in range(1, 15)]

    def t(id_, dr, cr, amount, **kw):
        return Transfer(id=id_, debit_account_id=dr, credit_account_id=cr,
                        amount=amount, ledger=1, code=1, **kw)

    transfers = [
        t(400, 1, 9, 100), t(401, 10, 2, 100), t(402, 7, 8, (1 << 128) - 10),
        t(403, 13, 14, (1 << 127) - 1),
        t(502, 13, 14, (1 << 127) - 1, flags=TF.pending),
        t(500, 1, 2, 50, flags=TF.pending, user_data_64=5),
        t(501, 3, 4, 40, flags=TF.pending, timeout=3600),
        t(600, 5, 6, 7, user_data_32=3),
    ]
    ts = SEQ_HAZARD_TS
    return [("accounts", accounts, ts), ("transfers", transfers, ts + 100)]


def seq_hazard_cases(Transfer, TF) -> list:
    """Batches that hit the sequential kernel's hazards between its
    pre-pass and its walk, each (name, events, timestamp, expected status
    names of some events by index), run on seq_hazard_setup's state:
    repeated ids whose row is in the batch store, posts and voids of
    pendings created earlier in the batch, chains that break after they
    flipped a pending's status, closed accounts, balancing clamps and
    limits against balances moved in the batch, overflows, and imported
    events that regress key_max inside and after a broken chain."""
    L, P, POST, VOID = TF.linked, TF.pending, TF.post_pending_transfer, \
        TF.void_pending_transfer
    MAX = (1 << 128) - 1
    missing = 99_999

    def t(id_, dr, cr, amount, **kw):
        kw.setdefault("ledger", 1)
        kw.setdefault("code", 1)
        return Transfer(id=id_, debit_account_id=dr, credit_account_id=cr,
                        amount=amount, **kw)

    def pv(id_, pid, flags, amount=0, **kw):
        return t(id_, 0, 0, amount, pending_id=pid, flags=flags, ledger=0,
                 code=0, **kw)

    ts = SEQ_HAZARD_TS + 10**6
    at = SEQ_HAZARD_TS + 10**3  # imported timestamps: after the setup
    cases = [
        ("repeated ids", [
            t(700, 1, 2, 5), t(700, 1, 2, 5), t(700, 1, 2, 6),
            t(600, 5, 6, 7, user_data_32=3), t(600, 5, 6, 7),
            t(701, 1, missing, 5), t(701, 1, 2, 5),
            t(702, 3, 4, 5, flags=L), t(703, 3, 4, 5, ledger=0),
            t(702, 3, 4, 5),
        ], ts, {1: "exists", 2: "exists_with_different_amount",
                3: "exists", 4: "exists_with_different_user_data_32",
                5: "credit_account_not_found", 6: "id_already_failed",
                7: "linked_event_failed", 9: "created"}),
        ("two-phase in the batch", [
            t(710, 1, 2, 30, flags=P, user_data_64=7),
            pv(711, 710, POST, MAX, user_data_64=9),
            t(712, 3, 4, 20, flags=P, timeout=60, user_data_64=4),
            pv(713, 712, VOID),
            pv(714, 710, POST, MAX), t(715, 5, 6, 20, flags=P),
            pv(716, 715, POST, 5), pv(717, 715, VOID),
            pv(718, 500, POST, MAX), pv(719, 501, VOID, user_data_64=9),
            pv(720, 710, VOID), pv(721, 730, POST, MAX),
        ], ts, {1: "created", 3: "created", 4:
                "pending_transfer_already_posted", 6: "created",
                7: "pending_transfer_already_posted", 8: "created",
                9: "created", 11: "pending_transfer_not_found"}),
        ("a chain that flips pendings breaks", [
            pv(730, 500, POST | L, MAX),
            t(731, 1, missing, 5),
            pv(732, 500, POST, MAX),
            t(733, 3, 4, 25, flags=P),
            pv(734, 733, VOID | L),
            t(735, 1, 2, 5, flags=L), t(736, 1, 2, 5, ledger=0),
            pv(737, 733, POST, MAX),
            pv(738, 501, VOID | L), t(739, 1, 2, 1, flags=L),
        ], ts, {0: "linked_event_failed", 2: "created", 4:
                "linked_event_failed", 7: "created",
                9: "linked_event_chain_open"}),
        ("closed accounts", [
            t(740, 11, 12, 5, flags=P | TF.closing_debit),
            t(741, 11, 1, 3), t(742, 2, 11, 3),
            pv(743, 740, VOID), t(744, 11, 1, 3),
            t(745, 12, 2, 1, flags=P | TF.closing_credit | L),
            t(746, 1, 2, 4), t(747, 1, 2, 4),
            t(748, 12, 3, 1, flags=P | TF.closing_credit),
            pv(749, 748, POST, MAX), t(750, 1, 3, 1),
            t(751, 12, 4, 1, flags=P | TF.closing_debit | L),
            t(752, 1, missing, 1), t(753, 12, 1, 1),
        ], ts, {1: "debit_account_already_closed",
                2: "credit_account_already_closed", 4: "created",
                5: "linked_event_failed", 7: "created",
                10: "credit_account_already_closed", 11:
                "linked_event_failed", 13: "created"}),
        ("balancing and limits", [
            t(760, 1, 9, 50), t(761, 9, 2, 1000, flags=TF.balancing_debit),
            t(762, 9, 3, 10), t(763, 3, 10, 1000,
                                flags=TF.balancing_credit),
            t(764, 4, 10, 5), t(765, 1, 9, 20, flags=L),
            t(766, 9, 2, 1000, flags=TF.balancing_debit | L),
            t(767, 1, 2, 1, ledger=0),
            t(768, 9, 2, 1000, flags=TF.balancing_debit | P),
            t(769, 7, 8, 20), t(770, 7, 1, 5, flags=P),
            t(771, 7, 8, 5, flags=P | L), t(772, 1, 2, MAX - 5),
            t(773, 13, 1, 5), t(774, 2, 14, 5),
        ], ts, {1: "created", 2: "exceeds_credits", 3: "created",
                4: "exceeds_debits", 5: "linked_event_failed",
                9: "overflows_debits_posted", 13: "overflows_debits",
                14: "overflows_credits"}),
        ("imported regressions", [
            t(780, 1, 2, 5, flags=TF.imported | L, timestamp=at + 10),
            t(781, 1, 2, 5, flags=TF.imported | L, timestamp=at + 20),
            t(782, 1, 2, 5, flags=TF.imported, timestamp=at + 15),
            t(783, 1, 2, 5, flags=TF.imported, timestamp=at + 12),
            t(784, 1, 2, 5, flags=TF.imported, timestamp=at + 5),
            t(785, 3, 4, 5, flags=TF.imported | P, timestamp=at + 30),
            pv(786, 785, POST | TF.imported, MAX, timestamp=at + 25),
            pv(787, 785, POST | TF.imported, MAX, timestamp=at + 31),
            t(788, 1, 2, 5, flags=TF.imported, timestamp=at + 31),
        ], ts, {0: "linked_event_failed", 2:
                "imported_event_timestamp_must_not_regress", 3: "created",
                4: "imported_event_timestamp_must_not_regress",
                6: "imported_event_timestamp_must_not_regress",
                7: "created"}),
    ]
    return cases


def seq_account_hazard_cases(Account, AF) -> list:
    """Batches that hit the accounts kernel's hazards between its pre-pass
    and its walk, each (name, events, timestamp, expected status names of
    some events by index), run on seq_hazard_setup's state (accounts 1-14,
    transfer 600 at SEQ_HAZARD_TS + 100): ids repeated in the batch, in
    the warp's one-step chunks and in chunks walked one event at a time;
    a repeated id that breaks its chain; a chain broken by its last
    member; key_max restored by a broken chain in an imported batch; a
    linked last event with padded lanes; imported events that regress
    against key_max, within a warp step and across two."""
    L, IMP = AF.linked, AF.imported
    ts = SEQ_HAZARD_TS + 10**6
    at = SEQ_HAZARD_TS + 10**3  # imported timestamps: after the setup

    def a(id_, **kw):
        kw.setdefault("ledger", 1)
        kw.setdefault("code", 1)
        return Account(id=id_, **kw)

    def filler(first, k):
        return [a(first + j) for j in range(k)]

    repeated = (
        [a(100), a(101, user_data_64=1), a(1), a(2, code=3)]
        + filler(1000, 28)
        + [a(100), a(101, user_data_64=9)] + filler(1100, 30)
        + [a(100, flags=AF.debits_must_not_exceed_credits),
           a(100, user_data_128=7), a(100, user_data_32=7),
           a(100, ledger=2), a(100, code=2), a(101, user_data_64=1)]
        + filler(1200, 26))
    return [
        ("repeated account ids", repeated, ts, {
            0: "created", 2: "exists", 3: "exists_with_different_code",
            32: "exists", 33: "exists_with_different_user_data_64",
            64: "exists_with_different_flags",
            65: "exists_with_different_user_data_128",
            66: "exists_with_different_user_data_32",
            67: "exists_with_different_ledger",
            68: "exists_with_different_code", 69: "exists"}),
        ("a repeated id breaks its chain", [
            a(200, flags=L), a(201, flags=L), a(200, flags=L), a(202),
            a(200), a(200), a(203, flags=L), a(203),
        ], ts, {0: "linked_event_failed", 1: "linked_event_failed",
                2: "exists", 3: "linked_event_failed", 4: "created",
                5: "exists", 6: "linked_event_failed",
                7: "exists_with_different_flags"}),
        ("a chain broken by its last member", [
            a(300, flags=L), a(301, flags=L), a(302, ledger=0), a(300),
            a(301, user_data_64=4), a(301),
        ], ts, {0: "linked_event_failed", 1: "linked_event_failed",
                2: "ledger_must_not_be_zero", 3: "created", 4: "created",
                5: "exists_with_different_user_data_64"}),
        ("imported key_max restored by a broken chain", [
            a(399, flags=IMP, timestamp=SEQ_HAZARD_TS + 100),
            a(400, flags=IMP, timestamp=at + 10),
            a(401, flags=IMP | L, timestamp=at + 50),
            a(402, flags=IMP | L, timestamp=at + 60),
            a(403, flags=IMP, timestamp=at + 70, ledger=0),
            a(404, flags=IMP, timestamp=at + 5),
            a(405, flags=IMP, timestamp=at + 30),
            a(406, flags=IMP, timestamp=at + 30),
            a(407, flags=IMP, timestamp=ts),
        ], ts, {0: "imported_event_timestamp_must_not_regress",
                1: "created", 2: "linked_event_failed",
                3: "linked_event_failed", 4: "ledger_must_not_be_zero",
                5: "imported_event_timestamp_must_not_regress",
                6: "created",
                7: "imported_event_timestamp_must_not_regress",
                8: "imported_event_timestamp_must_not_advance"}),
        ("a linked last event with padded lanes", [
            a(500), a(501, flags=L), a(502, flags=L),
        ], ts, {0: "created", 1: "linked_event_failed",
                2: "linked_event_chain_open"}),
        ("imported regressions in warp steps", [
            a(600 + j, flags=IMP, timestamp=t, ledger=int(j != 6))
            for j, t in enumerate(
                [SEQ_HAZARD_TS + 100, SEQ_HAZARD_TS + 50, at + 100, at + 90,
                 at + 100, at + 101, at + 200, at + 150, ts, at + 145]
                + [at + 300 + k for k in range(22)]
                + [at + 321, at + 322, at + 250])
        ], ts, {0: "imported_event_timestamp_must_not_regress",
                1: "created", 2: "created",
                3: "imported_event_timestamp_must_not_regress",
                4: "imported_event_timestamp_must_not_regress",
                5: "created", 6: "ledger_must_not_be_zero", 7: "created",
                8: "imported_event_timestamp_must_not_advance",
                9: "imported_event_timestamp_must_not_regress",
                32: "imported_event_timestamp_must_not_regress",
                33: "created",
                34: "imported_event_timestamp_must_not_regress"}),
    ]


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


def device_profile(fn, reps: int = 20, attempts: int = 4):
    """(device-busy ms per call, {name: (ms per call, launches per
    call)}) of fn() from a torch.profiler trace of `reps` calls;
    (None, {}) when no trace holds device time. The profiler now and
    then drops device events from a trace, a few or nearly all of them,
    so traces are taken until the fullest (the most device events) has
    come twice, up to `attempts` traces, and the fullest is kept."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best, best_n, seen = {}, 0, 0
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name, n_events = {}, 0
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            if us:
                ms, n = by_name.get(e.key, (0.0, 0.0))
                by_name[e.key] = (ms + us / 1e3 / reps, n + e.count / reps)
                n_events += e.count
        if n_events > best_n:
            best, best_n, seen = by_name, n_events, 1
        elif n_events == best_n and n_events:
            seen += 1
        if seen >= 2:
            break
    if not best:
        return None, {}
    return sum(v[0] for v in best.values()), best


def kernel_ms(fn, tag: str, reps: int = 20, attempts: int = 4) -> float:
    """Device ms per call of the one kernel named like `tag` that fn()
    launches once a call, from a torch.profiler trace of `reps` calls.
    The profiler now and then drops device events, so a trace that
    holds the kernel fewer times than the calls made is taken again,
    up to `attempts` traces; when none holds every launch, the ms is
    the mean over the launches the fullest trace recorded, if it holds
    at least half of them. A trace that holds the kernel more often
    than once a call, or under more than one name, fails."""
    best = None
    for _ in range(attempts):
        _, names = device_profile(fn, reps=reps, attempts=1)
        hits = [v for k, v in names.items() if tag in k]
        check(len(hits) <= 1 and all(n < 1 + 1e-9 for _, n in hits),
              f"the trace of {tag} holds its kernel more than once a "
              f"call: { {k: v[1] for k, v in names.items() if tag in k} }")
        if hits and abs(hits[0][1] - 1) < 1e-9:
            return hits[0][0]
        if hits and (best is None or hits[0][1] > best[1]):
            best = hits[0]
    check(best is not None and best[1] >= 0.5,
          f"the traces of {tag} held its kernel in fewer than half of the "
          f"calls: {best}")
    print(f"{tag}: the fullest of {attempts} traces held "
          f"{best[1] * reps:.0f} of {reps} launches; ms is their mean",
          flush=True)
    return best[0] / best[1]


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


def _exact_cpu_main(send, n_accounts: int, batch: int,
                    setup_batches: int, caps: tuple) -> None:
    """A child process: the exact path's CPU side, a ledger on the CPU fed
    exact_path_plan's steps. Sends ("step", label, its results (for a
    pulse: whether one was due, and how many it expired), its state
    digest, its counters) a step, then ("end", whether it left the
    mirror regime), or ("error", the traceback)."""
    import traceback

    try:
        from tigerbeetle_tpu_torch import DeviceLedger
        from tigerbeetle_tpu_torch.ops.ledger import results_to_arrays
        from tigerbeetle_tpu_torch.types import (
            Account, AccountFlags, Transfer, TransferFlags)

        ref = DeviceLedger(a_cap=caps[0], t_cap=caps[1], device="cpu")
        for label, op, events, ts, _ in exact_path_plan(
                Account, Transfer, AccountFlags, TransferFlags,
                np.random.default_rng(5), n_accounts, batch, setup_batches):
            if op == "accounts":
                exp = results_to_arrays(ref.create_accounts(events, ts))
            elif op == "transfers":
                exp = ref.create_transfers_soa(events, ts)
            else:
                due = ref.pulse_needed(ts)
                exp = (due, ref.expire_pending_transfers(ts) if due else 0)
            send.send(("step", label, exp, ledger_digest(ref),
                       (ladder_counters(ref), dict(ref.fallback_causes))))
        send.send(("end", ref.mirror is None))
    except BaseException:
        send.send(("error", traceback.format_exc()))


class ExactCpuSide:
    """The exact path's CPU ledger (`_exact_cpu_main`) in a child process,
    a step ahead of the card: next() returns its next message, and fails
    the phase if it failed or went quiet. close() stops it."""

    def __init__(self, *args):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.recv, send = ctx.Pipe(duplex=False)
        self.proc = ctx.Process(target=_exact_cpu_main, daemon=True,
                                args=(send, *args))
        self.proc.start()
        send.close()

    def next(self) -> tuple:
        check(self.recv.poll(900), "exact path: no answer from the CPU "
              "ledger in 900 s")
        try:
            msg = self.recv.recv()
        except EOFError:
            msg = ("error", f"it exited with {self.proc.exitcode}")
        check(msg[0] != "error",
              f"exact path: the CPU ledger failed:\n{msg[1]}")
        return msg

    def close(self) -> None:
        if self.proc.is_alive():
            self.proc.kill()
        self.proc.join()


def exact_path_phase(dev, n_accounts: int = N_ACCOUNTS, batch: int = BATCH,
                     setup_batches: int = X_SETUP_BATCHES,
                     caps: tuple = (A_CAP, T_CAP)):
    """The exact path: the hard batches no device tier can run, the
    host-mirror regime that answers them, the expiry pulse and the
    probe's return to the device tiers (exact_path_plan), on a ledger on
    `dev` beside the port's oracle fed the same batches and one on the
    CPU, which runs in a child process a step ahead (`ExactCpuSide`).
    After every batch: statuses and timestamps equal to the oracle's and
    the CPU ledger's, state digests and counters equal to the CPU
    ledger's. Returns the probe and row-gather launches and the
    timings."""
    from tigerbeetle_tpu_torch import DeviceLedger
    from tigerbeetle_tpu_torch.oracle import StateMachineOracle
    from tigerbeetle_tpu_torch.ops import fused_probe
    from tigerbeetle_tpu_torch.ops import row_gather as RG
    from tigerbeetle_tpu_torch.ops.batch import transfers_from_arrays
    from tigerbeetle_tpu_torch.ops.ledger import results_to_arrays
    from tigerbeetle_tpu_torch.types import (
        Account, AccountFlags, Transfer, TransferFlags)

    t0 = time.perf_counter()
    cpu = ExactCpuSide(n_accounts, batch, setup_batches, caps)
    card = DeviceLedger(a_cap=caps[0], t_cap=caps[1], device=dev)
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
    try:
        for label, op, events, ts, is_hard in steps:
            fb = card.fallbacks
            n_spans = {k: len(v) for k, v in spans.items()}
            t = time.perf_counter()
            if op == "accounts":
                got = results_to_arrays(card.create_accounts(events, ts))
                sync(dev)
                wall = (time.perf_counter() - t) * 1e3
                want = results_to_arrays(sm.create_accounts(events, ts))
            elif op == "transfers":
                got = card.create_transfers_soa(events, ts)
                sync(dev)
                wall = (time.perf_counter() - t) * 1e3
                want = results_to_arrays(sm.create_transfers(
                    transfers_from_arrays(events), ts))
            else:
                check(card.pulse_needed(ts) and sm.pulse_needed(ts),
                      f"{label}: no pulse is due")
                n = card.expire_pending_transfers(ts)
                sync(dev)
                wall = (time.perf_counter() - t) * 1e3
                want = sm.expire_pending_transfers(ts)
            # The CPU ledger ran this step meanwhile.
            _, cpu_label, exp, cpu_digest, cpu_counters = cpu.next()
            check(cpu_label == label, f"{label}: the CPU ledger ran "
                  f"{cpu_label}")
            if op == "expire":
                check(exp[0], f"{label}: no pulse is due on the CPU ledger")
                check(n == exp[1] == want == batch,
                      f"{label}: expired {n}, not {batch} on every engine")
                got = exp = want = (np.array([n]), np.array([n]))
            for name, res in (("the oracle", want),
                              ("the CPU ledger", exp)):
                check(np.array_equal(got[0], res[0])
                      and np.array_equal(got[1], res[1]),
                      f"{label}: statuses or timestamps differ from "
                      f"{name}'s")
            check(ledger_digest(card) == cpu_digest,
                  f"{label}: state digests differ")
            counters = (ladder_counters(card), dict(card.fallback_causes))
            check(counters == cpu_counters,
                  f"{label}: counters differ: card {counters}, CPU "
                  f"{cpu_counters}")
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
        end = cpu.next()
    finally:
        cpu.close()
    launches = (fused_probe.LAUNCHES, RG.LAUNCHES)

    check(card.mirror is None and end == ("end", True),
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


def _seq_plain_main(send, inputs_path: str) -> None:
    """A child process: the sequential kernels' plain twins on the CPU on
    the prefetched numpy inputs pickled at `inputs_path` ({name: (kind,
    inputs)}), each timed on the host clock; sends ("ok", {name: (ms, the
    outputs as numpy)}) or ("error", the traceback)."""
    import pickle
    import traceback

    try:
        from tigerbeetle_tpu_torch.ops import create_kernels as CK

        torch.set_num_threads(1)
        with open(inputs_path, "rb") as f:
            jobs = pickle.load(f)
        plain = {"transfers": CK.create_transfers_seq_plain,
                 "accounts": CK.create_accounts_seq_plain}
        res = {}
        for name, (kind, inputs) in jobs.items():
            tin = CK.inputs_to_device(inputs, "cpu")
            t = time.perf_counter()
            out = plain[kind](tin)
            ms = (time.perf_counter() - t) * 1e3
            res[name] = (ms, {k: v.numpy() for k, v in out.items()})
        send.send(("ok", res))
    except BaseException:
        send.send(("error", traceback.format_exc()))


class SeqPlainChild:
    """The plain twins' full-width runs (host CPU) in a child process,
    beside the phases after the sequential kernels'. finish() waits for
    it, holds the transfers kernel's outputs `got` equal to its twin's
    and returns (plain_ms, max_abs_err); with `accounts` = {name: (inputs,
    the accounts kernel's outputs)} it holds those too and sets
    `self.accounts` to {name: (plain_ms, max_abs_err)}. The inputs go
    through a file, so that starting the child does not wait for it to
    read them."""

    def __init__(self, inputs: dict, got: dict, accounts=None):
        import multiprocessing
        import pickle

        accounts = accounts or {}
        fd, self.path = tempfile.mkstemp(prefix="tb_seq_plain_",
                                         suffix=".pkl")
        with os.fdopen(fd, "wb") as f:
            pickle.dump({"transfers": ("transfers", inputs), **{
                f"accounts {k}": ("accounts", v[0])
                for k, v in accounts.items()}}, f)
        ctx = multiprocessing.get_context("spawn")
        self.recv, send = ctx.Pipe(duplex=False)
        self.proc = ctx.Process(target=_seq_plain_main, daemon=True,
                                args=(send, self.path))
        self.proc.start()
        send.close()
        self.got = {"transfers": got, **{f"accounts {k}": v[1]
                                         for k, v in accounts.items()}}
        self.accounts = {}

    def finish(self) -> tuple:
        try:
            msg = (self.recv.recv() if self.recv.poll(900) else
                   ("error", "no answer in 900 s"))
        except EOFError:
            msg = ("error", f"the child exited with {self.proc.exitcode}")
        finally:
            self.proc.join(60)
            if self.proc.is_alive():
                self.proc.kill()
                self.proc.join()
            os.unlink(self.path)
        check(msg[0] == "ok", f"create_seq plain twin failed:\n{msg[1]}")
        res = {}
        for name, (ms, out) in msg[1].items():
            want = {k: torch.from_numpy(v) for k, v in out.items()}
            res[name] = (ms, seq_compare(f"{name} full width",
                                         self.got[name], want))
        self.accounts = {k.split(" ", 1)[1]: v for k, v in res.items()
                         if k != "transfers"}
        return res["transfers"]


def seq_phase(dev, n_full: int = BATCH, n_checked: int = SEQ_CHECKED,
              n_accounts: int = N_ACCOUNTS,
              config3_batches: int = SEQ_CONFIG3_BATCHES):
    """The sequential kernels. Checked: mixed batches (chains,
    two-phase, balancing, closing, repeated ids, imported) and both
    kernels' hazard batches through the CUDA kernels and through the
    plain twins on the same prefetched inputs, bit-equal on every
    output. Then the path a user calls, run_create_accounts (n_accounts
    accounts) and run_create_transfers at n_full events (config-3
    batches, and a config-4 pend batch and its post/void batch), on the
    card and held against a second oracle fed the same batches. Returns
    the kernels' launches on that path and the numbers."""
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
    # The hazards between each kernel's pre-pass and its walk, each batch
    # on a fresh state.
    hazards = [("transfers", *c) for c in seq_hazard_cases(
        Transfer, TransferFlags)] + [("accounts", *c) for c in
                                     seq_account_hazard_cases(
                                         Account, AccountFlags)]
    for kind, label, events, at, expect in hazards:
        o = StateMachineOracle()
        for op, evs, t in seq_hazard_setup(Account, AccountFlags, Transfer,
                                           TransferFlags):
            getattr(o, f"create_{op}")(evs, t)
        if kind == "transfers":
            inputs, _ = prefetch_create_transfers(
                o, transfers_to_arrays(events), at)
            kern, plain, codes = (create_seq.create_transfers_seq,
                                  CK.create_transfers_seq_plain, CK._TS)
        else:
            inputs, _ = prefetch_create_accounts(
                o, accounts_to_arrays(events), at)
            kern, plain, codes = (create_seq.create_accounts_seq,
                                  CK.create_accounts_seq_plain, CK._AS)
        want = plain(CK.inputs_to_device(inputs, "cpu"))
        got = kern(CK.inputs_to_device(inputs, dev))
        err = max(err, seq_compare(f"{kind} hazard: {label}", got, want))
        for k, name in expect.items():
            check(codes[name] == int(want["r_status"][k]),
                  f"{kind} hazard: {label}: event {k} is not {name}")
    print(f"sequential kernels vs plain twins: the {len(hazards)} hazard "
          f"batches bit-equal", flush=True)

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
    create_seq.KIND_LAUNCHES.update(transfers=0, accounts=0)
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
    by_kind = dict(create_seq.KIND_LAUNCHES)
    on_card = torch.device(dev).type == "cuda"
    check(launches == (runs if on_card else 0)
          and (min(by_kind.values()) > 0 or not on_card),
          f"run_create_* launched the kernels {launches} times "
          f"({by_kind}) in {runs} calls")
    n_pend = int((st_p == created).sum())
    check(int((st_r == created).sum()) == n_pend,
          "the config-4 post/void batch did not resolve every pending")

    numbers = dict(
        launches=launches, launches_by_kind=by_kind, max_abs_err=err,
        kernel_ms=spans["kernel"], events=spans["events"],
        prefetch_ms=spans["prefetch"], apply_ms=spans["apply"],
        config3_created=c3, config4_created=n_pend)
    if not on_card:
        return numbers

    # The kernels line: device time of each kernel (its own %globaltimer
    # stamps, with the stage split) on full-width batches, beside its
    # bytes bound: the transfers kernel on the first config-3 batch's
    # inputs and on a config-4 pend batch and its post/void batch, the
    # accounts kernel on n_full new accounts and on an n_full-event mixed
    # batch. The config-4 outputs are held to the plain twin here; the
    # config-3 and accounts ones in a child process that main() waits for
    # at its end, which times the twins.
    inputs = seq_config3_inputs(n_full)
    tin_g = CK.inputs_to_device(inputs, dev)
    got = create_seq.create_transfers_seq(tin_g)
    acc = {}
    for name, acc_in in (("new", seq_accounts_inputs(n_full)),
                         ("mixed", seq_mixed_accounts_inputs(n_full))):
        tin_a = CK.inputs_to_device(acc_in, dev)
        acc[name] = (acc_in, tin_a, create_seq.create_accounts_seq(tin_a))
    plain = SeqPlainChild(inputs, got, accounts={
        k: (v[0], v[2]) for k, v in acc.items()})
    bound_ms = seq_bytes(tin_g, got) / HBM_BYTES_PER_S * 1e3
    ms, stage_split = seq_device_ms(create_seq, "transfers", tin_g)
    c4 = {}
    for label, inp in zip(("pend", "post_void"),
                          seq_config4_inputs(n_full)):
        tin4 = CK.inputs_to_device(inp, dev)
        out4 = create_seq.create_transfers_seq(tin4)
        err = max(err, seq_compare(f"config-4 {label}", out4,
                                   CK.create_transfers_seq_plain(
                                       CK.inputs_to_device(inp, "cpu"))))
        c4[label] = dict(
            ms=seq_device_ms(create_seq, "transfers", tin4)[0],
            bound_ms=seq_bytes(tin4, out4) / HBM_BYTES_PER_S * 1e3)
    accounts = {}
    for name, (_, tin_a, got_a) in acc.items():
        a_ms, a_split = seq_device_ms(create_seq, "accounts", tin_a)
        accounts[name] = dict(
            ms=a_ms, ns_per_event=a_ms * 1e6 / n_full, stage_ms=a_split,
            bound_ms=seq_bytes(tin_a, got_a) / HBM_BYTES_PER_S * 1e3)
    numbers.update(max_abs_err=err, ms=ms, plain_twin=plain,
                   bound_ms=bound_ms, ns_per_event=ms * 1e6 / n_full,
                   stage_ms=stage_split, config4_ms=c4, accounts=accounts,
                   elapsed_s=time.perf_counter() - t0)
    print(f"sequential kernels: {launches} launches on run_create_* "
          f"({runs} calls: {by_kind}), equal to the oracle; transfers "
          f"device {ms:.4f} ms a {n_full}-event config-3 batch "
          f"({numbers['ns_per_event']:.0f} ns/event; stages ms "
          + ", ".join(f"{k} {v:.4f}" for k, v in stage_split.items())
          + f"; bound {bound_ms:.4f} ms, bytes), config-4 pend "
          f"{c4['pend']['ms']:.4f} ms and post/void "
          f"{c4['post_void']['ms']:.4f} ms (equal to the plain twin)"
          + "; accounts device "
          + ", ".join(f"{k} {v['ms']:.4f} ms ({v['ns_per_event']:.0f} "
                      f"ns/event; stages ms " + ", ".join(
                          f"{s} {t:.4f}" for s, t in v["stage_ms"].items())
                      + f"; bound {v['bound_ms']:.4f} ms)"
                      for k, v in accounts.items())
          + f" a {n_full}-event batch; plain twins in a child process; "
          f"run_create_* kernel spans (launch to outputs on the host, "
          f"ms / events): "
          + ", ".join(f"{m:.2f}/{n}" for m, n in zip(spans["kernel"],
                                                     spans["events"]))
          + f"; prefetch ms {[round(x, 1) for x in spans['prefetch']]}, "
          f"apply ms {[round(x, 1) for x in spans['apply']]}; config 3 "
          f"created {c3}, config 4 {n_pend} pendings resolved; "
          f"{numbers['elapsed_s']:.1f} s", flush=True)
    return numbers


def seq_device_ms(create_seq, kind: str, tin: dict, reps: int = 5):
    """(device ms, stage split) of the sequential kernel of `kind` on
    `tin`: the median over `reps` launches of the kernel's own
    %globaltimer stamps (first stamp to last, and each stage's), after
    one warm-up launch. A profiler trace of these launches holds one
    kernel a call, and the profiler now and then drops every event of
    such a trace."""
    run = (create_seq.create_transfers_seq if kind == "transfers"
           else create_seq.create_accounts_seq)
    run(tin)
    ms, stages = [], []
    for _ in range(reps):
        run(tin)
        ms.append(create_seq.device_ms(kind))
        stages.append(create_seq.stage_ms(kind))
    split = {k: float(np.median([s[k] for s in stages]))
             for k in create_seq.STAGES}
    return float(np.median(ms)), split


def seq_config3_inputs(n: int = BATCH) -> dict:
    """The transfers kernel's timed config-3 inputs: the first config-3
    batch (seed 3) over 1,000 accounts, prefetched."""
    from tigerbeetle_tpu_torch.oracle import StateMachineOracle
    from tigerbeetle_tpu_torch.ops.batch import prefetch_create_transfers
    from tigerbeetle_tpu_torch.types import Account

    o = StateMachineOracle()
    o.create_accounts([Account(id=i, ledger=1, code=1)
                       for i in range(1, 1001)], 1000)
    inputs, _ = prefetch_create_transfers(
        o, config3_batch(np.random.default_rng(3), 0, n, 1000), 10**7)
    return inputs


def seq_config4_inputs(n: int = BATCH) -> tuple:
    """The transfers kernel's timed config-4 inputs: a pend batch (seed
    4) over config 4's accounts, and its post/void batch prefetched after
    the pends were committed (by the oracle)."""
    from tigerbeetle_tpu_torch.oracle import StateMachineOracle
    from tigerbeetle_tpu_torch.ops.batch import (prefetch_create_transfers,
                                                 transfers_from_arrays)
    from tigerbeetle_tpu_torch.types import Account, AccountFlags, \
        TransferFlags

    o = StateMachineOracle()
    o.create_accounts(config4_accounts(Account, AccountFlags), C4_ACCOUNTS)
    pend, rev, _ = config4_pair(np.random.default_rng(4), 10**7,
                                TransferFlags, n)
    ts = 10**12
    pend_in, _ = prefetch_create_transfers(o, pend, ts + n + 10)
    o.create_transfers(transfers_from_arrays(pend), ts + n + 10)
    rev_in, _ = prefetch_create_transfers(o, rev, ts + 2 * (n + 10))
    return pend_in, rev_in


def seq_accounts_inputs(n: int = BATCH) -> dict:
    """The accounts kernel's timed inputs: n new accounts, prefetched."""
    from tigerbeetle_tpu_torch.oracle import StateMachineOracle
    from tigerbeetle_tpu_torch.ops.batch import (accounts_to_arrays,
                                                 prefetch_create_accounts)
    from tigerbeetle_tpu_torch.types import Account

    inputs, _ = prefetch_create_accounts(
        StateMachineOracle(), accounts_to_arrays(
            [Account(id=i, ledger=1, code=1) for i in range(1, n + 1)]),
        10**7)
    return inputs


def seq_mixed_accounts_case(n: int = BATCH) -> tuple:
    """The accounts kernel's second timed batch as (state, events,
    timestamp): n events of seq_mixed_accounts (seed 8: chains, some
    broken, ids repeated with equal and other fields, failing checks)
    over a state that already holds one id in 16 of the batch (half of
    those with another user_data_64)."""
    from tigerbeetle_tpu_torch.oracle import StateMachineOracle
    from tigerbeetle_tpu_torch.types import Account, AccountFlags

    events = seq_mixed_accounts(Account, AccountFlags,
                                np.random.default_rng(8), n, 10**6)
    o = StateMachineOracle()
    o.create_accounts([Account(id=10**6 + j, ledger=1, code=1,
                               user_data_64=j % 2)
                       for j in range(5, n, 16)], 10**6)
    return o, events, 10**7


def seq_mixed_accounts_inputs(n: int = BATCH) -> dict:
    """seq_mixed_accounts_case(n), prefetched."""
    from tigerbeetle_tpu_torch.ops.batch import (accounts_to_arrays,
                                                 prefetch_create_accounts)

    o, events, ts = seq_mixed_accounts_case(n)
    inputs, _ = prefetch_create_accounts(o, accounts_to_arrays(events), ts)
    return inputs


# ------------------------------------------------------------ commit windows

def window_launches(route: str, W: int) -> tuple:
    """(probe, row gather) launches of one window on `route`: one tier
    run a prepare on the chain (plain tier), one over all W·n_pad lanes
    on a flat tier, one partitioned plain prepare a prepare on the
    partitioned chain (PT_SHARDS shards)."""
    if route == "partitioned_chain":
        p, g = partitioned_launches("plain", PT_SHARDS)
        return p * W, g * W
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


def _trace_by_name(dev, fn) -> dict:
    """{kernel or op name: (device ms, launches)} from a torch.profiler
    trace of one call of fn()."""
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
    return by_name


def _kernel_counts(by_name: dict) -> tuple:
    return (sum(v[1] for k, v in by_name.items() if "ht_probe_kernel" in k),
            sum(v[1] for k, v in by_name.items() if "row_gather" in k))


def window_trace(dev, fn, label: str, replay=None, want=None,
                 attempts: int = 4) -> dict:
    """One call of fn() under torch.profiler: its device-busy ms, its
    device ops and its probe and row-gather kernel counts (None where the
    trace holds no device time, and on the CPU). The profiler now and
    then drops device events from a trace, and fn() commits a window, so
    it runs once: where its trace's kernel counts differ from `want`,
    `replay` (a call that runs the same kernels and leaves the state as
    it was: a poisoned replay of the window's graph) is traced up to
    attempts - 1 times, and the first trace holding `want`, else the one
    holding the most of those kernels, is kept."""
    if torch.device(dev).type != "cuda":
        fn()
        return dict(busy_ms=None, ops=None, probes=None, gathers=None)
    best = _trace_by_name(dev, fn)
    taken = 1
    if replay is not None and want is not None:
        while _kernel_counts(best) != tuple(want) and taken < attempts:
            got = _trace_by_name(dev, replay)
            taken += 1
            if (_kernel_counts(got) == tuple(want)
                    or sum(_kernel_counts(got)) > sum(_kernel_counts(best))):
                best = got
    if not best:
        print(f"{label}: the trace holds no device time", flush=True)
        return dict(busy_ms=None, ops=None, probes=None, gathers=None)
    top = sorted(best.items(), key=lambda kv: -kv[1][0])[:8]
    probes, gathers = _kernel_counts(best)
    out = dict(busy_ms=sum(v[0] for v in best.values()),
               ops=sum(v[1] for v in best.values()),
               probes=probes, gathers=gathers, traces=taken)
    print(f"{label}: device busy {out['busy_ms']} ms, {out['ops']} device "
          f"ops, probe kernels {out['probes']}, row-gather kernels "
          f"{out['gathers']} ({taken} trace(s)); top (ms, count): "
          + "; ".join(f"{k[:60]} {v[0]:.4f} x{v[1]}" for k, v in top),
          flush=True)
    return out


def last_graph_replay(led):
    """A call that replays, poisoned, the window graph the ledger replayed
    last when it is called (nothing where the ledger holds no graph, as
    on the CPU)."""
    def replay():
        if led.windows._graphs:
            poisoned_replay(led, next(reversed(led.windows._graphs)))
    return replay


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
                         f"config-2 window of {w_timed} (one replay)",
                         replay=last_graph_replay(G),
                         want=window_launches("chain", w_timed))
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
                         f"config-4 window of {2 * pairs} (one replay)",
                         replay=last_graph_replay(card),
                         want=window_launches("super_deep", 2 * pairs))
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
        f"imported window of {w} (one replay)",
        replay=last_graph_replay(trio.card),
        want=window_launches("super_imported", w))
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
    def balancing_replay():
        poisoned_replay(trio.card,
                        ("super_balancing", 2 * pairs, _pad_bucket(batch)))

    w_trace = window_trace(
        dev, balancing_replay,
        f"balancing window of {2 * pairs} (one poisoned replay)",
        replay=balancing_replay,
        want=window_launches("super_balancing", 2 * pairs))
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
        staged; then with recycle_events on (the ring window kernels,
        their key warmed by 2 windows) w_piped staged, then w_piped
        inline (overlap_staging off): transfers/s, host_stall_fraction
        and the drain for each;
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
    _zero_launches()
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

    piped = {}
    # Staging on and off with the ring kernels: staged, then inline.
    for mode, recycle, stage, n_win in (
            ("staged", False, True, w_piped),
            ("ring_warmup", True, True, 2),
            ("staged_ring", True, True, w_piped),
            ("inline_ring", True, False, w_piped)):
        led.recycle_events = recycle
        led.overlap_staging = stage
        # The ring windows' key warms up (eager, then captured) before it
        # is timed.
        windows = [c2_window() for _ in range(n_win)]
        # Each mode's staging counters count from zero: the difference
        # of two cumulative float sums is not the sum of the mode's own
        # increments, and an inline mode's stall and work must come out
        # equal to the last bit.
        led.staging_stats.update(windows=0, staged=0, misses=0,
                                 stall_ms=0.0, work_ms=0.0)
        d2h = L.D2H_BYTES
        sync(dev)
        t = time.perf_counter()
        replies = drive_serving(card, windows, stage)
        sync(dev)
        wall = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        led.drain_mirror()
        drain = (time.perf_counter() - t) * 1e3
        st = dict(led.staging_stats)
        for k, (window, reply) in enumerate(zip(windows, replies)):
            ref_window(f"serving {mode} window {k}", window, reply)
        check(not recycle or int(led.state["events"]["count"]) == 0,
              f"serving {mode}: the ring was not recycled")
        if mode == "ring_warmup":
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
        create_seq_by_kind=_seq_by_kind(),
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
        t = time.perf_counter()
        want = run_chaos_seed(seed, device="cpu")
        cpu_ms = (time.perf_counter() - t) * 1e3
        # A seed that draws the mesh scenarios runs them on each device's
        # default mesh (the card's devices; 8 CPU shards): the reroutes
        # and the resyncs must agree; the mesh size, the dropped device's
        # name and the flight dump's differ.
        loss = (got.pop("shard_loss", None), want.pop("shard_loss", None))
        resync = (got.pop("shard_resync", None),
                  want.pop("shard_resync", None))
        check(got == want and (loss[0] is None) == (loss[1] is None)
              and (loss[0] is None or loss[0]["reroutes"]
                   == loss[1]["reroutes"] == 2)
              and (resync[0] is None) == (loss[0] is None)
              and (resync[1] is None) == (loss[1] is None)
              and (resync[0] is None or resync[0]["resyncs"]
                   == resync[1]["resyncs"] == 1),
              f"chaos seed {seed}: the card's summary {got} {loss[0]} "
              f"{resync[0]} differs from the CPU's {want} {loss[1]} "
              f"{resync[1]}")
        out[seed] = dict(got, ms=ms, cpu_ms=cpu_ms, shard_loss=loss[0],
                         shard_resync=resync[0])
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

    from tigerbeetle_tpu_torch import constants
    from tigerbeetle_tpu_torch.ops import fused_probe
    from tigerbeetle_tpu_torch.ops import row_gather as RG

    t0 = time.perf_counter()
    was_verify = constants.VERIFY
    constants.set_verify(True)
    flight_dir = tempfile.mkdtemp(prefix="tb_flight_")
    fused_probe.LAUNCHES = RG.LAUNCHES = 0
    legs, marks = {}, [t0]

    def lap(name):
        marks.append(time.perf_counter())
        legs[name] = marks[-1] - marks[-2]

    try:
        clean = supervisor_clean(dev, caps, n_accounts, body, widths,
                                 flight_dir)
        lap("a_clean")
        faults = supervisor_faults(dev, caps, n_accounts, body, flight_dir)
        lap("b_faults")
        chaos = supervisor_chaos(dev, chaos_seeds)
        lap("c_chaos")
        adm = supervisor_admission(dev, flight_dir, **(admission or {}))
        lap("d_admission")
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
                   launches=launches, flight_dumps=dumps, legs_s=legs,
                   elapsed_s=time.perf_counter() - t0)
    print(f"supervisor: launches probe/gather {launches}; "
          f"{dumps} flight dumps; {numbers['elapsed_s']:.1f} s; "
          f"{card_line_or_cpu(dev)}", flush=True)
    return numbers


# ------------------------------------------------------- the durable phase

class DurableReplica:
    """A StateMachine committing through a replica's loop minus consensus
    (the JAX package's vsr/replica.py `_post_commit` and `_checkpoint`),
    its forest in `storage`'s grid zone. After every op: the ledger's
    flush columns (one prepare's worth in a window) through the column
    flush when the mirror is quiescent, else a drain and the object
    flush; the cache upsert; one compaction beat. Every `interval` ops a
    checkpoint: drain, the stale columns popped, the root written to the
    other snapshot slot, the superblock flipped, the host history pruned.
    `spans` holds each op's path, flush ms, beat ms and grid blocks in
    use; `ckpts` each checkpoint's op, ms and root bytes."""

    def __init__(self, sm, storage, durable, sb, op: int, interval: int):
        self.sm, self.storage, self.durable, self.sb = sm, storage, durable, sb
        self.op = op
        self.interval = interval
        self.spans: list = []
        self.ckpts: list = []
        self.roots: list = []
        sm.attach_durable(durable)

    @classmethod
    def format(cls, sm, storage, interval: int) -> "DurableReplica":
        """A fresh data file (the storage part of the JAX package's
        Replica.format, vsr/replica.py:249-274): the empty forest's root
        in snapshot slot 0 and the genesis superblock."""
        from tigerbeetle_tpu_torch import StateMachine
        from tigerbeetle_tpu_torch.vsr.checksum import checksum
        from tigerbeetle_tpu_torch.vsr.durable import DurableState
        from tigerbeetle_tpu_torch.vsr.superblock import SuperBlock

        root = DurableState(storage).checkpoint(
            StateMachine("oracle", device="cpu").state)
        storage.write("snapshot", 0, root)
        sb = SuperBlock(cluster=1, replica_id=0, replica_count=1,
                        snapshot_slot=0, snapshot_size=len(root),
                        snapshot_checksum=checksum(root, domain=b"ckptroot"))
        sb.store(storage)
        return cls(sm, storage, DurableState(storage), sb, 0, interval)

    @classmethod
    def reopen(cls, make_sm, storage, interval: int, dev):
        """Restart from the data file: the superblock's quorum, the root
        it names (checksum held), `DurableState.open`, then the state
        setter of a new StateMachine, which rebuilds the device ledger.
        Returns the replica, the open's ms and the rebuild's ms."""
        from tigerbeetle_tpu_torch.vsr.checksum import checksum
        from tigerbeetle_tpu_torch.vsr.durable import DurableState
        from tigerbeetle_tpu_torch.vsr.superblock import SuperBlock

        sb = SuperBlock.load(storage)
        check(sb is not None, "durable: no superblock quorum on reopen")
        lay = storage.layout
        root = storage.read("snapshot", sb.snapshot_slot
                            * lay.snapshot_size_max, sb.snapshot_size)
        check(checksum(root, domain=b"ckptroot") == sb.snapshot_checksum,
              "durable: the checkpoint root fails its checksum")
        durable = DurableState(storage)
        t = time.perf_counter()
        state = durable.open(root, load_events=False)
        open_ms = (time.perf_counter() - t) * 1e3
        sm = make_sm()
        sync(dev)
        t = time.perf_counter()
        sm.state = state
        sync(dev)
        rebuild_ms = (time.perf_counter() - t) * 1e3
        return (cls(sm, storage, durable, sb, sb.op_checkpoint, interval),
                open_ms, rebuild_ms)

    def blocks(self) -> int:
        grid = self.durable.grid
        return grid.block_count - sum(grid.free)

    def post_commit(self, chunk_count=None) -> None:
        from tigerbeetle_tpu_torch.vsr.durable import mirror_quiescent

        self.op += 1
        sm, led = self.sm, self.sm.led
        t0 = time.perf_counter()
        cols = (led.take_flush_columns(chunk_count) if led is not None
                else None)
        raw = sm.raw_state
        if cols and not mirror_quiescent(raw,
                                         self.durable.events_persisted):
            # Interleaved history (a hard body, accounts, an expiry): the
            # drain, then the object path flushes everything.
            check(chunk_count is None,
                  f"durable op {self.op}: a window met a dirty mirror")
            sm.state
            cols = None
        sm.cache_upsert(*self.durable.flush(raw, flush_columns=cols))
        t1 = time.perf_counter()
        self.durable.compact_beat(self.op)
        t2 = time.perf_counter()
        self.spans.append(dict(op=self.op,
                               path="columns" if cols else "object",
                               flush_ms=(t1 - t0) * 1e3,
                               beat_ms=(t2 - t1) * 1e3,
                               blocks=self.blocks()))
        if self.op % self.interval == 0:
            self.checkpoint()

    def checkpoint(self) -> None:
        from tigerbeetle_tpu_torch.vsr.checksum import checksum

        t = time.perf_counter()
        state = self.sm.state              # drains the mirror first
        if self.sm.led is not None:
            self.sm.led.take_flush_columns()   # stale after the drain
        root = self.durable.checkpoint(state)
        lay = self.storage.layout
        check(len(root) <= lay.snapshot_size_max,
              "durable: the checkpoint root exceeds its slot")
        slot = 1 - self.sb.snapshot_slot
        self.storage.write("snapshot", slot * lay.snapshot_size_max, root)
        sb = self.sb
        sb.snapshot_slot = slot
        sb.snapshot_size = len(root)
        sb.snapshot_checksum = checksum(root, domain=b"ckptroot")
        sb.op_checkpoint = sb.commit_min = sb.commit_max = self.op
        sb.store(self.storage)
        state.prune_account_events(self.durable.events_persisted)
        self.ckpts.append(dict(op=self.op, root_bytes=len(root),
                               ms=(time.perf_counter() - t) * 1e3))
        self.roots.append(root)

    def commit(self, op, body: bytes, ts: int) -> bytes:
        reply = self.sm.commit(op, body, ts)
        self.post_commit()
        return reply

    def commit_window(self, op, bodies, tss) -> list:
        """A window as the replica commits one (all_or_nothing): each
        prepare's flush takes its own chunks; a window the ledger
        declines commits op by op."""
        out = self.sm.commit_window(op, bodies, tss, all_or_nothing=True)
        if out is None:
            return [self.commit(op, b, t) for b, t in zip(bodies, tss)]
        replies, shape = out
        for k in shape:
            self.post_commit(k)
        return replies

    def pipelined(self, op, windows) -> list:
        """Windows submitted two deep; each prepare's flush after its
        window resolves (every prepare here creates rows, so its chunks
        are its shape). A host engine commits them op by op."""
        if self.sm.led is None:
            return [self.commit(op, b, t) for bodies, tss in windows
                    for b, t in zip(bodies, tss)]
        replies, in_flight = [], 0

        def finish(recs):
            for rec in recs:
                for reply, k in zip(rec["replies"], rec["shape"]):
                    replies.append(reply)
                    self.post_commit(k)

        for bodies, tss in windows:
            rec = self.sm.submit_commit_window(op, bodies, tss)
            check(rec is not None, "durable: a pipelined window declined")
            in_flight += 1
            if in_flight > 1:
                done = self.sm.resolve_commit_windows(count=1)
                in_flight -= len(done)
                finish(done)
        finish(self.sm.resolve_commit_windows())
        return replies


class DurableTraffic:
    """The durable phase's wire bodies: config 2 (uniform transfers over
    n_accounts accounts) with u64 user data >= 2^63, 1 event in
    DU_PEND_EVERY a pending (half with a 1 s timeout); a closing body
    (its first events closing_debit pendings), an imported body (user
    timestamps), a resolve body (posts and voids of the oldest pendings,
    voids of the closing ones first), a hard body (a repeated id)."""

    def __init__(self, seed: int, n_accounts: int, body: int):
        self.rng = np.random.default_rng(seed)
        self.n_accounts = n_accounts
        self.body = body
        self.next_id = 10**9
        self.ts = 10**12
        self.pending: list = []     # (id, closing)

    def next_ts(self, n: int) -> int:
        self.ts += n + 1000
        return self.ts

    def accounts(self) -> list:
        from tigerbeetle_tpu_torch.types import Account, AccountFlags

        hist = int(AccountFlags.history)
        out = []
        for lo in range(0, self.n_accounts, self.body):
            accts = [Account(id=i, ledger=1, code=1 + i % 3,
                             user_data_32=i % 7,
                             user_data_64=(1 << 63) + i % 5,
                             flags=hist if i % SV_HISTORY_EVERY == 0 else 0)
                     for i in range(lo + 1,
                                    min(lo + self.body, self.n_accounts) + 1)]
            out.append((accounts_body(accts), self.next_ts(len(accts))))
        return out

    def _batch(self) -> dict:
        ev = uniform_batch(self.rng, self.next_id, self.body,
                           self.n_accounts)
        self.next_id += self.body
        n = self.body
        ev["ud64"] = (self.rng.integers(0, 4, n).astype(np.uint64)
                      | np.uint64(1 << 63))
        ev["ud128_hi"] = np.full(n, 1 << 63, dtype=np.uint64)
        ev["ud128_lo"] = self.rng.integers(0, 2**62, n).astype(np.uint64)
        ev["ud32"] = self.rng.integers(0, 5, n).astype(np.uint32)
        ev["code"] = self.rng.integers(1, 4, n).astype(np.uint32)
        return ev

    def plain(self) -> bytes:
        from tigerbeetle_tpu_torch.types import TransferFlags as TF

        ev = self._batch()
        pend = np.nonzero(np.arange(self.body) % DU_PEND_EVERY == 1)[0]
        ev["flags"][pend] = int(TF.pending)
        ev["timeout"][pend[::2]] = 1
        self.pending.extend((int(ev["id_lo"][i]), False) for i in pend)
        return wire_body([ev])

    def closing(self, k: int = 4) -> bytes:
        from tigerbeetle_tpu_torch.types import TransferFlags as TF

        ev = self._batch()
        ev["dr_lo"][:k] = np.arange(1, k + 1, dtype=np.uint64)
        ev["cr_lo"][:k] = np.arange(k + 1, 2 * k + 1, dtype=np.uint64)
        ev["flags"][:k] = int(TF.closing_debit | TF.pending)
        self.pending[:0] = [(int(i), True) for i in ev["id_lo"][:k]]
        return wire_body([ev])

    def imported(self) -> bytes:
        """Imported transfers at user timestamps after the last commit
        and before this body's."""
        from tigerbeetle_tpu_torch.types import TransferFlags as TF

        ev = self._batch()
        ev["flags"][:] = int(TF.imported)
        ev["ts"] = np.uint64(self.ts + 1) + np.arange(self.body,
                                                       dtype=np.uint64)
        return wire_body([ev])

    def resolve(self) -> bytes:
        from tigerbeetle_tpu_torch.types import TransferFlags as TF

        ev = self._batch()
        k = min(len(self.pending), self.body // 2)
        take, self.pending = self.pending[:k], self.pending[k:]
        void = np.array([c or j % 3 == 0 for j, (_, c) in enumerate(take)],
                        dtype=bool)
        for f in ("dr_lo", "cr_lo", "ud128_hi", "ud128_lo", "ud64", "ud32",
                  "code", "ledger"):
            ev[f][:k] = 0
        ev["pid_lo"][:k] = [p for p, _ in take]
        # The full amount: 0 for a void, AMOUNT_MAX for a post.
        ev["amt_lo"][:k] = np.where(void, 0, 2**64 - 1)
        ev["amt_hi"][:k] = np.where(void, 0, 2**64 - 1)
        ev["flags"][:k] = np.where(void, int(TF.void_pending_transfer),
                                   int(TF.post_pending_transfer))
        return wire_body([ev])

    def hard(self) -> bytes:
        ev = self._batch()
        ev["id_lo"][-1] = ev["id_lo"][0]
        return wire_body([ev])


def durable_plan(acct_ops: int, n_ops: int, w: int, interval: int,
                 turns: int) -> list:
    """The ops after the account bodies, as (kind, n ops), to two
    checkpoints (at the card's interval of 16 the second falls where the
    forest's first bar of 32 ops ends): singles to the first (`turns`
    plain ones first, timed beside a ledger without the forest; then a
    closing, an imported and a resolve body), then two windows pipelined
    two deep, a synchronous window, a hard body, a resolve body, a pulse
    and singles to the second; then the rest of the n_ops bodies (the
    journal a restart replays)."""
    check(3 * w + 3 <= interval and interval - acct_ops >= turns + 3,
          "durable: the plan does not fit its checkpoints")
    plan = [("timed", turns), ("closing", 1), ("imported", 1),
            ("resolve", 1), ("plain", interval - acct_ops - turns - 3),
            ("pipelined", 2 * w), ("window", w), ("hard", 1),
            ("resolve", 1), ("pulse", 1), ("plain", interval - 3 * w - 3)]
    bodies = sum(n for kind, n in plan if kind != "pulse")
    check(n_ops > bodies, "durable: no ops left after the last checkpoint")
    plan.append(("journal", n_ops - bodies))
    return [(kind, n) for kind, n in plan if n]


def zone_digests(rep) -> dict:
    """What a replica's checkpoints made durable, digested: its roots,
    its data file's grid zone, snapshot zone and superblock copies, and
    every tree's memtable."""
    import hashlib

    lay = rep.storage.layout
    out = {"roots": list(rep.roots)}
    for zone, size in (
            ("grid", lay.grid_block_count * lay.grid_block_size),
            ("snapshot", 2 * lay.snapshot_size_max),
            ("superblock", 4 * 4096)):
        h = hashlib.blake2b()
        for off in range(0, size, 64 << 20):
            h.update(rep.storage.read(zone, off, min(64 << 20, size - off)))
        out[zone] = h.hexdigest()
    for name, tree in rep.durable.forest.trees.items():
        h = hashlib.blake2b()
        for k, v in sorted(tree.memtable.items()):
            h.update(k + v)
        out[f"memtable {name}"] = h.hexdigest()
    return out


def tree_digests(forest) -> dict:
    """Every tree's row count and a digest of its whole contents: the
    logical state of a forest."""
    import hashlib

    out = {}
    for name, tree in forest.trees.items():
        h, n = hashlib.blake2b(), 0
        for k, v in tree.scan(b"\x00" * tree.key_size,
                              b"\xff" * tree.key_size):
            h.update(k + v)
            n += 1
        out[name] = (n, h.hexdigest())
    return out


def _twin_main(conn, engine: str, layout, caps, interval: int,
               threads: int) -> None:
    """A CPU twin of the durable phase's replica, in its own process:
    `engine` "device" (the port's device engine on the CPU) or "oracle";
    commands in over `conn`, each answered with (True, result) or
    (False, the traceback)."""
    import traceback

    from tigerbeetle_tpu_torch import StateMachine
    from tigerbeetle_tpu_torch.types import Operation as Op
    from tigerbeetle_tpu_torch.vsr.storage import MemoryStorage

    torch.set_num_threads(threads)
    sm = (StateMachine("device", a_cap=caps[0], t_cap=caps[1], device="cpu")
          if engine == "device" else StateMachine("oracle", device="cpu"))
    rep = DurableReplica.format(sm, MemoryStorage(layout), interval)
    calls = {
        "commit": lambda op, *a: rep.commit(Op(op), *a),
        "commit_window": lambda op, *a: rep.commit_window(Op(op), *a),
        "pipelined": lambda op, *a: rep.pipelined(Op(op), *a),
        "read": lambda op, *a: rep.sm.commit(Op(op), *a),
        "pulse_needed": lambda ts: rep.sm.pulse_needed(ts),
        "files": lambda: zone_digests(rep),
        "trees": lambda: tree_digests(rep.durable.forest),
        "checkpoint_ms": lambda: [c["ms"] for c in rep.ckpts],
    }
    while True:
        msg = conn.recv()
        if msg is None:
            return
        name, args = msg
        try:
            conn.send((True, calls[name](*args)))
        except Exception:
            conn.send((False, traceback.format_exc()))


class Twin:
    """The phase's end of a `_twin_main` process (spawned: the parent
    holds the card). `send` starts a command, `recv` waits for it."""

    def __init__(self, ctx, engine: str, layout, caps, interval: int):
        self.engine = engine
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(
            target=_twin_main, daemon=True,
            args=(child, engine, layout, caps, interval,
                  min(2, torch.get_num_threads())))
        self.proc.start()
        child.close()

    def send(self, name: str, *args) -> None:
        self.conn.send((name, args))

    def recv(self):
        try:
            ok, out = self.conn.recv()
        except EOFError:
            ok, out = False, "the process ended"
        check(ok, f"durable: the CPU {self.engine} twin failed:\n{out}")
        return out

    def call(self, name: str, *args):
        self.send(name, *args)
        return self.recv()

    def stop(self) -> None:
        try:
            self.conn.send(None)
        except (BrokenPipeError, OSError):
            pass
        self.proc.join(timeout=60)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join()


def durable_phase(dev, n_accounts: int = N_ACCOUNTS, body: int = SV_BODY,
                  n_ops: int = DU_OPS, w: int = DU_W,
                  interval: int = DU_CHECKPOINT, n_after: int = DU_AFTER,
                  n_lookups: int = DU_LOOKUPS, turns: int = DU_TURNS,
                  layout=None, caps: tuple = (A_CAP, T_CAP)) -> dict:
    """The durable layer on `dev`: `StateMachine(engine="device")` with a
    `DurableState` on a `FileStorage` data file at `layout` (default
    `StorageLayout()`: a 1,024-slot WAL of 1 MiB messages, a 512 MiB grid
    of 64 KiB blocks; ~1.7 GB, sparse) in a temporary directory,
    committed through `DurableReplica` beside two twins on the CPU, each
    in its own process with its own forest, that get the same bodies at
    the same time: the port's device engine (the same flush path: its
    roots, grid zone, snapshot zone, superblock and memtables must equal
    the card's byte for byte after every checkpoint) and the oracle
    engine (every reply, the card's too, equal to its reply bytes; at
    the last checkpoint every tree's contents equal the card's).

    The ops follow `durable_plan` (n_ops bodies of `body` events after
    the account bodies): singles, windows of w pipelined two deep, a
    synchronous all_or_nothing window, a hard body on the mirror, a
    pulse past the pendings' 1 s timeouts, a checkpoint every
    `interval` ops. The first `turns` bodies are timed beside a ledger
    without the forest (the same bodies, in turns). After the journal's
    ops: lookups of n_lookups transfer and account ids from the forest,
    cold and warm (VERIFY on for one op: the cache against the trees),
    the five queries, each equal to the twins' bytes. Then the restart:
    the file closed, reopened from its superblock and root, the device
    ledger rebuilt (its digest equal to the one at the checkpoint), the
    journal replayed (replies and digest equal to the first run's),
    n_after more ops beside the twins. Returns the numbers."""
    import multiprocessing
    import shutil

    from tigerbeetle_tpu_torch.vsr.storage import StorageLayout

    t_phase = time.perf_counter()
    layout = layout or StorageLayout()
    tmp = tempfile.mkdtemp(prefix="tb_durable_")
    ctx = multiprocessing.get_context("spawn")
    twins: list = []
    try:
        twins = [Twin(ctx, engine, layout, caps, interval)
                 for engine in ("device", "oracle")]
        return _durable_run(
            dev, twins, f"{tmp}/replica.tigerbeetle", layout, caps, t_phase,
            n_accounts=n_accounts, body=body, n_ops=n_ops, w=w,
            interval=interval, n_after=n_after, n_lookups=n_lookups,
            turns=turns)
    finally:
        for t in twins:
            t.stop()
        shutil.rmtree(tmp, ignore_errors=True)


def _durable_run(dev, twins, path, layout, caps, t_phase, *, n_accounts,
                 body, n_ops, w, interval, n_after, n_lookups,
                 turns) -> dict:
    """durable_phase's body, with its twins started."""
    from tigerbeetle_tpu_torch import StateMachine, constants, multi_batch
    from tigerbeetle_tpu_torch.ops import create_seq, fused_probe
    from tigerbeetle_tpu_torch.ops import row_gather as RG
    from tigerbeetle_tpu_torch.ops.state_epoch import device_state_digest
    from tigerbeetle_tpu_torch.types import (
        AccountFilter, AccountFilterFlags, ChangeEventsFilter, Operation,
        QueryFilter)
    from tigerbeetle_tpu_torch.vsr.storage import FileStorage

    O = Operation
    CT = O.create_transfers
    twin = twins[0]
    cuda = torch.device(dev).type == "cuda"
    fused_probe.LAUNCHES = RG.LAUNCHES = 0
    seq0 = create_seq.LAUNCHES

    def device_sm(d):
        return StateMachine("device", a_cap=caps[0], t_cap=caps[1],
                            device=d)

    card = DurableReplica.format(
        device_sm(dev), FileStorage(path, layout, create=True), interval)
    bare = device_sm(dev)
    tr = DurableTraffic(90, n_accounts, body)
    replies_at: dict = {}        # op -> the card's reply
    journal: list = []           # the ops after the last checkpoint
    digests: dict = {}           # op -> device digest at a checkpoint
    zone_checks = []

    def same(label, got: list) -> bytes:
        check(all(g == got[-1] for g in got),
              f"durable {label}: the replies differ from the CPU oracle "
              "engine's")
        return got[0]

    def check_files(label) -> None:
        """After a checkpoint: the card's data file against the CPU
        device-engine twin's, zone by zone, its memtables and roots."""
        t = time.perf_counter()
        twin.send("files")
        mine = zone_digests(card)
        theirs = twin.recv()
        for key in mine:
            check(mine[key] == theirs[key],
                  f"durable {label}: the {key} differs from the CPU "
                  "device engine's")
        zone_checks.append((time.perf_counter() - t) * 1e3)

    def run(name, op, *args) -> list:
        """One op (or window) on the card and on both twins at once: the
        replies, the card's first."""
        n_ckpt = len(card.roots)
        for t in twins:
            t.send(name, int(op), *args)
        got = [getattr(card, name)(op, *args)] + [t.recv() for t in twins]
        if len(card.roots) > n_ckpt:
            check_files(f"checkpoint at op {card.op}")
            digests[card.op] = device_state_digest(card.sm.led.state)
        return got

    # ---- the account bodies
    for raw, ts in tr.accounts():
        same("accounts", run("commit", O.create_accounts, raw, ts))
        bare.commit(O.create_accounts, raw, ts)
    plan = durable_plan(card.op, n_ops, w, interval, turns)

    # ---- the ops to the last checkpoint
    commit_ms, bare_ms = [], []
    for kind, n in plan:
        if kind == "timed":
            for i in range(n):
                raw, ts = tr.plain(), tr.next_ts(body)
                for t in twins:
                    t.send("commit", int(CT), raw, ts)
                got = {}
                for who in (("bare", "card") if i % 2 else ("card", "bare")):
                    sm = bare if who == "bare" else card.sm
                    sync(dev)
                    t0 = time.perf_counter()
                    got[who] = sm.commit(CT, raw, ts)
                    sync(dev)
                    (bare_ms if who == "bare" else commit_ms).append(
                        (time.perf_counter() - t0) * 1e3)
                card.post_commit()
                check(got["card"] == got["bare"],
                      "durable: the forest changed a reply")
                same("timed", [got["card"]] + [t.recv() for t in twins])
            bare.led.shutdown_staging()
            bare.led.release()
            bare = None
            if cuda:
                torch.cuda.empty_cache()
        elif kind in ("pipelined", "window"):
            windows = [(bodies, [tr.next_ts(body) for _ in bodies])
                       for bodies in ([tr.plain() for _ in range(w)]
                                      for _ in range(n // w))]
            got = (run("pipelined", CT, windows) if kind == "pipelined"
                   else run("commit_window", CT, *windows[0]))
            check(got[0] == got[1] == got[2],
                  f"durable {kind}: the replies differ from the CPU oracle "
                  "engine's")
        elif kind == "pulse":
            tr.ts += 2 * 10**9
            ts = tr.ts
            check(card.sm.pulse_needed(ts) and all(
                t.call("pulse_needed", ts) for t in twins),
                  "durable: no pulse due past the pendings' timeouts")
            run("commit", O.pulse, b"", ts)
        else:
            for _ in range(n):
                raw = getattr(tr, "plain" if kind == "journal"
                              else kind)()
                ts = tr.next_ts(body)
                if kind == "journal":
                    journal.append((raw, ts))
                fb0 = card.sm.led.fallbacks
                op_no = card.op + 1
                replies_at[op_no] = same(kind, run("commit", CT, raw, ts))
                check(kind != "hard" or card.sm.led.fallbacks == fb0 + 1,
                      "durable: the hard body did not run on the mirror")
    check(len(card.roots) == 2 and len(zone_checks) == 2,
          f"durable: {len(card.roots)} checkpoints")
    last_ckpt = card.roots[-1]
    digest_end = device_state_digest(card.sm.led.state)

    # ---- every tree's contents against the oracle engine's forest
    t = time.perf_counter()
    twins[1].send("trees")
    mine = tree_digests(card.durable.forest)
    theirs = twins[1].recv()
    for name in mine:
        check(mine[name] == theirs[name],
              f"durable: tree {name} differs from the oracle engine's")
    trees_ms = (time.perf_counter() - t) * 1e3
    rows = {name: n for name, (n, _) in mine.items()}

    # ---- reads from the forest (nothing drains the card's mirror)
    chunks0 = len(card.sm.led._mirror_chunks)
    xids = [int(x) for x in tr.rng.choice(
        np.arange(10**9, tr.next_id), n_lookups, replace=False)]
    aids = [int(x) for x in tr.rng.integers(1, n_accounts + 1, n_lookups)]

    def read(op, raw, label):
        for t in twins:
            t.send("read", int(op), raw, tr.ts)
        sync(dev)
        t0 = time.perf_counter()
        got = card.sm.commit(op, raw, tr.ts)
        ms = (time.perf_counter() - t0) * 1e3
        same(label, [got] + [t.recv() for t in twins])
        check(len(got) > 0, f"durable {label}: an empty reply")
        return ms

    lookup_ms = {}
    for op, ids in ((O.lookup_transfers, xids), (O.lookup_accounts, aids)):
        raw = multi_batch.encode(
            [b"".join(i.to_bytes(16, "little") for i in ids)], 16)
        cache = (card.sm._xfer_cache if op == O.lookup_transfers
                 else card.sm._acct_cache)
        card.sm._acct_cache.clear()
        card.sm._xfer_cache.clear()
        card.durable.grid.cache.clear()
        cold = read(op, raw, f"{op.name} cold")
        constants.set_verify(op == O.lookup_transfers)
        try:
            warm = read(op, raw, f"{op.name} warm")
        finally:
            constants.set_verify(False)
        lookup_ms[op.name] = dict(cold_ms=cold, warm_ms=warm,
                                  cache=dict(cache.stats()))
    both = int(AccountFilterFlags.debits | AccountFilterFlags.credits)
    hist_id = SV_HISTORY_EVERY
    queries = [
        (O.get_account_transfers, multi_batch.encode([AccountFilter(
            account_id=hist_id, limit=200, flags=both).pack()], 128)),
        (O.get_account_balances, multi_batch.encode([AccountFilter(
            account_id=hist_id, limit=200, flags=both).pack()], 128)),
        (O.query_accounts, multi_batch.encode([QueryFilter(
            user_data_32=3, code=2, limit=200).pack()], 64)),
        (O.query_transfers, multi_batch.encode([QueryFilter(
            user_data_64=(1 << 63) + 2, code=3, limit=200,
            flags=1).pack()], 64)),
        (O.get_change_events, ChangeEventsFilter(limit=200).pack()),
    ]
    query_ms = {op.name: read(op, raw, op.name) for op, raw in queries}
    check(len(card.sm.led._mirror_chunks) == chunks0,
          "durable: a read drained the mirror")

    before = card
    print_durable_ops("durable (first run)", before)

    # ---- restart from the data file
    sync(dev)
    card.sm.led.shutdown_staging()
    card.sm.led.release()
    card.sm = None
    card.storage.close()
    if cuda:
        torch.cuda.empty_cache()
    storage = FileStorage(path, layout)
    card, open_ms, rebuild_ms = DurableReplica.reopen(
        lambda: device_sm(dev), storage, interval, dev)
    check(card.op == 2 * interval and card.roots == []
          and storage.read("snapshot", card.sb.snapshot_slot
                           * layout.snapshot_size_max,
                           card.sb.snapshot_size) == last_ckpt,
          "durable: the reopened superblock names another checkpoint")
    check(device_state_digest(card.sm.led.state) == digests[card.op],
          "durable: the rebuilt ledger's digest differs from the "
          "checkpoint's")
    memory = memory_now(dev)
    for raw, ts in journal:
        got = card.commit(CT, raw, ts)
        check(got == replies_at[card.op],
              f"durable: replayed op {card.op}'s reply differs")
    check(device_state_digest(card.sm.led.state) == digest_end,
          "durable: the digest after the replay differs")
    for _ in range(n_after):
        raw, ts = tr.plain(), tr.next_ts(body)
        same("after the restart", run("commit", CT, raw, ts))
    launches = (fused_probe.LAUNCHES, RG.LAUNCHES)
    check(not cuda or (launches[0] > 0 and launches[1] > 0),
          f"durable: launches probe/gather {launches}")
    check(create_seq.LAUNCHES == seq0, "durable: create_seq launched")
    twin_ckpt_ms = twin.call("checkpoint_ms")
    storage.close()

    print_durable_ops("durable (after the restart)", card)
    spans = before.spans + card.spans
    by_path = {p: [s["flush_ms"] for s in spans if s["path"] == p]
               for p in ("columns", "object")}
    numbers = dict(
        ops=card.op, bodies=n_ops + n_after, events_per_body=body,
        plan=plan, layout=dict(slot_count=layout.slot_count,
                               message_size_max=layout.message_size_max,
                               grid_block_size=layout.grid_block_size,
                               grid_block_count=layout.grid_block_count,
                               file_bytes=layout.size),
        commit_ms_forest=commit_ms, commit_ms_bare=bare_ms,
        flush_ms_columns=by_path["columns"], flush_ms_object=by_path["object"],
        beat_ms=[s["beat_ms"] for s in spans],
        blocks=[s["blocks"] for s in spans],
        checkpoints=before.ckpts, twin_checkpoint_ms=twin_ckpt_ms,
        zone_check_ms=zone_checks, trees_ms=trees_ms,
        tree_rows=rows, lookups=lookup_ms, query_ms=query_ms,
        undrained_chunks_at_reads=chunks0,
        open_ms=open_ms, rebuild_ms=rebuild_ms, memory_after_rebuild=memory,
        launches=launches, elapsed_s=time.perf_counter() - t_phase)
    print(f"durable: {numbers['ops']} ops, every reply equal to the CPU "
          f"oracle engine's, 2 checkpoints byte-equal to the CPU device "
          f"engine's; flush {np.mean(by_path['columns']):.1f} ms (columns, "
          f"{len(by_path['columns'])} ops) / {np.mean(by_path['object']):.1f}"
          f" ms (object, {len(by_path['object'])}); checkpoints "
          f"{[round(c['ms'], 1) for c in before.ckpts]} ms, roots "
          f"{[c['root_bytes'] for c in before.ckpts]} B; open "
          f"{open_ms:.1f} ms, rebuild {rebuild_ms:.1f} ms; lookups "
          f"{ {k: (round(v['cold_ms'], 1), round(v['warm_ms'], 1)) for k, v in lookup_ms.items()} }"
          f" ms cold/warm; queries "
          f"{ {k: round(v, 1) for k, v in query_ms.items()} } ms; commit "
          f"{np.mean(commit_ms):.1f} ms with the forest, "
          f"{np.mean(bare_ms):.1f} without; memory after the rebuild "
          f"{memory}; launches probe/gather {launches}; "
          f"{numbers['elapsed_s']:.1f} s; {card_line_or_cpu(dev)}",
          flush=True)
    return numbers


def print_durable_ops(label, rep) -> None:
    """One line an op: its flush path and ms, beat ms, grid blocks."""
    for sp in rep.spans:
        print(f"{label} op {sp['op']}: {sp['path']} flush "
              f"{sp['flush_ms']:.1f} ms, beat {sp['beat_ms']:.1f} ms, "
              f"{sp['blocks']} blocks", flush=True)
    for c in rep.ckpts:
        print(f"{label} checkpoint at op {c['op']}: {c['ms']:.1f} ms, root "
              f"{c['root_bytes']} B", flush=True)


# ------------------------------------------------------- the replica phase

RP_CLIENTS = 8              # one request in flight each: the pipeline's 8
RP_BODIES = 3               # create_transfers bodies a client (5 before
#                             the clients phase was added)
RP_KILL_AT = 21             # SIGKILL once a client holds this op's reply
RP_GET_LIMIT = 200
RP_TIMEOUT_S = 300.0        # a client's patience (a restart takes ~20 s)
RC_OPS = 24                 # the cluster's ops, its accounts body first
RC_BODY = 500               # events a cluster body: TEST_LAYOUT's 64 KiB
RC_CRASH_AT = 12            # the primary crashes once this op committed
RC_SEED = 17
RC_CAPS = (1 << 12, 1 << 14)
BM_TRANSFERS = 12 * BATCH   # main.py benchmark: one window of 12
BM_SERVING_BATCHES = 8      # bench_config6_serving: one window of 8
# The drivers phase: the JAX package's VOPR soak seeds of the device and
# kernel engines (tests/test_vopr.py), the fuzzers at its test sizes
# (tests/test_fuzz.py: name, seed, iterations), and the cfo run whose
# selection, worked out from the JAX package's draws, is CFO_COUNTS.
DV_DEVICE_SEEDS = (515, 626)
DV_KERNEL_SEEDS = (101, 202)
DV_FUZZ = (("device_ledger", 4, 15), ("device_ledger", 5, 15),
           ("state_machine", 9, 30), ("durability", 1, 6),
           ("storage_faults", 1, 2))
CFO_SEED, CFO_RUNS = 7, 8
CFO_COUNTS = {"chaos": 1, "fuzz:durability": 1, "fuzz:ewah": 1,
              "fuzz:lsm_manifest_level": 1, "vopr": 4}
SERVER_SPANS = ("commit_execute", "commit_compact", "commit_checkpoint",
                "journal_recover")


def _seq_by_kind() -> dict:
    """create_seq's launches by kernel (create_seq.KIND_LAUNCHES)."""
    from tigerbeetle_tpu_torch.ops import create_seq

    return dict(create_seq.KIND_LAUNCHES)


def _launch_counts() -> tuple:
    from tigerbeetle_tpu_torch.ops import create_seq, fused_probe
    from tigerbeetle_tpu_torch.ops import row_gather as RG

    return fused_probe.LAUNCHES, RG.LAUNCHES, create_seq.LAUNCHES


def _server_main(conn, argv, log_path) -> None:
    """The replica server, in a child process: `tigerbeetle_tpu_torch.
    main.main(argv)` (`start`) with this harness's taps around it, its
    output appended to log_path. Over `conn` it reports, as they happen:
    ("open", ...) once `Replica.open` returned (the kernel wrappers'
    counts set to 0 just before it, after the warmup; the storage's
    native and async engines; the engine and device; open, forest-open,
    ledger-rebuild, journal-scan and WAL-replay ms; the ops it committed
    from the journal), ("span", name, ms, op, window) for the replica's commit,
    compaction and checkpoint spans, ("flush", ms) and ("beat", ms) for
    each durable flush and compaction beat, ("prepare", op, operation)
    after each prepare it makes as the primary, ("commit", op, launches)
    after each op; and ("exit", ...) when the main loop returned on
    SIGTERM (the counts, the memory the allocator reserved at its peak,
    the replica's op and commit_min, the windows it committed)."""
    fd = os.open(log_path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    from tigerbeetle_tpu_torch import StateMachine, main as tb_main
    from tigerbeetle_tpu_torch.ops import create_seq, fused_probe
    from tigerbeetle_tpu_torch.ops import row_gather as RG
    from tigerbeetle_tpu_torch.trace.tracer import Tracer
    from tigerbeetle_tpu_torch.vsr.durable import DurableState
    from tigerbeetle_tpu_torch.vsr.journal import Journal
    from tigerbeetle_tpu_torch.vsr.replica import Replica

    holder, timing = [], {}

    def cuda_sync():
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def timed(cls, name, key, after=None):
        orig = getattr(cls, name)

        def wrapper(self, *args, **kwargs):
            t = time.perf_counter()
            try:
                return orig(self, *args, **kwargs)
            finally:
                ms = (time.perf_counter() - t) * 1e3
                timing[key] = timing.get(key, 0.0) + ms
                if after is not None:
                    after(ms)
        setattr(cls, name, wrapper)

    timed(DurableState, "open", "durable_open_ms")
    timed(Journal, "recover", "recover_ms")
    # The WAL suffix's commits at open: a primary re-adopts each journaled
    # prepare (its self-ack commits it), anyone else replays them.
    timed(Replica, "_primary_adopt_canonical", "replay_ms")
    timed(Replica, "_commit_journal", "replay_ms")
    timed(DurableState, "flush", "flush_ms",
          lambda ms: conn.send(("flush", ms)))
    timed(DurableState, "compact_beat", "beat_ms",
          lambda ms: conn.send(("beat", ms)))
    prop = StateMachine.state

    def set_state(self, value):
        cuda_sync()
        t = time.perf_counter()
        prop.fset(self, value)
        cuda_sync()
        timing["rebuild_ms"] = (timing.get("rebuild_ms", 0.0)
                                + (time.perf_counter() - t) * 1e3)
    StateMachine.state = property(prop.fget, set_state)
    record = Tracer._record

    def tap(self, ev, start, dur, tags, tid):
        record(self, ev, start, dur, tags, tid)
        if ev.name in SERVER_SPANS:
            conn.send(("span", ev.name, dur / 1e6, tags.get("op"),
                       tags.get("window")))
    Tracer._record = tap
    open_ = Replica.open

    def opened(self):
        holder.append(self)
        _zero_launches()
        for k in list(timing):
            timing[k] = 0.0
        t = time.perf_counter()
        open_(self)
        cuda_sync()
        sm, st = self.state_machine, self.storage
        conn.send(("open", dict(
            native=st.native is not None, aio=st.aio is not None,
            engine=sm.engine, device=str(sm.device),
            op_checkpoint=self.superblock.op_checkpoint, op=self.op,
            commit_min=self.commit_min,
            replayed=self.commit_min - self.superblock.op_checkpoint,
            open_ms=(time.perf_counter() - t) * 1e3, **timing,
            launches=_launch_counts())))
    Replica.open = opened
    post = Replica._post_commit

    def posted(self, prepare, result, chunk_count=None):
        post(self, prepare, result, chunk_count)
        conn.send(("commit", prepare.header.op, _launch_counts(),
                   _seq_by_kind()))
    Replica._post_commit = posted
    prepare = Replica._primary_prepare

    def prepared(self, operation, body, **kwargs):
        op = self.op
        prepare(self, operation, body, **kwargs)
        if self.op > op:
            conn.send(("prepare", self.op, int(operation)))
    Replica._primary_prepare = prepared

    try:
        rc = tb_main.main(argv)
    except BaseException:
        import traceback

        conn.send(("error", traceback.format_exc()))
        raise
    rep = holder[-1] if holder else None
    conn.send(("exit", dict(
        rc=rc, op=rep.op if rep else None,
        commit_min=rep.commit_min if rep else None,
        windows=rep._windows_committed if rep else None,
        launches=_launch_counts(), seq_by_kind=_seq_by_kind(),
        max_reserved=(torch.cuda.max_memory_reserved()
                      if torch.cuda.is_initialized() else 0))))
    conn.close()


class ServerChild:
    """A `_server_main` process and a thread collecting its reports."""

    def __init__(self, ctx, argv, log_path):
        self.msgs: list = []
        self.ready = threading.Event()
        self.exited = threading.Event()
        recv, send = ctx.Pipe(duplex=False)
        self.proc = ctx.Process(target=_server_main, daemon=True,
                                args=(send, argv, log_path))
        self.t0 = time.perf_counter()
        self.proc.start()
        send.close()
        self.reader = threading.Thread(target=self._read, args=(recv,),
                                       daemon=True)
        self.reader.start()

    def _read(self, recv) -> None:
        while True:
            try:
                msg = recv.recv()
            except (EOFError, OSError):
                break
            self.msgs.append((time.perf_counter(), msg))
            if msg[0] == "open":
                self.ready.set()
            elif msg[0] in ("exit", "error"):
                self.exited.set()
                self.ready.set()
        self.ready.set()
        self.exited.set()

    def info(self, kind: str):
        got = [m for _, m in self.msgs if m[0] == kind]
        return got[-1][1] if got else None

    def stop(self, sig: str, timeout: float = 300.0) -> None:
        if sig == "kill":
            self.proc.kill()
        else:
            self.proc.terminate()
        self.proc.join(timeout)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join()
        self.reader.join(60)


class UtilSampler:
    """`nvidia-smi --query-gpu=utilization.gpu` every 100 ms (NVIDIA's
    own sampling, coarse) until stop(); nothing on the CPU."""

    def __init__(self, on: bool):
        self.samples: list = []
        self.proc = None
        if on:
            self.proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=utilization.gpu",
                 "--format=csv,noheader,nounits", "-lms", "100", "-i", "0"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
            self.thread = threading.Thread(target=self._read, daemon=True)
            self.thread.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            try:
                self.samples.append(int(line.strip()))
            except ValueError:
                pass

    def stop(self) -> dict:
        if self.proc is not None:
            self.proc.terminate()
            self.proc.wait(30)
            self.thread.join(30)
        s = self.samples
        return dict(source="nvidia-smi utilization.gpu, 100 ms samples "
                    "(coarse)",
                    samples=len(s), mean_pct=float(np.mean(s)) if s else None,
                    p50_pct=float(np.median(s)) if s else None,
                    busy_share=(sum(1 for x in s if x > 0) / len(s)
                                if s else None))


def wait_watching(event, server, timeout_s: float, what: str, fail) -> None:
    """Wait for `event`; fail at once, with the server's log, if the
    server process ends first or reports an error."""
    t_end = time.perf_counter() + timeout_s
    while not event.wait(1.0):
        if server.info("error") is not None or not server.proc.is_alive():
            fail(f"the server ended while waiting for {what}: "
                 f"{server.info('error')}")
        if time.perf_counter() > t_end:
            fail(f"timed out waiting for {what}")


def wait_settled(server, quiet_s: float, timeout_s: float, fail) -> None:
    """Wait until `server` has committed every op it prepared and has
    reported no prepare or commit for quiet_s seconds: the expiry pulses
    a primary prepares on its own while its pipeline is empty have run
    out."""
    t_end = time.perf_counter() + timeout_s
    while True:
        got = [(t, m) for t, m in list(server.msgs)
               if m[0] in ("prepare", "commit")]
        prepared = max((m[1] for _, m in got if m[0] == "prepare"),
                       default=0)
        committed = max((m[1] for _, m in got if m[0] == "commit"),
                        default=0)
        last = got[-1][0] if got else server.t0
        if committed >= prepared and time.perf_counter() - last >= quiet_s:
            return
        if server.info("error") is not None or not server.proc.is_alive():
            fail(f"the server ended while settling: {server.info('error')}")
        if time.perf_counter() > t_end:
            fail("timed out waiting for the server to settle")
        time.sleep(0.2)


def _client_run(port, client_id, items, out, kill_op, kill_ev) -> None:
    """One client thread: `items` ((operation, body) pairs) one at a time
    through the port's `vsr.client.Client`; each reply recorded with its
    send and receive times. Sets kill_ev once a reply's op reaches
    kill_op."""
    from tigerbeetle_tpu_torch.vsr.client import Client

    c = Client(cluster=0, client_id=client_id,
               replica_addresses=[("127.0.0.1", port)])
    try:
        for op, body in items:
            t0 = time.perf_counter()
            c.request(op, body, timeout_s=RP_TIMEOUT_S)
            m = c._reply
            out.append(dict(client=client_id, request=m.header.request,
                            op=m.header.op, operation=int(op),
                            reply_operation=m.header.operation, sent=t0,
                            got=time.perf_counter(), raw=m.pack(),
                            body_bytes=len(body)))
            if kill_op is not None and m.header.op >= kill_op:
                kill_ev.set()
    except Exception as exc:   # re-raised by the phase
        out.append(dict(client=client_id, error=repr(exc)))
    finally:
        c.close()


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _module_cli(*args, timeout=600):
    """`python -m tigerbeetle_tpu_torch <args>` from the repo root."""
    return subprocess.run(
        [sys.executable, "-m", "tigerbeetle_tpu_torch", *args],
        cwd=str(Path(__file__).resolve().parent), capture_output=True,
        text=True, timeout=timeout)


def checkpoint_trees(storage) -> tuple:
    """(op_checkpoint, tree_digests) of the forest the superblock's
    checkpoint root names, opened afresh from `storage`."""
    from tigerbeetle_tpu_torch.vsr.checksum import checksum
    from tigerbeetle_tpu_torch.vsr.durable import DurableState
    from tigerbeetle_tpu_torch.vsr.replica import _split_root
    from tigerbeetle_tpu_torch.vsr.superblock import SuperBlock

    sb = SuperBlock.load(storage)
    root = storage.read("snapshot", sb.snapshot_slot
                        * storage.layout.snapshot_size_max, sb.snapshot_size)
    assert checksum(root, domain=b"ckptroot") == sb.snapshot_checksum
    durable = DurableState(storage)
    durable.open(_split_root(root)[0], load_events=False)
    return sb.op_checkpoint, tree_digests(durable.forest)


class _Capture:
    """A bus that keeps what a replica sends to clients."""

    def __init__(self):
        self.replies: dict = {}

    def send_to_replica(self, dst, msg) -> None:
        pass

    def send_to_client(self, client_id, msg) -> None:
        self.replies[(client_id, msg.header.request)] = msg.pack()


class _StillTime:
    """A clock that never moves: the twin commits prepares that carry
    their timestamps, and never ticks."""

    def monotonic(self) -> int:
        return 0

    def realtime(self) -> int:
        return 0


class ReplicaTwin:
    """The server's WAL read in op order with the port's Journal, its
    prepares committed with their own headers (timestamps among them)
    through a solo `Replica` on the oracle engine, on the CPU, over a
    `MemoryStorage` of the same layout. `commit_from(path, upto)` takes
    the ops up to `upto` (all of them when None) that it has not taken
    yet, so it can start on the prefix a killed server left while its
    successor writes later slots; the ops it took before must still be
    there, checksum for checksum. `result()`: every reply it sent by
    (client, request), each op's (client, request), and the trees of its
    last checkpoint beside those of the server's file."""

    def __init__(self, small: bool):
        from tigerbeetle_tpu_torch import StateMachine
        from tigerbeetle_tpu_torch.vsr.replica import Replica
        from tigerbeetle_tpu_torch.vsr.storage import (
            MemoryStorage, StorageLayout, TEST_LAYOUT)

        self.layout = TEST_LAYOUT if small else StorageLayout()
        self.mem = MemoryStorage(self.layout)
        Replica.format(self.mem, cluster=0, replica_id=0, replica_count=1)
        self.bus = _Capture()
        self.rep = Replica(cluster=0, replica_id=0, replica_count=1,
                           storage=self.mem, bus=self.bus,
                           time=_StillTime(),
                           state_machine_factory=lambda: StateMachine(
                               "oracle", device="cpu"))
        self.rep.open()
        self.ops: list = []
        self.checksums: list = []
        self.ms = 0.0
        self.card = None

    def commit_from(self, path: str, upto=None) -> int:
        from tigerbeetle_tpu_torch.vsr.journal import Journal
        from tigerbeetle_tpu_torch.vsr.storage import FileStorage

        t = time.perf_counter()
        card = FileStorage(path, self.layout)
        try:
            journal = Journal(card)
            slots = journal.recover()
            n_ops = journal.op_max() if upto is None else upto
            rep = self.rep
            for op in range(1, n_ops + 1):
                m = journal.read_prepare(op)
                assert m is not None, f"WAL op {op} is missing"
                if op <= len(self.checksums):
                    assert m.header.checksum == self.checksums[op - 1], \
                        f"WAL op {op} changed under the twin"
                    continue
                rep.journal.append(m)
                rep.op = rep.commit_max = op
                rep._commit_journal(op)
                assert rep.commit_min == op, f"the twin stopped at op {op}"
                self.checksums.append(m.header.checksum)
                self.ops.append((op, m.header.client, m.header.request,
                                 m.header.operation))
            if upto is None:
                self.card = dict(
                    faulty=sum(1 for s_ in slots
                               if s_.state.value != "clean"),
                    trees=checkpoint_trees(card))
        finally:
            card.close()
        self.ms += (time.perf_counter() - t) * 1e3
        return len(self.ops)

    def result(self) -> dict:
        twin_ckpt, twin_trees = checkpoint_trees(self.mem)
        card_ckpt, card_trees = self.card["trees"]
        return dict(replies=self.bus.replies, faulty=self.card["faulty"],
                    n_ops=len(self.ops), ops=self.ops,
                    card_ckpt=card_ckpt, card_trees=card_trees,
                    twin_ckpt=twin_ckpt, twin_trees=twin_trees, ms=self.ms)


def cluster_bodies(seed: int, n_ops: int, body: int) -> list:
    """The cluster's requests: one accounts body (body accounts, ids
    1..body), then n_ops - 1 config-2 transfer bodies over them."""
    from tigerbeetle_tpu_torch.types import Account, Operation

    tr = DurableTraffic(seed, body, body)
    out = [(Operation.create_accounts, accounts_body(
        [Account(id=i, ledger=1, code=1) for i in range(1, body + 1)]))]
    out += [(Operation.create_transfers, tr.plain())
            for _ in range(n_ops - 1)]
    return out


def run_cluster(factory, seed: int, n_ops: int, body: int,
                crash_at: int) -> dict:
    """A 3-replica in-process cluster (the port's `testing/cluster.py`,
    TEST_LAYOUT, simulated time and network) through `factory`'s state
    machines: the bodies one request at a time from one client, the
    primary crashed once op crash_at committed (a view change follows),
    restarted after the last op (it catches up), then settled: every
    replica's state and checkpoints equal (the cluster's own checkers)
    and its state digest. Returns the replies, the digests, each
    replica's commit windows and the view."""
    from tigerbeetle_tpu_torch import constants
    from tigerbeetle_tpu_torch.ops.state_epoch import (
        combine, oracle_state_digest)
    from tigerbeetle_tpu_torch.testing.cluster import Cluster

    verify = constants.VERIFY
    t = time.perf_counter()
    try:
        cluster = Cluster(seed=seed, replica_count=3,
                          state_machine_factory=factory)
        client = cluster.client(77)
        victim = None
        for i, (op, raw) in enumerate(cluster_bodies(seed, n_ops, body)):
            client.request(op, raw)
            ok = cluster.run(6000, until=lambda: client.idle)
            check(ok, f"cluster: op {i + 1} stuck: {cluster.debug_status()}")
            if i + 1 == crash_at:
                victim = cluster.replicas[0].primary_index()
                cluster.crash(victim)
        cluster.restart(victim)
        cluster.settle(6000)
        digests = [combine(oracle_state_digest(r.state_machine.state,
                                               RC_CAPS[0]))
                   for r in cluster.replicas]
        return dict(
            replies=[m.pack() for m in client.replies], digests=digests,
            windows=[r._windows_committed for r in cluster.replicas],
            view=cluster.replicas[0].view, victim=victim,
            commit=[r.commit_min for r in cluster.replicas],
            checkpoints=[r.superblock.op_checkpoint
                         for r in cluster.replicas],
            ms=(time.perf_counter() - t) * 1e3)
    finally:
        constants.set_verify(verify)


def _replica_twin_proc(conn) -> None:
    """The CPU side of the replica phase, in a process of its own:
    ("twin_begin", path, small, upto) -> a ReplicaTwin takes ops up to
    `upto` (their count); ("twin_more", path, upto) -> it takes the ops
    up to `upto` it has not taken (the count); ("twin_end", path) -> it
    takes the rest, its
    result(); ("cluster", seed, n_ops, body, crash_at) -> run_cluster on
    oracle-engine state machines. Each answer (True, result) or (False,
    the traceback)."""
    import traceback

    from tigerbeetle_tpu_torch import StateMachine

    torch.set_num_threads(2)
    twin = None
    while True:
        msg = conn.recv()
        if msg is None:
            return
        name, args = msg
        try:
            if name == "twin_begin":
                path, small, upto = args
                twin = ReplicaTwin(small)
                out = twin.commit_from(path, upto)
            elif name == "twin_more":
                out = twin.commit_from(*args)
            elif name == "twin_end":
                twin.commit_from(args[0])
                out = twin.result()
            else:
                out = run_cluster(
                    lambda: StateMachine("oracle", device="cpu"), *args)
            conn.send((True, out))
        except Exception:
            conn.send((False, traceback.format_exc()))


def commit_span_stats(spans) -> dict:
    """Window sizes and commit ms by size from commit_execute spans
    ((ms, window) pairs)."""
    by = {}
    for ms, w in spans:
        by.setdefault(int(w or 1), []).append(ms)
    return {str(w): dict(n=len(v), mean_ms=float(np.mean(v)),
                         max_ms=float(np.max(v)))
            for w, v in sorted(by.items())}


def trace_windows(path: str) -> dict:
    """Commit windows from a dumped Chrome trace's commit_execute spans:
    {window size: count}."""
    doc = json.loads(Path(path).read_text())
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    out = {}
    for e in events:
        if e.get("name") == "commit_execute" and e.get("ph") == "X":
            w = int((e.get("args") or {}).get("window", 1))
            out[str(w)] = out.get(str(w), 0) + 1
    return out


def replica_phase(dev, n_accounts: int = N_ACCOUNTS, body: int = SV_BODY,
                  n_clients: int = RP_CLIENTS, n_bodies: int = RP_BODIES,
                  kill_at: int = RP_KILL_AT, n_lookups: int = None,
                  rc_ops: int = RC_OPS, rc_body: int = RC_BODY,
                  rc_crash_at: int = RC_CRASH_AT) -> dict:
    """The replica server on `dev`, through the entry points a user
    calls: (a) `python -m tigerbeetle_tpu_torch format` a data file (the
    default `StorageLayout()`: a 1,024-slot WAL of 1 MiB messages, a
    512 MiB grid; on the CPU the small layout); (b) `main.main(["start",
    ...])` in a child process (`_server_main`), the device engine at the
    serving capacities (2^17 / 2^21; on the CPU `--platform cpu --small`:
    the small layout and capacities);
    it must run on `dev` with the native storage engine and its
    asynchronous engine live; (c) n_clients clients of the port's
    `vsr/client.py`, one request in flight each: 2 accounts bodies
    (n_accounts accounts), then n_bodies `body`-event config-2 transfer
    bodies each (u64 user data >= 2^63, 1 event in 16 a pending, half of
    them with a 1 s timeout); (d) the child SIGKILLed as soon as a client
    holds op kill_at's reply, a new child started on the file, the
    clients resending what they had in flight; (e) one lookup past every
    timeout and the server settled (it pulses while its pipeline is
    empty: at least one expiry pulse must commit), lookups of n_lookups
    account and transfer ids (the most whose worst-case reply fits a
    message), a get_account_transfers, then one client's last request
    again, whose reply must be the cached bytes with the server's op
    unmoved; (f)
    SIGTERM, then `inspect --digest` exits 0 with no corrupt superblock
    copy and 0 faulty WAL slots; (g) on the CPU in a process of its own,
    the WAL's prepares committed through an oracle-engine replica (from
    the kill on, the prefix the clients saw committed; once the clients
    are done, what they saw committed since; after (f), the rest): every
    reply the clients got equal to its, byte for byte, no
    (client, request) prepared twice, the last checkpoint's trees equal
    to the file's; (h) meanwhile a 3-replica cluster of device engines on `dev`
    (`run_cluster`), equal to an oracle-engine cluster on the CPU.
    Returns the numbers."""
    import multiprocessing
    import shutil

    from tigerbeetle_tpu_torch import StateMachine, multi_batch
    from tigerbeetle_tpu_torch.ops import fused_probe
    from tigerbeetle_tpu_torch.ops import row_gather as RG
    from tigerbeetle_tpu_torch.types import (
        AccountFilter, AccountFilterFlags, Operation as O)
    from tigerbeetle_tpu_torch.vsr.replica import _reply_fits
    from tigerbeetle_tpu_torch.vsr.storage import StorageLayout, TEST_LAYOUT

    cuda = torch.device(dev).type == "cuda"
    small = not cuda
    layout = TEST_LAYOUT if small else StorageLayout()
    if n_lookups is None:
        n_lookups = next(
            n for n in range(BATCH, 0, -1)
            if _reply_fits(O.lookup_transfers, len(multi_batch.encode(
                [b"\x00" * 16 * n], 16)), layout.message_size_max))
    phase_s = {}
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="tb_replica_")
    path = f"{tmp}/0_0.tigerbeetle"
    trace_path = f"{tmp}/trace.json"
    aof_path = f"{tmp}/0_0.aof"
    log_path = f"{tmp}/server.log"
    ctx = multiprocessing.get_context("spawn")
    servers, sampler, twin_proc = [], None, None
    twin_conn = None

    def log_tail() -> str:
        return (Path(log_path).read_text()[-6000:]
                if Path(log_path).exists() else "")

    def fail_log(msg):
        check(False, f"replica: {msg}\nserver log tail:\n{log_tail()}")

    try:
        # (a) format
        t = time.perf_counter()
        flags = ["--small"] if small else []
        out = _module_cli("format", "--cluster=0", "--replica=0",
                          "--replica-count=1", *flags, path)
        check(out.returncode == 0, f"replica: format failed:\n{out.stderr}")
        phase_s["format"] = time.perf_counter() - t
        # The CPU side's process starts now, to be up when it is needed.
        twin_conn, child = ctx.Pipe()
        twin_proc = ctx.Process(target=_replica_twin_proc, args=(child,),
                                daemon=True)
        twin_proc.start()
        child.close()

        # (b) start
        port = _free_port()
        argv = ["start", f"--addresses=127.0.0.1:{port}", "--replica=0",
                "--engine=device", f"--trace={trace_path}",
                f"--aof={aof_path}", "--metrics-port=0", *flags, path]
        if not cuda:
            argv.insert(1, "--platform=cpu")
        t = time.perf_counter()
        servers.append(ServerChild(ctx, argv, log_path))
        srv = servers[-1]
        wait_watching(srv.ready, srv, 900, "the server to open", fail_log)
        if srv.info("open") is None:
            fail_log("the server never opened")
        opened = srv.info("open")
        check(opened["native"] and opened["aio"],
              f"replica: the native storage engine was not live: {opened}")
        check(opened["engine"] == "device"
              and opened["device"].startswith("cuda" if cuda else "cpu"),
              f"replica: the server ran {opened['engine']} on "
              f"{opened['device']}")
        phase_s["start"] = time.perf_counter() - t

        # (c) clients
        tr = DurableTraffic(91, n_accounts, body)
        acct_items = [(O.create_accounts, raw) for raw, _ in tr.accounts()]
        bodies = [[(O.create_transfers, tr.plain()) for _ in range(n_bodies)]
                  for _ in range(n_clients)]
        # The accounts go first, from a client of their own (a client's
        # requests number from 1 in its session), then the n_clients.
        acct_id = 999
        acct_recs: list = []
        ids = [1000 + i for i in range(n_clients)]
        records = [[] for _ in range(n_clients)]
        kill_ev = threading.Event()
        sampler = UtilSampler(cuda)
        t = time.perf_counter()
        acct_done = threading.Event()
        acct = threading.Thread(target=lambda: (_client_run(
            port, acct_id, acct_items, acct_recs, None, None),
            acct_done.set()), daemon=True)
        acct.start()
        wait_watching(acct_done, srv, 2 * RP_TIMEOUT_S,
                      "the accounts bodies", fail_log)
        if any("error" in r for r in acct_recs):
            fail_log(f"the accounts bodies failed: {acct_recs}")
        t_transfers = time.perf_counter()
        threads = [threading.Thread(
            target=_client_run, daemon=True,
            args=(port, ids[i], bodies[i], records[i], kill_at, kill_ev))
            for i in range(n_clients)]
        for th in threads:
            th.start()
        wait_watching(kill_ev, srv, 1800, f"the reply of op {kill_at}",
                      fail_log)

        # (d) SIGKILL and restart
        t_kill = time.perf_counter()
        srv.stop("kill")
        first = srv
        # (g) begins: the CPU twin takes the ops the clients saw committed
        # before the kill while the next server writes later slots.
        upto = max(r["op"] for rs in records + [acct_recs] for r in rs
                   if "op" in r)
        twin_conn.send(("twin_begin", (path, small, upto)))
        phase_s["serve_to_kill"] = t_kill - t
        servers.append(ServerChild(ctx, argv, log_path))
        srv = servers[-1]
        wait_watching(srv.ready, srv, 900, "the restarted server to open",
                      fail_log)
        if srv.info("open") is None:
            fail_log("the restarted server never opened")
        t_ready = time.perf_counter()
        reopened = srv.info("open")
        all_done = threading.Event()
        threading.Thread(target=lambda: ([th.join() for th in threads],
                                         all_done.set()), daemon=True).start()
        wait_watching(all_done, srv, 1800, "the clients", fail_log)
        t_done = time.perf_counter()
        util = sampler.stop()
        sampler = None
        phase_s["restart_to_done"] = t_done - t_kill
        recs = acct_recs + [r for rs in records for r in rs]
        errors = [r for r in recs if "error" in r]
        if errors:
            fail_log(f"client errors: {errors}")
        check(all(r["reply_operation"] == r["operation"] for r in recs),
              "replica: a reply answers another operation")
        check(len(recs) == len(acct_items) + n_clients * n_bodies,
              f"replica: {len(recs)} replies")
        # The twin takes the ops the clients saw committed while the
        # reads, the SIGTERM and inspect run (its replay is the phase's
        # longest path).
        upto_done = max(r["op"] for r in recs)
        twin_conn.send(("twin_more", (path, upto_done)))

        # (e) reads and a duplicate. First a lookup, sent once every
        # pending's 1 s timeout has passed, moves the server's prepare
        # timestamp past them all (a primary pulses on the timestamp of
        # its last prepare); the expiry pulses it then prepares run out
        # before the reads, so that nothing but the duplicate reaches the
        # server after the last read.
        t = time.perf_counter()
        time.sleep(max(0.0, t_done + 1.5 - t))
        reads, settle = [], []
        rng = np.random.default_rng(5)
        xids = [int(x) for x in rng.choice(
            np.arange(10**9, tr.next_id), n_lookups, replace=False)]
        aids = [int(x) for x in rng.integers(1, n_accounts + 1, n_lookups)]
        both = int(AccountFilterFlags.debits | AccountFilterFlags.credits)
        read_items = [
            (O.lookup_accounts, multi_batch.encode(
                [b"".join(i.to_bytes(16, "little") for i in aids)], 16)),
            (O.lookup_transfers, multi_batch.encode(
                [b"".join(i.to_bytes(16, "little") for i in xids)], 16)),
            (O.get_account_transfers, multi_batch.encode([AccountFilter(
                account_id=SV_HISTORY_EVERY, limit=RP_GET_LIMIT,
                flags=both).pack()], 128))]
        from tigerbeetle_tpu_torch.vsr.client import Client

        c = Client(cluster=0, client_id=ids[0],
                   replica_addresses=[("127.0.0.1", port)])
        c.request_number = max(r["request"] for r in records[0])
        try:
            t0 = time.perf_counter()
            c.request(O.lookup_accounts, multi_batch.encode(
                [(1).to_bytes(16, "little")], 16), timeout_s=RP_TIMEOUT_S)
            settle.append(dict(client=ids[0], request=c._reply.header.request,
                               op=c._reply.header.op,
                               operation=int(O.lookup_accounts), sent=t0,
                               got=time.perf_counter(), raw=c._reply.pack()))
            wait_settled(srv, 2.0, RP_TIMEOUT_S, fail_log)
            phase_s["settle"] = time.perf_counter() - t0
            for op, raw in read_items:
                t0 = time.perf_counter()
                c.request(op, raw, timeout_s=RP_TIMEOUT_S)
                m = c._reply
                reads.append(dict(client=ids[0], request=m.header.request,
                                  op=m.header.op, operation=int(op),
                                  sent=t0, got=time.perf_counter(),
                                  raw=m.pack(), body_bytes=len(raw)))
            check(all(len(r["raw"]) > 256 for r in reads),
                  "replica: an empty read reply")
            last = reads[-1]
            c.request_number -= 1
            c.request(read_items[-1][0], read_items[-1][1],
                      timeout_s=RP_TIMEOUT_S)
            dup_same = c._reply.pack() == last["raw"]
        finally:
            c.close()
        check(dup_same, "replica: the duplicate's reply is not the cached "
              "one")
        phase_s["reads"] = time.perf_counter() - t
        # One scrape of the restarted server's /metrics: it counts every
        # op it committed, from its checkpoint (the WAL replay at open
        # included) to the last reply the clients got.
        scraped = scrape_metrics(Path(log_path).read_text())
        commits = sum(v for _, v in scraped.get("tb_tpu_commits_total", []))
        check(commits >= last["op"] - reopened["op_checkpoint"],
              f"replica: /metrics counts {commits} commits, the restarted "
              f"server committed ops {reopened['op_checkpoint'] + 1}.."
              f"{last['op']}")

        # (f) SIGTERM and inspect
        srv.stop("term")
        final = srv.info("exit")
        if final is None or final["rc"] != 0:
            fail_log(f"the server did not stop cleanly: {final}")
        check(final["op"] == last["op"] and final["commit_min"] == last["op"],
              f"replica: the duplicate moved the server to op "
              f"{final['op']} (last op {last['op']})")
        aof_ops = aof_against_wal(aof_path, path, layout)
        check(aof_ops == final["commit_min"],
              f"replica: the AOF holds {aof_ops} ops, the server "
              f"committed {final['commit_min']}")
        # (g) the CPU twin takes the rest of the stopped server's WAL,
        # beside (f) and (h).
        t_twin = time.perf_counter()
        twin_conn.send(("twin_end", (path,)))
        twin_conn.send(("cluster", (RC_SEED, rc_ops, rc_body, rc_crash_at)))
        t = time.perf_counter()
        ins = _module_cli("inspect", "--digest", *flags, path)
        lines = ins.stdout.splitlines()
        jline = [ln for ln in lines if ln.startswith("journal:")]
        check(ins.returncode == 0 and not any("CORRUPT" in ln for ln in lines)
              and jline and ", 0 faulty," in jline[0]
              and any(ln.startswith("digest: checkpoint_op=") for ln in lines),
              f"replica: inspect failed ({ins.returncode}):\n{ins.stdout}"
              f"{ins.stderr}")
        phase_s["inspect"] = time.perf_counter() - t

        # (h) the cluster on dev, while the CPU side runs
        t = time.perf_counter()
        fused_probe.LAUNCHES = RG.LAUNCHES = 0
        card_cluster = run_cluster(
            lambda: StateMachine("device", a_cap=RC_CAPS[0],
                                 t_cap=RC_CAPS[1], device=dev),
            RC_SEED, rc_ops, rc_body, rc_crash_at)
        cluster_launches = (fused_probe.LAUNCHES, RG.LAUNCHES)
        phase_s["cluster_card"] = time.perf_counter() - t
        answers = []
        for _ in range(4):
            ok, got = twin_conn.recv()
            check(ok, f"replica: the CPU side failed:\n{got}")
            answers.append(got)
        twin_prefix, twin_more, twin, cpu_cluster = answers
        check(twin_prefix == upto, f"replica: the twin took {twin_prefix} "
              f"ops before the restart, not {upto}")
        check(twin_more == upto_done, f"replica: the twin took {twin_more} "
              f"ops once the clients were done, not {upto_done}")
        phase_s["twin_wait"] = time.perf_counter() - t
        phase_s["twin_and_cluster_cpu"] = time.perf_counter() - t_twin
    finally:
        if sampler is not None:
            sampler.stop()
        for s in servers:
            if s.proc.is_alive():
                s.stop("kill")
        if twin_conn is not None:
            try:
                twin_conn.send(None)
            except (BrokenPipeError, OSError):
                pass
        if twin_proc is not None:
            twin_proc.join(60)
            if twin_proc.is_alive():
                twin_proc.kill()
                twin_proc.join()
        trace_file = Path(trace_path)
        trace_w = trace_windows(trace_path) if trace_file.exists() else {}
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- the twin's verdicts
    every = recs + settle + reads
    for r in every:
        want = twin["replies"].get((r["client"], r["request"]))
        check(want == r["raw"],
              f"replica: the reply to client {r['client']} request "
              f"{r['request']} (op {r['op']}) differs from the CPU "
              "oracle twin's")
    keys = [(c_, q) for _, c_, q, _ in twin["ops"] if c_]
    check(len(keys) == len(set(keys)),
          "replica: a request was prepared twice")
    check(twin["faulty"] == 0, "replica: the twin's WAL scan found faults")
    pulses = [op for op, _, _, o in twin["ops"] if o == int(O.pulse)]
    check(pulses, "replica: the server committed no expiry pulse")
    check(twin["card_ckpt"] == twin["twin_ckpt"]
          and twin["card_trees"] == twin["twin_trees"],
          f"replica: the trees at checkpoint {twin['card_ckpt']} differ "
          f"from the oracle twin's at {twin['twin_ckpt']}")
    # ---- the cluster's
    cc, oc = card_cluster, cpu_cluster
    check(len(set(cc["digests"])) == 1,
          f"replica cluster: digests differ between replicas: {cc}")
    check(cc["replies"] == oc["replies"] and cc["digests"] == oc["digests"],
          "replica cluster: the card's cluster differs from the CPU "
          "oracle cluster")
    check(not cuda or (cluster_launches[0] > 0 and cluster_launches[1] > 0),
          f"replica cluster: launches probe/gather {cluster_launches}")
    check(max(cc["windows"]) > 0 or not cuda,
          f"replica cluster: no replica formed a commit window: {cc}")

    # ---- the server's numbers
    def stream(server, kind):
        return [m for _, m in server.msgs if m[0] == kind]

    spans = {name: [] for name in SERVER_SPANS}
    for s in (first, srv):
        for _, name, ms, op, w in stream(s, "span"):
            spans[name].append((ms, w))
    # The killed child's counts: its last report.
    first_commits = stream(first, "commit")
    launches_first = first_commits[-1][2] if first_commits else (0, 0, 0)
    launches = tuple(a + b for a, b in zip(launches_first,
                                           final["launches"]))
    kinds_first = first_commits[-1][3] if first_commits else {}
    seq_by_kind = {k: v + kinds_first.get(k, 0)
                   for k, v in final["seq_by_kind"].items()}
    check(not cuda or (launches[0] > 0 and launches[1] > 0),
          f"replica: the server's launches probe/gather {launches}")
    check(launches[2] == 0, "replica: create_seq launched on the server")
    xfer = [r for r in recs if r["operation"] == int(O.create_transfers)]
    lat = np.array([r["got"] - r["sent"] for r in every]) * 1e3
    pre = [r for r in xfer if r["got"] <= t_kill]
    post = [r for r in xfer if r["got"] >= t_ready]
    steady = {}
    for label, rs, t_a in (("before_kill", pre, t_transfers),
                           ("after_restart", post, t_ready)):
        if rs:
            span_s = max(r["got"] for r in rs) - t_a
            steady[label] = dict(
                requests=len(rs), seconds=span_s,
                requests_per_s=len(rs) / span_s,
                transfers_per_s=len(rs) * body / span_s)
    xlat = np.array([r["got"] - r["sent"] for r in pre]) * 1e3
    ckpt = [ms for ms, _ in spans["commit_checkpoint"]]
    flushes = [m[1] for s in (first, srv) for m in stream(s, "flush")]
    beats = [m[1] for s in (first, srv) for m in stream(s, "beat")]
    numbers = dict(
        clients=n_clients, bodies=n_clients * n_bodies,
        events_per_body=body, transfers=n_clients * n_bodies * body,
        ops=final["op"], kill_at_op=kill_at, pulse_ops=pulses,
        latency_ms=dict(p50=float(np.percentile(lat, 50)),
                        p99=float(np.percentile(lat, 99)),
                        max=float(lat.max())),
        transfer_latency_before_kill_ms=(dict(
            p50=float(np.percentile(xlat, 50)),
            p99=float(np.percentile(xlat, 99)),
            max=float(xlat.max())) if len(xlat) else None),
        steady=steady,
        windows_server=commit_span_stats(spans["commit_execute"]),
        windows_trace_after_restart=trace_w,
        windows_cluster=cc["windows"],
        flush_ms=dict(mean=float(np.mean(flushes)), max=float(max(flushes)),
                      n=len(flushes)) if flushes else None,
        beat_ms=dict(mean=float(np.mean(beats)), max=float(max(beats)),
                     n=len(beats)) if beats else None,
        checkpoint_ms=ckpt,
        open_first=opened, open_restart=reopened,
        replayed_ops=reopened["replayed"],
        max_reserved=final["max_reserved"],
        utilization=util, launches=launches, seq_by_kind=seq_by_kind,
        launches_replica=cluster_launches,
        reads_ms={O(r["operation"]).name: (r["got"] - r["sent"]) * 1e3
                  for r in reads},
        n_lookups=n_lookups, twin_ms=twin["ms"], aof_ops=aof_ops,
        metrics_commits=commits,
        cluster=dict(ops=rc_ops, body=rc_body, crash_at=rc_crash_at,
                     view=cc["view"], windows=cc["windows"],
                     checkpoints=cc["checkpoints"], card_ms=cc["ms"],
                     cpu_ms=oc["ms"]),
        phase_seconds=phase_s, elapsed_s=time.perf_counter() - t_phase)
    print(f"replica: {numbers['ops']} ops, {len(every)} replies equal to the "
          f"CPU oracle twin's; SIGKILL after op {kill_at}, "
          f"{reopened['replayed']} ops replayed on open "
          f"({reopened['open_ms']:.1f} ms: forest "
          f"{reopened.get('durable_open_ms', 0):.1f}, rebuild "
          f"{reopened.get('rebuild_ms', 0):.1f}, replay "
          f"{reopened.get('replay_ms', 0):.1f}); latency p50/p99/max "
          f"{numbers['latency_ms']}; steady {steady}; windows server "
          f"{numbers['windows_server']} cluster {cc['windows']}; launches "
          f"server {launches} cluster {cluster_launches}; "
          f"{numbers['elapsed_s']:.1f} s; {card_line_or_cpu(dev)}",
          flush=True)
    return numbers


def scrape_metrics(server_log: str) -> dict:
    """One scrape of the endpoint the last server in `server_log`
    announced (`start --metrics-port`), parsed with the port's
    parse_prometheus (which raises on a malformed line)."""
    import re
    import urllib.request

    from tigerbeetle_tpu_torch.metrics import parse_prometheus

    urls = re.findall(r"metrics on (http://\S+/metrics)", server_log)
    check(bool(urls), "replica: the server announced no /metrics")
    with urllib.request.urlopen(urls[-1], timeout=60) as r:
        check(r.status == 200, f"replica: /metrics answered {r.status}")
        return parse_prometheus(r.read().decode())


def aof_against_wal(aof_path: str, data_path: str, layout) -> int:
    """The AOF's frames (`start --aof`) are ops 1, 2, ... in order, each
    the prepare the data file's WAL holds at its op (header checksum and
    body), every op the WAL's ring still holds (all of them at the
    default layout's 1,024 slots); returns the number of frames."""
    from tigerbeetle_tpu_torch.aof import AOF
    from tigerbeetle_tpu_torch.vsr.journal import Journal
    from tigerbeetle_tpu_torch.vsr.storage import FileStorage

    frames = list(AOF.iterate(aof_path))
    check([m.header.op for m in frames] == list(range(1, len(frames) + 1)),
          "replica: the AOF's ops are not 1.. in order")
    storage = FileStorage(data_path, layout)
    try:
        journal = Journal(storage)
        journal.recover()
        for m in frames:
            if m.header.op <= journal.op_max() - journal.slot_count:
                continue   # its slot holds a later op
            w = journal.read_prepare(m.header.op)
            check(w is not None and w.header.checksum == m.header.checksum
                  and w.body == m.body,
                  f"replica: AOF op {m.header.op} differs from the WAL's")
    finally:
        storage.close()
    return len(frames)


def benchmark_phase(dev, transfers: int = BM_TRANSFERS,
                    serving_batches: int = BM_SERVING_BATCHES) -> dict:
    """The port's load harness through its entry points on `dev`:
    `main.main(["benchmark", ...])` uniform and `--zipfian` (stdout
    parsed: every transfer accepted; the ledger's fallbacks 0, debits
    equal to credits; the route and window depths from
    benchmark.CONFIG_ROUTES), `parity_config5` (True) and
    `bench_config6_serving(batches=serving_batches)` (every transfer
    accepted, no fallback). Returns tx/s, ms a window and the wrappers'
    launches (counted; with the graph replays, ran)."""
    import contextlib
    import io

    from tigerbeetle_tpu_torch import benchmark as B, main as tb_main
    from tigerbeetle_tpu_torch.ops import fused_probe
    from tigerbeetle_tpu_torch.ops import row_gather as RG

    cuda = torch.device(dev).type == "cuda"
    t_phase = time.perf_counter()
    fused_probe.LAUNCHES = RG.LAUNCHES = 0
    ledgers = []
    make = B._make_ledger

    def tapped(*args, **kwargs):
        ledgers.append(make(*args, **kwargs))
        return ledgers[-1]

    B._make_ledger = tapped
    out, ran = {}, [0, 0]
    try:
        for label, key, extra in (("uniform", "config2", []),
                                  ("zipfian", "zipfian", ["--zipfian"])):
            buf = io.StringIO()
            argv = ["benchmark", "--transfer-count", str(transfers), *extra]
            if not cuda:
                argv += ["--platform", "cpu"]
            t = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = tb_main.main(argv)
            wall = time.perf_counter() - t
            check(rc == 0, f"benchmark {label}: rc {rc}")
            line = json.loads(buf.getvalue().strip().splitlines()[-1])
            led = ledgers[-1]
            check(line["transfers"] == transfers,
                  f"benchmark {label}: {line['transfers']} of {transfers} "
                  "transfers accepted")
            check(led.fallbacks == 0 and led.window_fallbacks == 0,
                  f"benchmark {label}: fallbacks {led.fallback_stats()}")
            double_entry(led)
            route = B.CONFIG_ROUTES[key]
            want_route = "chain" if cuda else "per_batch"
            check(route["route"] == want_route,
                  f"benchmark {label}: route {route}")
            windows = len(range(0, transfers // BATCH,
                                max(route["window_depths"])))
            counted, graph_ran = graph_launches(led.windows)
            ran = [ran[i] + graph_ran[i] for i in range(2)]
            out[label] = dict(
                **line, route=route["route"],
                window_depths=route["window_depths"],
                ms_per_window=(line["transfers"] * 1e3 / windows
                               / line["load_accepted_tx_per_s"]),
                wall_s=wall, graphs=dict(
                    eager=sum(led.windows.eager.values()),
                    captures=sum(led.windows.captures.values()),
                    replays=sum(led.windows.replays.values())))
            led.release()
            ledgers.clear()
            print(f"benchmark {label}: {out[label]}", flush=True)
    finally:
        B._make_ledger = make
    t = time.perf_counter()
    check(B.parity_config5(device=dev) is True,
          "benchmark: parity_config5 differs from the oracle")
    out["parity_config5_s"] = time.perf_counter() - t
    t = time.perf_counter()
    accepted, elapsed, latency = B.bench_config6_serving(
        batches=serving_batches, device=dev)
    check(accepted == serving_batches * (BATCH - 1),
          f"benchmark serving: {accepted} of "
          f"{serving_batches * (BATCH - 1)} transfers accepted")
    out["serving"] = dict(
        transfers=accepted, seconds=elapsed,
        load_accepted_tx_per_s=accepted / elapsed,
        route=B.CONFIG_DIAGNOSTICS["config6"]["routes"]["windows"],
        latency_ms={k: v for k, v in (latency or {}).items()
                    if k != "histogram"}, wall_s=time.perf_counter() - t)
    launches = (fused_probe.LAUNCHES, RG.LAUNCHES)
    check(not cuda or (launches[0] > 0 and launches[1] > 0),
          f"benchmark: launches probe/gather {launches}")
    out.update(launches=launches, launches_ran_windows=tuple(ran),
               elapsed_s=time.perf_counter() - t_phase,
               card=card_line_or_cpu(dev))
    print(f"benchmark: {out}", flush=True)
    return out


def _zero_launches() -> None:
    from tigerbeetle_tpu_torch.ops import create_seq, fused_probe
    from tigerbeetle_tpu_torch.ops import row_gather as RG

    fused_probe.LAUNCHES = RG.LAUNCHES = create_seq.LAUNCHES = 0
    create_seq.KIND_LAUNCHES.update(transfers=0, accounts=0)


def vopr_twins(dev, seed: int, engine: str) -> dict:
    """`run_swarm_seed(seed, engine, device=dev)` beside its CPU twin on
    the oracle engine, each with a recording auditor: the summaries
    (engine aside) and every audited (events, results) pair must be
    equal. Returns the summary, the seconds of each run and the
    wrappers' launches in the run on `dev`."""
    from tigerbeetle_tpu_torch.testing import vopr

    audited = {}
    auditor = vopr.Auditor

    def recording(key):
        class Recording(auditor):
            def check(self, events, results):
                audited[key].append(
                    ([e.pack() for e in events], [r.pack() for r in results]))
                super().check(events, results)
        audited[key] = []
        return Recording

    out = {}
    try:
        for key, eng, where in (("card", engine, dev),
                                ("twin", "oracle", "cpu")):
            vopr.Auditor = recording(key)
            if key == "card":
                _zero_launches()
            t = time.perf_counter()
            summary = vopr.run_swarm_seed(seed, engine=eng, device=where)
            out[f"{key}_s"] = time.perf_counter() - t
            if key == "card":
                launches, by_kind = _launch_counts(), _seq_by_kind()
            check(summary.pop("engine") == eng,
                  f"vopr seed {seed}: engine drawn, not {eng}")
            out[key] = summary
    finally:
        vopr.Auditor = auditor
    label = f"vopr seed {seed} ({engine})"
    check(out["card"] == out["twin"],
          f"{label}: {out['card']} against the CPU's {out['twin']}")
    check(audited["card"] == audited["twin"],
          f"{label}: the audited replies differ from the CPU twin's")
    return dict(seed=seed, engine=engine, audited=out["card"]["audited"],
                replica_count=out["card"]["replica_count"],
                steps=out["card"]["steps"], card_s=out["card_s"],
                twin_s=out["twin_s"], launches=launches,
                seq_by_kind=by_kind)


def drivers_phase(dev, bm: dict, device_seeds=DV_DEVICE_SEEDS,
                  kernel_seeds=DV_KERNEL_SEEDS, fuzz_runs=DV_FUZZ) -> dict:
    """The port's test drivers on `dev`: (a) VOPR seeds on the device and
    kernel engines against oracle twins on the CPU, (b) the fuzzers
    through `fuzz.run(..., device=dev)`, (c) `cfo --max-runs 8 --seed 7`
    through the module's command line (CFO_COUNTS, every run clean), (d)
    `devhub` recording `bm` (the benchmark phase's line) with (c)'s
    artifact. Returns each part's seconds, the seeds, the launches of
    (a) and (b) and cfo's counts."""
    from tigerbeetle_tpu_torch.testing import fuzz

    cuda = torch.device(dev).type == "cuda"
    platform = [] if cuda else ["--platform", "cpu"]
    t_phase = time.perf_counter()
    out, launches = {}, [0, 0, 0]
    seq_by_kind = {"transfers": 0, "accounts": 0}

    def add(run) -> None:
        for i in range(3):
            launches[i] += run["launches"][i]
        for k, v in run["seq_by_kind"].items():
            seq_by_kind[k] += v

    t = time.perf_counter()
    vopr = []
    for engine, seeds in (("device", device_seeds),
                          ("kernel", kernel_seeds)):
        for seed in seeds:
            run = vopr_twins(dev, seed, engine)
            probes, gathers, seqs = run["launches"]
            moved = (probes, gathers) if engine == "device" else (seqs,)
            check(not cuda or all(moved),
                  f"vopr seed {seed} ({engine}): launches probe/gather/"
                  f"create_seq {run['launches']}")
            add(run)
            vopr.append(run)
            print(f"drivers vopr: {run}", flush=True)
    out["vopr"] = vopr
    out["vopr_s"] = time.perf_counter() - t

    t = time.perf_counter()
    fuzzed = []
    for name, seed, iterations in fuzz_runs:
        _zero_launches()
        t_one = time.perf_counter()
        fuzz.run(name, seed, iterations, device=dev)
        run = dict(name=name, seed=seed, iterations=iterations,
                   seconds=time.perf_counter() - t_one,
                   launches=_launch_counts(), seq_by_kind=_seq_by_kind())
        add(run)
        fuzzed.append(run)
        print(f"drivers fuzz: {run}", flush=True)
    out["fuzz"] = fuzzed
    out["fuzz_s"] = time.perf_counter() - t

    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        cfo_dir = os.path.join(tmp, "cfo")
        os.mkdir(cfo_dir)
        artifact = os.path.join(cfo_dir, "CFO_chip.json")
        proc = _module_cli("cfo", "--max-runs", str(CFO_RUNS), "--seed",
                           str(CFO_SEED), "--artifact", artifact, *platform)
        check(proc.returncode == 0,
              f"cfo: rc {proc.returncode}: {proc.stdout[-2000:]}"
              f"{proc.stderr[-2000:]}")
        with open(artifact) as f:
            cfo = json.load(f)
        check(cfo["runs_clean"] == CFO_RUNS and cfo["runs_failing"] == 0,
              f"cfo: {cfo}")
        check(cfo["counts"] == CFO_COUNTS,
              f"cfo: counts {cfo['counts']}, the selection gives "
              f"{CFO_COUNTS}")
        out["cfo"] = dict(counts=cfo["counts"], elapsed_s=cfo["elapsed_s"],
                          wall_s=time.perf_counter() - t)

        t = time.perf_counter()
        record = os.path.join(tmp, "benchmark.json")
        with open(record, "w") as f:
            json.dump(bm, f)
        page = os.path.join(tmp, "devhub.html")
        proc = _module_cli("devhub", "--record", record, "--history",
                           os.path.join(tmp, "history.jsonl"), "--out",
                           page, "--cfo-dir", cfo_dir)
        check(proc.returncode == 0 and "devhub: 1 runs" in proc.stdout,
              f"devhub: rc {proc.returncode}: {proc.stdout[-2000:]}"
              f"{proc.stderr[-2000:]}")
        with open(page) as f:
            html = f.read()
        check("continuous fuzzing" in html and "CFO_chip.json" in html,
              "devhub: the page lacks the cfo artifact")
        out["devhub_s"] = time.perf_counter() - t

    check(not cuda or all(n > 0 for n in launches),
          f"drivers: launches probe/gather/create_seq {launches}")
    out.update(launches=tuple(launches), seq_by_kind=seq_by_kind,
               elapsed_s=time.perf_counter() - t_phase,
               card=card_line_or_cpu(dev))
    print(f"drivers: {out}", flush=True)
    return out


# ------------------------------------------------- the observatory phase

def _ob_window(sup, rng, tid: int, ts: int, shape) -> int:
    """One window of uniform transfers over accounts 1..8 (amount 1), one
    prepare of each size in `shape` (the JAX package's observatory smoke
    workload); returns the next id."""
    from tigerbeetle_tpu_torch.types import Transfer

    batches = []
    for n in shape:
        b = []
        for _ in range(n):
            dr, cr = (int(x) for x in rng.choice(np.arange(1, 9), 2,
                                                 replace=False))
            b.append(Transfer(id=tid, debit_account_id=dr,
                              credit_account_id=cr, amount=1, ledger=1,
                              code=1))
            tid += 1
        batches.append(b)
    sup.create_transfers_window(batches,
                                [ts + i * 10**6 for i in range(len(shape))])
    return tid


def _ob_supervisor(dev, caps, tracer=None, **kw):
    """A supervisor at `caps` on `dev` with accounts 1..8."""
    from tigerbeetle_tpu_torch import ServingSupervisor
    from tigerbeetle_tpu_torch.types import Account

    sup = ServingSupervisor(caps[0], caps[1], epoch_interval=4,
                            tracer=tracer, device=dev, **kw)
    sup.create_accounts([Account(id=i, ledger=1, code=1)
                         for i in range(1, 9)], 10**9)
    return sup


def observatory_profiler(dev, caps, n_accounts, body, w, chain_windows,
                         flat_windows, tmp) -> tuple:
    """(a) The dispatch profiler at sampling 1/1 on a full-width
    supervisor: windows of `w` config-2 prepares (the chain route; the
    last captured by torch.profiler into a Chrome trace) and windows of
    one prepare (the per-batch route), then the profile record: the
    static cost model at the sampled shape (`caps`, `w` prepares of
    `body`) on a scratch ledger on `dev` (its launches counted apart),
    the sampled series, the roofline fractions. The profiler is attached
    after a warm-up (the chain key's eager and captured windows, one
    per-batch window), so on the card every sampled chain window is a
    graph replay of the costed shape. Returns (summary, the run: its
    ledger is measured next)."""
    from tigerbeetle_tpu_torch.trace import (DispatchProfiler, Tracer,
                                             profile_probe)

    cuda = torch.device(dev).type == "cuda"
    tracer = Tracer()
    prof = DispatchProfiler(tracer=tracer, sample_every=1)
    run = SupervisedRun(dev, caps, n_accounts, body, seed=91,
                        flight_dir=os.path.join(tmp, "flight"),
                        tracer=tracer, epoch_interval=100)
    _zero_launches()
    kinds, ms = [], []
    for _ in range(2):
        before = graph_counts(run.sup.led)
        ms.append(run.commit(run.window(w)))
        kinds.append(window_kind(run.sup.led, before))
    ms.append(run.commit(run.window(1)))
    run.sup.profiler = prof
    for k in range(chain_windows):
        if k == chain_windows - 1:
            # Only around a replay: CUPTI under a graph capture can hang.
            check(not cuda or kinds[-1] in ("capture", "replay"),
                  f"observatory (a): window {k} would not replay: {kinds}")
            prof.capture_once(os.path.join(tmp, "capture"))
        before = graph_counts(run.sup.led)
        ms.append(run.commit(run.window(w)))
        kinds.append(window_kind(run.sup.led, before))
    check(not cuda or kinds[2:] == ["replay"] * chain_windows,
          f"observatory (a): a sampled chain window was no replay: {kinds}")
    for _ in range(flat_windows):
        ms.append(run.commit(run.window(1)))
    launches = _launch_counts()[:2]
    t = time.perf_counter()
    rec = profile_probe(tracer=tracer, profiler=prof, depth=w, device=dev,
                        caps=caps, batch=body)
    cost_s = time.perf_counter() - t
    measured = rec["dispatch_device_time"]
    routes = {m["route"] for m in measured.values() if m["count"]}
    check({"chain", "per_batch"} <= routes,
          f"observatory (a): dispatch_device_time lacks a route: {routes}")
    check(all(m["count"] and m["p50_us"] and m["p50_us"] > 0
              for m in measured.values()), f"observatory (a): {measured}")
    check(prof.samples == prof.dispatches == chain_windows + flat_windows,
          f"observatory (a): sampler {prof.stats()}")
    tiers = rec["cost_model"]["tiers"]
    fractions = {}
    for tier in ("flat", "chain"):
        row = tiers.get(tier) or {}
        check(row.get("flops") and row.get("hbm_bytes"),
              f"observatory (a): no FLOPs / bytes for {tier}: {row}")
        frac = (rec["roofline"].get(tier) or {}).get("fraction")
        check(frac is not None and 0.0 < frac < float("inf"),
              f"observatory (a): no finite roofline fraction for {tier}")
        fractions[tier] = frac
        # The scratch run's launches: one tier run (flat) or one a
        # prepare (chain at depth w), counted apart from the path's.
        runs = 1 if tier == "flat" else rec["cost_model"]["depth"]
        want = ({"ht_probe": PROBES_PER_RUN["plain"] * runs,
                 "row_gather": GATHERS_PER_RUN["plain"] * runs}
                if cuda else {"ht_probe": 0, "row_gather": 0})
        check(row["launches"] == want,
              f"observatory (a): cost model {tier} launches "
              f"{row['launches']}, expected {want}")
    cap = prof.capture_result or {}
    check(cap.get("ok") and os.path.getsize(cap["path"]) > 0,
          f"observatory (a): capture {cap}")
    with open(cap["path"]) as f:
        trace_events = len(json.load(f).get("traceEvents", []))
    p3 = type(prof)(sample_every=3)
    for _ in range(7):
        p3.time(lambda: 0, route="r", tier="t")
    check((p3.dispatches, p3.samples) == (7, 3), f"1-in-3: {p3.stats()}")
    series = {k: {"count": m["count"], "p50_us": m["p50_us"],
                  "p99_us": m["p99_us"]} for k, m in measured.items()}
    out = dict(window_kinds=kinds, window_ms=ms, launches=launches,
               series=series, fractions=fractions,
               roofline={t: {k: v for k, v in r.items() if k != "route"}
                         for t, r in rec["roofline"].items()},
               cost_model={t: {k: r.get(k) for k in (
                   "instructions", "flops", "hbm_bytes", "kernel_bytes",
                   "roofline_seconds", "launches")}
                   for t, r in tiers.items()},
               cost_model_s=cost_s, capture_trace_events=trace_events)
    print(f"observatory (a) profiler: fractions {fractions}, "
          f"p50/p99 us {series}", flush=True)
    return out, run


def _staged_worst_case(dev, a_cap: int, t_cap: int):
    """A bare ledger holding the worst-case staged pack: a window of
    STAGED_PACK_DEPTH prepares at the largest pad bucket, packed by the
    stager (no device work)."""
    from tigerbeetle_tpu_torch import DeviceLedger
    from tigerbeetle_tpu_torch.trace.memwatch import STAGED_PACK_DEPTH

    led = DeviceLedger(a_cap, t_cap, device=dev)
    led.overlap_staging = True
    n = 4097                                       # pads to 8,192
    evs = [soa(np.arange(1 + k * n, 1 + (k + 1) * n), np.ones(n),
               np.full(n, 2), np.ones(n), np.zeros(n))
           for k in range(STAGED_PACK_DEPTH)]
    check(led.stage_window(evs, [10**9 + k * 10**4
                                 for k in range(len(evs))]),
          "observatory (b): the worst-case window was not staged")
    led._staged[-1].result()
    return led


def observatory_memwatch(dev, run, caps) -> dict:
    """(b) Memory watermarks: a supervisor at the budget's caps audits
    green at every verified epoch, its state stores equal to the static
    ledger's; with the worst-case pack staged every measured component
    equals the static one and audits green, and the 16-fold-t_cap leak
    REDs on the grown stores and the total; the full-width run's ledger
    (`run`) equals its static ledger on every store; the allocator's
    stats with the window graphs' pools."""
    from tigerbeetle_tpu_torch.trace import Tracer
    from tigerbeetle_tpu_torch.trace.event import Event
    from tigerbeetle_tpu_torch.trace.memwatch import (
        MemWatch, check_budget, device_memory_stats, load_budget,
        measure_ledger, static_ledger)

    budget = load_budget()
    bc = (budget["caps"]["a_cap"], budget["caps"]["t_cap"])
    tracer = Tracer()
    mw = MemWatch(tracer=tracer)
    sup = _ob_supervisor(dev, bc, tracer, memwatch=mw)
    rng = np.random.default_rng(21)
    tid, ts = 1, 2 * 10**9
    for _ in range(4):
        tid = _ob_window(sup, rng, tid, ts, (32,))
        ts += 10**7
    check(sup.verify_epoch(), "observatory (b): the epoch did not verify")
    check(mw.observations >= 1 and mw.reds == []
          and mw.last["budget_ok"] is True, f"observatory (b): {mw.stats()}")
    check(Event.memory_watermark_bytes.name in tracer.emitted
          and Event.memory_budget_headroom_bytes.name in tracer.emitted,
          "observatory (b): the watermark gauges were not emitted")
    static = static_ledger(*bc)["components"]
    for name, pin in static.items():
        if name.startswith("state."):
            check(mw.last["components"][name] == pin,
                  f"observatory (b): {name} measured "
                  f"{mw.last['components'][name]}, static {pin}")
    sup.led.release()
    led = _staged_worst_case(dev, *bc)
    staged = measure_ledger(led)
    led.shutdown_staging()
    led.release()
    check(static.pop("telemetry_block") == 0
          and staged["components"] == static,
          f"observatory (b): measured {staged['components']} against "
          f"static {static}")
    check(check_budget(staged, budget) == [],
          "observatory (b): the worst case audits red")
    # The budget pins the partitioned attach mode's state too: t_cap
    # grows 16-fold before the total passes it.
    leaked = _staged_worst_case(dev, bc[0], 16 * bc[1])
    reds = check_budget(measure_ledger(leaked), budget)
    leaked.shutdown_staging()
    leaked.release()
    check(len(reds) == 3 and any("'state.transfers'" in r for r in reds)
          and any("'state.events'" in r for r in reds)
          and any("total watermark" in r for r in reds),
          f"observatory (b): the leak audited {reds}")
    full = measure_ledger(run.sup.led)["components"]
    want = static_ledger(*caps)["components"]
    check(all(full[k] == v for k, v in want.items() if k.startswith("state.")),
          f"observatory (b): full caps measured {full}, static {want}")
    stats = device_memory_stats(run.sup.led)
    out = dict(observations=mw.observations,
               headroom_bytes=mw.last["headroom_bytes"],
               worst_case_bytes=staged["total_bytes"],
               budget_bytes=budget["total_bytes"], leak_reds=len(reds),
               full_caps_bytes=sum(v for k, v in full.items()
                                   if k.startswith("state.")),
               device_memory_stats=stats)
    print(f"observatory (b) memwatch: {out}", flush=True)
    return out


def observatory_alerts(tmp) -> dict:
    """(c) The alert engine: a seeded latency burn fires the page rule
    (typed alert, runbook anchor, alert:<rule> tail retention, a flight
    artifact); the same burn with the rule disabled stays silent; a
    healthy stretch resolves it after its hysteresis; a rule naming an
    undeclared objective is a load-time ValueError."""
    from tigerbeetle_tpu_torch.trace import (AlertEngine, FlightRecorder,
                                             Tracer, load_alert_rules,
                                             mint_context)
    from tigerbeetle_tpu_torch.trace.event import Event
    from tigerbeetle_tpu_torch.trace.slo import DEFAULT_SLO_PATH

    loaded = load_alert_rules()
    rules = {r.name: r for r in loaded["rules"]}
    check(rules["window_latency_burn"].severity == "page",
          "observatory (c): window_latency_burn is not a page")

    def burn(eng, tracer, n_ticks, dur_ms):
        for i in range(n_ticks):
            tracer.record_span(Event.window_commit, tracer.now_ns(),
                               int(dur_ms * 1e6), ctx=mint_context(7, i),
                               route="chain", tier="scan")
            eng.tick()

    tracer = Tracer()
    flight = FlightRecorder(pid=0, tracer=tracer,
                            dump_dir=os.path.join(tmp, "alerts"))
    eng = AlertEngine(tracer=tracer, flight=flight, tick_every=1)
    burn(eng, tracer, 8, 600.0)
    alert = eng.active.get("window_latency_burn")
    check(alert is not None and alert.severity == "page"
          and "monitoring.md#alert-window-latency-burn" in alert.runbook
          and alert.value and alert.value > 400.0
          and alert.fast_burn_rate >= 0.5 and alert.trace_ids
          and flight.dumps == 1 and alert.flight_path
          and os.path.exists(alert.flight_path),
          f"observatory (c): the burn did not page: {eng.stats()}")
    check(any(r == "alert:window_latency_burn"
              for r in tracer.kept_traces.values()),
          "observatory (c): the exemplar trace was not kept")
    check("dispatch_latency_burn" not in eng.active,
          "observatory (c): an unfed rule fired")
    burn(eng, tracer, rules["window_latency_burn"].hysteresis, 1.0)
    check("window_latency_burn" not in eng.active
          and eng.fired[0].resolved_tick is not None,
          f"observatory (c): not resolved: {eng.stats()}")
    tracer2 = Tracer()
    flight2 = FlightRecorder(pid=0, tracer=tracer2,
                             dump_dir=os.path.join(tmp, "alerts2"))
    eng2 = AlertEngine([r for r in loaded["rules"]
                        if r.name != "window_latency_burn"],
                       loaded["objectives"], tracer=tracer2, flight=flight2,
                       tick_every=1)
    burn(eng2, tracer2, 8, 600.0)
    check(not eng2.active and flight2.dumps == 0,
          f"observatory (c): the disabled arm fired: {eng2.stats()}")
    with open(DEFAULT_SLO_PATH) as f:
        cfg = json.load(f)
    cfg["alerts"] = [dict(cfg["alerts"][0], objective="no_such_objective")]
    dead = os.path.join(tmp, "slo_dead.json")
    with open(dead, "w") as f:
        json.dump(cfg, f)
    try:
        load_alert_rules(dead)
        check(False, "observatory (c): a dead rule loaded")
    except ValueError as e:
        check("no_such_objective" in str(e), f"observatory (c): {e}")
    out = dict(fired=len(eng.fired), fired_tick=eng.fired[0].fired_tick,
               resolved_tick=eng.fired[0].resolved_tick,
               trace_ids=len(eng.fired[0].trace_ids))
    print(f"observatory (c) alerts: {out}", flush=True)
    return out


def _timed_observatory(tracer, spent: list) -> dict:
    """The whole observatory at its production decimations (the profiler
    at 1-in-8, the memwatch, the alert engine at tick_every 4), each hook
    timed where the supervisor calls it: spent[0] gathers the wall time
    of the observatory's own work, the profiler's wait for the device on
    a sampled dispatch included and the dispatch it wraps excluded."""
    from tigerbeetle_tpu_torch.trace import (AlertEngine, DispatchProfiler,
                                             MemWatch)

    hooks = dict(profiler=DispatchProfiler(tracer=tracer, sample_every=8),
                 memwatch=MemWatch(tracer=tracer),
                 alert_engine=AlertEngine(tracer=tracer, tick_every=4))

    def timed(fn, wraps_thunk: bool):
        def call(*args, **kw):
            inner = [0.0]
            if wraps_thunk:
                thunk = args[0]

                def timed_thunk():
                    t1 = time.perf_counter()
                    try:
                        return thunk()
                    finally:
                        inner[0] += time.perf_counter() - t1
                args = (timed_thunk,) + args[1:]
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent[0] += time.perf_counter() - t - inner[0]
        return call

    hooks["profiler"].time = timed(hooks["profiler"].time, True)
    hooks["memwatch"].observe = timed(hooks["memwatch"].observe, False)
    hooks["alert_engine"].tick = timed(hooks["alert_engine"].tick, False)
    return hooks


def observatory_overhead(dev, pairs: int = OB_OVERHEAD_PAIRS) -> dict:
    """(d) The whole observatory on against off, on supervisors at the
    budget's caps. A pair: two fresh supervisors, each warmed without the
    observatory (its window key's eager and captured windows and an
    epoch: a one-off of each supervisor, with the most jitter), the
    observatory then attached to one; then both take OB_WINDOWS windows
    of OB_SHAPE prepares and a verified epoch, in turns call by call (the
    order flipped every call), each call timed on the host clock, the
    epoch to a synced device. The host's speed drifts between runs on
    the card's machine (a run's time moves ~18%), and the turns give both
    arms the same stretch of it. One warm pair first.

    Held to the budget's profiler.overhead_ratio_max: on the card, the
    median over the pairs of the on arm's time over the off arm's (the
    JAX package's criterion, on many pairs); everywhere, the
    observatory's own time (its hooks timed where the supervisor calls
    them, `_timed_observatory`): the on arm's time over the same less
    that, summed over the pairs."""
    from tigerbeetle_tpu_torch.trace import Tracer, load_budget

    cuda = torch.device(dev).type == "cuda"
    budget = load_budget()
    ratio_max = budget["profiler"]["overhead_ratio_max"]
    bc = (budget["caps"]["a_cap"], budget["caps"]["t_cap"])

    class Arm:
        def __init__(self, on: bool):
            self.tracer = Tracer()
            self.spent = [0.0]
            self.sup = _ob_supervisor(dev, bc, self.tracer)
            self.rng = np.random.default_rng(22)
            self.tid, self.ts = 1, 2 * 10**9
            for _ in range(2):
                self.window()
            check(self.sup.verify_epoch(),
                  "observatory (d): the warm epoch failed")
            self.hooks = {}
            if on:
                self.hooks = _timed_observatory(self.tracer, self.spent)
                self.sup.profiler = self.hooks["profiler"]
                self.sup.memwatch = self.hooks["memwatch"]
                self.sup.alert_engine = self.hooks["alert_engine"]
                self.sup.alert_engine.bind(self.sup.tracer, self.sup.flight)

        def window(self) -> None:
            self.tid = _ob_window(self.sup, self.rng, self.tid, self.ts,
                                  OB_SHAPE)
            self.ts += 10**7

        def epoch(self) -> None:
            check(self.sup.verify_epoch(), "observatory (d): the epoch failed")
            sync(dev)

    def pair() -> tuple:
        arms = {True: Arm(True), False: Arm(False)}
        dt = {True: 0.0, False: 0.0}
        # No collector pause inside the clock, in either arm.
        gc.collect()
        gc.disable()
        try:
            sync(dev)
            for k in range(OB_WINDOWS + 1):
                for on in ((True, False) if k % 2 else (False, True)):
                    arm = arms[on]
                    t0 = time.perf_counter()
                    if k < OB_WINDOWS:
                        arm.window()
                    else:
                        arm.epoch()
                    dt[on] += time.perf_counter() - t0
        finally:
            gc.enable()
        hooks = arms[True].hooks
        check(hooks["profiler"].samples >= 1
              and hooks["memwatch"].observations >= 1
              and hooks["alert_engine"].ticks >= 1,
              "observatory (d): a hook was not driven")
        for arm in arms.values():
            # Its memory goes back to the caching allocator, not the
            # driver: the next pair's allocations do not wait on cudaMalloc.
            arm.sup.led.shutdown_staging()
        return dt[True], dt[False], arms[True].spent[0]

    pair()
    runs = [pair() for _ in range(pairs)]
    paired = sorted(on / off for on, off, _ in runs)
    ab = float(np.median(paired))
    on_s = sum(on for on, _, _ in runs)
    own = on_s / (on_s - sum(spent for _, _, spent in runs))
    check(not cuda or ab <= ratio_max,
          f"observatory (d): with the observatory on a run takes {ab:.4f}x "
          f"as long (median of {pairs} pairs), above {ratio_max}")
    check(own <= ratio_max,
          f"observatory (d): the observatory's own time makes a run "
          f"{own:.4f}x as long, above {ratio_max}")
    out = dict(ratio=ab, own_ratio=own, ratio_max=ratio_max, pairs=pairs,
               paired_quartiles=[float(q) for q in np.quantile(
                   paired, (0.25, 0.5, 0.75))],
               observatory_ms_median=float(np.median(
                   [spent for _, _, spent in runs])) * 1e3,
               on_ms_median=float(np.median([r[0] for r in runs])) * 1e3,
               off_ms_median=float(np.median([r[1] for r in runs])) * 1e3)
    print(f"observatory (d) overhead: {out}", flush=True)
    return out


def observatory_phase(dev, caps: tuple = (A_CAP, T_CAP),
                      n_accounts: int = N_ACCOUNTS, body: int = BATCH,
                      w: int = OB_W, chain_windows: int = OB_CHAIN_WINDOWS,
                      flat_windows: int = OB_FLAT_WINDOWS,
                      pairs: int = OB_OVERHEAD_PAIRS) -> dict:
    """The performance observatory on `dev`, its four legs (the JAX
    package's testing/observatory_smoke.py), each with its negative arm:
    (a) the profiler at full width, (b) the memory watermarks, (c) the
    alert engine, (d) the overhead of the whole observatory."""
    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        out["profiler"], run = observatory_profiler(
            dev, caps, n_accounts, body, w, chain_windows, flat_windows, tmp)
        out["profiler_s"] = time.perf_counter() - t
        t = time.perf_counter()
        out["memwatch"] = observatory_memwatch(dev, run, caps)
        run.sup.led.release()
        out["memwatch_s"] = time.perf_counter() - t
        out["alerts"] = observatory_alerts(tmp)
    t = time.perf_counter()
    out["overhead"] = observatory_overhead(dev, pairs)
    out["overhead_s"] = time.perf_counter() - t
    out["launches"] = out["profiler"]["launches"]
    out["elapsed_s"] = time.perf_counter() - t_phase
    out["card"] = card_line_or_cpu(dev)
    print(f"observatory: {out['elapsed_s']:.1f} s", flush=True)
    return out


# ------------------------------------------------------ the sharded phase

def _clone_state(state: dict, device) -> dict:
    return {k: (_clone_state(v, device) if isinstance(v, dict)
                else v.to(device, copy=True)) for k, v in state.items()}


def sharded_steps(rng, n_accounts: int, batch: int, c2_batches: int):
    """The phase's batches, (label, SoA events, prepare timestamp) in
    commit order: config 2 over accounts C4_ACCOUNTS + 1.., a config-4
    pend / post-void pair, a balancing pend batch (config 4's, 1 event in
    BAL_EVERY balancing) and an imported batch (user timestamps between
    the last prepare's and its own)."""
    from tigerbeetle_tpu_torch.types import TransferFlags as TF

    out, ts = [], 10**9
    for b in range(c2_batches):
        ev = uniform_batch(rng, 10**7 + b * batch, batch, n_accounts)
        ev["dr_lo"] += np.uint64(C4_ACCOUNTS)
        ev["cr_lo"] += np.uint64(C4_ACCOUNTS)
        ts += batch + 10
        out.append(("config2", ev, ts))
    pend, rev, nxt = config4_pair(rng, 2 * 10**7, TF, batch)
    for label, ev in (("config4_pend", pend), ("config4_post_void", rev)):
        ts += batch + 10
        out.append((label, ev, ts))
    bal, _, nxt = balancing_pair(rng, nxt, TF, batch)
    ts += batch + 10
    out.append(("balancing", bal, ts))
    imp = uniform_batch(rng, nxt, batch, n_accounts)
    imp["dr_lo"] += np.uint64(C4_ACCOUNTS)
    imp["cr_lo"] += np.uint64(C4_ACCOUNTS)
    imp["flags"][:] = int(TF.imported)
    imp["ts"] = np.arange(ts + 1, ts + 1 + batch, dtype=np.uint64)
    ts += batch + 1000
    out.append(("imported", imp, ts))
    return out


def sharded_phase(dev, caps: tuple = (A_CAP, T_CAP),
                  n_accounts: int = N_ACCOUNTS, batch: int = BATCH,
                  meshes: tuple = SH_MESHES, c2_batches: int = SH_C2_BATCHES,
                  loss_seeds: tuple = SH_LOSS_SEEDS) -> dict:
    """The replicated-state mesh route on `dev`: ShardedRouter on a mesh
    of each size in `meshes` (logical shards on the one card), fed
    full-width batches of every mode (`sharded_steps`) from one ledger
    state (config 4's accounts and n_accounts plain ones), each step's
    results and state digest equal to the single-chip
    create_transfers_fast on `dev` and on a CPU twin (both through a
    router whose only device is lost: its single-chip step), and the
    kernels launched as `sharded_launches` predicts; then
    shard_loss_scenario on the card's default mesh for `loss_seeds`,
    exactly 2 reroutes each."""
    from tigerbeetle_tpu_torch import DeviceLedger
    from tigerbeetle_tpu_torch.ops.ledger import _pad_bucket, pad_transfer_events
    from tigerbeetle_tpu_torch.ops.state_epoch import device_state_digest
    from tigerbeetle_tpu_torch.parallel.full_sharded import (ShardedRouter,
                                                             shard_batch)
    from tigerbeetle_tpu_torch.parallel.shard_utils import Mesh, replicate
    from tigerbeetle_tpu_torch.testing.chaos import shard_loss_scenario
    from tigerbeetle_tpu_torch.types import Account, AccountFlags

    cuda = torch.device(dev).type == "cuda"
    t_phase = time.perf_counter()
    accounts = (config4_accounts(Account, AccountFlags)
                + [Account(id=C4_ACCOUNTS + i, ledger=1, code=1)
                   for i in range(1, n_accounts + 1)])
    led = DeviceLedger(caps[0], caps[1], device=dev)
    ts = 10**6
    for lo in range(0, len(accounts), BATCH):
        chunk = accounts[lo:lo + BATCH]
        ts += len(chunk) + 10
        led.create_accounts(chunk, ts)
    base, led.state = led.state, None
    routers = {}
    for s in meshes:
        mesh = Mesh([dev] * s)
        routers[f"sharded_{s}"] = [ShardedRouter(mesh),
                                   replicate(mesh, _clone_state(base, dev))]
    for key, where in (("single", dev), ("cpu_twin", "cpu")):
        mesh = Mesh([where])
        router = ShardedRouter(mesh)
        router.drop_device(mesh.devices[0])
        routers[key] = [router, (_clone_state(base, where),)]
    del base
    digest0 = {k: device_state_digest(r[1][0]) for k, r in routers.items()}
    check(len({json.dumps(d, sort_keys=True) for d in digest0.values()})
          == 1, "sharded: the starting states differ")

    launches, predicted, steps = [0, 0], [0, 0], []
    modes_run = set()
    t_steps = {k: 0.0 for k in routers}
    for label, ev, ts in sharded_steps(np.random.default_rng(73),
                                       n_accounts, batch, c2_batches):
        n = len(ev["id_lo"])
        evp = pad_transfer_events(ev, _pad_bucket(n))
        results = {}
        for key, entry in routers.items():
            router, state = entry
            esc = router.escalations
            shards = shard_batch(router.mesh, evp)
            _zero_launches()
            sync(dev)
            t = time.perf_counter()
            state, out, fell = router.step(state, shards, ts, n)
            sync(dev)
            t_steps[key] += time.perf_counter() - t
            entry[1] = state
            ran = [router.route(evp)] + (["fixpoint"]
                                         if router.escalations > esc else [])
            if key.startswith("sharded"):
                got = _launch_counts()[:2]
                want = [0, 0]
                for mode in ran:
                    p, g = sharded_launches(mode, router.mesh.size)
                    want[0] += p
                    want[1] += g
                modes_run.update(ran)
                check(not cuda or tuple(got) == tuple(want),
                      f"sharded {key} {label}: launches {got}, the route "
                      f"{ran} predicts {want}")
                for i in range(2):
                    launches[i] += got[i]
                    predicted[i] += want[i]
            results[key] = (out["r_status"][:n].cpu(), out["r_ts"][:n].cpu(),
                            fell, device_state_digest(state[0]), ran)
        want = results["cpu_twin"]
        for key, got in results.items():
            check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                  and got[2] == want[2] and got[3] == want[3]
                  and got[4] == want[4],
                  f"sharded {label}: {key} differs from the CPU twin "
                  f"(fell back {got[2]} / {want[2]}, route {got[4]} / "
                  f"{want[4]})")
        steps.append(dict(label=label, route=want[4], fell_back=want[2],
                          created=int((want[0] == 0xFFFFFFFF).sum())))
        print(f"sharded {label}: {steps[-1]}", flush=True)
    check(modes_run == {"plain", "fixpoint", "balancing", "imported"},
          f"sharded: the modes run were {sorted(modes_run)}")
    stats = {k: r[0].stats() for k, r in routers.items()}
    routers.clear()
    if cuda:
        torch.cuda.empty_cache()

    loss = {}
    t = time.perf_counter()
    for seed in loss_seeds:
        _zero_launches()
        got = shard_loss_scenario(seed, device=dev)
        check(got["reroutes"] == 2, f"sharded: shard_loss seed {seed}: {got}")
        loss[seed] = dict(got, launches=_launch_counts()[:2])
    loss_s = time.perf_counter() - t
    print(f"sharded shard_loss: {loss}", flush=True)
    out = dict(steps=steps, stats=stats, launches=tuple(launches),
               predicted=tuple(predicted),
               escalations={k: s["escalations"] for k, s in stats.items()},
               host_fallbacks={k: s["host_fallbacks"]
                               for k, s in stats.items()},
               step_s=t_steps, shard_loss=loss, shard_loss_s=loss_s,
               elapsed_s=time.perf_counter() - t_phase,
               card=card_line_or_cpu(dev))
    print(f"sharded: escalations {out['escalations']}, host fallbacks "
          f"{out['host_fallbacks']}, launches {out['launches']}", flush=True)
    return out

class _WrapperCalls:
    """The kernel wrappers' calls through their cost hooks (`COST`), on
    the CPU, where LAUNCHES stays put: the calls where the path would
    launch the kernels, one a wrapper call."""

    def __init__(self):
        self.n = {"ht_probe": 0, "row_gather": 0}

    def kernel(self, name, fn, bound_bytes, *args):
        self.n[name] += 1
        return fn(*args)

    def __enter__(self):
        from tigerbeetle_tpu_torch.ops import fused_probe
        from tigerbeetle_tpu_torch.ops import row_gather as RG

        fused_probe.COST = RG.COST = self
        return self

    def __exit__(self, *exc):
        from tigerbeetle_tpu_torch.ops import fused_probe
        from tigerbeetle_tpu_torch.ops import row_gather as RG

        fused_probe.COST = RG.COST = None


class _CountedRouter:
    """Adds `partitioned_launches` to `pred` for each call of a router's
    steps that runs the kernels: a per-batch step of its mode, a chain
    call of W plain prepares (an eager window or a capture; a replay calls
    nothing)."""

    def __init__(self, router, shards: int):
        self.pred = [0, 0]
        self.steps = {}
        step, chain = router._step, router._chain_step

        def add(mode, times=1):
            p, g = partitioned_launches(mode, shards)
            self.pred[0] += p * times
            self.pred[1] += g * times

        def step_of(mode):
            fn = step(mode)

            def counted(*args, **kw):
                add(mode)
                self.steps[mode] = self.steps.get(mode, 0) + 1
                return fn(*args, **kw)
            return counted

        def chain_of(mode):
            fn = chain(mode)

            def lanes(state, lanes_t, force_fallback=None):
                add(mode, lanes_t.shape[1])
                return fn.lanes(state, lanes_t, force_fallback)
            return type("Chain", (), {"lanes": staticmethod(lanes)})

        router._step = step_of
        router._chain_step = chain_of


def _owned_counts(evs, shards: int) -> np.ndarray:
    """[shards, W]: each prepare's events a shard by the host ownership
    hash (shard_utils.shard_of_int over every id)."""
    from tigerbeetle_tpu_torch.parallel.shard_utils import shard_of_int

    out = np.zeros((shards, len(evs)), dtype=np.int64)
    for b, ev in enumerate(evs):
        ids = ((ev["id_hi"].astype(object) << 64) | ev["id_lo"].astype(object))
        for i in ids:
            out[shard_of_int(int(i), shards), b] += 1
    return out


def partitioned_phase(dev, caps: tuple = (A_CAP, T_CAP),
                      n_accounts: int = N_ACCOUNTS, batch: int = BATCH,
                      shards: int = PT_SHARDS, w: int = PT_W,
                      windows: int = PT_WINDOWS,
                      poison_at: int = PT_POISON_AT,
                      resync_seeds: tuple = PT_RESYNC_SEEDS) -> dict:
    """The partitioned-state mesh route on `dev`: a PartitionedRouter on a
    mesh of `shards` logical shards of the device at `caps`, seeded from
    an oracle holding config 4's accounts and n_accounts plain ones, with
    a DeviceLedger attached (`attach_partitioned`), and the port's oracle
    fed every prepare on the host. (a) `windows` config-2 chain windows
    of w x batch through submit_window / resolve_windows (eager, capture,
    replays); (b) a window poisoned at prepare `poison_at` by a config-4
    limit cascade, a clean window in flight behind it; (c) an imported, a
    balancing and a plain prepare through the synchronous path, each
    pre-routed per batch; after each leg (each window of (a)) the results
    equal the oracle's and `partitioned_state_digest` its
    `partitioned_oracle_digest`, with no host fallback. (d) the first
    window's telemetry block against a host count; (e)
    shard_resync_scenario on the device's default mesh for
    `resync_seeds`; (f) the resident bytes against the replicated route
    and memwatch's static ledger; (g) the wrappers' counts (on the CPU,
    their calls) against `partitioned_launches`."""
    from tigerbeetle_tpu_torch import DeviceLedger
    from tigerbeetle_tpu_torch.ops.batch import transfers_from_arrays
    from tigerbeetle_tpu_torch.ops.ledger import _pad_bucket, results_to_arrays
    from tigerbeetle_tpu_torch.ops.state_epoch import (
        partitioned_oracle_digest, partitioned_state_digest)
    from tigerbeetle_tpu_torch.oracle import StateMachineOracle
    from tigerbeetle_tpu_torch.parallel.partitioned import (
        PartitionedRouter, TEL_CAUSES, decode_telemetry,
        partitioned_state_bytes, replicated_state_bytes,
        static_partitioned_bytes)
    from tigerbeetle_tpu_torch.parallel.shard_utils import (Mesh,
                                                            shard_of_int)
    from tigerbeetle_tpu_torch.testing.chaos import shard_resync_scenario
    from tigerbeetle_tpu_torch.trace import FlightRecorder
    from tigerbeetle_tpu_torch.trace.memwatch import (measure_ledger,
                                                      static_ledger)
    from tigerbeetle_tpu_torch.types import (Account, AccountFlags,
                                             CreateTransferStatus)
    from tigerbeetle_tpu_torch.types import TransferFlags as TF

    cuda = torch.device(dev).type == "cuda"
    created = int(CreateTransferStatus.created)
    t_phase = time.perf_counter()
    legs, marks = {}, [t_phase]

    def lap(name):
        marks.append(time.perf_counter())
        legs[name] = marks[-1] - marks[-2]

    tmp = tempfile.mkdtemp(prefix="tb_partitioned_")
    calls = _WrapperCalls()
    try:
        sm = StateMachineOracle()
        accounts = (config4_accounts(Account, AccountFlags)
                    + [Account(id=C4_ACCOUNTS + i, ledger=1, code=1)
                       for i in range(1, n_accounts + 1)])
        clock = [10**6]
        for lo in range(0, len(accounts), BATCH):
            chunk = accounts[lo:lo + BATCH]
            clock[0] += len(chunk) + 10
            sm.create_accounts(chunk, clock[0])
        mesh = Mesh([dev] * shards)
        router = PartitionedRouter(
            mesh, a_cap=caps[0], t_cap=caps[1],
            flight_recorder=FlightRecorder(
                dump_dir=os.path.join(tmp, "flight")))
        counted = _CountedRouter(router, shards)
        led = DeviceLedger(caps[0], caps[1], device=dev)
        led.attach_partitioned(router, router.from_oracle(sm))
        lap("setup")
        rng = np.random.default_rng(83)
        nxt = [3 * 10**7]
        clock[0] = 10**9

        def stamp():
            clock[0] += batch + 10
            return clock[0]

        def c2():
            ev = uniform_batch(rng, nxt[0], batch, n_accounts)
            nxt[0] += batch
            ev["dr_lo"] += np.uint64(C4_ACCOUNTS)
            ev["cr_lo"] += np.uint64(C4_ACCOUNTS)
            return ev

        def oracle_check(label, evs, tss, got):
            check(len(got) == len(evs),
                  f"partitioned {label}: {len(got)} prepares answered, "
                  f"{len(evs)} sent")
            for b, (ev, t, (gs, gt)) in enumerate(zip(evs, tss, got)):
                ws, wt = results_to_arrays(sm.create_transfers(
                    transfers_from_arrays(ev), t))
                check(np.array_equal(np.asarray(gs, np.uint32), ws)
                      and np.array_equal(np.asarray(gt, np.uint64), wt),
                      f"partitioned {label}: prepare {b} differs from the "
                      "oracle's")

        def digest_check(label):
            got = partitioned_state_digest(led.partitioned_state)
            want = partitioned_oracle_digest(sm, caps[0], shards)
            check(got == want, f"partitioned {label}: digest {got}, the "
                  f"oracle's {want}")

        def launches_now():
            return (tuple(_launch_counts()[:2]) if cuda else
                    (calls.n["ht_probe"], calls.n["row_gather"]))

        # (a) config-2 chain windows: eager, capture, replays; the last
        # under torch.profiler (a replay: never profile a capture).
        _zero_launches()
        with (calls if not cuda else contextlib.nullcontext()):
            start = launches_now()
            kinds, window_ms, tel0, evs0, res0 = [], [], None, None, None
            idle = None
            for k in range(windows):
                evs = [c2() for _ in range(w)]
                tss = [stamp() for _ in range(w)]
                before = graph_counts(led)
                profiled = cuda and k == windows - 1 and k >= 3
                sync(dev)
                t = time.perf_counter()
                if profiled:
                    from torch.profiler import ProfilerActivity, profile

                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        tk = led.submit_window(evs, tss)
                        led.resolve_windows()
                        sync(dev)
                else:
                    tk = led.submit_window(evs, tss)
                    led.resolve_windows()
                    sync(dev)
                ms = (time.perf_counter() - t) * 1e3
                window_ms.append(ms)
                kinds.append(window_kind(led, before))
                if profiled:
                    # Busy ms from the traced replay, the wall from the
                    # untraced one before it (the profiler's own host
                    # cost lands in the traced window's wall).
                    busy = 0.0
                    for e in prof.key_averages():
                        us = getattr(e, "self_device_time_total", None)
                        if us is None:
                            us = getattr(e, "self_cuda_time_total", 0)
                        busy += (us or 0) / 1e3
                    wall = window_ms[-2]
                    idle = dict(busy_ms=busy, wall_ms=wall, traced_ms=ms,
                                idle_share=(1 - busy / wall) if busy
                                else None)
                check(tk is not None and tk.results[0] == "ok",
                      f"partitioned (a): window {k} did not commit whole")
                oracle_check(f"(a) window {k}", evs, tss, tk.results[1])
                digest_check(f"(a) window {k}")
                if k == 0:
                    tel0 = tk.harvest.get()["shard_stats"]["tel"]
                    evs0, res0 = evs, tk.results[1]
            check(not cuda or kinds[:3] == ["eager", "capture", "replay"]
                  and all(x == "replay" for x in kinds[2:]),
                  f"partitioned (a): windows ran {kinds}")
            routes = led.fallback_stats()["routes"]
            check(routes["windows"] == {"partitioned_chain": windows}
                  and router.host_fallbacks == 0,
                  f"partitioned (a): routes {routes}, host fallbacks "
                  f"{router.host_fallbacks}")
            launches_a = tuple(a - b for a, b in zip(launches_now(), start))
            lap("a_windows")

            # (b) a window poisoned at prepare poison_at by a config-4
            # limit cascade, a clean window in flight behind it.
            pend, _, _ = config4_pair(rng, 4 * 10**7, TF, batch)
            evs_b = [c2() if b != poison_at else pend for b in range(w)]
            tss_b = [stamp() for _ in range(w)]
            evs_c = [c2() for _ in range(w)]
            tss_c = [stamp() for _ in range(w)]
            esc0 = router.escalations
            tk_b = led.submit_window(evs_b, tss_b)
            tk_c = led.submit_window(evs_c, tss_c)
            check(tk_b is not None and tk_c is not None,
                  "partitioned (b): a window was not submitted")
            led.resolve_windows()
            check(tk_b.results[0] == "redo" and tk_c.results[0] == "redo",
                  f"partitioned (b): {tk_b.results[0]}, {tk_c.results[0]}")
            oracle_check("(b) poisoned", evs_b, tss_b, tk_b.results[1])
            oracle_check("(b) behind", evs_c, tss_c, tk_c.results[1])
            tel_b = decode_telemetry(
                tk_b.harvest.get()["shard_stats"]["tel"])
            causes = [TEL_CAUSES[c - 1] if c else None
                      for c in tel_b["poison_cause"].max(axis=0)]
            check(causes[:poison_at] == [None] * poison_at
                  and causes[poison_at] == "e3_limit"
                  and all(c == "forced" for c in causes[poison_at + 1:]),
                  f"partitioned (b): poison causes {causes}")
            check(router.escalations > esc0 and router.host_fallbacks == 0,
                  f"partitioned (b): escalations {router.escalations}, "
                  f"host fallbacks {router.host_fallbacks}")
            digest_check("(b)")
            lap("b_poisoned")

            # (c) imported, balancing and plain prepares, per batch.
            bal, _, _ = balancing_pair(rng, 5 * 10**7, TF, batch)
            t_bal = stamp()
            imp = c2()
            imp["flags"][:] = int(TF.imported)
            imp["ts"] = np.arange(clock[0] + 1, clock[0] + 1 + batch,
                                  dtype=np.uint64)
            clock[0] += batch + 1000
            t_imp = clock[0]
            plain = c2()
            t_plain = stamp()
            step_ms = {}
            for label, ev, t in (("balancing", bal, t_bal),
                                 ("imported", imp, t_imp),
                                 ("plain", plain, t_plain)):
                n0 = dict(counted.steps)
                sync(dev)
                t0 = time.perf_counter()
                got = led.create_transfers_window([ev], [t])
                sync(dev)
                step_ms[label] = (time.perf_counter() - t0) * 1e3
                ran = {m: c - n0.get(m, 0) for m, c in counted.steps.items()
                       if c != n0.get(m, 0)}
                check(ran == {label: 1},
                      f"partitioned (c): {label} ran the steps {ran}")
                oracle_check(f"(c) {label}", [ev], [t], got)
            check(router.host_fallbacks == 0,
                  f"partitioned (c): host fallbacks {router.host_fallbacks}")
            digest_check("(c)")
            lap("c_per_batch")
            launches = tuple(a - b for a, b in zip(launches_now(), start))
            pred = tuple(counted.pred)
            check(launches == pred,
                  f"partitioned (g): launches {launches}, "
                  f"partitioned_launches predicts {pred}")
            graph_counted, graph_ran = graph_launches(led.windows)

        # (d) the first window's telemetry against a host count.
        n_pad = _pad_bucket(batch)
        d = decode_telemetry(tel0)
        owned = _owned_counts(evs0, shards)
        check(np.array_equal(d["events_owned"], owned),
              "partitioned (d): events_owned differs from the host count")
        for b, (ev, (st, _)) in enumerate(zip(evs0, res0)):
            ok = np.asarray(st) == created
            sd = np.array([shard_of_int(int(x), shards)
                           for x in ev["dr_lo"][ok]])
            sc = np.array([shard_of_int(int(x), shards)
                           for x in ev["cr_lo"][ok]])
            accts = len(np.unique(np.concatenate([ev["dr_lo"],
                                                  ev["cr_lo"]])))
            # Replicated words are equal on every shard; fresh ids and no
            # pendings: no live transfer row crosses the exchange.
            rep = {k: set(d[k][:, b].tolist()) for k in (
                "fix_rounds", "xchg1_occupancy", "xchg1_capacity",
                "xchg2_occupancy", "xchg2_capacity",
                "cross_shard_transfers", "poison_cause")}
            want = {"fix_rounds": {0}, "xchg1_occupancy": {0},
                    "xchg1_capacity": {2 * n_pad},
                    "xchg2_occupancy": {accts},
                    "xchg2_capacity": {4 * n_pad},
                    "cross_shard_transfers": {int((sd != sc).sum())},
                    "poison_cause": {0}}
            check(rep == want and int(d["writeback_transfers"][:, b].sum())
                  == int(ok.sum()),
                  f"partitioned (d): prepare {b} telemetry {rep}, "
                  f"writeback {d['writeback_transfers'][:, b].tolist()}, "
                  f"the host count {want}, {int(ok.sum())} created")
        lap("d_telemetry")

        # (e) shard resync on the device's default mesh.
        resync = {}
        _zero_launches()
        for seed in resync_seeds:
            got = shard_resync_scenario(seed, device=dev, flight_dir=tmp)
            check(got["resyncs"] == 1, f"partitioned (e): seed {seed}: {got}")
            resync[seed] = got
        resync_launches = tuple(_launch_counts()[:2])
        lap("e_resync")

        # (f) resident bytes.
        pb = partitioned_state_bytes(led.partitioned_state)
        rb = replicated_state_bytes(*caps)
        static_pb = static_partitioned_bytes(caps[0], caps[1], shards)
        check(pb * shards == static_pb and pb <= rb // shards + rb // 50,
              f"partitioned (f): {pb} B a shard, the replicated route "
              f"{rb} B a device, static {static_pb} over {shards}")
        measured = measure_ledger(led)["components"]
        static = static_ledger(*caps, partitioned_shards=shards)[
            "components"]
        check(all(measured[k] == static[k] for k in measured
                  if k.startswith("state.") or k == "partitioned_state"),
              f"partitioned (f): measured {measured}, static {static}")
        lap("f_memory")
        stats = router.stats()
        out = dict(
            shards=shards, window=w, batch=batch, caps=list(caps),
            window_kinds=kinds, window_ms=window_ms,
            idle_replay=idle, step_ms=step_ms,
            launches=launches, predicted=pred, launches_a=launches_a,
            graph_counted=graph_counted, graph_ran=graph_ran,
            resync=resync, resync_launches=resync_launches,
            bytes=dict(partitioned_per_shard=pb, replicated=rb,
                       components=measured),
            poison_causes=causes,
            routes=led.fallback_stats()["routes"],
            stats={k: v for k, v in stats.items() if k != "telemetry"},
            telemetry=stats["telemetry"],
            legs_s=legs, elapsed_s=time.perf_counter() - t_phase,
            card=card_line_or_cpu(dev))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    led.release()
    del led, router
    if cuda:
        torch.cuda.empty_cache()
    print(f"partitioned: windows {kinds} {[round(x, 1) for x in window_ms]}"
          f" ms, steps {step_ms}, launches {launches} (predicted {pred}), "
          f"legs {legs}", flush=True)
    return out


def _states_equal(got: dict, want: dict) -> str | None:
    """Two stacked numpy partitioned states (`convert.partitioned_to_
    numpy`), shard by shard: each store's rows below its count and the
    counts, both hash tables but the dump bucket (masked lanes race
    there). Returns the first difference, or None."""
    n = want["accounts"]["count"].shape[0]
    for s in range(n):
        for store in ("accounts", "transfers", "events"):
            c = int(want[store]["count"][s])
            if int(got[store]["count"][s]) != c:
                return f"shard {s} {store} count"
            for k, w in want[store].items():
                if k != "count" and not np.array_equal(got[store][k][s][:c],
                                                       w[s][:c]):
                    return f"shard {s} {store}.{k}"
        for table in ("acct_ht", "xfer_ht"):
            if not np.array_equal(got[table]["packed"][s][:-1],
                                  want[table]["packed"][s][:-1]):
                return f"shard {s} {table}"
    return None


class _ReshardTwin:
    """The CPU twin of a controller's migrations on the card: before each
    call of `on_window` or `drain` that writes the device (a copy chunk,
    a drain, a flip and retire, an abort's eviction), the card's state is
    copied to CPU shards and a twin controller on a CPU router of the same
    mesh size and ownership makes the same call from the same host fields;
    after it the card's state must equal the twin's on the plan's source
    and receiver, the shards a migration writes (their stores below their
    counts, the tables but the dump bucket), and so must the stage, the
    rows copied, the ownership, the abort raised and the range digests of
    the plan. A call that only counts a double-write window runs
    alone."""

    FIELDS = ("plan", "stage", "rows_copied", "dw_windows", "_snap", "_t0",
              "_entry", "corrupt_next_chunk")
    # Only the plan's source and receiver are written (and compared): the
    # twin's other shards are the card's own, read only by the range
    # digests.

    def __init__(self, ctl, shards: int, caps: tuple, flight_dir: str):
        from tigerbeetle_tpu_torch.parallel.partitioned import (
            PartitionedRouter)
        from tigerbeetle_tpu_torch.parallel.resharding import (
            ReshardController)
        from tigerbeetle_tpu_torch.parallel.shard_utils import Mesh
        from tigerbeetle_tpu_torch.trace import FlightRecorder

        self.ctl = ctl
        self.mesh = Mesh(["cpu"] * shards)
        self.router = PartitionedRouter(
            self.mesh, a_cap=caps[0], t_cap=caps[1],
            flight_recorder=FlightRecorder(dump_dir=flight_dir))
        self.twin = ReshardController(
            self.router, chunk_rows=ctl.chunk_rows,
            min_double_write_windows=ctl.min_double_write_windows)
        self.compared = []
        self.aborts = []
        for name in ("on_window", "drain"):
            setattr(ctl, name, self._wrap(name, getattr(ctl, name)))

    def _writes(self, name: str) -> bool:
        c = self.ctl
        return c.stage == "copy" or (
            c.stage == "double_write"
            and (name == "drain"
                 or c.dw_windows + 1 >= c.min_double_write_windows))

    def _wrap(self, name, fn):
        from tigerbeetle_tpu_torch.convert import (partitioned_to_numpy,
                                                   state_from_numpy,
                                                   state_to_numpy)
        from tigerbeetle_tpu_torch.ops.state_epoch import (
            partitioned_range_digest)
        from tigerbeetle_tpu_torch.parallel.resharding import (
            MigrationAborted)

        def call(state, *args, **kw):
            if not self._writes(name):
                return fn(state, *args, **kw)
            c, t = self.ctl, self.twin
            plan = c.plan
            for f in self.FIELDS:
                setattr(t, f, getattr(c, f))
            t._cursors = dict(c._cursors) if c._cursors else c._cursors
            self.router.ownership = c.router.ownership
            before_stage = c.stage
            written = (plan.src, plan.dst)
            cpu = tuple(state_from_numpy(state_to_numpy(sub), "cpu")
                        if s in written else sub
                        for s, sub in enumerate(state))
            raised = [None, None]
            try:
                cpu = getattr(t, name)(cpu, *args, **kw)
            except MigrationAborted as e:
                cpu, raised[1] = e.state, e
            try:
                out = fn(state, *args, **kw)
            except MigrationAborted as e:
                out, raised[0] = e.state, e
            diff = _states_equal(
                partitioned_to_numpy([out[s] for s in written]),
                partitioned_to_numpy([cpu[s] for s in written]))
            same = [getattr(c, f) == getattr(t, f) for f in (
                "stage", "rows_copied", "dw_windows")]
            reasons = [e.reason if e else None for e in raised]
            digests = [partitioned_range_digest(x, plan.lo, plan.hi,
                                                plan.src) for x in (out, cpu)]
            check(diff is None and all(same) and reasons[0] == reasons[1]
                  and c.router.ownership == self.router.ownership
                  and digests[0] == digests[1],
                  f"reshard twin: {name} at stage {before_stage} differs "
                  f"from the CPU twin: {diff}, stage/rows/dw {same}, "
                  f"aborts {reasons}")
            self.compared.append((name, before_stage, c.stage))
            if raised[0] is not None:
                self.aborts.append(reasons[0])
                raise raised[0]
            return out

        return call


def _overlay_label(entries) -> str:
    names = {1: "double_write", 2: "migrated", 3: "returning"}
    return ("base" if not entries else
            "+".join(f"{e[2]}->{e[3]}:{names[e[4]]}" for e in entries))


def reshard_phase(dev, caps: tuple = (A_CAP, T_CAP),
                  n_accounts: int = N_ACCOUNTS, batch: int = BATCH,
                  shards: int = RS_SHARDS, w: int = RS_W,
                  warm: int = RS_WARM,
                  chaos_seeds: tuple = RS_CHAOS_SEEDS) -> dict:
    """Live resharding and the multi-process mesh on `dev`: a
    ServingSupervisor at `caps` seeded with config 4's accounts and
    n_accounts plain ones, attached to a PartitionedRouter on `shards`
    logical shards of the device; (a) `warm` config-2 windows of w x
    batch (submit and drain: on the card each one graph replay, eager and
    captured first), a split of [0, 2^63 - 1] from shard 0 to 1 driven by
    the windows' ticks to `done`, then its merge_back, each controller
    call that writes the device held to a CPU twin (`_ReshardTwin`), every
    window's results and the digest held to the oracle by the epoch
    checks (`reshard` verifies first; the last check after the last
    window); (b) a migration of [2^63, 2^64 - 1] from shard 1 to 2 with a
    corrupted chunk: it aborts before the flip (digest_mismatch, a flight
    artifact, ownership at the base) and the next window is exact; (c)
    reshard_chaos_scenario for `chaos_seeds` on 2 logical shards of `dev`
    against the CPU; (d) two_process_smoke on `dev`; (e) the launches of
    (a) and (b) (on the CPU, the wrappers' calls) against
    partitioned_launches and RESHARD_GATHERS."""
    from tigerbeetle_tpu_torch import ServingSupervisor
    from tigerbeetle_tpu_torch.ops.batch import transfers_from_arrays
    from tigerbeetle_tpu_torch.parallel import resharding as RS
    from tigerbeetle_tpu_torch.parallel.multihost import two_process_smoke
    from tigerbeetle_tpu_torch.parallel.partitioned import PartitionedRouter
    from tigerbeetle_tpu_torch.parallel.shard_utils import (
        OVERLAY_MIGRATED, Mesh)
    from tigerbeetle_tpu_torch.testing.chaos import reshard_chaos_scenario
    from tigerbeetle_tpu_torch.trace import FlightRecorder
    from tigerbeetle_tpu_torch.types import Account, AccountFlags

    cuda = torch.device(dev).type == "cuda"
    half = 1 << 63
    t_phase = time.perf_counter()
    legs, marks = {}, [t_phase]

    def lap(name):
        marks.append(time.perf_counter())
        legs[name] = marks[-1] - marks[-2]

    tmp = tempfile.mkdtemp(prefix="tb_reshard_")
    flight_dir = os.path.join(tmp, "flight")
    calls = _WrapperCalls()
    kernel_calls = {k: 0 for k in RESHARD_GATHERS}
    originals = {k: getattr(RS, k) for k in RESHARD_GATHERS}

    def counting(name):
        fn = originals[name]

        def call(sub, *args, **kw):
            if sub["accounts"]["u64"].device.type == torch.device(dev).type:
                kernel_calls[name] += 1
            return fn(sub, *args, **kw)
        return call

    try:
        sup = ServingSupervisor(
            caps[0], caps[1], device=dev, epoch_interval=1 << 20,
            sleep=lambda s: None,
            flight_recorder=FlightRecorder(dump_dir=flight_dir))
        accounts = (config4_accounts(Account, AccountFlags)
                    + [Account(id=C4_ACCOUNTS + i, ledger=1, code=1)
                       for i in range(1, n_accounts + 1)])
        clock = [10**6]
        for lo in range(0, len(accounts), BATCH):
            chunk = accounts[lo:lo + BATCH]
            clock[0] += len(chunk) + 10
            sup.create_accounts(chunk, clock[0])
        router = PartitionedRouter(Mesh([dev] * shards), a_cap=caps[0],
                                   t_cap=caps[1])
        counted = _CountedRouter(router, shards)
        ctl = sup.attach_partitioned(router)
        check(sup.mirror_audit == "off" and sup.part_router is router,
              "reshard (a): attach_partitioned did not take the router")
        twin = _ReshardTwin(ctl, shards, caps, os.path.join(tmp, "twin"))
        stage_ms: dict = {}

        def timed(name):
            fn = getattr(ctl, name)

            def call(*args, **kw):
                sync(dev)
                t = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    sync(dev)
                    stage_ms.setdefault(name, []).append(
                        (time.perf_counter() - t) * 1e3)
            return call

        for name in ("_take_snapshot", "copy_chunk", "_activate_double_write",
                     "flip", "_retire"):
            setattr(ctl, name, timed(name))
        # The supervisor's per-window tick (the migration's step, the
        # twin's comparison) apart from the window's dispatch.
        tick_ms = []
        tick = sup._reshard_tick

        def timed_tick(batches):
            if not ctl.active:
                return tick(batches)
            t = time.perf_counter()
            try:
                return tick(batches)
            finally:
                sync(dev)
                tick_ms.append((time.perf_counter() - t) * 1e3)

        sup._reshard_tick = timed_tick
        lap("setup")
        rng = np.random.default_rng(97)
        nxt = [6 * 10**7]
        clock[0] = 10**9
        windows = []

        def window(label):
            evs, tss = [], []
            for _ in range(w):
                ev = uniform_batch(rng, nxt[0], batch, n_accounts)
                nxt[0] += batch
                ev["dr_lo"] += np.uint64(C4_ACCOUNTS)
                ev["cr_lo"] += np.uint64(C4_ACCOUNTS)
                clock[0] += batch + 10
                evs.append(ev)
                tss.append(clock[0])
            batches = [transfers_from_arrays(ev) for ev in evs]
            led = sup.led
            before = graph_counts(led)
            overlay = router.ownership.entries
            sync(dev)
            n_ticks = len(tick_ms)
            t = time.perf_counter()
            sup.submit_transfers_window(batches, tss, evs=evs)
            sup.drain_pipeline()
            sync(dev)
            ms = (time.perf_counter() - t) * 1e3
            tick = sum(tick_ms[n_ticks:])
            # The tick ran before the dispatch: the window ran under the
            # overlay it left.
            windows.append(dict(
                label=label, ms=ms - tick, tick_ms=tick,
                kind=window_kind(led, before),
                stage=ctl.stage,
                overlay=_overlay_label(router.ownership.entries),
                overlay_before=_overlay_label(overlay)))
            check(sup.led is led and sup.counters["recoveries"] == {},
                  f"reshard {label}: a recovery ran: {sup.stats()}")

        def verify(label):
            t = time.perf_counter()
            ok = sup.verify_epoch()
            check(ok and sup.counters["recoveries"] == {},
                  f"reshard {label}: the epoch did not verify: "
                  f"{sup.last_recovery}")
            return (time.perf_counter() - t) * 1e3

        def migrate(plan, label):
            """reshard() (an epoch check first), then windows until done."""
            t = time.perf_counter()
            sup.reshard(plan)
            verify_ms = (time.perf_counter() - t) * 1e3
            check(ctl.stage == "copy", f"reshard {label}: {ctl.stage}")
            guard = 0
            while ctl.stage == "copy" or ctl.stage == "double_write":
                window(f"{label} {guard}")
                guard += 1
                check(guard <= 6, f"reshard {label}: still {ctl.stage}")
            return verify_ms

        _zero_launches()
        verify_ms = {}
        with (calls if not cuda else contextlib.nullcontext()):
            start = (tuple(_launch_counts()[:2]) if cuda else
                     (calls.n["ht_probe"], calls.n["row_gather"]))
            for name in RESHARD_GATHERS:
                setattr(RS, name, counting(name))
            try:
                for k in range(warm):
                    window(f"warm {k}")
                lap("a_warm")
                verify_ms["split"] = migrate(
                    RS.ReshardPlan(0, half - 1, 0, 1, "split"), "(a) split")
                check(ctl.stage == "done" and router.ownership.entries
                      == ((0, half - 1, 0, 1, OVERLAY_MIGRATED),),
                      f"reshard (a) split: {ctl.stage}, "
                      f"{router.ownership.entries}")
                lap("a_split")
                verify_ms["merge_back"] = migrate(
                    RS.ReshardPlan(0, half - 1, 0, 1, "merge_back"),
                    "(a) merge_back")
                check(ctl.stage == "done" and router.ownership.entries == ()
                      and [m["kind"] for m in ctl.migrations]
                      == ["split", "merge_back"]
                      and all(m["double_write_windows"] >= 2
                              and m["rows_copied"] > 0
                              for m in ctl.migrations),
                      f"reshard (a) merge_back: {ctl.migrations}")
                lap("a_merge_back")

                # (b) a corrupted chunk aborts the migration before its
                # flip: the epoch check drains it (copy, finalize,
                # double-write, the flip's witness).
                t = time.perf_counter()
                sup.reshard(RS.ReshardPlan(half, (1 << 64) - 1, 1, 2,
                                           "migrate"))
                verify_ms["negative"] = (time.perf_counter() - t) * 1e3
                ctl.corrupt_next_chunk = True
                verify_ms["negative_drain"] = verify("(b) drain")
                arts = glob.glob(os.path.join(flight_dir,
                                              "FLIGHT_*_reshard_*"))
                check(ctl.stage == "aborted" and twin.aborts
                      == ["digest_mismatch"]
                      and [a["reason"] for a in ctl.aborts]
                      == ["digest_mismatch"]
                      and ctl.aborts[0]["stage"] == "double_write"
                      and router.ownership.entries == () and arts
                      and len(ctl.migrations) == 2,
                      f"reshard (b): stage {ctl.stage}, aborts {ctl.aborts}, "
                      f"ownership {router.ownership.entries}, artifacts "
                      f"{arts}")
                window("(b) after")
                verify_ms["final"] = verify("(b) after")
            finally:
                for name, fn in originals.items():
                    setattr(RS, name, fn)
            launches = tuple(
                a - b for a, b in zip(
                    (tuple(_launch_counts()[:2]) if cuda else
                     (calls.n["ht_probe"], calls.n["row_gather"])), start))
        pred = (counted.pred[0], counted.pred[1] + sum(
            RESHARD_GATHERS[k] * n for k, n in kernel_calls.items()))
        check(launches == pred,
              f"reshard (e): launches {launches}, predicted {pred} "
              f"(windows {counted.pred}, kernels {kernel_calls})")
        st = sup.stats()
        check(st["recoveries"] == {} and router.host_fallbacks == 0
              and st["epochs_verified"] >= 5,
              f"reshard (a): {st['recoveries']}, host fallbacks "
              f"{router.host_fallbacks}, epochs {st['epochs_verified']}")
        wg = sup.led.windows
        graphs = {}
        for key in set(wg.eager) | set(wg.captures) | set(wg.replays):
            graphs[_overlay_label(key[-1])] = (
                wg.eager.get(key, 0), wg.captures.get(key, 0),
                wg.replays.get(key, 0))
        check(not cuda or all(x["kind"] != "host" for x in windows),
              f"reshard (a): windows ran {windows}")
        resharding = dict(st["resharding"])
        evictions, drops = wg.evictions, wg.drops
        check(drops == 0, f"reshard (a): the window graphs were dropped "
              f"{drops} times: a kernel moved a state tensor")
        sup.led.release()
        lap("ab_migrations")

        # (c) the chaos scenario on 2 logical shards of the device.
        chaos = {}
        for seed in chaos_seeds:
            t = time.perf_counter()
            got = reshard_chaos_scenario(seed, device=dev,
                                         flight_dir=os.path.join(tmp, "c"))
            ms = (time.perf_counter() - t) * 1e3
            want = reshard_chaos_scenario(seed, device="cpu",
                                          flight_dir=os.path.join(tmp, "cc"))
            check(got == want and got["aborts"] == 6
                  and got["migrations"] == 1,
                  f"reshard (c): seed {seed}: {got}, the CPU's {want}")
            chaos[seed] = dict(got, ms=ms)
        lap("c_chaos")

        # (d) two processes, one gloo group.
        two = {}
        t = time.perf_counter()
        verdict = two_process_smoke(device=dev if cuda else "cpu",
                                    timeout=240, stats=two)
        check(verdict == "ok", f"reshard (d): two_process_smoke {verdict}")
        two_ms = (time.perf_counter() - t) * 1e3
        lap("d_two_process")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if cuda:
        torch.cuda.empty_cache()
    out = dict(
        shards=shards, window=w, batch=batch, caps=list(caps),
        windows=windows, stage_ms=stage_ms, verify_ms=verify_ms,
        resharding=resharding, graphs=graphs, graph_evictions=evictions,
        twin_compared=twin.compared, launches=launches, predicted=pred,
        kernel_calls=kernel_calls, window_pred=list(counted.pred),
        chaos=chaos, two_process=dict(verdict=verdict, ms=two_ms,
                                      launches=two.get("launches")),
        legs_s=legs, elapsed_s=time.perf_counter() - t_phase,
        card=card_line_or_cpu(dev))
    kinds = [(x["kind"], round(x["ms"], 1)) for x in windows]
    stages = {k: (len(vs), round(sum(vs), 1), round(max(vs), 1))
              for k, vs in stage_ms.items()}
    print(f"reshard: windows {kinds}, stages (calls, ms, max ms) {stages}, "
          f"graphs {graphs}, "
          f"launches {launches} (predicted {pred}), two-process {verdict}, "
          f"legs {legs}", flush=True)
    return out

# --------------------------------------------------- the catalog gate

def trace_coverage_phase(dev) -> dict:
    """The port's trace-catalog gate on `dev`: `coverage_main` over
    `trace_coverage.SCENARIOS`, each scenario timed and its newly emitted
    catalog events recorded, held to rc 0 (every catalog event emitted,
    no off-catalog name, no starved histogram, no scenario failed) and to
    a catalog of 56 events; then `metrics_main` rc 0. Returns the seconds
    and new events a scenario and the launches of the gate."""
    import functools

    from tigerbeetle_tpu_torch.testing import trace_coverage as TCV
    from tigerbeetle_tpu_torch.trace import Event

    rows, cols = [], []

    def timed(fn):
        @functools.wraps(fn)
        def run(col):
            if not cols:
                cols.append(col)
            seen, t = col.emitted(), time.perf_counter()
            try:
                fn(col)
            finally:
                if torch.device(dev).type == "cuda":
                    torch.cuda.synchronize()
                row = dict(name=fn.__name__.replace("_scenario_", ""),
                           seconds=time.perf_counter() - t,
                           new=sorted(col.emitted() - seen))
                rows.append(row)
                print(f"[trace-cov] {row['name']}: {row['seconds']:.2f} s, "
                      f"new {row['new']}", flush=True)
        return run

    _zero_launches()
    t = time.perf_counter()
    rc = TCV.coverage_main(tuple(timed(s) for s in TCV.SCENARIOS),
                           device=dev)
    coverage_s = time.perf_counter() - t
    launches, seq_by_kind = _launch_counts(), _seq_by_kind()
    catalog = len(Event)
    check(rc == 0 and catalog == 56,
          f"trace coverage: coverage_main returned {rc} on a catalog of "
          f"{catalog} events")
    if torch.device(dev).type == "cuda":
        check(min(launches) > 0, f"trace coverage: launches {launches}: "
              "a kernel of the gate's path never launched")
    t = time.perf_counter()
    mrc = TCV.metrics_main(device=dev)
    metrics_s = time.perf_counter() - t
    check(mrc == 0, f"trace coverage: metrics_main returned {mrc}")
    numbers = dict(scenarios=rows, emitted=len(cols[0].emitted()),
                   catalog=catalog, tracers=len(cols[0].tracers),
                   coverage_s=coverage_s, metrics_s=metrics_s,
                   launches=launches, seq_by_kind=seq_by_kind,
                   card=card_line_or_cpu(dev))
    print(f"trace coverage: {numbers['emitted']}/{catalog} events in "
          f"{coverage_s:.1f} s, metrics {metrics_s:.1f} s, launches "
          f"{launches} ({numbers['card']})", flush=True)
    return numbers


# ------------------------------------------------------------ clients

CL_BODIES = 3            # config-2 transfer bodies of SV_BODY events
CL_SMALL = 200           # timed one-transfer requests, after one warm-up
CL_ACCOUNT_BASE = 10_000  # ids above the C++ example's accounts 1, 2
CL_TRANSFER_BASE = 1_000_000
CL_TIMEOUT_S = 300.0


def _no_ts(objs) -> list:
    return [dataclasses.replace(o, timestamp=0) for o in objs]


class ClientsRig:
    """The clients phase's processes, started ahead of the phase so that
    they come up while earlier phases run: g++ on clients/cpp/example.cpp
    against csrc/tb_client.cpp, `main.py clients --out <tmp>/gen`, and a
    thread that formats two data files (the default `StorageLayout()`;
    on the CPU the small layout), then starts `start --engine=device` on
    `dev` in a child process (`_server_main`) and a CPU oracle-engine
    twin server. close() stops every process it started, and may be
    called again."""

    def __init__(self, dev):
        import multiprocessing

        self.root = Path(__file__).resolve().parent
        self.cuda = torch.device(dev).type == "cuda"
        self.flags = [] if self.cuda else ["--small"]
        self.tmp = tempfile.mkdtemp(prefix="tb_clients_")
        self.exe = f"{self.tmp}/example"
        self.phase_s, self.servers, self.ports, self.procs = {}, {}, {}, []
        self.error = None
        self.build = self._spawn("g++", "-O2", "-std=c++17",
                                 "clients/cpp/example.cpp",
                                 "tigerbeetle_tpu_torch/csrc/tb_client.cpp",
                                 "-o", self.exe, "-pthread")
        self.gen = self._cli("clients", f"--out={self.tmp}/gen")
        self.thread = threading.Thread(
            target=self._start_servers,
            args=(multiprocessing.get_context("spawn"),), daemon=True)
        self.thread.start()

    def _spawn(self, *argv):
        """`argv` from the repo root, its output kept."""
        self.procs.append(subprocess.Popen(
            argv, cwd=str(self.root), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
        return self.procs[-1]

    def _cli(self, *args):
        return self._spawn(sys.executable, "-m", "tigerbeetle_tpu_torch",
                           *args)

    def _start_servers(self, ctx) -> None:
        try:
            t = time.perf_counter()
            formats = [self._cli("format", "--cluster=0", "--replica=0",
                                 "--replica-count=1", *self.flags,
                                 f"{self.tmp}/{name}.tigerbeetle")
                       for name in ("card", "twin")]
            for proc in formats:
                _, err = proc.communicate(timeout=600)
                check(proc.returncode == 0, f"clients: format failed:\n{err}")
            self.phase_s["format"] = time.perf_counter() - t
            for name, platform, engine in (
                    ("card", "cuda" if self.cuda else "cpu", "device"),
                    ("twin", "cpu", "oracle")):
                self.ports[name] = _free_port()
                argv = ["start", f"--platform={platform}",
                        f"--addresses=127.0.0.1:{self.ports[name]}",
                        "--replica=0", f"--engine={engine}", *self.flags,
                        f"{self.tmp}/{name}.tigerbeetle"]
                self.servers[name] = ServerChild(
                    ctx, argv, f"{self.tmp}/{name}.log")
        except Exception as exc:   # re-raised by wait_open, in the phase
            self.error = exc

    def log_tail(self, name) -> str:
        path = Path(f"{self.tmp}/{name}.log")
        return path.read_text()[-6000:] if path.exists() else ""

    def fail_log(self, name):
        def fail(msg):
            check(False, f"clients: {msg}\n{name} log tail:\n"
                  f"{self.log_tail(name)}")
        return fail

    def wait_open(self) -> None:
        """Wait until both servers have opened; fail with a server's log
        if it did not. `start` is the slower server's seconds from its
        spawn to its open; `wait` what the phase itself waited."""
        t = time.perf_counter()
        self.thread.join()
        if self.error is not None:
            raise self.error
        for name, srv in self.servers.items():
            wait_watching(srv.ready, srv, 900, f"the {name} server to open",
                          self.fail_log(name))
            check(srv.info("open") is not None,
                  f"clients: the {name} server never opened")
        self.phase_s["start"] = max(
            next(at for at, m in srv.msgs if m[0] == "open") - srv.t0
            for srv in self.servers.values())
        self.phase_s["wait"] = time.perf_counter() - t

    def close(self) -> None:
        self.thread.join()
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for srv in self.servers.values():
            if srv.proc.is_alive():
                srv.stop("kill")
        shutil.rmtree(self.tmp, ignore_errors=True)


def clients_phase(dev, rig: ClientsRig = None, n_accounts: int = N_ACCOUNTS,
                  body: int = SV_BODY, n_bodies: int = CL_BODIES,
                  n_small: int = CL_SMALL, seed: int = 16) -> dict:
    """The port's clients against the replica server on `dev`: (a) the
    rig's servers (a `ClientsRig` started ahead, or one started here),
    `start --engine=device` on `dev` and a CPU oracle-engine twin; (b)
    the port's `CClient` (csrc/tb_client.cpp) sends each server the same
    requests: n_accounts accounts, n_bodies config-2 bodies of `body`
    transfers over them, one untimed one-transfer request, n_small timed
    one-transfer requests, then lookup_accounts and lookup_transfers of
    as many ids as a reply may hold; every reply equal to the twin's,
    timestamps aside, and each server's looked-up transfer timestamps
    equal to its create results'; (c) clients/cpp/example.cpp built by
    g++ against csrc/tb_client.cpp, its echo mode and its run against
    the card's server; (d) `main.py clients --out <tmp>` byte-equal to
    the committed clients/ tree; (e) SIGTERM, the server's launches. g++
    is required. Returns the numbers: each kind of request's latency at
    the client (the one-transfer requests' p50, p99 and max over
    n_small)."""
    from tigerbeetle_tpu_torch import multi_batch
    from tigerbeetle_tpu_torch.clients import CClient, c_client_available
    from tigerbeetle_tpu_torch.clients import codegen
    from tigerbeetle_tpu_torch.types import (Account, Operation as O,
                                             Transfer)
    from tigerbeetle_tpu_torch.vsr.replica import _reply_fits
    from tigerbeetle_tpu_torch.vsr.storage import StorageLayout, TEST_LAYOUT

    class PatientClient(CClient):
        def request(self, operation, body, timeout_s=CL_TIMEOUT_S):
            return super().request(operation, body, timeout_s)

    check(shutil.which("g++") is not None, "clients: no g++ on this host")
    check(c_client_available(), "clients: the native tb_client did not build")
    t_phase = time.perf_counter()
    rig = rig or ClientsRig(dev)
    cuda, root, tmp = rig.cuda, rig.root, rig.tmp
    servers, ports, phase_s = rig.servers, rig.ports, rig.phase_s
    layout = StorageLayout() if cuda else TEST_LAYOUT
    n_lookups = next(
        n for n in range(BATCH, 0, -1)
        if _reply_fits(O.lookup_transfers, len(multi_batch.encode(
            [b"\x00" * 16 * n], 16)), layout.message_size_max))
    clients = []
    try:
        # (a) the two servers
        rig.wait_open()
        opened = servers["card"].info("open")
        check(opened["engine"] == "device"
              and opened["device"].startswith("cuda" if cuda else "cpu"),
              f"clients: the card's server ran {opened['engine']} on "
              f"{opened['device']}")
        check(servers["twin"].info("open")["engine"] == "oracle",
              "clients: the twin is not the oracle engine")

        # (b) the same requests to both servers
        rng = np.random.default_rng(seed)
        acct_ids = [CL_ACCOUNT_BASE + i for i in range(1, n_accounts + 1)]
        accounts = [Account(id=i, ledger=1, code=1) for i in acct_ids]
        requests = [("accounts", "create_accounts", accounts[k:k + body])
                    for k in range(0, n_accounts, body)]
        tid = CL_TRANSFER_BASE
        xfer_ids = []

        def transfers(n):
            nonlocal tid
            dr = rng.integers(0, n_accounts, n)
            cr = (dr + rng.integers(1, n_accounts, n)) % n_accounts
            amt = rng.integers(1, 10**6, n)
            out = [Transfer(id=tid + i, debit_account_id=acct_ids[dr[i]],
                            credit_account_id=acct_ids[cr[i]],
                            amount=int(amt[i]), ledger=1, code=1)
                   for i in range(n)]
            xfer_ids.extend(range(tid, tid + n))
            tid += n
            return out

        requests += [("body", "create_transfers", transfers(body))
                     for _ in range(n_bodies)]
        requests += [("warm_up", "create_transfers", transfers(1))]
        requests += [("small", "create_transfers", transfers(1))
                     for _ in range(n_small)]
        requests += [("lookup_accounts", "lookup_accounts",
                      acct_ids[-n_lookups:]),
                     ("lookup_transfers", "lookup_transfers",
                      xfer_ids[:n_lookups])]
        replies = {name: [] for name in servers}
        latency = {name: [] for name in servers}
        t = time.perf_counter()
        for name in servers:
            client = PatientClient(cluster=0, client_id=77,
                                   replica_addresses=[
                                       ("127.0.0.1", ports[name])])
            clients.append(client)
            for _, what, arg in requests:
                t0 = time.perf_counter()
                replies[name].append(getattr(client, what)(arg))
                latency[name].append((time.perf_counter() - t0) * 1e3)
            client.close()
            phase_s[f"requests_{name}"] = time.perf_counter() - t
            t = time.perf_counter()
        for k, ((_, what, arg), got, want) in enumerate(zip(
                requests, replies["card"], replies["twin"])):
            check(len(got) == len(arg) and _no_ts(got) == _no_ts(want),
                  f"clients: request {k} ({what}) differs from the twin's")
        for name in servers:
            created = {}
            for (_, what, arg), got in zip(requests, replies[name]):
                if what == "create_transfers":
                    check(all(r.status.name == "created" for r in got),
                          f"clients: {name}: a transfer was not created")
                    created.update((x.id, r.timestamp)
                                   for x, r in zip(arg, got))
            looked = replies[name][-1]
            check([x.id for x in looked] == xfer_ids[:n_lookups]
                  and all(x.timestamp == created[x.id] for x in looked),
                  f"clients: {name}: looked-up transfers are not the "
                  f"created ones")
        balances = replies["card"][-2]
        check(sum(a.debits_posted for a in balances) > 0,
              "clients: no looked-up account moved")

        # (c) the C++ example against the card's server
        t = time.perf_counter()
        _, err = rig.build.communicate(timeout=300)
        check(rig.build.returncode == 0,
              f"clients: example.cpp did not build:\n{err}")
        phase_s["cpp_build"] = time.perf_counter() - t
        t = time.perf_counter()
        echo = subprocess.run([rig.exe, "echo"], capture_output=True,
                              text=True, timeout=60)
        check(echo.returncode == 0 and "echo ok" in echo.stdout,
              f"clients: example echo failed: {echo.stdout}{echo.stderr}")
        run = subprocess.run([rig.exe, "0", f"127.0.0.1:{ports['card']}"],
                             capture_output=True, text=True, timeout=300)
        check(run.returncode == 0 and "cpp client ok" in run.stdout,
              f"clients: example against the card's server failed: "
              f"{run.stdout}{run.stderr}")
        phase_s["cpp_run"] = time.perf_counter() - t

        # (d) the generators
        t = time.perf_counter()
        _, err = rig.gen.communicate(timeout=600)
        check(rig.gen.returncode == 0,
              f"clients: main.py clients failed:\n{err}")
        want = codegen.generate_all()
        got = sorted(str(p.relative_to(f"{tmp}/gen"))
                     for p in Path(f"{tmp}/gen").rglob("*") if p.is_file())
        check(got == sorted(want), "clients: main.py clients wrote "
              f"{len(got)} files, the generator has {len(want)}")
        for rel in want:
            check((Path(tmp) / "gen" / rel).read_bytes()
                  == (root / "clients" / rel).read_bytes(),
                  f"clients: generated {rel} differs from the committed one")
        phase_s["generate"] = time.perf_counter() - t

        # (e) SIGTERM
        for name, srv in servers.items():
            srv.stop("term")
            check(srv.info("error") is None,
                  f"clients: the {name} server failed:\n{srv.info('error')}")
        ex = servers["card"].info("exit")
        check(ex is not None and ex["rc"] == 0,
              f"clients: the card's server exited with {ex}")
        launches, seq_by_kind = ex["launches"], ex["seq_by_kind"]
        check(not cuda or (launches[0] > 0 and launches[1] > 0),
              f"clients: the card's server launched {launches}")
    finally:
        for c in clients:
            c.close()
        rig.close()

    def by_kind(name) -> dict:
        out: dict = {}
        for (kind, _, _), ms in zip(requests, latency[name]):
            out.setdefault(kind, []).append(ms)
        return out

    card, twin = by_kind("card"), by_kind("twin")

    def spread(ms) -> dict:
        """p50, p99 and max, and the three slowest as (their place among
        the requests of the kind, ms)."""
        slowest = sorted(range(len(ms)), key=ms.__getitem__)[::-1][:3]
        return dict(n=len(ms), p50=float(np.percentile(ms, 50)),
                    p99=float(np.percentile(ms, 99)), max=float(max(ms)),
                    slowest=[(k, float(ms[k])) for k in slowest])

    numbers = dict(
        accounts=n_accounts, bodies=n_bodies, events_per_body=body,
        small_requests=n_small, n_lookups=n_lookups,
        requests=len(requests), files_generated=len(want),
        small_latency_ms=spread(card["small"]),
        warm_up_ms=card["warm_up"][0],
        body_latency_ms=card["body"],
        account_body_latency_ms=card["accounts"],
        lookup_latency_ms={k: card[k][0] for k in (
            "lookup_accounts", "lookup_transfers")},
        twin_small_latency_ms=spread(twin["small"]),
        launches=list(launches), seq_by_kind=seq_by_kind,
        phase_seconds=phase_s,
        elapsed_s=time.perf_counter() - t_phase, card=card_line_or_cpu(dev))
    s = numbers["small_latency_ms"]
    print(f"clients: {len(requests)} requests; one-transfer p50 "
          f"{s['p50']:.1f} ms, p99 {s['p99']:.1f} ms, max {s['max']:.1f} ms "
          f"over {n_small} (slowest "
          f"{[(k, round(ms, 1)) for k, ms in s['slowest']]}; warm-up "
          f"{numbers['warm_up_ms']:.1f} ms); a "
          f"{body}-transfer body {min(card['body']):.1f}-"
          f"{max(card['body']):.1f} ms; server launches {launches} "
          f"({numbers['card']})", flush=True)
    return numbers


# ------------------------------------------------------------- static

ST_CAPTURE_WIDTHS = (4, 8)   # retrace.capture_probe's default widths


def _static_main(send, device: str, status_path: str,
                 threads: int) -> None:
    """A child process: the static leg on `device` with `threads` intra-op
    threads. Sends ("ok", the status, the child's seconds, the kernels'
    launches in it, create_seq's by kernel) or ("error", the traceback)."""
    import traceback

    try:
        t = time.perf_counter()
        torch.set_num_threads(threads)
        from tigerbeetle_tpu_torch.testing import static_smoke as SS

        _zero_launches()
        status = SS.static_smoke(status_path=status_path, device=device)
        send.send(("ok", status, time.perf_counter() - t, _launch_counts(),
                   _seq_by_kind()))
    except BaseException:
        send.send(("error", traceback.format_exc()))


class StaticChild:
    """The static leg (`_static_main`) in a child process on `dev`,
    beside the phases the script runs meanwhile, with this process's
    intra-op threads (a spawned child would otherwise take one a core);
    finish() waits for it and returns (status, the child's seconds, its
    launches), failing the phase if it failed."""

    def __init__(self, dev):
        import multiprocessing

        fd, self.path = tempfile.mkstemp(prefix="tb_static_",
                                         suffix=".json")
        os.close(fd)
        ctx = multiprocessing.get_context("spawn")
        self.recv, send = ctx.Pipe(duplex=False)
        self.proc = ctx.Process(target=_static_main, daemon=True,
                                args=(send, str(torch.device(dev)),
                                      self.path, torch.get_num_threads()))
        self.proc.start()
        send.close()

    def finish(self) -> tuple:
        try:
            msg = (self.recv.recv() if self.recv.poll(900) else
                   ("error", "no answer in 900 s"))
        except EOFError:
            msg = ("error", f"the child exited with {self.proc.exitcode}")
        finally:
            self.proc.join(60)
            if self.proc.is_alive():
                self.proc.kill()
                self.proc.join()
            os.unlink(self.path)
        check(msg[0] == "ok", f"static leg failed:\n{msg[1]}")
        return msg[1:]


def static_phase(dev, child: StaticChild = None) -> dict:
    """The static leg's verdict (`child`'s, or a child started here):
    every pass clean and every negative proof red (static_smoke raises
    otherwise); the capture probe's keys eager once, then on the card
    captured once and replayed, with the launches `window_launches`
    predicts for its eager windows and captures; the census of
    create_transfers_fast launching (on the card) and calling what a
    plain tier run predicts. Returns the per-pass finding counts, the
    negative proofs, the capture counters, the census and the seconds."""
    t = time.perf_counter()
    if child is None:
        child = StaticChild(dev)
    status, child_s, launches, seq_by_kind = child.finish()
    cuda = torch.device(dev).type == "cuda"
    passes = {k: v["n_findings"] for k, v in status["passes"].items()}
    check(set(passes) == {"determinism", "host", "retrace", "sharding"}
          and not any(passes.values()),
          f"static: findings by pass {passes}")
    check(len(status["negatives"]) == 7 and all(status["negatives"].values()),
          f"static: negative proofs {status['negatives']}")
    check(status["n_entries"] == 18,
          f"static: {status['n_entries']} registry entries, not 18")
    cap = status["capture"]
    predicted = [0, 0]
    w0, w1 = ST_CAPTURE_WIDTHS
    for route in ("chain", "super"):
        first, second = (cap[repr((route, w, 1024))] for w in (w0, w1))
        want = ({"eager": 1, "captures": 1, "replays": 2} if cuda
                else {"eager": 3, "captures": 0, "replays": 0})
        check(first == want and second == {"eager": 1, "captures": 0,
                                           "replays": 0},
              f"static: capture counts of {route}: {first}, {second}")
        for w, calls in ((w0, first["eager"] + first["captures"]),
                         (w1, 1)):
            per = window_launches(route, w)
            predicted = [predicted[i] + calls * per[i] for i in range(2)]
    got = [cap["launches"]["ht_probe"], cap["launches"]["row_gather"]]
    check(cap["drops"] == 0 and got == (predicted if cuda else [0, 0]),
          f"static: capture probe drops {cap['drops']}, launches {got}, "
          f"predicted {predicted}")
    census = status["census"]["create_transfers_fast"]
    plain = {"ht_probe": PROBES_PER_RUN["plain"],
             "row_gather": GATHERS_PER_RUN["plain"]}
    check(census["kernel_calls"] == plain and census["launches"] == (
        plain if cuda else {"ht_probe": 0, "row_gather": 0}),
        f"static: census of create_transfers_fast calls "
        f"{census['kernel_calls']}, launches {census['launches']}")
    numbers = dict(
        findings=passes, negatives=status["negatives"],
        n_entries=status["n_entries"], tracebudget=status["tracebudget"],
        capture=cap, capture_predicted=predicted,
        census=census, launches=list(launches), seq_by_kind=seq_by_kind,
        child_s=child_s,
        wait_s=time.perf_counter() - t, card=card_line_or_cpu(dev))
    print(f"static: 4 passes clean over {status['n_entries']} entries, "
          f"{len(status['negatives'])} negatives red, capture launches "
          f"{got} (predicted {predicted}), census launches "
          f"{census['launches']}; the child {child_s:.1f} s, waited "
          f"{numbers['wait_s']:.1f} s ({numbers['card']})", flush=True)
    return numbers


# ------------------------------------------------------------ gate legs

GL_LEGS = ("chain", "partitioned_chain", "overlap", "reshard", "telemetry",
           "overload", "observatory")
# The two legs run again at full width; the overlap leg at 5 windows of 4
# prepares (its poisoned window the fourth), without its partitioned arm,
# and at SV_BODY events a prepare: its poisoned prepare takes one more.
GL_FULL = {"chain_full": ("chain", dict(batch=BATCH, caps=(A_CAP, T_CAP))),
           "overlap_full": ("overlap", dict(batch=SV_BODY,
                                            caps=(A_CAP, T_CAP), windows=5,
                                            partitioned=False))}
# (probe, row gather) kernels each run makes (`KernelCalls` on the CPU at
# the JAX sizes; tests/test_torch_gate_legs*.py hold the CPU to them): on
# the card the kernels it runs, launches less those recorded into graphs
# plus those the replays ran. The full-width runs make the calls of the
# same runs at the JAX prepare size (the overlap leg's at 5 windows), as
# a batch's kernel calls do not depend on its size. The overload leg has
# none: its plane's shed level reads the ledger's host stall fraction, a
# wall clock, so its windows' shapes, and its kernels, vary run to run.
GL_RUNS = {"chain": (43, 176), "partitioned_chain": (62, 1496),
           "overlap": (90, 1094), "reshard": (66, 1573),
           "chain_full": (43, 176), "overlap_full": (56, 228)}
# The overhead legs' calls grow with the on/off pairs they time: the card
# times GL_PAIRS (their modules' OVERHEAD_PAIRS), the CPU fewer.
GL_PAIRS = {"telemetry": 16, "observatory": 20}
GL_BASE = {"telemetry": (26, 575), "observatory": (22, 84)}
GL_PER_PAIR = {"telemetry": (8, 272), "observatory": (34, 132)}


def gl_calls(name: str, pairs: int | None = None):
    """The (probe, row gather) kernels run `name` makes; an overhead leg's
    with `pairs` timed pairs and its warm pair (None: the card's); None
    for a run with no prediction."""
    if name not in GL_PER_PAIR:
        return GL_RUNS.get(name)
    pairs = GL_PAIRS[name] if pairs is None else pairs
    return tuple(b + p * (pairs + 1)
                 for b, p in zip(GL_BASE[name], GL_PER_PAIR[name]))


class KernelCalls:
    """While entered, counts (probe, row gather) wrapper calls that launch
    a kernel on the card: not a call whose every segment is empty (no
    rows, or no 32-bit word a row), nor one that builds a partitioned
    state on the host (`partitioned._chunk_insert`, under `from_oracle`:
    its tensors are the host's on the card too). On the card they equal
    the kernels run; on the CPU they predict them."""

    def __enter__(self):
        from tigerbeetle_tpu_torch.ops import fused_probe, row_gather

        self.calls = [0, 0]
        self._mods = (fused_probe, row_gather)
        probe, gather = fused_probe._probe_multi, row_gather._gather_multi
        self._saved = (probe, gather)

        def host_built() -> bool:
            f = sys._getframe(2)
            while f is not None:
                if f.f_code.co_name == "_chunk_insert":
                    return True
                f = f.f_back
            return False

        def counted_probe(segments):
            segments = list(segments)
            self.calls[0] += bool(
                any(k_hi.shape[0] for _, k_hi, _ in segments)
                and not host_built())
            return probe(segments)

        def counted_gather(tables, rows, masks):
            ts, rs, _ = row_gather._segments(tables, rows, masks)
            self.calls[1] += bool(
                any(r.shape[0] and t.shape[1] * t.element_size() // 4
                    for t, r in zip(ts, rs)) and not host_built())
            return gather(tables, rows, masks)

        fused_probe._probe_multi = counted_probe
        row_gather._gather_multi = counted_gather
        return self

    def __exit__(self, *exc):
        self._mods[0]._probe_multi, self._mods[1]._gather_multi = self._saved
        return False


def _ran_counts() -> tuple:
    """(probe, row gather) kernels the card ran so far: the wrappers'
    launches less those recorded into graphs, plus the replays'."""
    from tigerbeetle_tpu_torch.ops import window_graph as WG

    p, g, _ = _launch_counts()
    return (p - WG.CAPTURED[0] + WG.REPLAYED[0],
            g - WG.CAPTURED[1] + WG.REPLAYED[1])


def _gate_numbers(name: str, out: dict) -> dict:
    """The numbers a leg's summary is read for."""
    if name.startswith("chain"):
        return {arm: {k: out[arm]["pipelined"][k]
                      for k in ("host_fallbacks", "routes")}
                for arm in ("clean", "poisoned")}
    if name == "partitioned_chain":
        return {str(n): {k: out[n][k] for k in (
                    "routes", "chain_batch_fallbacks", "escalations",
                    "cross_shard_transfers")}
                for n in out if n != "budget"}
    if name.startswith("overlap"):
        nums = {k: out[k] for k in ("fraction", "sync_fraction", "fallbacks",
                                    "routes")}
        nums["staging"] = out["staging"]
        if "partitioned" in out:
            nums["partitioned_fraction"] = out["partitioned"]["fraction"]
        return nums
    if name == "reshard":
        return {"windows": {n: out[n]["windows"] for n in out
                            if n != "negative"},
                "abort": out["negative"]["abort"],
                "artifacts": out["negative"]["artifacts"]}
    if name == "telemetry":
        return {"census": out["census"], "overhead": out["overhead"],
                "negative_reds": len(out["negative_reds"])}
    if name == "overload":
        return {"conservation": out["conservation"],
                "p99_ms": {c: v["admit_wait_ms"]["p99"]
                           for c, v in out["classes"].items()},
                "negative_worst_p99_ms": out["negative_worst_p99_ms"]}
    return {"routes": out["profiler"]["routes"],
            "fractions": out["profiler"]["fractions"],
            "overhead": out["overhead"], "leak_reds":
                out["memwatch"]["leak_reds"]}


# The runs that wait until the host is the child's alone: the overlap
# leg at the JAX sizes, whose 128-event packs (~60 small numpy ops under
# the GIL) hide only if the stager thread gets a core while the dispatch
# path waits ~1 ms on the device. On an H100's 8-core host, beside the
# durable phase's CPU twins it read stall 0.8787 once (0.0942-0.3674 in
# other runs), beside the partitioned phase 0.2317; the full-width run's
# packs are bulk copies that leave the GIL, and the overhead legs time
# both arms in turns.
GL_ALONE = ("overlap",)


def gate_legs_run(device, legs=GL_LEGS, full=GL_FULL,
                  budget: bool = True, quiet=None) -> dict:
    """The gate legs on `device`, each timed and its kernels counted
    (`launches` the wrappers', `ran` what the device ran), then the
    `full` runs, then the op budget: the census of every tier, held to
    the committed pins and linted. With `quiet` (an event), the runs of
    GL_ALONE come after the op budget, once it is set (`quiet_wait_s` the
    seconds spent waiting). Raises on a failed leg."""
    from tigerbeetle_tpu_torch.testing import (
        chain_smoke, observatory_smoke, overlap_smoke, overload_smoke,
        partitioned_chain_smoke, reshard_smoke, telemetry_smoke)
    from tigerbeetle_tpu_torch.torchhound import opbudget as OB

    fns = {"chain": chain_smoke.chain_smoke,
           "partitioned_chain": partitioned_chain_smoke.partitioned_chain_smoke,
           "overlap": overlap_smoke.overlap_smoke,
           "reshard": reshard_smoke.reshard_smoke,
           "telemetry": telemetry_smoke.telemetry_smoke,
           "overload": overload_smoke.overload_smoke,
           "observatory": observatory_smoke.observatory_smoke}
    runs = [(n, n, {}) for n in legs] + [(n, leg, kw) for n, (leg, kw)
                                         in full.items()]
    alone = [r for r in runs if quiet is not None and r[0] in GL_ALONE]
    out = {}

    def run(name, leg, kw) -> None:
        l0, r0 = _launch_counts()[:2], _ran_counts()
        t = time.perf_counter()
        with KernelCalls() as kc:
            summary = fns[leg](device, **kw)
        out[name] = dict(
            seconds=time.perf_counter() - t,
            launches=[a - b for a, b in zip(_launch_counts()[:2], l0)],
            ran=[a - b for a, b in zip(_ran_counts(), r0)],
            calls=kc.calls, numbers=_gate_numbers(name, summary))

    for r in runs:
        if r not in alone:
            run(*r)
    if budget:
        l0 = _launch_counts()[:2]
        t = time.perf_counter()
        current, traces = OB.census_tiers(device, with_traces=True)
        tel = OB.telemetry_report(device, traces)
        cuda = torch.device(device).type == "cuda"
        out["opbudget"] = dict(
            seconds=time.perf_counter() - t, tiers=len(current),
            check=(OB.check_budgets(current, on_card=cuda)
                   + OB.check_telemetry(tel)),
            lint=OB.run_lints(traces), telemetry=tel,
            launches=[a - b for a, b in zip(_launch_counts()[:2], l0)])
    if alone:
        t = time.perf_counter()
        if not quiet.wait(900):
            raise RuntimeError("gate: no quiet signal in 900 s")
        out["quiet_wait_s"] = time.perf_counter() - t
        for r in alone:
            run(*r)
    return out


def _gate_main(send, device: str, legs, full, budget: bool, quiet,
               threads: int) -> None:
    """A child process: `gate_legs_run` on `device` with `threads`
    intra-op threads. Sends ("ok", the legs' results, the child's
    seconds) or ("error", the traceback)."""
    import traceback

    try:
        t = time.perf_counter()
        torch.set_num_threads(threads)
        out = gate_legs_run(device, legs, full, budget, quiet)
        send.send(("ok", out, time.perf_counter() - t))
    except BaseException:
        send.send(("error", traceback.format_exc()))


class GateChild:
    """The gate legs (`_gate_main`: `legs`, the `full` runs, the op budget
    if `budget`) in a child process on `dev`, beside the phases the script
    runs meanwhile, with this process's intra-op threads (as
    `StaticChild`). finish() lets its runs of GL_ALONE go, so that they
    run while the script waits for the child, the host its own, and
    returns (the legs' results, the child's seconds), failing the phase
    if a leg failed."""

    def __init__(self, dev, legs=GL_LEGS, full=GL_FULL, budget: bool = True):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.recv, send = ctx.Pipe(duplex=False)
        self._quiet = ctx.Event()
        self.proc = ctx.Process(target=_gate_main, daemon=True,
                                args=(send, str(torch.device(dev)), legs,
                                      full, budget, self._quiet,
                                      torch.get_num_threads()))
        self.proc.start()
        send.close()

    def finish(self) -> tuple:
        self._quiet.set()
        try:
            msg = (self.recv.recv() if self.recv.poll(900) else
                   ("error", "no answer in 900 s"))
        except EOFError:
            msg = ("error", f"the child exited with {self.proc.exitcode}")
        finally:
            self.proc.join(60)
            if self.proc.is_alive():
                self.proc.kill()
                self.proc.join()
        check(msg[0] == "ok", f"gate legs failed:\n{msg[1]}")
        return msg[1:]


def gate_phase(dev, child: GateChild = None) -> dict:
    """The gate legs' verdict (`child`'s, or a child started here): every
    leg passed (the legs raise otherwise: negatives red, histories equal
    to the oracle's, on the card the stall fraction under the ceiling and
    the overhead ratios within their bounds); on the card each run's
    kernels equal to `gl_calls`; the op budget green and its lints clean,
    every tier's launches its kernel calls. Prints a line a leg."""
    t = time.perf_counter()
    if child is None:
        child = GateChild(dev)
    res, child_s = child.finish()
    cuda = torch.device(dev).type == "cuda"
    misses = []
    for name, r in res.items():
        if name in ("opbudget", "quiet_wait_s"):
            continue
        pred = gl_calls(name)
        want = list(pred) if pred is not None else None
        # A call launches once on the card (a replay runs a window's
        # kernels with no call); the kernels run are the CPU's calls.
        if r["launches"] != (r["calls"] if cuda else [0, 0]):
            misses.append(f"{name}: launches {r['launches']} for calls "
                          f"{r['calls']}")
        got = r["ran"] if cuda else r["calls"]
        if want is not None and got != want:
            misses.append(f"{name}: kernels {got}, predicted {want}")
        nums = r["numbers"]
        extra = ""
        if name.startswith("overlap"):
            extra = (f", stall fraction {nums['fraction']} (sync arm "
                     f"{nums['sync_fraction']})")
        elif name in ("telemetry", "observatory"):
            extra = (f", overhead ratio {nums['overhead']['ratio']:.4f} "
                     f"(bound {nums['overhead']['ratio_max']})")
        print(f"gate {name}: {r['seconds']:.1f} s, kernels ran {r['ran']} "
              f"(predicted {want}), calls {r['calls']}, launches "
              f"{r['launches']}{extra}", flush=True)
    check(not misses, "gate: " + "; ".join(misses))
    ob = res["opbudget"]
    # On the card check_budgets also reds a tier whose launches differ
    # from its kernel calls.
    check(not ob["check"] and not ob["lint"],
          f"gate opbudget: check {ob['check']}, lint {ob['lint']}")
    print(f"gate opbudget: {ob['tiers']} tiers within the committed budget, "
          f"each tier's launches its kernel calls, lints clean, telemetry "
          f"lanes {ob['telemetry']['lanes']}, launches {ob['launches']}, "
          f"{ob['seconds']:.1f} s", flush=True)
    quiet_wait = res.pop("quiet_wait_s", None)
    launches = [sum(r["launches"][i] for r in res.values())
                for i in range(2)]
    numbers = dict(legs=res, launches=launches, child_s=child_s,
                   wait_s=time.perf_counter() - t, quiet_wait_s=quiet_wait,
                   card=card_line_or_cpu(dev))
    held = ("" if quiet_wait is None else
            f", its overlap run held {quiet_wait:.1f} s until the script "
            "waited for it")
    print(f"gate: {len(res) - 1} runs passed, the child {child_s:.1f} s"
          f"{held}, waited {numbers['wait_s']:.1f} s ({numbers['card']})",
          flush=True)
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
    phase_seconds, marks = {}, [t0]

    def lap(name) -> None:
        marks.append(time.perf_counter())
        phase_seconds[name] = marks[-1] - marks[-2]

    build_all()
    lap("build_all")
    probe_fx = probe_fixtures(dev)
    gather_fx = gather_fixtures(dev)
    probe = probe_phase(probe_fx)
    gather = gather_phase(gather_fx)
    del probe_fx, gather_fx
    lap("probe_gather_phases")
    launches, c2_gathers, main_probe_ms, c2 = main_path_phase(dev)
    lap("main_path_phase")
    c4 = config4_phase(dev)
    lap("config4_phase")
    x_launches, exact = exact_path_phase(dev)
    lap("exact_path_phase")
    seq = seq_phase(dev)
    lap("seq_phase")
    w2 = config2_window_phase(dev)
    lap("config2_window_phase")
    w4 = config4_window_phase(dev)
    lap("config4_window_phase")
    wfb = window_fallback_phase(dev)
    lap("window_fallback_phase")
    imp = imported_phase(dev)
    lap("imported_phase")
    bal = balancing_phase(dev)
    lap("balancing_phase")
    srv = serving_phase(dev)
    lap("serving_phase")
    sup = supervisor_phase(dev)
    lap("supervisor_phase")
    # The static leg and the gate legs run in child processes on the card
    # from here on, beside the durable phase's host-bound work.
    static_child = StaticChild(dev)
    gate_child = GateChild(dev)
    dur = durable_phase(dev)
    lap("durable_phase")
    rep = replica_phase(dev)
    lap("replica_phase")
    bm = benchmark_phase(dev)
    lap("benchmark_phase")
    drv = drivers_phase(dev, bm)
    lap("drivers_phase")
    obs = observatory_phase(dev)
    lap("observatory_phase")
    shd = sharded_phase(dev)
    lap("sharded_phase")
    prt = partitioned_phase(dev)
    lap("partitioned_phase")
    # The clients phase's servers come up while the two phases before it
    # run.
    rig = ClientsRig(dev)
    try:
        rsh = reshard_phase(dev)
        lap("reshard_phase")
        tcv = trace_coverage_phase(dev)
        lap("trace_coverage_phase")
        cli = clients_phase(dev, rig)
        lap("clients_phase")
    finally:
        rig.close()
    stc = static_phase(dev, static_child)
    lap("static_phase")
    gate = gate_phase(dev, gate_child)
    lap("gate_phase")
    twins = seq.pop("plain_twin")
    plain_ms, err = twins.finish()
    for name, (a_ms, a_err) in twins.accounts.items():
        seq["accounts"][name].update(plain_ms=a_ms, max_abs_err=a_err)
    seq.update(plain_ms=plain_ms, max_abs_err=max(seq["max_abs_err"], err))
    print(f"sequential kernels: plain twins {plain_ms:.0f} ms (transfers), "
          + ", ".join(f"{v['plain_ms']:.0f} ms (accounts, {k})"
                      for k, v in seq["accounts"].items())
          + " on the CPU, equal to the kernels", flush=True)
    lap("seq_plain_twin")
    phase_seconds["total"] = time.perf_counter() - t0
    print(f"all phases passed in {phase_seconds['total']:.1f} s",
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
        # The durable phase's: the card's device tiers, its windows'
        # eager runs and captures, and the write-through delta gathers.
        "launches_durable": dur["launches"][0],
        # The replica phase's: the server's (its device engine, both
        # runs of the child) and the 3-replica cluster's on the card.
        "launches_replica_server": rep["launches"][0],
        "launches_replica": rep["launches_replica"][0],
        # The benchmark phase's: counted (eager windows, captures, the
        # per-batch and serving runs); ran adds the window replays.
        "launches_benchmark": bm["launches"][0],
        "ran_benchmark_windows": bm["launches_ran_windows"][0],
        # The drivers phase's: its device-engine VOPR seeds and the
        # device_ledger fuzzer.
        "launches_drivers": drv["launches"][0],
        # The observatory phase's profiled full-width windows (the
        # supervisor's path; its cost model's scratch runs apart, below);
        # the sharded phase's router steps on meshes of 1 and 8.
        "launches_observatory": obs["launches"][0],
        "launches_cost_model": sum(
            r["launches"]["ht_probe"]
            for r in obs["profiler"]["cost_model"].values()),
        "launches_sharded": shd["launches"][0],
        # The partitioned phase's: its chain windows (eager and capture;
        # replays in ran_partitioned_windows), per-batch steps and
        # replays, as partitioned_launches predicts.
        "launches_partitioned": prt["launches"][0],
        "ran_partitioned_windows": prt["graph_ran"][0],
        # The reshard phase's (a) and (b): its windows' eager runs and
        # captures under each overlay (the judge's probe; the resharding
        # kernels launch none); the two-process leg's, its two workers'
        # sum.
        "launches_reshard": rsh["launches"][0],
        "launches_reshard_two_process": rsh["two_process"]["launches"][0],
        # The trace-coverage gate's scenarios on the card; the clients
        # phase's server (its device engine).
        "launches_trace_coverage": tcv["launches"][0],
        "launches_clients_server": cli["launches"][0],
        # The static leg's child process: its census, capture probe and
        # registry runs on the card.
        "launches_static": stc["launches"][0],
        # The gate legs' child: its legs, full-width runs and op budget.
        "launches_gate": gate["launches"][0],
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
        "launches_durable": dur["launches"][1],
        "launches_replica_server": rep["launches"][1],
        "launches_replica": rep["launches_replica"][1],
        "launches_benchmark": bm["launches"][1],
        "ran_benchmark_windows": bm["launches_ran_windows"][1],
        "launches_drivers": drv["launches"][1],
        "launches_observatory": obs["launches"][1],
        "launches_cost_model": sum(
            r["launches"]["row_gather"]
            for r in obs["profiler"]["cost_model"].values()),
        "launches_sharded": shd["launches"][1],
        "launches_partitioned": prt["launches"][1],
        "ran_partitioned_windows": prt["graph_ran"][1],
        # The reshard phase's (a) and (b): its windows' and the resharding
        # kernels' (RESHARD_GATHERS); the two-process leg's.
        "launches_reshard": rsh["launches"][1],
        "launches_reshard_two_process": rsh["two_process"]["launches"][1],
        "launches_trace_coverage": tcv["launches"][1],
        "launches_clients_server": cli["launches"][1],
        "launches_static": stc["launches"][1],
        "launches_gate": gate["launches"][1],
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
        # No Pallas counterpart: the JAX package's XLA sequential
        # create_transfers kernel. ms / plain_ms / bound_ms: one
        # 8,190-event config-3 batch (device time from the kernel's own
        # %globaltimer stamps; the plain twin on the CPU, host clock);
        # stage_ms: its stage split (the same stamps); config4_ms: the
        # config-4 pend and post/void batches; kernel_ms / prefetch_ms /
        # apply_ms: the spans each
        # run_create_* call recorded (create_seq.SPANS; events in
        # events). launches_*: this kernel's launches in each phase
        # (create_seq.KIND_LAUNCHES); launches_*_both: both sequential
        # kernels' (create_seq.LAUNCHES), which the phases check.
        "name": "create_seq",
        "route": "cuda",
        "source": "tigerbeetle_tpu_torch/csrc/create_seq.cu",
        "replaces": "tigerbeetle_tpu/ops/create_kernels.py:664",
        "launches": seq["launches_by_kind"]["transfers"],
        "launches_seq_both": seq["launches"],
        # The serving phase's "kernel"-engine commits; none on the
        # durable phase (its StateMachine runs the device engine).
        "launches_serving": srv["create_seq_by_kind"]["transfers"],
        "launches_durable": 0,
        "launches_replica": rep["seq_by_kind"]["transfers"],
        # The drivers phase's: its kernel-engine VOPR seeds and the
        # state_machine and storage_faults fuzzers.
        "launches_drivers": drv["seq_by_kind"]["transfers"],
        # The trace-coverage gate's kernel-engine clusters.
        "launches_trace_coverage": tcv["seq_by_kind"]["transfers"],
        "launches_clients_server": cli["seq_by_kind"]["transfers"],
        "launches_static": stc["seq_by_kind"]["transfers"],
        "launches_serving_both": srv["create_seq_launches"],
        "launches_replica_both": rep["launches"][2],
        "launches_drivers_both": drv["launches"][2],
        "launches_trace_coverage_both": tcv["launches"][2],
        "launches_clients_server_both": cli["launches"][2],
        "launches_static_both": stc["launches"][2],
        "max_abs_err": seq["max_abs_err"],
        "ms": seq["ms"],
        "plain_ms": seq["plain_ms"],
        "bound_ms": seq["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "ns_per_event": seq["ns_per_event"],
        "stage_ms": seq["stage_ms"],
        "config4_ms": seq["config4_ms"],
        "kernel_ms": seq["kernel_ms"],
        "events": seq["events"],
        "prefetch_ms": seq["prefetch_ms"],
        "apply_ms": seq["apply_ms"],
    }, {
        # The JAX package's XLA sequential create_accounts kernel. ms /
        # plain_ms / bound_ms / ns_per_event / stage_ms: one batch of
        # 8,190 new accounts (device time and stage split from the
        # kernel's stamps; the plain twin on the CPU, host clock); mixed:
        # the same on an 8,190-event mixed batch (chains, repeated ids,
        # ids the state holds). launches: its run_create_accounts calls
        # on the seq phase's path; launches_*: its launches in each
        # phase (create_seq.KIND_LAUNCHES).
        "name": "create_accounts_seq",
        "route": "cuda",
        "source": "tigerbeetle_tpu_torch/csrc/create_seq.cu",
        "replaces": "tigerbeetle_tpu/ops/create_kernels.py:792",
        "launches": seq["launches_by_kind"]["accounts"],
        "launches_serving": srv["create_seq_by_kind"]["accounts"],
        "launches_durable": 0,
        "launches_replica": rep["seq_by_kind"]["accounts"],
        "launches_drivers": drv["seq_by_kind"]["accounts"],
        "launches_trace_coverage": tcv["seq_by_kind"]["accounts"],
        "launches_clients_server": cli["seq_by_kind"]["accounts"],
        "launches_static": stc["seq_by_kind"]["accounts"],
        "max_abs_err": max(seq["max_abs_err"], *(
            v["max_abs_err"] for v in seq["accounts"].values())),
        "ms": seq["accounts"]["new"]["ms"],
        "plain_ms": seq["accounts"]["new"]["plain_ms"],
        "bound_ms": seq["accounts"]["new"]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "ns_per_event": seq["accounts"]["new"]["ns_per_event"],
        "stage_ms": seq["accounts"]["new"]["stage_ms"],
        "mixed": seq["accounts"]["mixed"],
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
    print(json.dumps({"durable": dur}), flush=True)
    print(json.dumps({"replica": rep}), flush=True)
    print(json.dumps({"benchmark": bm}), flush=True)
    print(json.dumps({"drivers": drv}), flush=True)
    print(json.dumps({"observatory": obs}, default=str), flush=True)
    print(json.dumps({"sharded": shd}, default=str), flush=True)
    print(json.dumps({"partitioned": prt}, default=str), flush=True)
    print(json.dumps({"reshard": rsh}, default=str), flush=True)
    print(json.dumps({"trace_coverage": tcv}), flush=True)
    print(json.dumps({"clients": cli}), flush=True)
    print(json.dumps({"static": stc}), flush=True)
    print(json.dumps({"gate": gate}, default=str), flush=True)
    print(json.dumps({"phase_seconds": phase_seconds}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
