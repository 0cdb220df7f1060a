"""Benchmark harness: workload generation + measurement.

The port's copy of the JAX package's `benchmark.py` (reference:
src/tigerbeetle/benchmark_load.zig — "load accepted ... tx/s"): builds
Zipfian/uniform workloads as SoA arrays, runs them through the device
ledger, and measures accepted transfers / wall time. Seeds, generators,
account counts, ids and amounts are the JAX package's, so both packages
run the same batches.

Every runner takes `device=None`, which means the card (CUDA). On the
card, runs of several batches go through `DeviceLedger.submit_window` /
`resolve_windows`: each window of up to SUPERBATCH_MAX prepares is one
replay of a captured CUDA graph. Packs are staged and warm-up windows
(the eager window and the graph capture) run before the clock starts;
the clock stops once the accepted count has been read back to the host,
which waits for the stream.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .constants import BATCH_MAX, U128_MAX
from .ops.device import resolve_device
from .types import (
    Account,
    AccountFlags,
    Transfer,
    TransferFlags,
)

N = BATCH_MAX


def _soa(ids, dr, cr, amount, flags=None, pid=None, timeout=None):
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
        ud32=z32.copy(),
        timeout=z32.copy() if timeout is None else np.asarray(timeout, dtype=np.uint32),
        ledger=np.ones(n, dtype=np.uint32),
        code=np.ones(n, dtype=np.uint32),
        flags=z32.copy() if flags is None else np.asarray(flags, dtype=np.uint32),
        ts=z.copy(),
    )


# Per-config routing/fallback diagnostics, recorded by each config as it
# finishes. Keyed "configN" -> DeviceLedger.fallback_stats().
CONFIG_DIAGNOSTICS: dict = {}

# Per-config dispatch-route record: the routes the ledger's windows took
# in the timed run (from `led.window_routes`, "per_batch" for one batch a
# dispatch) and the window depths used, so a silent route degradation is
# visible in every run record.
CONFIG_ROUTES: dict = {}


def _record_diag(key, led) -> None:
    CONFIG_DIAGNOSTICS[key] = led.fallback_stats()
    routes = CONFIG_DIAGNOSTICS[key]["routes"]["windows"]
    if routes:
        CONFIG_ROUTES.setdefault(key, {}).update(windows=routes)


def _record_route(key, route, depths) -> None:
    CONFIG_ROUTES[key] = {"route": route,
                          "window_depths": sorted(set(depths))}


def _make_ledger(account_count, a_cap=1 << 15, t_cap=1 << 21, device=None):
    from .ops.ledger import DeviceLedger

    led = DeviceLedger(a_cap=a_cap, t_cap=t_cap, device=device)
    accounts = [Account(id=i, ledger=1, code=1)
                for i in range(1, account_count + 1)]
    for lo in range(0, account_count, BATCH_MAX):
        chunk = accounts[lo:lo + BATCH_MAX]
        led.create_accounts(chunk, timestamp=lo + len(chunk))
    assert led.fallbacks == 0
    return led


# Batches a warm-up runs one batch at a time.
B_CHUNK = 8

# Prepares a window at most (the JAX package's measured knee of the
# window's fixed cost; PERF.md §5 has the card's window times).
SUPERBATCH_MAX = 32


def _superbatch_default(n_batches, device=None):
    """Window depth a dispatch: on the card min(SUPERBATCH_MAX, n_batches)
    (a window is one graph replay, which amortises the host's per-kernel
    issue cost); on the CPU 1, where a window only widens the sorts."""
    if resolve_device(device).type != "cuda":
        return 1
    return min(SUPERBATCH_MAX, n_batches)


def _run_scan(led, evs, ts0, stack=None, diag_key=None):
    """Run batches back to back with no host sync between them; returns
    (accepted, elapsed). Host-side padding and the copies to the device
    are staged before the clock.

    stack=1: the plain tier, one batch a dispatch; the fallback flag
    threads through the dispatches as a device value (force_fallback), so
    a fallback masks every later batch without a per-batch sync, and the
    accepted count sums on the device.

    stack=K: K prepares a window through submit_window (the chain route
    for this traffic; on the card one graph replay a window after the
    warm-up), all windows in flight, then resolve_windows. The first
    window's pinned pack is staged before the clock, each later one on
    the stager thread while the window before it is dispatched; the copy
    of a pack into the graph's input buffer is one non-blocking copy on
    the stream at submit, inside the clock, since every replay of a
    window shape reads the same buffer. A window whose depth differs
    from the first (the tail) is a graph of its own. The routes the
    ledger took land in CONFIG_ROUTES.

    Raises if any batch fell back: the counts would not be the device's."""
    from .ops.fast_kernels import create_transfers_fast
    from .ops.ledger import events_to_device, pad_transfer_events
    from .types import CreateTransferStatus

    stack = stack or _superbatch_default(len(evs), led.device)
    tss = [int(ts0) + i * (N + 10) for i in range(len(evs))]
    fallbacks0 = (led.fallbacks, led.window_fallbacks)
    if stack > 1:
        groups = [(evs[lo:lo + stack], tss[lo:lo + stack])
                  for lo in range(0, len(evs), stack)]
        routes0 = dict(led.window_routes)
        created = int(CreateTransferStatus.created)
        if led.stage_window(*groups[0]):
            led._staged[-1].result()  # the first pack ready before the clock
        t0 = time.perf_counter()
        tickets = []
        for k, (g_evs, g_tss) in enumerate(groups):
            tk = led.submit_window(g_evs, g_tss)
            if tk is None:
                raise RuntimeError("a benchmark window was not eligible "
                                   "for the pipelined route")
            tickets.append(tk)
            if k + 1 < len(groups):
                led.stage_window(*groups[k + 1])
        led.resolve_windows()
        accepted = sum(int((np.asarray(st) == created).sum())
                       for tk in tickets for st, _ in tk.results[1])
        elapsed = time.perf_counter() - t0
        if any(tk.results[0] != "ok" for tk in tickets) or \
                (led.fallbacks, led.window_fallbacks) != fallbacks0:
            raise RuntimeError("unexpected fallback")
        if diag_key is not None:
            routes = {r: c - routes0.get(r, 0)
                      for r, c in led.window_routes.items()
                      if c != routes0.get(r, 0)}
            _record_route(diag_key, "+".join(sorted(routes)),
                          [len(g) for g, _ in groups])
        return accepted, elapsed

    padded = [events_to_device(pad_transfer_events(e), led.device)
              for e in evs]
    if diag_key is not None:
        _record_route(diag_key, "per_batch", [1])
    poisoned = torch.zeros((), dtype=torch.bool, device=led.device)
    accepted_dev = torch.zeros((), dtype=torch.int64, device=led.device)
    t0 = time.perf_counter()
    for e, ev, ts in zip(evs, padded, tss):
        led.state, outs = create_transfers_fast(
            led.state, ev, ts, len(e["id_lo"]), force_fallback=poisoned)
        poisoned = outs["fallback"]
        accepted_dev += outs["created_count"]
    accepted, bad = accepted_dev.item(), bool(poisoned)
    elapsed = time.perf_counter() - t0
    if bad or (led.fallbacks, led.window_fallbacks) != fallbacks0:
        raise RuntimeError("unexpected fallback")
    return int(accepted), elapsed


def _warm_and_run(led, mk, batches, diag_key=None):
    """Warm up the exact window shape the timed run uses outside the
    clock, then measure. On the card a window key's first window runs
    eagerly and its second is captured as a graph, so each warm-up window
    (the full depth, then the tail) runs twice, the second time at later
    timestamps (its transfers then fail as `exists`; the graph does not
    depend on the data). The generator is called in the JAX package's
    order, so the timed batches are its batches."""
    stack = _superbatch_default(batches, led.device)
    warm = stack if stack > 1 else B_CHUNK
    rounds = 2 if stack > 1 else 1
    warm_evs = [mk(b) for b in range(-warm, 0)]
    for r in range(rounds):
        _run_scan(led, warm_evs, np.uint64(10**11 + r * 10**8), stack=stack)
    tail = batches % stack
    if stack > 1 and tail:
        tail_evs = [mk(b) for b in range(-warm - tail, -warm)]
        for r in range(rounds):
            _run_scan(led, tail_evs, np.uint64(10**11 + 10**9 + r * 10**8),
                      stack=tail)
    out = _run_scan(led, [mk(b) for b in range(batches)],
                    np.uint64(10**12), stack=stack, diag_key=diag_key)
    led.shutdown_staging()
    if diag_key is not None:
        _record_diag(diag_key, led)
    return out


def bench_config1(batches, device=None):
    """2 hot accounts, one ledger."""
    led = _make_ledger(2, device=device)
    rng = np.random.default_rng(1)

    def mk(b):
        base = 10**7 + b * N
        ids = np.arange(base, base + N)
        dr = np.full(N, 1)
        cr = np.full(N, 2)
        return _soa(ids, dr, cr, rng.integers(1, 1000, N))

    return _warm_and_run(led, mk, batches, diag_key="config1")


def bench_config2(batches, account_count=10_000, device=None):
    """Uniform random transfers over 10K accounts (fuzz shape)."""
    led = _make_ledger(account_count, device=device)
    rng = np.random.default_rng(2)

    def mk(b):
        base = 10**7 + b * N
        ids = np.arange(base, base + N)
        dr = rng.integers(1, account_count + 1, N, dtype=np.uint64)
        cr = rng.integers(1, account_count + 1, N, dtype=np.uint64)
        clash = dr == cr
        cr[clash] = dr[clash] % account_count + 1
        return _soa(ids, dr, cr, rng.integers(1, 10**6, N))

    return _warm_and_run(led, mk, batches, diag_key="config2")


def bench_config_zipfian(batches, account_count=10_000, theta=0.99,
                         device=None):
    """Zipfian hot accounts — the reference benchmark's default workload
    shape (src/tigerbeetle/benchmark_load.zig:66-77 account_count_hot)."""
    from .utils.zipfian import ZipfianGenerator

    led = _make_ledger(account_count, device=device)
    zipf = ZipfianGenerator(account_count, theta=theta, seed=7)
    rng = np.random.default_rng(7)

    def mk(b):
        base = 10**7 + b * N
        ids = np.arange(base, base + N)
        dr = zipf.draw(N).astype(np.uint64) + 1
        cr = zipf.draw(N).astype(np.uint64) + 1
        clash = dr == cr
        cr[clash] = dr[clash] % account_count + 1
        return _soa(ids, dr, cr, rng.integers(1, 1000, N))

    return _warm_and_run(led, mk, batches, diag_key="zipfian")


def bench_config3(batches, account_count=1000, device=None):
    """Linked chains: all-or-nothing pairs, ~25% of chains failing."""
    led = _make_ledger(account_count, device=device)
    rng = np.random.default_rng(3)
    linked = int(TransferFlags.linked)

    def mk(b):
        base = 10**7 + b * N
        ids = np.arange(base, base + N)
        dr = rng.integers(1, account_count + 1, N, dtype=np.uint64)
        cr = rng.integers(1, account_count + 1, N, dtype=np.uint64)
        clash = dr == cr
        cr[clash] = dr[clash] % account_count + 1
        flags = np.zeros(N, dtype=np.uint32)
        flags[0::2] = linked  # pairs: even=head, odd=terminator
        # poison ~25% of chains: terminator debits a missing account
        bad = rng.random(N // 2) < 0.25
        dr[1::2][bad] = account_count + 10**6
        return _soa(ids, dr, cr, rng.integers(1, 1000, N), flags=flags)

    return _warm_and_run(led, mk, batches, diag_key="config3")


def bench_config4(batches=2, n=None, account_count=64, device=None):
    """Two-phase under balance limits — the hard-semantics config: breach
    batches run the on-device limit fixpoint (ops/fast_kernels.py
    LIMIT_FIXPOINT_ROUNDS); only cascades deeper than the round budget
    would fall back to the exact host path.

    On the card: full protocol-max batches, W_PAIRS pend / post-void
    pairs a window (the super_deep route resolves the in-window pending
    references), two windows in flight; the first two windows (eager,
    then the graph capture) run before the clock. On the CPU: 1,024-event
    batches one at a time. The kernels build at the ledger's first batch
    (create_accounts), so no tier builds inside the clock."""
    from .ops.ledger import DeviceLedger
    from .types import CreateTransferStatus

    on_card = resolve_device(device).type == "cuda"
    if n is None:
        n = N if on_card else 1024

    # Room for (batches + warmup) * 2 * n transfers plus orphan entries
    # (~half of pend events breach): next power of two with 2x headroom.
    need = (batches + 1) * 2 * n * 2
    t_cap = 1 << max(14, (need - 1).bit_length())
    led = DeviceLedger(a_cap=1 << 12, t_cap=t_cap, device=device)
    limit = int(AccountFlags.debits_must_not_exceed_credits)
    accounts = [Account(id=i, ledger=1, code=1,
                        flags=limit if i % 2 == 0 else 0)
                for i in range(1, account_count + 1)]
    led.create_accounts(accounts, timestamp=account_count)
    rng = np.random.default_rng(4)
    pend = int(TransferFlags.pending)
    post = int(TransferFlags.post_pending_transfer)
    void = int(TransferFlags.void_pending_transfer)

    created_code = np.uint32(int(CreateTransferStatus.created))
    # One window shape only: W_PAIRS must divide `batches` (a tail window
    # of another depth would capture a graph inside the timed region).
    W_PAIRS = 1
    if on_card:
        for w in (4, 3, 2):
            if batches % w == 0:
                W_PAIRS = w
                break
    accepted = 0
    ts = 10**12
    next_id = 10**7

    def mk_pair_batches(ts_base):
        nonlocal next_id
        out = []
        pend_base = next_id
        next_id += n
        dr = rng.integers(1, account_count + 1, n, dtype=np.uint64)
        cr = rng.integers(1, account_count + 1, n, dtype=np.uint64)
        clash = dr == cr
        cr[clash] = dr[clash] % account_count + 1
        ev = _soa(np.arange(pend_base, pend_base + n), dr, cr,
                  rng.integers(1, 100, n),
                  flags=np.full(n, pend, dtype=np.uint32))
        out.append((ev, ts_base + n + 10))
        even = np.arange(n) % 2 == 0
        rev = _soa(np.arange(next_id, next_id + n),
                   np.zeros(n, dtype=np.uint64),
                   np.zeros(n, dtype=np.uint64),
                   np.where(even, np.uint64(U128_MAX & ((1 << 64) - 1)),
                            np.uint64(0)),
                   flags=np.where(even, post, void).astype(np.uint32),
                   pid=np.arange(pend_base, pend_base + n))
        rev["amt_hi"] = np.where(even, np.uint64(U128_MAX >> 64),
                                 np.uint64(0))
        rev["ledger"] = np.zeros(n, dtype=np.uint32)  # inherit from pending
        rev["code"] = np.zeros(n, dtype=np.uint32)
        next_id += n
        out.append((rev, ts_base + 2 * (n + 10)))
        return out

    def ticket_created(tk):
        outcome, res = tk.results
        if outcome != "ok":
            raise RuntimeError("config4 window fell back")
        return sum(int((np.asarray(st) == created_code).sum())
                   for st, _ in res)

    # Depth-2 pipelined windows (card): submit window k+1 before
    # resolving k. Two warm-up windows (the eager one and the graph
    # capture) run before the clock starts.
    t0 = None
    pending: list = []
    warmup_left = 2 if W_PAIRS > 1 else 1
    b = 0
    while b < batches or warmup_left:
        if warmup_left == 0 and t0 is None:
            led.resolve_windows()
            pending.clear()  # warmup events don't count
            accepted = 0
            t0 = time.perf_counter()
        pairs = W_PAIRS if warmup_left else min(W_PAIRS, batches - b)
        window = []
        for _ in range(pairs):
            window.extend(mk_pair_batches(ts))
            ts += 2 * (n + 10)
        if W_PAIRS > 1:
            tk = led.submit_window(
                [ev for ev, _ in window], [t for _, t in window])
            if tk is None:
                raise RuntimeError("config4 window unexpectedly ineligible")
            pending.append(tk)
            if len(pending) > 1:
                led.resolve_windows(count=1)
                accepted += ticket_created(pending.pop(0))
        else:
            for ev, ts_b in window:
                st, _ = led.create_transfers_soa(ev, ts_b)
                accepted += int((np.asarray(st) == created_code).sum())
        if warmup_left:
            warmup_left -= 1
        else:
            b += pairs
    led.resolve_windows()
    for tk in pending:
        accepted += ticket_created(tk)
    elapsed = time.perf_counter() - t0
    _record_diag("config4", led)
    return accepted, elapsed


def bench_config6_serving(batches=24, account_count=10_000, device=None):
    """The database serving path: the same boundary a replica commits
    through — StateMachine(engine='device').commit() with multi-batch
    wire bodies — so the benched engine IS the served engine. Covers body
    decode, the device tiers, the write-through host mirror, and result
    encode (reference: execute path src/state_machine.zig:2564 +
    benchmark_load.zig)."""
    from . import multi_batch
    from .state_machine import StateMachine
    from .trace.histogram import Histogram
    from .types import Operation

    sm = StateMachine(engine="device", a_cap=1 << 15, t_cap=1 << 19,
                      device=device)
    rng = np.random.default_rng(6)
    ts = 1000
    accounts = [Account(id=i, ledger=1, code=1)
                for i in range(1, account_count + 1)]
    for lo in range(0, account_count, N):
        chunk = accounts[lo:lo + N]
        ts += len(chunk) + 10
        sm.create_accounts(chunk, ts)

    # One trailer element (128 B) rides in the 1 MiB body, so a single
    # multi-batch holds N-1 events (reference: batch_max derivation,
    # src/state_machine.zig:336-380).
    nb = N - 1

    def mk_body(base):
        dr = rng.integers(1, account_count + 1, nb, dtype=np.uint64)
        cr = rng.integers(1, account_count + 1, nb, dtype=np.uint64)
        clash = dr == cr
        cr[clash] = dr[clash] % account_count + 1
        amt = rng.integers(1, 10**6, nb)
        payload = b"".join(
            Transfer(id=int(base + i), debit_account_id=int(dr[i]),
                     credit_account_id=int(cr[i]), amount=int(amt[i]),
                     ledger=1, code=1).pack()
            for i in range(nb))
        return multi_batch.encode([payload], 128)

    next_id = 10**7
    bodies = []
    for _ in range(batches + 1):
        bodies.append(mk_body(next_id))
        next_id += nb

    # Serving commits a window of committed prepares a dispatch when a
    # backlog exists (commit_window; the reference's pipeline admits 8
    # prepares in flight, src/config.zig:155). Latency is recorded per
    # WINDOW (submit -> resolve wall) into a log2 histogram.
    W = 1
    if resolve_device(device).type == "cuda":
        for w in (8, 4, 2):
            if batches % w == 0:
                W = w
                break
    ts += nb + 10
    sm.commit(Operation.create_transfers, bodies[0], ts)  # warm-up
    if W > 1:
        # Two pipelined windows before the clock: the first runs its
        # route eagerly, the second captures its graph.
        for _ in range(2):
            wts = []
            for _ in range(W):
                ts += nb + 10
                wts.append(ts)
            rec = sm.submit_commit_window(
                Operation.create_transfers,
                [mk_body(next_id + i * nb) for i in range(W)], wts)
            assert rec is not None
            next_id += W * nb
        sm.resolve_commit_windows()

    n_before = len(sm.state.transfers)
    hist = Histogram()  # per-window latency, milliseconds
    t0 = time.perf_counter()
    if W > 1:
        # Depth-2 pipelined serving: submit window k+1 before resolving
        # window k. One histogram sample per window.
        def note_done(done_recs):
            now = time.perf_counter()
            for done in done_recs:
                hist.record((now - done["_tb"]) * 1000)

        wins = []
        for lo in range(1, len(bodies), W):
            window = bodies[lo:lo + W]
            wts = []
            for _ in window:
                ts += nb + 10
                wts.append(ts)
            wins.append((window, wts))
        for i, (window, wts) in enumerate(wins):
            tb = time.perf_counter()
            rec = sm.submit_commit_window(
                Operation.create_transfers, window, wts)
            if rec is None:
                note_done(sm.resolve_commit_windows())
                sm.commit_window(Operation.create_transfers, window, wts)
                hist.record((time.perf_counter() - tb) * 1000)
                continue
            rec["_tb"] = tb
            # Stage window k+1's operand pack now, on the staging worker,
            # while this iteration's resolve waits on window k.
            if i + 1 < len(wins):
                sm.stage_commit_window(
                    Operation.create_transfers, wins[i + 1][0],
                    wins[i + 1][1])
            if len(sm._pending_windows) > 1:
                note_done(sm.resolve_commit_windows(count=1))
        note_done(sm.resolve_commit_windows())
    else:
        for body in bodies[1:]:
            ts += nb + 10
            tb = time.perf_counter()
            sm.commit(Operation.create_transfers, body, ts)
            hist.record((time.perf_counter() - tb) * 1000)
    elapsed = time.perf_counter() - t0
    # The commit path defers mirror materialization (columnar chunks,
    # drained lazily at read boundaries). Time the drain separately.
    td = time.perf_counter()
    sm.led.drain_mirror()
    drain_ms = (time.perf_counter() - td) * 1000
    if sm.led.fallbacks:
        raise RuntimeError("serving bench unexpectedly fell back")
    _record_diag("config6", sm.led)
    accepted = len(sm.state.transfers) - n_before
    latency = None
    if hist.count:
        latency = {
            "p50_ms": round(hist.quantile(0.50), 3),
            "p95_ms": round(hist.quantile(0.95), 3),
            "p99_ms": round(hist.quantile(0.99), 3),
            "p999_ms": round(hist.quantile(0.999), 3),
            "p100_ms": round(hist.max, 3),
            "windows": hist.count,
            "drain_ms_total": round(drain_ms, 1),
            "sustained_tps": round(
                accepted / (elapsed + drain_ms / 1000), 1),
            "histogram": hist.to_dict(),
        }
    sm.led.shutdown_staging()
    return accepted, elapsed, latency


def parity_config5(n_batches=6, batch=256, device=None):
    """Differential check: DeviceLedger vs sequential oracle, mixed workload."""
    from .oracle import StateMachineOracle
    from .ops.ledger import DeviceLedger

    led = DeviceLedger(a_cap=1 << 12, t_cap=1 << 14, device=device)
    sm = StateMachineOracle()
    rng = np.random.default_rng(5)
    accts = [Account(id=i, ledger=1, code=1) for i in range(1, 101)]
    for eng in (led, sm):
        eng.create_accounts(accts, 100)
    ts = 10**12
    next_id = 10**6
    pend = int(TransferFlags.pending)
    post = int(TransferFlags.post_pending_transfer)
    for b in range(n_batches):
        events = []
        for i in range(batch):
            roll = rng.random()
            tid = next_id
            next_id += 1
            if roll < 0.7:
                events.append(Transfer(
                    id=tid, debit_account_id=int(rng.integers(0, 110)),
                    credit_account_id=int(rng.integers(1, 110)),
                    amount=int(rng.integers(0, 1000)), ledger=1,
                    code=int(rng.integers(0, 2))))
            elif roll < 0.85:
                events.append(Transfer(
                    id=tid, debit_account_id=int(rng.integers(1, 101)),
                    credit_account_id=1 + int(rng.integers(1, 100)),
                    amount=int(rng.integers(1, 100)), ledger=1, code=1,
                    flags=pend))
            else:
                events.append(Transfer(
                    id=tid, pending_id=int(rng.integers(10**6, next_id)),
                    amount=U128_MAX, flags=post))
        for e in events:
            # Post/void events legitimately carry zero account ids (sentinel
            # = inherit from the pending transfer); only fix regular events.
            if (e.flags & post) == 0 and e.debit_account_id == e.credit_account_id:
                e.credit_account_id = e.debit_account_id % 100 + 1
        ts += batch + 10
        got = led.create_transfers(events, ts)
        want = sm.create_transfers(events, ts)
        if [(r.timestamp, r.status) for r in got] != [
                (r.timestamp, r.status) for r in want]:
            return False
    host = led.to_host()
    return (host.accounts == sm.accounts and host.transfers == sm.transfers
            and host.pending_status == sm.pending_status
            and host.orphaned == sm.orphaned
            and host.account_events == sm.account_events)


def bench_admission(rounds=24, sessions=100_000, reqs_per_round=96,
                    seed=83, device=None):
    """Sessionized-Zipfian admission bench: the admission plane in front
    of a real ServingSupervisor under an offered load ~2x the pump's
    window capacity, sessions drawn Zipfian-hot from a `sessions`-deep
    population on a deterministic virtual clock.

    The success metric of the serving path under overload is not raw
    tps: it is sustained admitted tps plus per-class admitted queue-wait
    p99 while lower classes shed explicitly. Returns per-class
    admitted/shed-by-reason counts, the shed line reached, queue/credit
    occupancy, conservation, and both virtual-sustained and wall
    events/s."""
    from .admission import AdmissionClass, AdmissionPlane, VirtualClock
    from .serving import ServingSupervisor
    from .trace import Tracer
    from .utils.zipfian import ZipfianGenerator

    n_accounts = 128
    txns_per_req = 4
    tick_s = 0.020
    classes = (
        AdmissionClass("critical", 0, slo_ms=100.0, deadline_ms=400.0),
        AdmissionClass("standard", 1, slo_ms=200.0, deadline_ms=600.0),
        AdmissionClass("batch", 2, slo_ms=300.0, deadline_ms=300.0),
    )
    tracer = Tracer(pid=0)
    clock = VirtualClock()
    sup = ServingSupervisor(a_cap=1 << 10, t_cap=1 << 15,
                            epoch_interval=16, sleep=lambda s: None,
                            seed=seed, tracer=tracer, device=device)
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
    wall_s = time.perf_counter() - t0
    sup.led.shutdown_staging()
    st = plane.stats()
    st["session_population"] = sessions
    st["rounds"] = rounds
    st["offered_events_per_round"] = reqs_per_round * txns_per_req
    st["sustained_admitted_eps_virtual"] = round(
        st["events_admitted"] / (rounds * tick_s), 1)
    st["admitted_eps_wall"] = round(
        st["events_admitted"] / max(wall_s, 1e-9), 1)
    st["wall_s"] = round(wall_s, 3)
    return st
