"""Seeded device-fault injection for the serving pipeline (a port of the
JAX package's `testing/chaos.py`, single-chip scenarios; the mesh
scenarios wait for the port's `parallel/`).

A deterministic `FaultPlan(seed)` injects device-state bit flips,
dispatch failures and timeouts, poisoned delta fetches and forced
fallback storms, and the run is audited end to end against the pure
oracle. The bar is zero silent corruption: for every injected fault the
pipeline either recovers to bit-exact oracle parity (authoritative
history, full state, mirror spot checks at 100% sampling) or fails loudly
with the fault attributed. Deterministic per seed.

Injection points (all at architectural boundaries, none inside a kernel):

  state_bitflip     flip one bit of a digest-covered cell of a live device
                    row between windows (the memory-corruption model), in
                    place: the captured window graphs read the same
                    storage the digest folds.
  dispatch_fail     raise TransientDispatchError at the dispatch
                    boundary, before the kernels run (state untouched);
                    `count` <= retry budget exercises pure retry,
                    `count` > budget exercises recovery.
  dispatch_timeout  the same, as DispatchTimeout (the deadline model).
  poison_fetch      corrupt one value of a queued device-to-host delta
                    chunk (the bad-DMA model): the mirror diverges from
                    both device and oracle and must be caught.
  fallback_storm    force the host-mirror regime for a stretch of windows
                    (every batch leaves the device): exactness must hold
                    and the storm must be a counted event.

VERIFY and the spot rate are set by the call (`constants.set_verify`,
`DeviceLedger.verify_spot_rate`), never through the environment.
"""

from __future__ import annotations

import random

import numpy as np

from .. import constants
from ..ops import state_epoch
from ..ops.u64 import s64
from ..oracle.state_machine import StateMachineOracle
from ..serving import (DispatchTimeout, RetryPolicy, ServingSupervisor,
                       TransientDispatchError)
from ..types import Account, Transfer, TransferFlags
from ..utils.zipfian import ZipfianGenerator

FAULT_KINDS = ("state_bitflip", "dispatch_fail", "dispatch_timeout",
               "poison_fetch", "fallback_storm")

# Corruption-class faults must produce at least one recovery (silent
# survival would mean undetected corruption); dispatch faults below the
# retry budget legitimately resolve without one.
CORRUPTION_KINDS = frozenset({"state_bitflip", "poison_fetch"})


class ChaosDispatchFailure(TransientDispatchError):
    """Injected dispatch failure (seeded; state untouched)."""


class FaultPlan:
    """Deterministic per-seed fault schedule over a run's windows.

    `schedule[w]` is the fault descriptor injected around window `w`.
    The plan guarantees at least one fault per run (a chaos run that
    injects nothing proves nothing) and spreads kinds round-robin through
    a seed-shuffled deck so every kind appears across a small seed
    sweep."""

    def __init__(self, seed: int, n_windows: int, kinds=FAULT_KINDS,
                 fault_rate: float = 0.5):
        self.seed = seed
        self.rng = random.Random((seed * 0x9E3779B1 + 0xC8A05) & 0xFFFFFFFF)
        self.schedule: dict[int, dict] = {}
        self._deck: list[str] = []
        self._kinds = tuple(kinds)
        for w in range(n_windows):
            if self.rng.random() < fault_rate:
                self._add(w)
        if not self.schedule and n_windows:
            self._add(n_windows - 1)

    def _add(self, w: int) -> None:
        if not self._deck:
            self._deck = list(self._kinds)
            self.rng.shuffle(self._deck)
        kind = self._deck.pop()
        f = {"kind": kind, "window": w, "applied": False}
        if kind == "state_bitflip":
            f.update(target=self.rng.choice(
                ("accounts_u64", "accounts_bal", "transfers_u64")),
                row_pick=self.rng.randrange(1 << 30),
                col_pick=self.rng.randrange(1 << 30),
                bit=self.rng.randrange(64))
        elif kind in ("dispatch_fail", "dispatch_timeout"):
            # Sometimes within the retry budget (pure retry), sometimes
            # past it (forces replay recovery).
            f.update(count=self.rng.choice((1, 2, 4)), fired=0)
        elif kind == "poison_fetch":
            f.update(row_pick=self.rng.randrange(1 << 30),
                     bit=self.rng.randrange(32),
                     key=self.rng.choice(
                         ("amt_lo", "ud64", "code", "ledger")))
        elif kind == "fallback_storm":
            f.update(duration=self.rng.choice((1, 2, 3)))
        self.schedule[w] = f

    # ------------------------------------------------------ installation

    def dispatch_hook(self, win: int, what: str) -> None:
        """ServingSupervisor fault hook: raises before the window's
        dispatch, so the device state is untouched."""
        if what != "window":
            return
        f = self.schedule.get(win)
        if not f or f["kind"] not in ("dispatch_fail", "dispatch_timeout"):
            return
        if f["fired"] >= f["count"]:
            return
        f["fired"] += 1
        f["applied"] = True
        if f["kind"] == "dispatch_timeout":
            raise DispatchTimeout(
                f"chaos seed {self.seed}: injected dispatch timeout "
                f"(window {win}, {f['fired']}/{f['count']})")
        raise ChaosDispatchFailure(
            f"chaos seed {self.seed}: injected dispatch failure "
            f"(window {win}, {f['fired']}/{f['count']})")

    def _reschedule(self, f: dict, win: int) -> None:
        """A fault found nothing to corrupt (no live rows / no queued
        delta yet): retry it one window later, unless that slot is taken
        or the run is over."""
        nxt = win + 1
        if nxt in self.schedule:
            return
        del self.schedule[win]
        f["window"] = nxt
        self.schedule[nxt] = f

    def apply_pre(self, sup: ServingSupervisor, win: int) -> None:
        """Between-window faults injected before window `win`."""
        f = self.schedule.get(win)
        if not f:
            return
        if f["kind"] == "state_bitflip":
            f["applied"] = inject_state_bitflip(sup.led, f)
            if not f["applied"]:
                self._reschedule(f, win)
        elif f["kind"] == "poison_fetch" and not f["applied"]:
            # The previous window's delta may still be queued (no epoch
            # check consumed it): poisoning before the window works too.
            f["applied"] = poison_delta_fetch(sup.led, f)
        elif f["kind"] == "fallback_storm":
            led = sup.led
            if led._wt:
                # Force the host-mirror regime; the probe hysteresis ends
                # the storm after ~`duration` more mirror-routed ops.
                led._hard_regime = True
                led._mirror_batches = max(
                    1, led.MIRROR_PROBE_INTERVAL - f["duration"])
                f["applied"] = True

    def apply_post(self, sup: ServingSupervisor, win: int) -> None:
        """Post-window faults (they need the window's queued delta)."""
        f = self.schedule.get(win)
        if f and f["kind"] == "poison_fetch" and not f["applied"]:
            f["applied"] = poison_delta_fetch(sup.led, f)
            if not f["applied"]:
                self._reschedule(f, win)

    def summary(self) -> dict:
        out: dict = {}
        for f in self.schedule.values():
            key = f["kind"] + ("" if f["applied"] else "_skipped")
            out[key] = out.get(key, 0) + 1
        return out

    def applied(self, kinds=None) -> int:
        return sum(1 for f in self.schedule.values() if f["applied"]
                   and (kinds is None or f["kind"] in kinds))


# ------------------------------------------------------------- injectors

def inject_state_bitflip(led, f: dict) -> bool:
    """Flip one bit of a live, digest-covered cell of the device state (the
    memory-corruption model). The flip is an in-place XOR on the int64
    carrier, so the tensor keeps its storage: a captured window graph
    replays over the flipped cell exactly as the digest folds it. Windows
    in flight resolve first. Returns False when the chosen component has
    no live rows yet (nothing to corrupt)."""
    led.resolve_windows()
    st = led.state
    target = f["target"]
    comp = "accounts" if target.startswith("accounts") else "transfers"
    store = st[comp]
    mat = store["bal"] if target == "accounts_bal" else store["u64"]
    count = int(store["count"])
    if count == 0:
        return False
    if target == "transfers_u64":
        cols = [j for j, m in enumerate(state_epoch.XF_COL_MASKS) if m]
    else:
        cols = list(range(mat.shape[1]))
    row = f["row_pick"] % count
    col = cols[f["col_pick"] % len(cols)]
    mat[row, col] ^= s64(1 << (f["bit"] % 64))
    f["where"] = f"{target}[{row},{col}] bit {f['bit'] % 64}"
    return True


def poison_delta_fetch(led, f: dict) -> bool:
    """Corrupt one value of the newest queued write-through delta chunk
    (the bad-DMA model): the mirror materializes the poisoned value and
    disagrees with both the device and the oracle — the spot audit or the
    epoch's mirror audit must catch it. `load()` waits for the chunk's
    copy and returns exact-size host copies, so the poison lands in the
    chunk's own columns, never in a pinned buffer a later copy reuses."""
    for t, e, der, t0, n_new, _orph, _op in reversed(led._mirror_chunks):
        if not n_new or t is None:
            continue
        cols = t.load()
        key = f["key"]
        arr = np.array(cols[key], copy=True)
        row = f["row_pick"] % n_new
        arr[row] ^= arr.dtype.type(1 << (f["bit"] % (arr.dtype.itemsize * 8)))
        cols[key] = arr
        f["where"] = f"delta chunk rows {t0}..{t0 + n_new}, {key}[{row}]"
        return True
    return False


# ------------------------------------------------------------ chaos runs

def _chaos_workload(rng: random.Random, n_accounts: int, next_id: int,
                    n_events: int, open_pendings: list):
    """One batch of supervisor-servable transfers (plain + two-phase)."""
    F = TransferFlags
    events = []
    for _ in range(n_events):
        tid = next_id
        next_id += 1
        dr = rng.randrange(1, n_accounts + 1)
        cr = rng.randrange(1, n_accounts + 1)
        if cr == dr:
            cr = dr % n_accounts + 1
        roll = rng.random()
        if roll < 0.15:
            events.append(Transfer(
                id=tid, debit_account_id=dr, credit_account_id=cr,
                amount=rng.randrange(1, 1000), ledger=1, code=1,
                flags=int(F.pending), timeout=3600))
            open_pendings.append(tid)
        elif roll < 0.3 and open_pendings:
            pid = open_pendings.pop(0)
            post = rng.random() < 0.6
            events.append(Transfer(
                id=tid, pending_id=pid,
                amount=(1 << 128) - 1 if post else 0, ledger=1, code=1,
                flags=int(F.post_pending_transfer if post
                          else F.void_pending_transfer)))
        else:
            events.append(Transfer(
                id=tid, debit_account_id=dr, credit_account_id=cr,
                amount=rng.randrange(1, 1000), ledger=1, code=1))
    return events, next_id


# ------------------------------------------------- adversarial traffic

TRAFFIC_SHAPES = ("hot_skew", "pending_storm", "open_close_burst")


class TrafficShape:
    """Named adversarial traffic generator: a seeded, reproducible
    workload shape that replaces the uniform chaos workload while the
    FaultPlan keeps injecting around it. Built on utils/zipfian.py:

    - ``hot_skew``: every debit/credit account drawn from a Zipfian with
      s=1.2 — a handful of accounts absorb almost all contention.
    - ``pending_storm``: the first half of the run floods two-phase
      pending transfers, the second half bursts post/void resolutions of
      that backlog.
    - ``open_close_burst``: even windows open pendings in bulk, odd
      windows post/void what the previous window opened.
    """

    def __init__(self, name: str, seed: int, n_accounts: int,
                 n_windows: int):
        assert name in TRAFFIC_SHAPES, name
        self.name = name
        self.n_accounts = n_accounts
        self.n_windows = max(1, n_windows)
        theta = 1.2 if name == "hot_skew" else 0.99
        self.zipf = ZipfianGenerator(n_accounts, theta=theta,
                                     seed=(seed * 0x9E3779B1) ^ 0x7A1F)

    def _pair(self):
        dr, cr = (int(v) + 1 for v in self.zipf.draw(2))
        if cr == dr:
            cr = dr % self.n_accounts + 1
        return dr, cr

    def batch(self, w: int, rng: random.Random, next_id: int,
              n_events: int, open_pendings: list):
        """One prepare's events under this shape (the contract of
        _chaos_workload). `w` is the window index — the storm and burst
        shapes phase on it."""
        F = TransferFlags
        events = []
        for _ in range(n_events):
            tid = next_id
            next_id += 1
            dr, cr = self._pair()
            if self.name == "hot_skew":
                kind = "pend" if rng.random() < 0.10 else "plain"
            elif self.name == "pending_storm":
                flood = w < self.n_windows // 2
                if flood:
                    kind = "pend" if rng.random() < 0.85 else "plain"
                else:
                    kind = "resolve" if (open_pendings
                                         and rng.random() < 0.85) \
                        else "plain"
            else:  # open_close_burst
                if w % 2 == 0:
                    kind = "pend"
                else:
                    kind = "resolve" if open_pendings else "plain"
            if kind == "pend":
                events.append(Transfer(
                    id=tid, debit_account_id=dr, credit_account_id=cr,
                    amount=rng.randrange(1, 1000), ledger=1, code=1,
                    flags=int(F.pending), timeout=3600))
                open_pendings.append(tid)
            elif kind == "resolve":
                pid = open_pendings.pop(0)
                post = rng.random() < 0.6
                events.append(Transfer(
                    id=tid, pending_id=pid,
                    amount=(1 << 128) - 1 if post else 0, ledger=1,
                    code=1,
                    flags=int(F.post_pending_transfer if post
                              else F.void_pending_transfer)))
            else:
                events.append(Transfer(
                    id=tid, debit_account_id=dr, credit_account_id=cr,
                    amount=rng.randrange(1, 1000), ledger=1, code=1))
        return events, next_id


def oracle_history(script) -> tuple:
    """A clean oracle replay of a supervisor script ([("accounts", objs,
    ts) | ("window", batches, tss)]): (normalized history in
    ServingSupervisor.history's shape, the oracle)."""
    audit = StateMachineOracle()
    expected: list = []
    for kind, payload, when in script:
        if kind == "accounts":
            expected.append([(r.timestamp, int(r.status))
                             for r in audit.create_accounts(payload, when)])
        else:
            expected.append([
                [(r.timestamp, int(r.status))
                 for r in audit.create_transfers(b, bts)]
                for b, bts in zip(payload, when)])
    return expected, audit


AUDITED_FIELDS = ("accounts", "transfers", "pending_status", "orphaned",
                  "expiry", "account_events")


def run_chaos_seed(seed: int, *, windows: int = 8,
                   batches_per_window: int = 2, events_per_batch: int = 48,
                   kinds=FAULT_KINDS, epoch_interval: int | None = None,
                   traffic: str | None = None, tracer=None,
                   device=None) -> dict:
    """One seed-deterministic audited chaos run against the serving
    supervisor, with VERIFY on and every drained row spot-audited.
    Raises on any silent corruption (the run must either recover to
    bit-exact oracle parity or have failed loudly already); returns a
    summary dict on success. `device` None means the card."""
    rng = random.Random(seed)
    if epoch_interval is None:
        epoch_interval = rng.choice((2, 3, 4))
    was_verify = constants.VERIFY
    constants.set_verify(True)
    try:
        return _run_supervisor_chaos(
            seed, rng, windows, batches_per_window, events_per_batch,
            kinds, epoch_interval, tracer, traffic=traffic, device=device)
    finally:
        constants.set_verify(was_verify)


def _run_supervisor_chaos(seed, rng, windows, batches_per_window,
                          events_per_batch, kinds, epoch_interval,
                          tracer=None, traffic: str | None = None,
                          device=None) -> dict:
    n_accounts = 16
    shape = (TrafficShape(traffic, seed, n_accounts, windows)
             if traffic else None)
    sup = ServingSupervisor(
        a_cap=1 << 9, t_cap=1 << 12, epoch_interval=epoch_interval,
        retry=RetryPolicy(max_retries=2, base_delay_s=1e-3,
                          max_delay_s=4e-3, deadline_s=30.0),
        seed=seed, mirror_audit="full", sleep=lambda s: None,
        tracer=tracer, device=device)
    sup.led.verify_spot_rate = 1.0  # audit every drained row
    plan = FaultPlan(seed, windows, kinds=kinds)
    sup.fault_hook = plan.dispatch_hook

    script: list = []  # the full run, for the independent end audit
    accounts = [Account(id=i, ledger=1, code=1)
                for i in range(1, n_accounts + 1)]
    ts = 1_000
    sup.create_accounts(accounts, ts)
    script.append(("accounts", accounts, ts))

    next_id = 1_000
    open_pendings: list[int] = []
    ts = 10 ** 9
    for w in range(windows):
        plan.apply_pre(sup, w)
        batches, tss = [], []
        for _ in range(batches_per_window):
            if shape is not None:
                events, next_id = shape.batch(
                    w, rng, next_id, events_per_batch, open_pendings)
            else:
                events, next_id = _chaos_workload(
                    rng, n_accounts, next_id, events_per_batch,
                    open_pendings)
            ts += len(events) + 10
            batches.append(events)
            tss.append(ts)
        sup.create_transfers_window(batches, tss)
        script.append(("window", batches, tss))
        plan.apply_post(sup, w)
    sup.verify_epoch()  # final epoch: everything verified or recovered

    # The independent audit: a clean oracle replay of the whole run.
    expected, audit = oracle_history(script)
    assert sup.history == expected, \
        f"chaos seed {seed}: authoritative history diverged from oracle"
    host = sup.led.to_host()
    for field in AUDITED_FIELDS:
        assert getattr(host, field) == getattr(audit, field), \
            f"chaos seed {seed}: device state diverged on {field}"
    # Zero silent corruption: every applied corruption-class fault must
    # have produced at least one detected recovery.
    n_corruptions = plan.applied(CORRUPTION_KINDS)
    recoveries = sum(sup.counters["recoveries"].values())
    assert n_corruptions == 0 or recoveries >= 1, \
        (f"chaos seed {seed}: {n_corruptions} corruption fault(s) "
         f"injected but zero recoveries — silent corruption")
    sup.led.shutdown_staging()
    return dict(seed=seed, windows=windows,
                epoch_interval=epoch_interval,
                traffic=traffic,
                faults=plan.summary(),
                recoveries=dict(sup.counters["recoveries"]),
                retries=sup.counters["retries"],
                backoff_s=sup.counters["backoff_s"],
                replayed_windows=sup.counters["replayed_windows"],
                epochs_verified=sup.counters["epochs_verified"],
                checksum_mismatches=sup.counters["checksum_mismatches"],
                audited_ops=len(expected))


# ------------------------------------------------------------- gate

GATE_SEEDS = (1, 2, 3, 7)


def gate_main(seeds=GATE_SEEDS, device=None) -> int:
    """The fixed chaos seed set that keeps the recovery path from rotting
    (single-chip scenarios). Returns 1 if any seed failed."""
    failures = 0
    for seed in seeds:
        try:
            s = run_chaos_seed(int(seed), device=device)
            print(f"[chaos] seed {seed} ok: faults={s['faults']} "
                  f"recoveries={s['recoveries']} "
                  f"epochs={s['epochs_verified']}", flush=True)
        except Exception as e:  # noqa: BLE001 — the gate wants all reds
            failures += 1
            print(f"[chaos] seed {seed} FAILED: {e!r}", flush=True)
    return 1 if failures else 0
