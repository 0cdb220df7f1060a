"""Seeded device-fault injection for the serving pipeline (a port of the
JAX package's `testing/chaos.py`: the single-chip scenarios and its three
mesh scenarios, `shard_loss_scenario` on the replicated-state router,
`shard_resync_scenario` and `reshard_chaos_scenario` on the partitioned
one).

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

import json
import os
import random

import numpy as np

from .. import constants
from ..ops import state_epoch
from ..ops.u64 import s64, u64
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
                   mesh_scenario: bool | None = None,
                   traffic: str | None = None, tracer=None,
                   device=None) -> dict:
    """One seed-deterministic audited chaos run against the serving
    supervisor, with VERIFY on and every drained row spot-audited.
    Raises on any silent corruption (the run must either recover to
    bit-exact oracle parity or have failed loudly already); returns a
    summary dict on success. `device` None means the card.

    mesh_scenario None draws it from the seed's generator, as the JAX
    package does (a steady quarter of the seeds); a seed that runs it
    also runs `shard_loss_scenario`, `shard_resync_scenario` and
    `reshard_chaos_scenario` on `device`, under the summary's
    ``shard_loss``, ``shard_resync`` and ``reshard`` keys."""
    rng = random.Random(seed)
    if epoch_interval is None:
        epoch_interval = rng.choice((2, 3, 4))
    if mesh_scenario is None:
        mesh_scenario = rng.random() < 0.25
    was_verify = constants.VERIFY
    constants.set_verify(True)
    try:
        summary = _run_supervisor_chaos(
            seed, rng, windows, batches_per_window, events_per_batch,
            kinds, epoch_interval, tracer, traffic=traffic, device=device)
        if mesh_scenario:
            summary["shard_loss"] = shard_loss_scenario(seed, device=device)
            summary["shard_resync"] = shard_resync_scenario(seed,
                                                            device=device)
            summary["reshard"] = reshard_chaos_scenario(seed, device=device)
        return summary
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


# ------------------------------------------------- shard-loss scenario

def shard_loss_scenario(seed: int, mesh=None, device=None) -> dict:
    """Drop a mesh device mid-run: ShardedRouter must re-route to the
    single-chip step with exact results, count the reroutes, and route
    back after restore. `mesh` None: every CUDA device (`device` None),
    or 8 logical shards on the CPU (`device="cpu"`). Each call builds its
    own router."""
    from ..ops.batch import transfers_to_arrays
    from ..ops.ledger import DeviceLedger, pad_transfer_events
    from ..parallel.full_sharded import ShardedRouter, shard_batch
    from ..parallel.shard_utils import default_mesh, replicate

    rng = random.Random(seed ^ 0x5AFE)
    if mesh is None:
        mesh = default_mesh(device)
    router = ShardedRouter(mesh)

    n_accounts = 12
    accounts = [Account(id=i, ledger=1, code=1)
                for i in range(1, n_accounts + 1)]
    led = DeviceLedger(a_cap=1 << 8, t_cap=1 << 11, device=mesh.devices[0])
    led.create_accounts(accounts, 1_000)
    oracle = StateMachineOracle()
    oracle.create_accounts(accounts, 1_000)
    state = replicate(mesh, led.state)
    led.state = None  # the router's state now

    ts = 10 ** 9
    next_id = 10_000
    dropped = None
    for step_i in range(4):
        if step_i == 1:
            dropped = mesh.devices[rng.randrange(mesh.size)]
            router.drop_device(dropped)
        if step_i == 3:
            router.restore_devices()
        events = []
        for _ in range(24):
            dr = rng.randrange(1, n_accounts + 1)
            cr = dr % n_accounts + 1
            events.append(Transfer(
                id=next_id, debit_account_id=dr, credit_account_id=cr,
                amount=rng.randrange(1, 100), ledger=1, code=1))
            next_id += 1
        n = len(events)
        ts += n + 10
        evp = pad_transfer_events(transfers_to_arrays(events), 1024)
        state, out, fell = router.step(state, shard_batch(mesh, evp), ts, n)
        assert not fell, f"chaos seed {seed}: unexpected shard fallback"
        got = [(u64(t), int(s)) for s, t in zip(
            out["r_status"][:n].tolist(), out["r_ts"][:n].tolist())]
        want = [(r.timestamp, int(r.status))
                for r in oracle.create_transfers(events, ts)]
        assert got == want, \
            (f"chaos seed {seed}: shard-loss step {step_i} diverged "
             f"(lost={sorted(map(str, router.lost_devices))})")
    reroutes = router.shard_loss_reroutes
    assert reroutes == 2, reroutes  # exactly the degraded steps
    return dict(devices=int(mesh.size), dropped=str(dropped),
                reroutes=reroutes)


# --------------------------------------------- partitioned resync scenario

# The default mesh's router of each device, cached across seeds.
_PART_ROUTERS: dict = {}


def shard_resync_scenario(seed: int, mesh=None, device=None,
                          flight_dir=None) -> dict:
    """Drop a mesh device under the partitioned router (sharded state):
    no single-chip reroute exists, as the lost shard's range lives
    nowhere else, so the router must refuse to serve while a shard is
    lost and recover to exact oracle parity through resync(oracle),
    counted under the `shard_resync` recovery cause. `mesh` None: the
    default mesh of `device` (None: the card), whose router is cached
    across seeds; a given mesh gets a fresh router. `flight_dir`: where
    the flight recorder dumps (None: its default under the temporary
    directory)."""
    from ..ops.batch import transfers_to_arrays
    from ..ops.ledger import pad_transfer_events
    from ..parallel.partitioned import PartitionedRouter
    from ..parallel.shard_utils import default_mesh
    from ..trace import FlightRecorder

    rng = random.Random(seed ^ 0xCAFE)

    def fresh(m):
        flight = (FlightRecorder(dump_dir=flight_dir)
                  if flight_dir is not None else None)
        return PartitionedRouter(m, a_cap=1 << 9, t_cap=1 << 11,
                                 flight_recorder=flight)

    if mesh is not None:
        router = fresh(mesh)
    else:
        key = (str(device), flight_dir)
        if key not in _PART_ROUTERS:
            _PART_ROUTERS[key] = fresh(default_mesh(device))
        router = _PART_ROUTERS[key]
    mesh = router.mesh
    router.restore_devices()
    resyncs0 = router.shard_resyncs
    fallbacks0 = router.host_fallbacks

    n_accounts = 12
    accounts = [Account(id=i, ledger=1, code=1)
                for i in range(1, n_accounts + 1)]
    oracle = StateMachineOracle()
    oracle.create_accounts(accounts, 1_000)
    state = router.from_oracle(oracle)

    ts = 10 ** 9
    next_id = 10_000
    dropped = None
    flight_path = None
    for step_i in range(4):
        events = []
        for _ in range(24):
            dr = rng.randrange(1, n_accounts + 1)
            cr = dr % n_accounts + 1
            events.append(Transfer(
                id=next_id, debit_account_id=dr, credit_account_id=cr,
                amount=rng.randrange(1, 100), ledger=1, code=1))
            next_id += 1
        n = len(events)
        ts += n + 10
        evp = pad_transfer_events(transfers_to_arrays(events), 1024)
        if step_i == 1:
            dropped = mesh.devices[rng.randrange(mesh.size)]
            window_at_loss = router._window_seq
            dumps0 = router.flight.dumps
            router.drop_device(dropped)
            # Quarantine dumps the flight recorder: the artifact exists
            # and its last record is the quarantine marker of the failing
            # window.
            assert router.flight.dumps == dumps0 + 1
            flight_path = router.flight.last_dump_path
            assert flight_path and os.path.exists(flight_path), \
                (f"chaos seed {seed}: quarantine produced no flight "
                 f"artifact (path={flight_path!r})")
            with open(flight_path) as f:
                flight_doc = json.load(f)
            assert flight_doc["reason"] == "shard_loss_quarantine"
            last = flight_doc["records"][-1]
            assert last["route"] == "quarantined", last
            assert last["window"] == window_at_loss, \
                (last["window"], window_at_loss)
            # A lost range is not servable: the quarantine must be loud.
            try:
                router.step(state, evp, ts, n)
            except RuntimeError:
                pass
            else:
                raise AssertionError(
                    f"chaos seed {seed}: partitioned router served "
                    "with a lost shard")
            state = router.resync(oracle)
            assert router.flight.dumps == dumps0 + 2  # resync dumps too
        state, out, fell = router.step(state, evp, ts, n)
        assert not fell, \
            f"chaos seed {seed}: unexpected partitioned fallback"
        got = [(u64(t), int(s)) for s, t in zip(
            out["r_status"][:n].tolist(), out["r_ts"][:n].tolist())]
        want = [(r.timestamp, int(r.status))
                for r in oracle.create_transfers(events, ts)]
        assert got == want, \
            (f"chaos seed {seed}: partitioned step {step_i} diverged "
             f"after resync (dropped={dropped})")
    resyncs = router.shard_resyncs - resyncs0
    assert resyncs == 1, resyncs
    assert router.host_fallbacks == fallbacks0, "resync run fell back"
    return dict(devices=int(mesh.size), dropped=str(dropped),
                resyncs=resyncs,
                flight_dump=os.path.basename(flight_path))


# --------------------------------------------- elastic-reshard scenario

# The default mesh's router of each (device, flight_dir), cached across
# seeds.
_RESHARD_ROUTERS: dict = {}


def reshard_chaos_scenario(seed: int, mesh=None, device=None,
                           flight_dir=None) -> dict:
    """Fault the five-stage resharding handoff at every stage it can die
    in: a crash (the supervisor's recovery path: revert the overlay,
    rebuild from the verified oracle) right after the snapshot, mid-copy
    and under double-write; the loss of the source and of the target shard
    mid-copy (the quarantine must be loud, then the same recovery); a
    bit-corrupted chunk that must abort before the flip on the digest
    witness; and a crash after a completed flip (the MIGRATED entry must
    survive the rebuild). Every abort leaves serving exact against the
    never-resharded oracle and dumps a FLIGHT_*_reshard_* artifact.

    `mesh` None: 2 logical shards on `device` (None: the card), whose
    router is cached across seeds by (device, flight_dir); a given mesh
    gets a fresh router. `flight_dir`: where the flight recorder dumps
    (None: its default under the temporary directory). `artifacts` counts
    this call's reshard artifacts."""
    import glob as _glob

    from ..ops.batch import transfers_to_arrays
    from ..ops.device import resolve_device
    from ..ops.state_epoch import (partitioned_oracle_digest,
                                   partitioned_state_digest)
    from ..parallel.partitioned import PartitionedRouter
    from ..parallel.resharding import (MigrationAborted, ReshardController,
                                       ReshardPlan)
    from ..parallel.shard_utils import (OVERLAY_MIGRATED, Mesh,
                                        OwnershipTable)
    from ..trace import FlightRecorder
    from ..trace.flight_recorder import _flight_dir

    rng = random.Random(seed ^ 0xE5A)
    a_cap = 1 << 9

    def fresh(m):
        flight = (FlightRecorder(dump_dir=flight_dir)
                  if flight_dir is not None else None)
        return PartitionedRouter(m, a_cap=a_cap, t_cap=1 << 11,
                                 flight_recorder=flight)

    if mesh is not None:
        router = fresh(mesh)
    else:
        key = (str(device), flight_dir)
        if key not in _RESHARD_ROUTERS:
            _RESHARD_ROUTERS[key] = fresh(Mesh([resolve_device(device)] * 2))
        router = _RESHARD_ROUTERS[key]

    def base_ownership():
        # A cached router may carry the MIGRATED entry of the previous
        # seed's completed migration: base ownership again.
        if router.ownership.entries:
            router.set_ownership(OwnershipTable(
                router.n_shards, router.ownership.generation + 1, ()))

    router.restore_devices()
    base_ownership()
    mesh = router.mesh
    fallbacks0 = router.host_fallbacks
    art_dir = router.flight.dump_dir or _flight_dir()

    def artifacts() -> dict:
        # Each reshard artifact with its mtime: a fresh router's dumps
        # reuse the names an earlier one wrote in the same directory.
        return {p: os.stat(p).st_mtime_ns for p in _glob.glob(
            os.path.join(art_dir, "FLIGHT_*_reshard_*"))}

    arts0 = artifacts()

    n_accounts = 16
    oracle = StateMachineOracle()
    oracle.create_accounts([Account(id=i, ledger=1, code=1)
                            for i in range(1, n_accounts + 1)], 1_000)
    state = router.from_oracle(oracle)
    ctl = ReshardController(router, chunk_rows=4,
                            min_double_write_windows=2)
    plan = ReshardPlan(lo=0, hi=(1 << 63) - 1, src=0, dst=1, kind="split")
    nid, ts = [50_000], [10 ** 9]

    def drive(k):
        """k windows of live traffic; every batch exact against the
        never-resharded oracle; a digest-mismatch abort is adopted."""
        nonlocal state
        aborted = None
        for _ in range(k):
            obj_batches, batches, tss = [], [], []
            for _b in range(2):
                evs = []
                for _i in range(8):
                    dr = rng.randrange(1, n_accounts + 1)
                    cr = dr % n_accounts + 1
                    evs.append(Transfer(
                        id=nid[0], debit_account_id=dr,
                        credit_account_id=cr,
                        amount=rng.randrange(1, 50), ledger=1, code=1))
                    nid[0] += 1
                ts[0] += 300
                obj_batches.append(evs)
                batches.append(transfers_to_arrays(evs))
                tss.append(ts[0])
            try:
                state = ctl.on_window(state, batches)
            except MigrationAborted as e:
                state = e.state
                aborted = e
            state, results = router.step_window(state, batches, tss)
            for evs, t, (st_a, ts_a) in zip(obj_batches, tss, results):
                want = [(r.timestamp, int(r.status))
                        for r in oracle.create_transfers(evs, t)]
                got = [(int(ts_a[i]), int(st_a[i]))
                       for i in range(len(evs))]
                assert got == want, \
                    (f"reshard chaos seed {seed}: history diverged "
                     f"after a fault", got[:4], want[:4])
        return aborted

    def crash():
        """The supervisor's recovery path for a crash mid-migration."""
        nonlocal state
        ctl.on_recovery()
        router.restore_devices()
        state = router.resync(oracle)

    faults = []
    try:
        drive(1)  # warm traffic

        # 1. A crash right after the snapshot (stage copy, cursor 0).
        state = ctl.begin(state, plan)
        assert ctl.stage == "copy", ctl.stage
        crash()
        faults.append("crash_snapshot")
        drive(1)

        # 2. A crash mid-copy (the cursor advanced, nothing flipped).
        state = ctl.begin(state, plan)
        state = ctl.on_window(state)  # one quiesced chunk, no traffic
        assert ctl.stage == "copy", ctl.stage
        crash()
        faults.append("crash_mid_copy")
        drive(1)

        # 3, 4. The loss of the source and of the target shard mid-copy:
        # the quarantine refuses to serve, then the crash recovery runs.
        for lost_shard, tag in ((plan.src, "loss_source"),
                                (plan.dst, "loss_target")):
            state = ctl.begin(state, plan)
            state = ctl.on_window(state)
            router.drop_device(mesh.devices[lost_shard])
            try:
                router.step_window(state, *_one_window(rng, n_accounts,
                                                       nid, ts))
            except RuntimeError:
                pass
            else:
                raise AssertionError(
                    f"reshard chaos seed {seed}: served with shard "
                    f"{lost_shard} lost mid-copy")
            crash()
            faults.append(tag)
            drive(1)

        # 5. A crash under double-write (the entry live, before the flip).
        state = ctl.begin(state, plan)
        guard = 0
        while ctl.stage == "copy":
            state = ctl.on_window(state)
            guard += 1
            assert guard < 64, ctl.stage
        assert ctl.stage == "double_write", ctl.stage
        crash()
        assert router.ownership.entries == (), router.ownership.entries
        faults.append("crash_double_write")
        drive(1)

        # 6. A bit-corrupted chunk: the digest witness must abort the flip,
        # revert the overlay and keep serving exact.
        state = ctl.begin(state, plan)
        ctl.corrupt_next_chunk = True
        aborted, guard = None, 0
        while aborted is None:
            aborted = drive(1)
            guard += 1
            assert guard < 64, "the corrupted copy never aborted"
            assert ctl.stage != "done", \
                f"seed {seed}: the flip went through on a corrupted copy"
        assert aborted.reason == "digest_mismatch", aborted.reason
        faults.append("digest_mismatch")
        drive(1)

        # 7. A clean migration, then a crash after the flip: the MIGRATED
        # entry is the collapsed base override and must survive the
        # oracle rebuild.
        state = ctl.begin(state, plan)
        guard = 0
        while ctl.stage != "done":
            drive(1)
            guard += 1
            assert guard < 64, ctl.stage
        entries = router.ownership.entries
        assert len(entries) == 1 and entries[0][4] == OVERLAY_MIGRATED
        crash()  # a no-op on the idle controller; the rebuild honours it
        assert router.ownership.entries == entries
        faults.append("crash_post_flip")
        drive(2)

        n_arts = sum(1 for p, t in artifacts().items() if arts0.get(p) != t)
        # Every abort dumped an artifact: five crashes or losses and the
        # digest mismatch (the crash after the flip aborts nothing).
        assert len(ctl.aborts) == 6, ctl.aborts
        assert n_arts >= 6, (n_arts, art_dir)
        assert len(ctl.migrations) == 1, ctl.migrations
        dd = partitioned_state_digest(state)
        want = partitioned_oracle_digest(
            oracle, a_cap, router.n_shards,
            overlay=router.ownership.entries)
        assert dd == want, f"seed {seed}: the final digest diverged"
        assert router.host_fallbacks == fallbacks0
    finally:
        # The cached router must come back clean for the next seed.
        base_ownership()
    return dict(devices=int(mesh.size), faults=faults,
                aborts=len(ctl.aborts), artifacts=n_arts,
                migrations=len(ctl.migrations))


def _one_window(rng, n_accounts, nid, ts):
    """One throwaway window (batches, tss) for the quarantine probe."""
    from ..ops.batch import transfers_to_arrays

    evs = []
    for _i in range(8):
        dr = rng.randrange(1, n_accounts + 1)
        evs.append(Transfer(id=nid[0], debit_account_id=dr,
                            credit_account_id=dr % n_accounts + 1,
                            amount=1, ledger=1, code=1))
        nid[0] += 1
    ts[0] += 300
    return [transfers_to_arrays(evs)], [ts[0]]


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
