"""Serving supervisor: retries, verified epochs and bounded replay recovery
around a write-through DeviceLedger (a port of the JAX package's
`serving.py`; the partitioned half — `attach_partitioned`, `reshard` —
waits for the port's `parallel/`).

1. **Bounded retry with backoff** — every device dispatch runs under a
   retry policy (exponential backoff with seeded jitter, a bounded
   attempt count, and a per-window deadline checked between attempts).
   Transient dispatch faults (`TransientDispatchError`, the class the
   chaos harness injects at the dispatch boundary) retry; exhaustion
   escalates to recovery. A CUDA error, a failed kernel build or a failed
   launch is none of these: it propagates to the caller.

2. **Verified state epochs** — every `epoch_interval` windows the
   supervisor quiesces the pipeline (resolve + drain), replays the
   epoch's logged inputs through the oracle (the pure-Python exact
   semantics, which device corruption cannot reach), and checks three
   invariants: (a) the device-returned results equal the oracle replay's,
   (b) the device state digest (`ops/state_epoch.py`) equals the digest of
   the replayed oracle state, and (c) the write-through mirror equals the
   replayed oracle object for object. A clean epoch advances the verified
   base; any divergence quarantines the device state.

3. **Bounded replay recovery** — on quarantine (digest mismatch, result
   divergence, mirror divergence, retry exhaustion), the supervisor
   replays at most the windows since the last verified epoch (asserted)
   through the oracle, revises the authoritative result history with the
   oracle's answers, releases the quarantined ledger's device memory,
   rebuilds a fresh mirror and device state from the recovered oracle
   (`from_host`, on the same device) and resumes serving. Per-cause
   counters surface through `DeviceLedger.fallback_stats()["recovery"]`.

The device is explicit: `ServingSupervisor(device=None)` means CUDA and
raises without it; the tests pass `device="cpu"`.
"""

from __future__ import annotations

import copy
import dataclasses
import random
import time
from dataclasses import dataclass

from .ops import state_epoch
from .ops.batch import transfers_to_arrays
from .ops.device import resolve_device
from .ops.ledger import DeviceLedger, MirrorDivergence, default_recovery_stats
from .oracle.state_machine import StateMachineOracle
from .trace import Event, FlightRecorder, NullTracer, fmt_trace_id


class TransientDispatchError(RuntimeError):
    """A device dispatch failed in a way worth retrying (the chaos
    harness's injected dispatch failures subclass this)."""


class DispatchTimeout(TransientDispatchError):
    """A dispatch exceeded its deadline (injected or wrapped)."""


class RecoveryNeeded(RuntimeError):
    """Internal escalation: the serving pipeline must quarantine device
    state and replay from the last verified epoch."""

    def __init__(self, cause: str, detail: str = ""):
        super().__init__(cause + (f": {detail}" if detail else ""))
        self.cause = cause
        self.detail = detail


@dataclass
class RetryPolicy:
    """Bounded-retry parameters for one device dispatch. Backoff is
    exponential from base_delay_s, capped at max_delay_s, with
    multiplicative seeded jitter in [1, 1+jitter); deadline_s bounds the
    whole attempt sequence (checked between attempts — a dispatch
    blocked inside the runtime cannot be preempted, only not retried)."""

    max_retries: int = 3
    base_delay_s: float = 0.01
    max_delay_s: float = 1.0
    deadline_s: float = 30.0
    jitter: float = 0.25

    def delay_s(self, attempt: int, rng: random.Random) -> float:
        base = min(self.max_delay_s,
                   self.base_delay_s * (2.0 ** max(0, attempt - 1)))
        return base * (1.0 + self.jitter * rng.random())

    def clamped(self, deadline_s: float | None) -> "RetryPolicy":
        """This policy with deadline_s tightened to a caller's remaining
        admission budget — never loosened — so the whole retry sequence
        (attempts + backoff sleeps) stays inside the budget a request was
        admitted under."""
        if deadline_s is None or deadline_s >= self.deadline_s:
            return self
        return dataclasses.replace(self, deadline_s=max(0.0, deadline_s))


# Structural faults while consuming device-produced bytes (the drain
# materializes fetched delta chunks into the mirror): an unknown
# account/transfer id, an invalid enum code, or a bad index there is
# detected corruption, so it routes to quarantine and replay, never to a
# retry or a raw crash.
_STRUCTURAL_FAULTS = (KeyError, IndexError, ValueError)


def call_with_retries(fn, policy: RetryPolicy, rng: random.Random,
                      counters: dict, *, sleep=time.sleep,
                      clock=time.monotonic, tracer=None):
    """Run `fn()` under `policy`. Transient faults retry with backoff;
    exhaustion (attempts or deadline) raises RecoveryNeeded, as do a
    MirrorDivergence and the structural drain faults (retrying cannot
    fix divergent state). Anything else propagates. Counters accumulate
    into the shared recovery-stats dict."""
    if tracer is None:
        tracer = NullTracer()
    t0 = clock()
    attempt = 0
    while True:
        try:
            return fn()
        except MirrorDivergence as e:
            raise RecoveryNeeded("mirror_divergence", str(e)) from e
        except _STRUCTURAL_FAULTS as e:
            raise RecoveryNeeded("drain_fault", repr(e)) from e
        except TransientDispatchError as e:
            attempt += 1
            counters["retries"] += 1
            tracer.count(Event.serving_retries)
            if attempt > policy.max_retries:
                raise RecoveryNeeded(
                    "dispatch_exhausted",
                    f"{attempt} attempts: {e!r}") from e
            remaining = policy.deadline_s - (clock() - t0)
            if remaining <= 0:
                raise RecoveryNeeded(
                    "dispatch_deadline",
                    f"deadline {policy.deadline_s}s: {e!r}") from e
            # The backoff sleep is capped by the remaining deadline, so
            # exponential backoff never stacks the attempt sequence past
            # the deadline the caller holds.
            delay = min(policy.delay_s(attempt, rng), remaining)
            counters["backoff_s"] = round(
                counters["backoff_s"] + delay, 6)
            sleep(delay)


def _normalized(pairs) -> list:
    """A window's per-prepare (status, ts) arrays in the history's shape:
    [(ts, status), ...] a prepare."""
    return [[(int(t), int(s)) for s, t in zip(st.tolist(), ts.tolist())]
            for st, ts in pairs]


class ServingSupervisor:
    """Owns a write-through DeviceLedger and supervises its serving loop:
    retries, verified epochs, and bounded replay recovery.

    The caller submits Transfer/Account object batches (the supervisor
    keeps them as the epoch's replayable log); device dispatch uses the
    ledger's array paths underneath. `history` is the authoritative
    normalized result record — one entry per submitted op, revised with
    the oracle's answers whenever a recovery replays a suffix.

    `epoch_ms` holds the host-clock milliseconds of the last
    verify_epoch's parts (drain, replay, device_digest, oracle_digest,
    mirror_audit); `recovery_ms` one entry a recovery (cause, replay and
    rebuild ms)."""

    def __init__(self, a_cap: int = 1 << 17, t_cap: int = 1 << 21, *,
                 epoch_interval: int = 8, retry: RetryPolicy | None = None,
                 seed: int = 0, mirror_audit: str = "full",
                 fault_hook=None, sleep=time.sleep, tracer=None,
                 flight_recorder=None, pipeline_depth: int = 2,
                 profiler=None, memwatch=None, alert_engine=None,
                 device=None):
        assert mirror_audit in ("full", "spot", "off")
        self.device = resolve_device(device)
        self.tracer = tracer if tracer is not None else NullTracer()
        # Flight recorder: every window's route decision and every
        # verified epoch digest ring here; any recovery, retry exhaustion
        # included, freezes the ring into a post-mortem artifact.
        self.flight = flight_recorder if flight_recorder is not None \
            else FlightRecorder(tracer=self.tracer)
        # The observatory's hooks, None by default (the unobserved path
        # pays nothing): the profiler samples window dispatches, the
        # memwatch ticks at every verified epoch, the alert engine once a
        # committed window.
        self.profiler = profiler
        self.memwatch = memwatch
        self.alert_engine = alert_engine
        if alert_engine is not None:
            alert_engine.bind(self.tracer, self.flight)
        self.a_cap = a_cap
        self.t_cap = t_cap
        self.epoch_interval = epoch_interval
        self.retry = retry or RetryPolicy()
        self.rng = random.Random(seed)
        self.mirror_audit = mirror_audit
        # Chaos-injection point: called as hook(window_index, what) at
        # every dispatch attempt; raising TransientDispatchError /
        # DispatchTimeout injects a dispatch fault (testing/chaos.py).
        self.fault_hook = fault_hook
        self._sleep = sleep
        self.counters = default_recovery_stats()
        # The last verified epoch's state: a pure oracle advanced only by
        # replaying logged inputs. After each clean epoch it equals the
        # live state.
        self.epoch_base = StateMachineOracle()
        self.log: list = []       # ops since the last verified epoch
        self.history: list = []   # normalized results, one per op ever
        self.last_recovery: dict | None = None
        self._windows_since_epoch = 0
        self.windows_total = 0
        # Overlapped serving (submit_transfers_window): in-flight window
        # records, oldest first; at pipeline_depth the oldest resolves
        # before the next submit.
        self.pipeline_depth = max(1, int(pipeline_depth))
        self._pending: list = []
        # Trace ids of requests whose windows landed since the last
        # verified epoch: a recovery affects exactly these, so tail
        # retention force-keeps them and the flight artifact names them.
        self._epoch_trace_ids: list[str] = []
        self.epoch_ms: dict = {}
        self.recovery_ms: list = []
        self._attach(DeviceLedger(a_cap, t_cap,
                                  write_through=StateMachineOracle(),
                                  device=self.device))

    def _attach(self, led: DeviceLedger) -> None:
        self.led = led
        # The ledger surfaces our counters through fallback_stats(), and
        # our tracer receives its window_stage spans and stall gauge.
        led.recovery_stats = self.counters
        led.tracer = self.tracer

    # ------------------------------------------------------------ serving

    def create_accounts(self, accounts: list, timestamp: int):
        accounts = list(accounts)
        res = self._dispatch(
            lambda: self.led.create_accounts(accounts, timestamp),
            what="create_accounts")
        norm = [(r.timestamp, int(r.status)) for r in res]
        self.log.append(("accounts", accounts, timestamp))
        self.history.append(norm)
        return res

    def create_transfers_window(self, batches: list, timestamps: list,
                                trace_ctxs: list | None = None,
                                deadline_s: float | None = None):
        """Submit one commit window: `batches` is a list of Transfer
        object lists, `timestamps` the per-prepare commit timestamps.
        Returns the ledger's per-prepare (status u32[n], ts u64[n])
        pairs. Runs the epoch check when the interval elapses.

        `trace_ctxs` is the optional per-prepare TraceContext list
        (entries may be None): the window span joins the first traced
        request's causal tree and links every constituent trace id. A
        window that lands on the fallback route force-keeps its
        constituent traces, as does any recovery that replays it."""
        batches = [list(b) for b in batches]
        timestamps = list(timestamps)
        win = self.windows_total
        ctxs = [c for c in (trace_ctxs or ()) if c is not None]
        trace_ids = [fmt_trace_id(c.trace_id) for c in ctxs]
        self._epoch_trace_ids.extend(trace_ids)

        def thunk():
            evs = [transfers_to_arrays(b) for b in batches]
            return self.led.create_transfers_window(evs, timestamps)

        thunk = self._profiled(thunk)
        # window_commit is tagged late (the ledger knows its route only
        # after the dispatch), so each window lands in its route/tier
        # latency class.
        with self.tracer.span(Event.window_commit,
                              ctx=ctxs[0] if ctxs else None) as sp:
            for tid in trace_ids:
                sp.link(tid)
            out = self._dispatch(thunk, what="window", win=win,
                                 deadline_s=deadline_s)
            route = self.led.last_window_route
            if route:
                sp.tags["route"] = route
                tier = self.led.last_window_tier
                if tier:
                    sp.tags["tier"] = tier
                self.tracer.count(Event.dispatch_route, route=route)
        if route and "fallback" in route:
            for tid in trace_ids:
                self.tracer.keep_trace(tid, reason="fallback")
        self.flight.record(window=win, route=route or "unknown",
                           prepares=len(batches),
                           **({"trace_ids": trace_ids} if trace_ids
                              else {}))
        self.log.append(("window", batches, timestamps))
        self.history.append(_normalized(out))
        self.windows_total += 1
        self._windows_since_epoch += 1
        self._observatory_tick()
        if self._windows_since_epoch >= self.epoch_interval:
            self.verify_epoch()
        return out

    # ------------------------------------------------- overlapped serving

    def submit_transfers_window(self, batches: list, timestamps: list,
                                trace_ctxs: list | None = None,
                                deadline_s: float | None = None,
                                evs: list | None = None) -> int:
        """The overlapped serving loop's submit half: stage window k's
        pack on the ledger's stager first, resolve the oldest in-flight
        window when the pipeline is at depth (the stage's pack overlaps
        that resolve and the in-flight dispatch), then dispatch window k
        with no host sync (DeviceLedger.submit_window). Returns the
        window's history index; results materialize at
        resolve_transfers_windows() / drain_pipeline(), or out of a
        recovery's oracle replay (the window is logged at dispatch, so
        bounded replay covers in-flight windows; a staged but undispatched
        pack dies with the quarantined ledger and never commits). Windows
        the pipeline cannot take run on the synchronous window path
        inline. Runs the epoch check when the interval elapses."""
        batches = [list(b) for b in batches]
        timestamps = list(timestamps)
        win = self.windows_total
        ctxs = [c for c in (trace_ctxs or ()) if c is not None]
        trace_ids = [fmt_trace_id(c.trace_id) for c in ctxs]
        self._epoch_trace_ids.extend(trace_ids)
        # `evs` lets the admission plane pass the same array dicts it
        # already staged ahead (DeviceLedger.stage_window matches on
        # prepare-dict identity): restaging would replace the pack.
        if evs is None:
            evs = [transfers_to_arrays(b) for b in batches]
        if not self.led.staged_matches(evs, timestamps):
            self.led.stage_window(evs, timestamps)
        if len(self._pending) >= self.pipeline_depth:
            self.resolve_transfers_windows(count=1)
        t0 = self.tracer.now_ns()
        ticket = self._dispatch(
            lambda: self.led.submit_window(evs, timestamps),
            what="window_submit", win=win, deadline_s=deadline_s)
        rec = {"hist_idx": len(self.history), "win": win,
               "ticket": ticket, "t0_ns": t0, "trace_ids": trace_ids,
               "route": self.led.last_window_route,
               "tier": self.led.last_window_tier, "results": None,
               "deadline_s": deadline_s}
        if ticket is None:
            # Not eligible for the pipeline: the synchronous window path
            # (which resolves everything in flight first, so submit order
            # is preserved).
            out = self._dispatch(
                lambda: self.led.create_transfers_window(evs,
                                                         timestamps),
                what="window", win=win, deadline_s=deadline_s)
            rec["route"] = self.led.last_window_route
            rec["tier"] = self.led.last_window_tier
            rec["results"] = _normalized(out)
        route = rec["route"]
        if route:
            self.tracer.count(Event.dispatch_route, route=route)
        if route and "fallback" in route:
            for tid in trace_ids:
                self.tracer.keep_trace(tid, reason="fallback")
        self.flight.record(window=win, route=route or "unknown",
                           prepares=len(batches),
                           **({"trace_ids": trace_ids} if trace_ids
                              else {}))
        self.log.append(("window", batches, timestamps))
        self.history.append(rec["results"])
        hist_idx = rec["hist_idx"]
        if rec["results"] is None:
            self._pending.append(rec)
        else:
            self._close_window_span(rec)
        self.windows_total += 1
        self._windows_since_epoch += 1
        self._observatory_tick()
        if self._windows_since_epoch >= self.epoch_interval:
            self.verify_epoch()
        return hist_idx

    def resolve_transfers_windows(self, count: int | None = None) -> list:
        """Resolve the oldest `count` pending pipelined windows (all of
        them when None), filling their history entries, and return their
        normalized per-prepare results. A mid-pipeline fallback or a
        recovery may resolve more than asked on the ledger side; those
        records then materialize without blocking when their turn
        comes."""
        n = len(self._pending) if count is None \
            else min(count, len(self._pending))
        out = []
        for _ in range(n):
            rec = self._pending[0]
            tk = rec["ticket"]
            if rec["results"] is None and tk is not None \
                    and tk.results is None:
                self._dispatch(
                    lambda: self.led.resolve_windows(count=1),
                    what="window_resolve", win=rec["win"],
                    deadline_s=rec.get("deadline_s"))
                tk = rec["ticket"]  # a recovery replaces it with None
            self._pending.pop(0)
            if rec["results"] is None:
                _kind, pairs = tk.results
                rec["results"] = _normalized(pairs)
                self.history[rec["hist_idx"]] = rec["results"]
            self._close_window_span(rec)
            out.append(rec["results"])
        return out

    def drain_pipeline(self) -> list:
        """Resolve every pending pipelined window (epoch verify and
        recovery drain through here): history is fully materialized
        after this returns."""
        return self.resolve_transfers_windows()

    def _close_window_span(self, rec) -> None:
        """Emit the submit->resolve window_commit span of one pipelined
        window (explicit timing: its open and close sites are separate
        calls), tagged with its route/tier latency class."""
        t0 = rec["t0_ns"]
        tags = {}
        if rec["route"]:
            tags["route"] = rec["route"]
            if rec["tier"]:
                tags["tier"] = rec["tier"]
        self.tracer.record_span(Event.window_commit, t0,
                                self.tracer.now_ns() - t0, **tags)

    def expire_pending_transfers(self, timestamp: int) -> int:
        n = self._dispatch(
            lambda: self.led.expire_pending_transfers(timestamp),
            what="expire")
        self.log.append(("expire", None, timestamp))
        self.history.append(n)
        return n

    def _profiled(self, thunk):
        """Wrap one window dispatch thunk in the sampled profiler, when
        one is attached (route and tier resolve late, through callables)."""
        prof = self.profiler
        if prof is None:
            return thunk
        return lambda: prof.time(
            thunk,
            route=lambda: self.led.last_window_route or "unknown",
            tier=lambda: self.led.last_window_tier or "-")

    def _observatory_tick(self) -> None:
        """Advance the alert engine one committed window, when one is
        attached."""
        if self.alert_engine is not None:
            self.alert_engine.tick()

    def _dispatch(self, thunk, *, what: str = "", win: int | None = None,
                  deadline_s: float | None = None):
        hook = self.fault_hook
        idx = self.windows_total if win is None else win
        policy = self.retry.clamped(deadline_s)

        def run():
            if hook is not None:
                hook(idx, what)
            return thunk()

        try:
            with self.tracer.span(Event.serving_dispatch, what=what):
                return call_with_retries(run, policy, self.rng,
                                         self.counters, sleep=self._sleep,
                                         tracer=self.tracer)
        except RecoveryNeeded as e:
            self._recover(e.cause, detail=e.detail)
            # Fresh, verified state: one post-recovery re-dispatch of the
            # op itself (no fault hook: the injected fault belonged to the
            # quarantined attempt sequence).
            return thunk()

    # ------------------------------------------------------------- epochs

    def verify_epoch(self) -> bool:
        """Quiesce, replay the epoch's log through the oracle, and check
        results / state digest / mirror. Clean -> advance the verified
        base and return True; any divergence -> recover and return
        False. With an empty log it is a cheap no-op epoch."""
        with self.tracer.span(Event.serving_epoch_verify):
            return self._verify_epoch()

    def _verify_epoch(self) -> bool:
        clock = time.perf_counter
        ms = self.epoch_ms = {}
        t0 = clock()
        # Quiesce the pipeline first: every pending window resolves
        # (filling its history entry) before the replay below compares.
        # A recovery triggered inside this drain clears the log and swaps
        # the ledger; the checks below then run on the rebuilt state.
        self.drain_pipeline()
        led = self.led
        try:
            led.resolve_windows()
            led.drain_mirror()
        except MirrorDivergence as e:
            self._recover("mirror_divergence", detail=str(e))
            return False
        except _STRUCTURAL_FAULTS as e:
            self._recover("drain_fault", detail=repr(e))
            return False
        t1 = clock()
        ms["drain"] = (t1 - t0) * 1e3
        n_entries = len(self.log)
        replayed = self._replay_log_into_base()
        t2 = clock()
        ms["replay"] = (t2 - t1) * 1e3
        cause = None
        detail = ""
        # (a) result parity: device answers vs the oracle replay.
        start = len(self.history) - n_entries
        for i, want in enumerate(replayed):
            if self.history[start + i] != want:
                cause = "result_divergence"
                detail = f"op {start + i}"
                break
        # (b) state digest: device fold vs the replayed oracle's fold.
        if cause is None:
            got = state_epoch.device_state_digest(led.state)
            t3 = clock()
            want_d = state_epoch.oracle_state_digest(self.epoch_base,
                                                     self.a_cap)
            ms["device_digest"] = (t3 - t2) * 1e3
            ms["oracle_digest"] = (clock() - t3) * 1e3
            if got != want_d:
                self.counters["checksum_mismatches"] += 1
                cause = "state_digest"
                detail = ",".join(
                    state_epoch.diverging_components(got, want_d))
        # (c) mirror audit: write-through mirror vs the replayed oracle.
        if cause is None and self.mirror_audit != "off":
            t4 = clock()
            bad = self._mirror_audit_fields(
                full=self.mirror_audit == "full")
            ms["mirror_audit"] = (clock() - t4) * 1e3
            if bad:
                cause = "mirror_divergence"
                detail = ",".join(bad)
        if cause is None:
            self.counters["epochs_verified"] += 1
            self.flight.record(window=self.windows_total,
                               route="epoch_verified",
                               epoch_digest=got)
            self.log.clear()
            self._windows_since_epoch = 0
            self._epoch_trace_ids.clear()
            # Memory watermark at the quiesce point.
            if self.memwatch is not None:
                self.memwatch.observe(self.led)
            return True
        self._recover(cause, detail=detail, replayed=replayed)
        return False

    def _replay_log_into_base(self) -> list:
        """Apply the epoch log to the verified base oracle, returning
        normalized results per entry (the authoritative answers)."""
        base = self.epoch_base
        out = []
        for kind, payload, ts in self.log:
            if kind == "accounts":
                res = base.create_accounts(payload, ts)
                out.append([(r.timestamp, int(r.status)) for r in res])
            elif kind == "window":
                out.append([
                    [(r.timestamp, int(r.status))
                     for r in base.create_transfers(b, bts)]
                    for b, bts in zip(payload, ts)])
            else:
                assert kind == "expire", kind
                out.append(base.expire_pending_transfers(ts))
        return out

    def _mirror_audit_fields(self, full: bool) -> list[str]:
        """Object-level audit of the write-through mirror against the
        replayed oracle. full=True compares every container; spot mode
        compares sizes/scalars plus a seeded object sample."""
        sm = self.led.mirror
        base = self.epoch_base
        bad: list[str] = []
        if full:
            for field in ("accounts", "transfers", "pending_status",
                          "orphaned", "expiry"):
                if getattr(sm, field) != getattr(base, field):
                    bad.append(field)
            off = sm.events_base - base.events_base
            if not (0 <= off <= len(base.account_events)) or \
                    sm.account_events != base.account_events[off:]:
                bad.append("account_events")
            return bad
        if (len(sm.accounts) != len(base.accounts)
                or len(sm.transfers) != len(base.transfers)
                or sm.commit_timestamp != base.commit_timestamp):
            return ["sizes"]
        ids = list(base.transfers)
        for tid in (self.rng.sample(ids, min(4, len(ids))) if ids else ()):
            if sm.transfers.get(tid) != base.transfers.get(tid):
                bad.append(f"transfer:{tid}")
        return bad

    # ----------------------------------------------------------- recovery

    def _recover(self, cause: str, detail: str = "",
                 replayed: list | None = None) -> None:
        """Quarantine the device state and recover from the last verified
        epoch: oracle-replay the logged suffix (bounded), revise the
        authoritative history, rebuild mirror and device from the
        recovered oracle, resume serving.

        Recovery is the flight recorder's dump point: the last-N window
        records (and epoch digests) freeze into a JSON artifact tagged
        with the cause before anything is rebuilt."""
        affected = list(dict.fromkeys(self._epoch_trace_ids))
        for tid in affected:
            self.tracer.keep_trace(tid, reason=cause)
        self.flight.record(window=self.windows_total, route="recovery",
                           cause=cause, detail=detail[:200],
                           **({"trace_ids": affected} if affected
                              else {}))
        self.flight.dump(cause)
        self.tracer.count(Event.serving_recoveries, cause=cause)
        with self.tracer.span(Event.serving_recovery_replay, cause=cause):
            self._recover_replay(cause, detail, replayed)

    def _recover_replay(self, cause: str, detail: str,
                        replayed: list | None) -> None:
        t0 = time.perf_counter()
        n_entries = len(self.log)
        n_windows = sum(1 for e in self.log if e[0] == "window")
        # Bounded-replay invariant: recovery never replays more windows
        # than fit between two epoch checks.
        assert n_windows <= self.epoch_interval, \
            (n_windows, self.epoch_interval)
        self.tracer.observe(Event.serving_replay_windows, n_windows)
        if replayed is None:
            replayed = self._replay_log_into_base()
        start = len(self.history) - n_entries
        self.history[start:] = replayed
        # Pipelined windows still in flight at quarantine were logged at
        # dispatch, so the replay above produced their results: adopt
        # them and drop the dead tickets. A staged but undispatched pack
        # was never logged: it dies with the quarantined ledger's stager.
        for rec in self._pending:
            rec["results"] = self.history[rec["hist_idx"]]
            rec["ticket"] = None
        self.counters["replayed_windows"] += n_windows
        recs = self.counters["recoveries"]
        recs[cause] = recs.get(cause, 0) + 1
        self.last_recovery = {"cause": cause, "detail": detail,
                              "replayed_entries": n_entries,
                              "replayed_windows": n_windows}
        t1 = time.perf_counter()
        # The quarantined ledger gives its device memory back first (its
        # stager stopped, its staged window dropped, its graphs, tickets,
        # deltas and state released); then a fresh mirror from the
        # recovered oracle (a deep copy: the mirror evolves by
        # write-through deltas, the base only by replay) and a device
        # rebuild through from_host on the same device, keeping the
        # VERIFY audit's spot rate.
        spot_rate = self.led.verify_spot_rate
        self.led.release()
        led = DeviceLedger(self.a_cap, self.t_cap,
                           write_through=copy.deepcopy(self.epoch_base),
                           device=self.device)
        led.verify_spot_rate = spot_rate
        self._attach(led)
        self.log.clear()
        self._windows_since_epoch = 0
        self._epoch_trace_ids.clear()
        self.recovery_ms.append({
            "cause": cause, "replayed_windows": n_windows,
            "replay_ms": (t1 - t0) * 1e3,
            "rebuild_ms": (time.perf_counter() - t1) * 1e3})

    # -------------------------------------------------------------- stats

    def stats(self) -> dict:
        out = {k: (dict(v) if isinstance(v, dict) else v)
               for k, v in self.counters.items()}
        out["windows_total"] = self.windows_total
        out["windows_since_epoch"] = self._windows_since_epoch
        out["pipeline"] = {"depth": self.pipeline_depth,
                           "pending": len(self._pending)}
        out["last_recovery"] = self.last_recovery
        out["flight"] = {"windows_recorded": self.flight.seq,
                         "dumps": self.flight.dumps,
                         "last_dump": self.flight.last_dump_path}
        observatory = {}
        if self.profiler is not None:
            observatory["profiler"] = self.profiler.stats()
        if self.memwatch is not None:
            observatory["memwatch"] = self.memwatch.stats()
        if self.alert_engine is not None:
            observatory["alerts"] = self.alert_engine.stats()
        if observatory:
            out["observatory"] = observatory
        out["ledger"] = self.led.fallback_stats()
        return out
