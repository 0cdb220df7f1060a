"""Admission plane: session ingress, backpressure, SLO-driven shedding
(a port of the JAX package's `admission.py`, over the port's
`ServingSupervisor`).

The serving stack below this module (ServingSupervisor -> DeviceLedger
-> the window kernels on the card) executes whatever it is fed. This
module is the ingress half of the serving story: tens of thousands of
client sessions submit SMALL requests (a handful of transfers each),
and the plane coalesces them into large prepares and full commit
windows under an explicit per-class latency budget — or rejects them
with a typed, attributable `ShedResult`. AT2 (PAPERS.md) frames
transfers as per-account-ordered requests from many independent
clients; the reference's VOPR drives exactly this shape with
`stdx.ZipfianGenerator` (mirrored in utils/zipfian.py), which the
chaos traffic shapes reuse.

Design, in the order a request experiences it:

1. **Sessions and queue credits (backpressure).** Each session holds a
   bounded number of queue credits; a queued request consumes one until
   it is admitted (dispatched in a window) or shed. A session with no
   credits gets an immediate `ShedResult(reason="no_credit")` — the
   fast-reject path that turns a misbehaving hot session into ITS
   problem instead of everyone's queue delay. A global bounded queue
   (`max_queue`) backstops the aggregate with `reason="queue_full"`.

2. **Priority classes with explicit budgets.** Every request lands in a
   priority class (critical/standard/batch by default), each carrying a
   committed admission SLO (`slo_ms`, the p99 queue-wait budget) and a
   hard per-request
   deadline (`deadline_ms`). A queued request whose deadline expires is
   shed (`reason="deadline"`) rather than admitted late: an admitted
   request's queue wait is bounded by its class deadline BY
   CONSTRUCTION, so saturation degrades into explicit rejections, never
   into a pipeline full of requests that already missed their budget.

3. **SLO-driven shed line (never static thresholds).** Once per pump
   tick the plane folds this tick's queue-wait samples (admitted waits
   plus the CURRENT age of everything still queued — the leading
   indicator) into per-class log2 histograms and compares p99 against
   each class's budget; the breach bits feed a trailing burn-rate
   window exactly like trace/slo.py's `burn_rates`. When any class's
   burn rate crosses `burn_budget` — or the ledger's measured
   `host_stall_fraction` or the queue depth crosses its
   fraction — the shed line rises one class: the lowest-priority class
   is gated (queued requests flushed as `reason="shed_line"`, new
   submits fast-rejected), then the next, and so on. The top class is
   never gated by the shed line. The line lowers only after
   `cool_ticks` consecutive clean ticks (hysteresis).

4. **Coalescing pump.** `pump()` packs queued requests — priority
   order, FIFO within a class, whole requests never split across
   prepares — into up to `prepare_max`-event prepares (8190, one
   TigerBeetle message body, by default) and `window_prepares`-prepare
   commit windows, then feeds them to
   `ServingSupervisor.submit_transfers_window` with `deadline_s` set to
   the tightest remaining member deadline, so the retry/backoff budget
   below (serving.RetryPolicy.clamped) can never stack past the
   admission budget. With `stage_ahead` the plane additionally packs
   the NEXT window onto the ledger's background stager
   (DeviceLedger.stage_window) before it is committed to — a
   staged-but-shed window is abandoned before submit and provably never
   commits (the drain contract recovery already enforces for
   quarantined stages).

5. **Attribution.** Every decision carries the request's trace
   context: admits and sheds both land in the `admission_decision` span
   (duration = queue wait on the plane clock), sheds additionally count
   `admission_shed` and force-keep their trace with a `shed:<reason>`
   tail-retention reason, so a shed storm is explainable request by
   request from the merged waterfall. Conservation is an invariant, not
   a hope: submitted == admitted + shed + still-queued at all times
   (`conservation()`), and nothing in this module ever drops a request
   silently or lets an exception reach the session.

The plane's clock is injectable: real serving uses `time.monotonic`,
tests use `VirtualClock`, so queue waits, deadlines and burn rates are
exactly reproducible under a seed.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass

from .constants import BATCH_MAX
from .ops.batch import transfers_to_arrays
from .oracle.state_machine import StateMachineOracle
from .trace import Event, NullTracer, fmt_trace_id, mint_context
from .trace.histogram import Histogram

#: Closed set of shed causes (the `reason` tag on admission_decision /
#: admission_shed — bounded cardinality by construction).
SHED_REASONS = ("no_credit", "queue_full", "shed_line", "deadline",
                "drain")


@dataclass(frozen=True)
class AdmissionClass:
    """One priority class and its committed admission budgets.
    `priority` 0 is highest and is never gated by the shed line;
    `slo_ms` is the committed p99 queue-wait budget (what the SLO
    objectives read); `deadline_ms` is the hard per-request bound — a
    queued request older than this is shed, never admitted late."""

    name: str
    priority: int
    slo_ms: float
    deadline_ms: float


DEFAULT_CLASSES = (
    AdmissionClass("critical", 0, slo_ms=50.0, deadline_ms=200.0),
    AdmissionClass("standard", 1, slo_ms=200.0, deadline_ms=800.0),
    AdmissionClass("batch", 2, slo_ms=1000.0, deadline_ms=4000.0),
)


@dataclass(frozen=True)
class ShedResult:
    """A typed rejection: the ONLY way the plane says no. Carries the
    request's identity and trace id (the trace is tail-kept under
    `shed:<reason>`), the class it was rejected from, the closed-set
    reason, and a retry hint. Never raised — returned/attached, so a
    session always gets a value, not an exception."""

    session_id: int
    request_id: int
    cls: str
    reason: str
    trace_id: str
    retry_after_ms: float


class Request:
    """One in-flight ingress request. `state` walks
    queued -> admitted | shed; `shed` holds the ShedResult when
    rejected; `hist_idx` the supervisor history index when admitted."""

    __slots__ = ("session_id", "request_id", "cls", "transfers", "ctx",
                 "trace_id", "t_enq", "deadline", "state", "shed",
                 "admit_wait_ms", "hist_idx")

    def __init__(self, session_id, request_id, cls, transfers, ctx,
                 t_enq, deadline):
        self.session_id = session_id
        self.request_id = request_id
        self.cls = cls
        self.transfers = transfers
        self.ctx = ctx
        self.trace_id = fmt_trace_id(ctx.trace_id)
        self.t_enq = t_enq
        self.deadline = deadline
        self.state = "new"
        self.shed: ShedResult | None = None
        self.admit_wait_ms: float | None = None
        self.hist_idx: int | None = None


class _Session:
    __slots__ = ("session_id", "credits", "request_number")

    def __init__(self, session_id, credits):
        self.session_id = session_id
        self.credits = credits
        self.request_number = 0


class VirtualClock:
    """Deterministic plane clock (seconds): tests and seeded callers
    advance it explicitly, so queue waits, deadline sweeps, and burn
    windows replay bit-identically under a seed."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, ds: float) -> None:
        self.t += float(ds)


class AdmissionPlane:
    """Session ingress + admission/batching in front of one
    ServingSupervisor. See the module docstring for the design; the
    calling loop is:

        plane.open_accounts(accounts, ts)
        for tick in ...:
            for (session, transfers, cls) in offered_load:
                req = plane.submit(session, transfers, cls=cls)
                # req.shed is a ShedResult on fast-reject
            plane.pump()
            clock.advance(tick_s)          # with a VirtualClock
        plane.drain()

    `admitted_log` is the replayable script of everything that actually
    reached the supervisor — `oracle_history()` replays it through the
    pure oracle for the bit-exactness-under-shedding contract."""

    def __init__(self, supervisor, *, classes=DEFAULT_CLASSES,
                 prepare_max: int = BATCH_MAX, window_prepares: int = 4,
                 max_windows_per_pump: int = 1,
                 session_credits: int = 8, max_queue: int = 4096,
                 burn_window_ticks: int = 8, burn_budget: float = 0.25,
                 cool_ticks: int = 4, stall_shed_fraction: float = 0.9,
                 depth_shed_fraction: float = 0.75,
                 shed_enabled: bool = True, stage_ahead: bool = True,
                 clock=time.monotonic, seed: int = 0,
                 head_rate: float = 0.1, ts0: int = 10 ** 9):
        assert prepare_max >= 1 and window_prepares >= 1
        self.sup = supervisor
        self.tracer = getattr(supervisor, "tracer", None) or NullTracer()
        self.classes = tuple(sorted(classes, key=lambda c: c.priority))
        assert len({c.priority for c in self.classes}) \
            == len(self.classes), "class priorities must be distinct"
        self._by_name = {c.name: c for c in self.classes}
        self.prepare_max = int(prepare_max)
        self.window_prepares = int(window_prepares)
        self.max_windows_per_pump = int(max_windows_per_pump)
        self.session_credits = int(session_credits)
        self.max_queue = int(max_queue)
        self.burn_window_ticks = int(burn_window_ticks)
        self.burn_budget = float(burn_budget)
        self.cool_ticks = int(cool_ticks)
        self.stall_shed_fraction = float(stall_shed_fraction)
        self.depth_shed_fraction = float(depth_shed_fraction)
        self.shed_enabled = bool(shed_enabled)
        self.stage_ahead = bool(stage_ahead)
        self.clock = clock
        self.seed = int(seed)
        self.head_rate = float(head_rate)
        self._ts = int(ts0)
        self._sessions: dict[int, _Session] = {}
        self._queues = {c.name: deque() for c in self.classes}
        self._queued_total = 0
        # One stage-ahead window at most: (batches, tss, arrays, reqs).
        self._staged_next = None
        self._next_request_id = 0
        self.shed_level = 0
        self._forced_level: int | None = None
        self._clean_ticks = 0
        self._tick = 0
        # Cumulative per-class accounting (the stats() record).
        self.submitted = {c.name: 0 for c in self.classes}
        self.admitted = {c.name: 0 for c in self.classes}
        self.shed_counts = {c.name: {} for c in self.classes}
        self.admit_waits = {c.name: Histogram() for c in self.classes}
        self.events_admitted = 0
        self.windows_dispatched = 0
        self.shed_results: list[ShedResult] = []
        # Per-tick breach signal state.
        self._tick_hists = {c.name: Histogram() for c in self.classes}
        self._breach_window = {
            c.name: deque(maxlen=self.burn_window_ticks)
            for c in self.classes}
        self.burn = {c.name: 0.0 for c in self.classes}
        # The replayable admitted script: ("accounts", objs, ts) and
        # ("window", batches, tss) entries, in supervisor submit order.
        self.admitted_log: list = []

    # ------------------------------------------------------------ ingress

    def open_accounts(self, accounts, timestamp: int):
        """Account creation rides through the plane so the admitted
        script stays a complete oracle-replayable run."""
        res = self.sup.create_accounts(list(accounts), timestamp)
        self.admitted_log.append(("accounts", list(accounts), timestamp))
        return res

    def submit(self, session_id: int, transfers, cls: str = "standard"
               ) -> Request:
        """Enqueue one request. Always returns the Request handle; a
        fast-rejected request comes back with state == "shed" and a
        typed ShedResult in `.shed` — never an exception."""
        c = self._by_name[cls]
        transfers = list(transfers)
        assert 0 < len(transfers) <= self.prepare_max, \
            (len(transfers), self.prepare_max)
        sess = self._sessions.get(session_id)
        if sess is None:
            sess = self._sessions[session_id] = _Session(
                session_id, self.session_credits)
        ctx = mint_context(session_id, sess.request_number,
                           head_rate=self.head_rate, seed=self.seed)
        sess.request_number += 1
        rid = self._next_request_id
        self._next_request_id += 1
        now = self.clock()
        req = Request(session_id, rid, c, transfers, ctx, now,
                      now + c.deadline_ms / 1e3)
        self.submitted[c.name] += 1
        if self.shed_enabled:
            # Fast-reject paths: cheaper than queueing work the plane
            # already knows it cannot serve in budget.
            if self._gated(c):
                return self._shed(req, "shed_line", now)
            if sess.credits <= 0:
                return self._shed(req, "no_credit", now)
            if self._queued_total >= self.max_queue:
                return self._shed(req, "queue_full", now)
        sess.credits -= 1
        req.state = "queued"
        self._queues[c.name].append(req)
        self._queued_total += 1
        return req

    # --------------------------------------------------------------- pump

    def pump(self, max_windows: int | None = None) -> int:
        """One admission tick: deadline sweep, shed-line update, then
        pack + dispatch up to `max_windows` commit windows (the plane's
        per-tick service capacity). Returns windows dispatched."""
        if max_windows is None:
            max_windows = self.max_windows_per_pump
        now = self.clock()
        self._tick += 1
        self._sweep_deadlines(now)
        self._update_shed_level(now)
        dispatched = 0
        while dispatched < max_windows:
            if not self._submit_staged(now):
                packed = self._pack_window(now)
                if packed is None:
                    break
                self._dispatch_window(*packed, now)
            dispatched += 1
        if self.stage_ahead and self._staged_next is None:
            self._prestage(now)
        self._finish_tick(now)
        return dispatched

    def drain(self, shed_remaining: bool = False) -> None:
        """Flush the plane: either pump everything through (default) or
        shed all still-queued work with reason "drain" (shutdown), then
        drain the supervisor pipeline. Conservation holds either way —
        queued reaches zero with every request admitted or shed."""
        now = self.clock()
        if shed_remaining and self.shed_enabled:
            self._unstage(now, shed_all_reason="drain")
            for c in self.classes:
                self._flush_class(c, "drain", now)
        while self._queued_total or self._staged_next is not None:
            before = (self._queued_total,
                      self._staged_next is not None)
            self.pump(max_windows=1 << 30)
            now = self.clock()
            if (self._queued_total,
                    self._staged_next is not None) == before:
                # No forward progress (everything left is gated): it
                # must leave as a typed shed, never hang or vanish.
                self._unstage(now, shed_all_reason="drain")
                for c in self.classes:
                    self._flush_class(c, "drain", now)
        self.sup.drain_pipeline()

    # ------------------------------------------------------ pump internals

    def _submit_staged(self, now: float) -> bool:
        """Dispatch the stage-ahead window if it is still admissible.
        When a shed decision lands mid-window — a member's class got
        gated, or a member's deadline passed, between stage and submit
        — the staged pack is abandoned before it was ever submitted:
        affected members shed, unaffected members return to the head
        of their queues and repack into the next window."""
        staged = self._staged_next
        if staged is None:
            return False
        batches, tss, arrays, reqs = staged
        if self.shed_enabled and any(
                self._gated(r.cls) or r.deadline <= now for r in reqs):
            self._unstage(now)
            return False
        self._staged_next = None
        self._dispatch_window(batches, tss, reqs, now, arrays=arrays)
        return True

    def _unstage(self, now: float, shed_all_reason: str | None = None
                 ) -> None:
        """Abandon the stage-ahead window. The pack the ledger's
        stager holds is simply never submitted: the next stage_window
        replaces it, or shutdown_staging drops it — the same
        never-committed guarantee the recovery drain contract gives a
        quarantined stage. Members are shed only for cause (gated
        class / expired deadline / explicit `shed_all_reason`);
        everyone else requeues in FIFO position."""
        staged, self._staged_next = self._staged_next, None
        if staged is None:
            return
        for req in reversed(staged[3]):
            if shed_all_reason is not None:
                self._release_credit(req)
                self._shed(req, shed_all_reason, now)
            elif self.shed_enabled and self._gated(req.cls):
                self._release_credit(req)
                self._shed(req, "shed_line", now)
            elif self.shed_enabled and req.deadline <= now:
                self._release_credit(req)
                self._shed(req, "deadline", now)
            else:
                self._queues[req.cls.name].appendleft(req)
                self._queued_total += 1

    def _prestage(self, now: float) -> None:
        """Pack the next window onto the ledger's background stager so
        its pack+transfer overlaps the in-flight dispatch. Members are
        dequeued (they are committed to a window shape) but remain
        sheddable until _submit_staged actually dispatches."""
        packed = self._pack_window(now)
        if packed is None:
            return
        batches, tss, reqs = packed
        arrays = [transfers_to_arrays(b) for b in batches]
        self.sup.led.stage_window(arrays, tss)
        self._staged_next = (batches, tss, arrays, reqs)

    def _pack_window(self, now: float):
        """Pull whole requests — priority order, FIFO within class —
        into up to `window_prepares` prepares of up to `prepare_max`
        events. Returns (batches, tss, member_reqs) or None when
        nothing is packable."""
        batches, tss, member_reqs = [], [], []
        prepare, prepare_n = [], 0
        while len(batches) < self.window_prepares:
            req = self._next_packable(prepare_n)
            if req is None:
                if not prepare:
                    break
                self._close_prepare(batches, tss, prepare)
                prepare, prepare_n = [], 0
                continue
            prepare.extend(req.transfers)
            prepare_n += len(req.transfers)
            member_reqs.append(req)
            if prepare_n >= self.prepare_max:
                self._close_prepare(batches, tss, prepare)
                prepare, prepare_n = [], 0
        if prepare and len(batches) < self.window_prepares:
            self._close_prepare(batches, tss, prepare)
        if not batches:
            return None
        return batches, tss, member_reqs

    def _next_packable(self, room_used: int):
        """Highest-priority queued request that still fits the current
        prepare (None if the prepare must close or queues are dry)."""
        room = self.prepare_max - room_used
        for c in self.classes:
            q = self._queues[c.name]
            if q and len(q[0].transfers) <= room:
                req = q.popleft()
                self._queued_total -= 1
                return req
        return None

    def _close_prepare(self, batches, tss, prepare) -> None:
        # The chaos-harness timestamp idiom: each prepare's commit
        # timestamp strictly clears the per-event timestamps the state
        # machine assigns inside it.
        self._ts += len(prepare) + 10
        batches.append(prepare)
        tss.append(self._ts)

    def _dispatch_window(self, batches, tss, reqs, now: float,
                         arrays=None) -> None:
        deadline_s = None
        if self.shed_enabled and reqs:
            deadline_s = max(1e-3,
                             min(r.deadline for r in reqs) - now)
        ctxs = [r.ctx for r in reqs]
        hist_idx = self.sup.submit_transfers_window(
            batches, tss, trace_ctxs=ctxs, deadline_s=deadline_s,
            evs=arrays)
        self.admitted_log.append(("window", batches, tss))
        self.windows_dispatched += 1
        for req in reqs:
            self._release_credit(req)
            wait_ms = max(0.0, (now - req.t_enq) * 1e3)
            req.state = "admitted"
            req.admit_wait_ms = wait_ms
            req.hist_idx = hist_idx
            self.admitted[req.cls.name] += 1
            self.events_admitted += len(req.transfers)
            self.admit_waits[req.cls.name].record(wait_ms)
            self._tick_hists[req.cls.name].record(wait_ms)
            self.tracer.record_span(
                Event.admission_decision, int(req.t_enq * 1e9),
                int(wait_ms * 1e6), ctx=req.ctx, decision="admit",
                cls=req.cls.name)

    # ----------------------------------------------------------- shedding

    def _shed(self, req: Request, reason: str, now: float) -> Request:
        assert reason in SHED_REASONS, reason
        wait_ms = max(0.0, (now - req.t_enq) * 1e3)
        result = ShedResult(
            session_id=req.session_id, request_id=req.request_id,
            cls=req.cls.name, reason=reason, trace_id=req.trace_id,
            retry_after_ms=req.cls.slo_ms)
        req.state = "shed"
        req.shed = result
        counts = self.shed_counts[req.cls.name]
        counts[reason] = counts.get(reason, 0) + 1
        self.shed_results.append(result)
        self._tick_hists[req.cls.name].record(wait_ms)
        self.tracer.record_span(
            Event.admission_decision, int(req.t_enq * 1e9),
            int(wait_ms * 1e6), ctx=req.ctx, decision="shed",
            cls=req.cls.name, reason=reason)
        self.tracer.count(Event.admission_shed, cls=req.cls.name,
                          reason=reason)
        # Every shed is tail-kept: the decision must be explainable
        # from the merged waterfall regardless of head sampling.
        self.tracer.keep_trace(req.trace_id, reason=f"shed:{reason}")
        return req

    def _release_credit(self, req: Request) -> None:
        sess = self._sessions.get(req.session_id)
        if sess is not None:
            sess.credits = min(self.session_credits, sess.credits + 1)

    def _sweep_deadlines(self, now: float) -> None:
        """Shed queued requests whose hard deadline already passed —
        admitting them would burn window capacity on answers nobody is
        still waiting for."""
        if not self.shed_enabled:
            return
        for c in self.classes:
            q = self._queues[c.name]
            keep = deque()
            while q:
                req = q.popleft()
                if req.deadline <= now:
                    self._queued_total -= 1
                    self._release_credit(req)
                    self._shed(req, "deadline", now)
                else:
                    keep.append(req)
            self._queues[c.name] = keep

    def _gated(self, c: AdmissionClass) -> bool:
        """True when the shed line currently gates class `c` (the
        `shed_level` lowest-priority classes; the top class never)."""
        if not self.shed_enabled or self.shed_level <= 0:
            return False
        return c.priority >= len(self.classes) - self.shed_level

    def _flush_class(self, c: AdmissionClass, reason: str,
                     now: float) -> None:
        q = self._queues[c.name]
        while q:
            req = q.popleft()
            self._queued_total -= 1
            self._release_credit(req)
            self._shed(req, reason, now)

    def _update_shed_level(self, now: float) -> None:
        """Raise/lower the shed line from live signals: per-class burn
        rates over the trailing tick window, the ledger's measured
        host_stall_fraction, and queue depth. Hysteresis: raise at most
        one class per tick, lower only after `cool_ticks` clean
        ticks."""
        if self._forced_level is not None:
            self._apply_level(self._forced_level, now)
            return
        overloaded = any(b > self.burn_budget for b in self.burn.values())
        if not overloaded:
            stall = self.sup.led.staging_summary().get(
                "host_stall_fraction")
            overloaded = (stall is not None
                          and stall > self.stall_shed_fraction
                          and self._queued_total > 0)
        if not overloaded:
            overloaded = (self._queued_total
                          >= self.depth_shed_fraction * self.max_queue)
        if overloaded:
            self._clean_ticks = 0
            self._apply_level(
                min(len(self.classes) - 1, self.shed_level + 1), now)
        elif self.shed_level > 0:
            self._clean_ticks += 1
            if self._clean_ticks >= self.cool_ticks:
                self._clean_ticks = 0
                self._apply_level(self.shed_level - 1, now)

    def _apply_level(self, level: int, now: float) -> None:
        level = max(0, min(len(self.classes) - 1, level))
        rising = level > self.shed_level
        self.shed_level = level
        if rising and self.shed_enabled:
            for c in self.classes:
                if self._gated(c):
                    self._flush_class(c, "shed_line", now)

    def force_shed_level(self, level: int | None) -> None:
        """Pin the shed line (tests, chaos scenarios); None resumes the
        burn-rate controller."""
        self._forced_level = level
        if level is not None:
            self._apply_level(level, self.clock())

    def _finish_tick(self, now: float) -> None:
        """Fold this tick's signals: queued AGES join the tick
        histograms (the leading indicator — waits still growing), then
        per-class p99-vs-budget breach bits push into the burn
        windows."""
        for c in self.classes:
            h = self._tick_hists[c.name]
            for req in self._queues[c.name]:
                h.record(max(0.0, (now - req.t_enq) * 1e3))
            p99 = h.quantile(0.99)
            breach = bool(h.count) and p99 is not None \
                and p99 > c.slo_ms
            win = self._breach_window[c.name]
            win.append(1 if breach else 0)
            self.burn[c.name] = sum(win) / len(win)
            self._tick_hists[c.name] = Histogram()
        occupancy = (self._queued_total / self.max_queue
                     if self.max_queue else 0.0)
        self.tracer.gauge(Event.admission_credit_occupancy,
                          round(occupancy, 6))
        self._last_occupancy = occupancy

    # ------------------------------------------------------------- oracle

    def oracle_history(self):
        """Replay the ADMITTED script through the pure oracle and
        return (normalized history, oracle) in exactly
        ServingSupervisor.history's shape — the bit-exactness-under-
        shedding contract compares this against sup.history."""
        base = StateMachineOracle()
        hist = []
        for kind, payload, ts in self.admitted_log:
            if kind == "accounts":
                res = base.create_accounts(payload, ts)
                hist.append([(r.timestamp, int(r.status)) for r in res])
            else:
                hist.append([
                    [(r.timestamp, int(r.status))
                     for r in base.create_transfers(b, bts)]
                    for b, bts in zip(payload, ts)])
        return hist, base

    # -------------------------------------------------------------- stats

    def conservation(self) -> dict:
        """The zero-silent-drops invariant, as data: every submitted
        request is admitted, shed, queued, or staged — nothing else."""
        sub = sum(self.submitted.values())
        adm = sum(self.admitted.values())
        shed = sum(sum(r.values()) for r in self.shed_counts.values())
        staged = (len(self._staged_next[3])
                  if self._staged_next is not None else 0)
        return {"submitted": sub, "admitted": adm, "shed": shed,
                "queued": self._queued_total, "staged": staged,
                "ok": sub == adm + shed + self._queued_total + staged}

    def stats(self) -> dict:
        """The admission record: per-class admitted/shed + wait
        distributions, the shed line, occupancy, and conservation."""
        per_class = {}
        for c in self.classes:
            per_class[c.name] = {
                "priority": c.priority,
                "slo_ms": c.slo_ms,
                "deadline_ms": c.deadline_ms,
                "submitted": self.submitted[c.name],
                "admitted": self.admitted[c.name],
                "shed": dict(sorted(self.shed_counts[c.name].items())),
                "burn": round(self.burn[c.name], 4),
                "admit_wait_ms": self.admit_waits[c.name].summary(),
            }
        return {
            "classes": per_class,
            "conservation": self.conservation(),
            "shed_level": self.shed_level,
            "ticks": self._tick,
            "windows_dispatched": self.windows_dispatched,
            "events_admitted": self.events_admitted,
            "sessions": len(self._sessions),
            "queue": {"max": self.max_queue,
                      "occupancy": round(
                          getattr(self, "_last_occupancy", 0.0), 4)},
            "credits": {"per_session": self.session_credits},
        }
