"""Tracers: the no-op production default and the recording tracer.

reference: src/trace.zig — span start/stop compiled into the hot path,
Chrome/Perfetto JSON via --trace, StatsD aggregation via trace/statsd.zig.
The tracer is injected at construction (replica, journal, scrubber,
message bus, serving supervisor, sharded router); the default NullTracer
keeps every hot path free of overhead (bench.py's ##trace probe records
that cost every run).

The recording `Tracer` enforces the typed catalog (trace/event.py): a
span/counter/gauge outside the catalog, or a tag key outside the event's
schema, is a hard error. Spans land in a bounded ring; eviction is
SELF-DESCRIBING (a dropped_events counter plus an instant marker event,
so a truncated Chrome trace says so instead of silently starting late).

Cross-process alignment: span timestamps are wall-clock anchored — the
tracer records `time.time_ns() - perf_counter_ns()` once at construction
and bakes the offset into every emitted `ts`, so per-replica traces from
different processes merge onto one timeline (trace/merge.py) without any
post-hoc clock guessing.
"""

from __future__ import annotations

import json
import time as _time
from typing import Optional

from .context import TraceContext, fmt_span_id, fmt_trace_id
from .event import TID_BASE, Event, EventKind, lookup
from .histogram import Histogram
from .statsd import StatsD, TimingAggregates

# The recording span path reads per-event constants through `ev._hot`
# (trace/event.py): one plain attribute access instead of enum property
# hops or member-keyed dict lookups (Enum.__hash__ is Python-level).
# The traced-vs-NullTracer overhead ratios in the bench ##trace record
# guard this path.


class NullTracer:
    """No-op tracer (production default unless --trace/--statsd is set).
    Accepts anything: enforcement is the recording tracer's job — the
    null path must stay a handful of attribute lookups."""

    def span(self, event, ctx=None, **tags):
        return _NULL_SPAN

    def begin(self, event, **tags) -> None:
        pass

    def end(self, event, **tags) -> None:
        pass

    def count(self, event, value: int = 1, **tags) -> None:
        pass

    def gauge(self, event, value: float, **tags) -> None:
        pass

    def observe(self, event, value: float, **tags) -> None:
        pass

    def now_ns(self) -> int:
        """Timestamp for record_span(); 0 on the null path so traced
        call sites never touch a clock when tracing is off."""
        return 0

    def record_span(self, event, start_ns: int, dur_ns: int, *,
                    ctx=None, span_id: int = 0, links=(), **tags) -> None:
        pass

    def mint_span_id(self) -> int:
        return 0

    def keep_trace(self, trace_id, reason: str) -> None:
        pass

    def dump_chrome_trace(self, path: str) -> None:
        pass

    def flush_statsd(self) -> None:
        pass


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @property
    def tags(self) -> dict:
        return {}  # a throwaway: late-tagging a null span is a no-op

    @property
    def ctx(self):
        return None  # no causal identity on the null path

    def link(self, trace_id) -> None:
        pass


_NULL_SPAN = _NullSpan()


class Tracer(NullTracer):
    """Recording tracer: bounded ring of completed spans, counters,
    gauges, per-event timing aggregates, and the emitted-name set the
    gate's coverage leg audits."""

    def __init__(self, capacity: int = 65536,
                 statsd: Optional[StatsD] = None, pid: int = 0,
                 emit_interval_s: float = 10.0):
        self.capacity = capacity
        self.statsd = statsd
        self.pid = pid
        self.emit_interval_s = emit_interval_s
        self.events: list[dict] = []
        self.counters: dict[str, int] = {}
        self.gauges: dict[str, float] = {}
        self.dropped_events = 0
        # Catalog coverage record: every event name this tracer emitted.
        self.emitted: set[str] = set()
        # Wall-clock anchor: perf_counter_ns + _epoch_ns == time_ns, so
        # emitted ts values are comparable ACROSS processes.
        self._epoch_ns = _time.time_ns() - _time.perf_counter_ns()
        # No StatsD -> the aggregates' per-interval percentile
        # histograms would never be flushed; skip feeding them. The
        # span-close path updates `_agg` directly on that (bench) path;
        # the alias dodges two attribute hops per span.
        self.aggregates = TimingAggregates(with_hist=statsd is not None)
        self._agg = self.aggregates._agg
        # CUMULATIVE distributions for the Prometheus exposition and
        # the merged-trace metadata: series key -> Histogram, fed at
        # span close BEFORE any ring bookkeeping (ring eviction drops
        # span *events*; it must never dent a distribution) and by
        # observe() for histogram-kind events. Unlike `aggregates`
        # (flush-and-reset, StatsD interval semantics) these only grow.
        self.histograms: dict[str, Histogram] = {}
        # series key -> (event name, partition tags) for exposition.
        self.histogram_series: dict[str, tuple] = {}
        self._last_flush_ns = _time.perf_counter_ns()
        # Concurrency lanes: event name -> busy slot set (sync spans),
        # and event name -> {slot: (start_ns, tags)} (begin/end spans).
        self._busy: dict[str, set] = {}
        self._open: dict[str, dict] = {}
        self._lanes_used: dict[int, str] = {}
        # Causal tracing: pid-salted monotonic span ids (no
        # randomness in the deterministic core), the tail-retention set
        # (trace_id hex -> keep reason), and per-series exemplars (last
        # traced sample: the Prometheus exposition links a latency
        # bucket to a concrete kept trace).
        self._span_seq = 0
        self.kept_traces: dict[str, str] = {}
        self.exemplars: dict[str, dict] = {}

    # ------------------------------------------------------------ catalog

    def _check(self, event, kind: EventKind, tags: dict) -> Event:
        ev = event if event.__class__ is Event else lookup(event)
        hot = ev._hot
        if hot[1] is not kind:
            raise ValueError(
                f"trace event {ev.name} is a {ev.kind.value}, used as a "
                f"{kind.value}")
        if tags and not set(tags) <= hot[2]:
            raise ValueError(
                f"trace event {ev.name}: tags {sorted(set(tags) - set(ev.tags))} "
                f"are outside its schema {ev.tags}")
        return ev

    def _lane(self, ev: Event) -> int:
        name, _, _, slots, _, tid0 = ev._hot
        busy = self._busy.get(name)
        if busy is None:
            busy = self._busy[name] = set()
        slot = 0 if not busy else next(
            (s for s in range(slots) if s not in busy),
            slots - 1)  # saturated: share the last lane
        busy.add(slot)
        tid = tid0 + slot
        if tid not in self._lanes_used:
            self._lanes_used[tid] = f"{name}[{slot}]"
        return slot

    # -------------------------------------------------------------- spans

    def span(self, event, ctx: Optional[TraceContext] = None, **tags):
        """Open a sync span.  With `ctx` the span joins that request's
        causal tree: it mints a pid-salted span id, records trace_id/
        span_id/parent_id into its args (AFTER schema check — causal
        keys are reserved, not per-event schema), and exposes `.ctx`,
        the child context to propagate onward."""
        ev = self._check(event, EventKind.span, tags)
        return _Span(self, ev, tags, ctx)

    def mint_span_id(self) -> int:
        """Pid-salted monotonic span id (unique across the cluster as
        long as pids are; never 0 — 0 means 'root, no parent')."""
        self._span_seq += 1
        return ((self.pid & 0xFFFF) << 48) | self._span_seq

    def now_ns(self) -> int:
        """Monotonic timestamp in record_span()'s domain.  Call sites
        in the deterministic core use this instead of touching a clock
        directly (the null tracer returns 0 and records nothing)."""
        return _time.perf_counter_ns()

    def record_span(self, event, start_ns: int, dur_ns: int, *,
                    ctx: Optional[TraceContext] = None, span_id: int = 0,
                    links=(), **tags) -> None:
        """Record a completed span with explicit timing (start from
        now_ns()) — for spans whose open/close sites are far apart,
        e.g. the primary's prepare_ok quorum wait."""
        ev = self._check(event, EventKind.span, tags)
        tags = dict(tags)
        if ctx is not None:
            sid = span_id or self.mint_span_id()
            tags["trace_id"] = fmt_trace_id(ctx.trace_id)
            tags["span_id"] = fmt_span_id(sid)
            tags["parent_id"] = fmt_span_id(ctx.parent_span_id)
        if links:
            tags["links"] = sorted(
                {t if isinstance(t, str) else fmt_trace_id(t)
                 for t in links})
        slot = self._lane(ev)
        self._busy[ev._hot[0]].discard(slot)
        self._record(ev, start_ns, dur_ns, tags, ev._hot[5] + slot)

    def keep_trace(self, trace_id, reason: str) -> None:
        """Tail retention: force-keep one trace regardless of the head-
        sampling decision (SLO breach, fallback/poison, recovery)."""
        tid = trace_id if isinstance(trace_id, str) else \
            fmt_trace_id(trace_id)
        if tid not in self.kept_traces:
            self.kept_traces[tid] = reason
            self.count(Event.trace_tail_keep, reason=reason)

    def begin(self, event, **tags) -> None:
        """Open a multi-tick phase span (view change, state sync,
        rebuild). A begin while the event is already open (same slot
        semantics as overlapping sync spans) first closes the open one."""
        ev = self._check(event, EventKind.span, tags)
        open_ = self._open.setdefault(ev.name, {})
        if len(open_) >= ev.slots:
            self.end(ev)  # saturated: close the oldest occurrence
        slot = self._lane(ev)
        open_[slot] = (_time.perf_counter_ns(), tags)

    def end(self, event, **tags) -> None:
        """Close the oldest open occurrence of a begin() span; a no-op
        when none is open (phases may end from several call sites)."""
        ev = self._check(event, EventKind.span, tags)
        open_ = self._open.get(ev.name)
        if not open_:
            return
        slot = min(open_)
        start_ns, begin_tags = open_.pop(slot)
        self._busy[ev.name].discard(slot)
        merged = dict(begin_tags, **tags)
        self._record(ev, start_ns, _time.perf_counter_ns() - start_ns,
                     merged, TID_BASE[ev] + slot)

    # --------------------------------------------------- counters / gauges

    def count(self, event, value: int = 1, **tags) -> None:
        ev = self._check(event, EventKind.counter, tags)
        self.emitted.add(ev.name)
        self.counters[ev.name] = self.counters.get(ev.name, 0) + value
        if self.statsd is not None:
            self.statsd.count(ev.name, value, **tags)
            self._maybe_flush()

    def gauge(self, event, value: float, **tags) -> None:
        ev = self._check(event, EventKind.gauge, tags)
        self.emitted.add(ev.name)
        self.gauges[ev.name] = value
        if self.statsd is not None:
            self.statsd.gauge(ev.name, value, **tags)
            self._maybe_flush()

    # ---------------------------------------------------------- histograms

    def observe(self, event, value: float, **tags) -> None:
        """Record one sample of a histogram-kind event (unit: whatever
        the event's doc declares). Span durations need no observe() —
        every span feeds its event's histogram at close."""
        ev = self._check(event, EventKind.histogram, tags)
        self.emitted.add(ev.name)
        self._histogram(ev, tags).record(value)
        self.aggregates.record(ev.name, float(value),
                               self._hist_tags(ev, tags))
        if self.statsd is not None:
            self._maybe_flush()

    def _hist_tags(self, ev: Event, tags: dict) -> dict:
        if not ev.hist_tags or not tags:
            return {}
        return {k: tags[k] for k in ev.hist_tags if k in tags}

    def _series_key(self, ev: Event, tags: dict) -> str:
        ht = self._hist_tags(ev, tags)
        return ev.name if not ht else ev.name + "|" + ",".join(
            f"{k}:{v}" for k, v in sorted(ht.items()))

    def _histogram(self, ev: Event, tags: dict) -> Histogram:
        key = self._series_key(ev, tags)
        h = self.histograms.get(key)
        if h is None:
            h = self.histograms[key] = Histogram()
            self.histogram_series[key] = (ev.name, self._hist_tags(ev, tags))
        return h

    # ----------------------------------------------------------- recording

    def _record(self, ev: Event, start_ns: int, dur_ns: int,
                tags: dict, tid: int) -> None:
        name = ev._hot[0]
        self.emitted.add(name)
        # Distributions first, ring second: accumulation at span close
        # must be complete BEFORE eviction can touch the span events,
        # so a halved ring never dents a histogram or an aggregate.
        dur_us = dur_ns / 1000.0
        # One hist-tags projection + series key, shared by histogram,
        # aggregates and exemplar (was computed up to four times).
        hts = ev._hot[4]
        ht = ({k: tags[k] for k in hts if k in tags}
              if hts and tags else {})
        key = name if not ht else name + "|" + ",".join(
            f"{k}:{v}" for k, v in sorted(ht.items()))
        h = self.histograms.get(key)
        if h is None:
            h = self.histograms[key] = Histogram()
            self.histogram_series[key] = (name, ht)
        h.record(dur_us)
        if self.statsd is None:
            # Inline count/sum/min/max update (the flush-interval
            # histogram is off without StatsD; see TimingAggregates).
            agg = self._agg
            a = agg.get(key)
            if a is None:
                agg[key] = [1, dur_us, dur_us, dur_us]
                self.aggregates._series[key] = (name, ht)
            else:
                a[0] += 1
                a[1] += dur_us
                if dur_us < a[2]:
                    a[2] = dur_us
                if dur_us > a[3]:
                    a[3] = dur_us
        else:
            self.aggregates.record(name, dur_us, ht, key=key)
        if "trace_id" in tags:
            # Exemplar: the last traced sample per series, linking a
            # latency distribution back to one concrete request trace.
            self.exemplars[key] = {
                "value": dur_us, "trace_id": tags["trace_id"]}
        if len(self.events) >= self.capacity:
            dropped = self.capacity // 2
            del self.events[:dropped]
            self.dropped_events += dropped
            # Self-describing truncation (satellite: a halved ring must
            # say so): a counter plus an instant marker INSIDE the trace.
            self.count(Event.trace_dropped_events, dropped)
            self.events.append({
                "name": Event.trace_dropped_events.name, "ph": "i",
                "ts": (start_ns + self._epoch_ns) / 1000.0,
                "pid": self.pid, "tid": 0, "s": "p",
                "args": {"dropped_total": self.dropped_events},
            })
        self.events.append({
            "name": name, "ph": "X",
            "ts": (start_ns + self._epoch_ns) / 1000.0,
            "dur": dur_us,
            "pid": self.pid, "tid": tid, "args": tags,
        })
        if self.statsd is not None:
            self._maybe_flush()

    def _maybe_flush(self) -> None:
        now = _time.perf_counter_ns()
        if now - self._last_flush_ns >= self.emit_interval_s * 1e9:
            self._last_flush_ns = now
            self.aggregates.flush_to(self.statsd)

    def flush_statsd(self) -> None:
        """Force-flush the timing aggregates (shutdown path)."""
        if self.statsd is not None:
            self._last_flush_ns = _time.perf_counter_ns()
            self.aggregates.flush_to(self.statsd)

    # --------------------------------------------------------------- dump

    def chrome_dict(self) -> dict:
        """Chrome/Perfetto-loadable document with process/thread names
        and the metadata block trace/merge.py keys on."""
        meta_events = [{
            "name": "process_name", "ph": "M", "pid": self.pid, "tid": 0,
            "args": {"name": f"replica {self.pid}"},
        }]
        for tid in sorted(self._lanes_used):
            meta_events.append({
                "name": "thread_name", "ph": "M", "pid": self.pid,
                "tid": tid, "args": {"name": self._lanes_used[tid]},
            })
        return {
            "traceEvents": meta_events + self.events,
            "metadata": {
                "pid": self.pid,
                "clock_anchor_ns": self._epoch_ns,
                "dropped_events": self.dropped_events,
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                # Tail-retention + exemplar state: merged across
                # documents so assemble_traces() keeps a trace any pid
                # flagged, and the metrics exposition can attach
                # exemplars after a merge.
                "kept_traces": dict(self.kept_traces),
                "exemplars": {k: dict(v)
                              for k, v in self.exemplars.items()},
                "aggregates": self.aggregates.snapshot(),
                # Cumulative per-series distributions: losslessly
                # mergeable across replica documents (trace/merge.py
                # adds bucket counts), eviction-proof unlike the ring.
                "histograms": {
                    key: {"event": self.histogram_series[key][0],
                          "tags": dict(self.histogram_series[key][1]),
                          **h.to_dict()}
                    for key, h in self.histograms.items()},
            },
        }

    def dump_chrome_trace(self, path: str) -> None:
        """Chrome/Perfetto-loadable trace (reference: --trace=file)."""
        with open(path, "w") as f:
            json.dump(self.chrome_dict(), f)


class _Span:
    __slots__ = ("tracer", "event", "tags", "start", "slot",
                 "ctx_in", "span_id", "_links")

    def __init__(self, tracer: Tracer, event: Event, tags: dict,
                 ctx: Optional[TraceContext] = None):
        self.tracer = tracer
        self.event = event
        self.tags = tags
        self.ctx_in = ctx
        self.span_id = 0
        self._links: set = set()

    @property
    def ctx(self) -> Optional[TraceContext]:
        """The context THIS span's children should carry (parent = this
        span's id); None when the span was opened without a context."""
        if self.ctx_in is None:
            return None
        return self.ctx_in.child(self.span_id)

    def link(self, trace_id) -> None:
        """Span link: tie this span into another request's trace (the
        batching fan-in — a window span links every constituent)."""
        self._links.add(trace_id if isinstance(trace_id, str)
                        else fmt_trace_id(trace_id))

    def __enter__(self):
        self.slot = self.tracer._lane(self.event)
        if self.ctx_in is not None:
            self.span_id = self.tracer.mint_span_id()
        self.start = _time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = _time.perf_counter_ns() - self.start
        hot = self.event._hot
        self.tracer._busy[hot[0]].discard(self.slot)
        tags = self.tags
        if self.ctx_in is not None or self._links:
            # Causal args ride beside the schema-checked tags; they are
            # reserved keys, not per-event schema, and never partition a
            # histogram series (only hist_tags do).
            tags = dict(tags)
            if self.ctx_in is not None:
                tags["trace_id"] = fmt_trace_id(self.ctx_in.trace_id)
                tags["span_id"] = fmt_span_id(self.span_id)
                tags["parent_id"] = fmt_span_id(self.ctx_in.parent_span_id)
            if self._links:
                tags["links"] = sorted(self._links)
        self.tracer._record(self.event, self.start, dur, tags,
                            hot[5] + self.slot)
        return False
