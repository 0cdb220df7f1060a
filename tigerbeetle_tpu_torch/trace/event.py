"""Typed trace-event catalog: every legal span, counter, and gauge.

reference: src/trace/event.zig — the reference compiles a closed event
catalog into every hot path (commit stages, storage, grid, message bus)
and derives both the Chrome-trace lanes and the StatsD metric names from
it. Here the catalog is the single source of truth for:

- **legal names**: under the recording `Tracer` a span/counter/gauge
  whose name is not a catalog member is a HARD error (free-form strings
  cannot ship — scripts/gate.py's coverage leg additionally fails when a
  catalog member is never emitted by the smokes, so dead metrics cannot
  ship either);
- **fixed tag schemas**: each event declares its legal tag keys; an
  out-of-schema tag is an error, which bounds metric cardinality at the
  call site instead of in the aggregation backend;
- **stable Chrome `tid` lanes**: each span event owns a fixed lane range
  (`TID_BASE[event] .. +slots`), so overlapping occurrences (e.g. two
  in-flight block repairs) render on stable per-event lanes in any trace
  from any build (event.zig derives its tids the same way).

The catalog is append-oriented: renaming/removing an event breaks the
continuity of its StatsD series, so prefer adding. Every event listed
here is exercised by the gate's trace-coverage leg
of the JAX reference package, whose catalog this one equals member for
member (same names, kinds, tags and order), so traces from both merge.
"""

from __future__ import annotations

import dataclasses
import enum


class EventKind(enum.Enum):
    span = "span"
    counter = "counter"
    gauge = "gauge"
    histogram = "histogram"


@dataclasses.dataclass(frozen=True)
class EventSpec:
    kind: EventKind
    tags: tuple = ()
    slots: int = 1  # concurrency lanes (spans only)
    doc: str = ""
    # Histogram partition dimensions: the subset of `tags` whose values
    # split this event's distribution into separate series (bounded
    # cardinality — route/tier class labels, never ids). Every span
    # event owns a duration histogram (fed at span close); hist_tags
    # empty means one series per event.
    hist_tags: tuple = ()


def _span(doc: str, *tags: str, slots: int = 1,
          hist_tags: tuple = ()) -> EventSpec:
    assert set(hist_tags) <= set(tags), (hist_tags, tags)
    return EventSpec(EventKind.span, tuple(tags), slots, doc,
                     tuple(hist_tags))


def _counter(doc: str, *tags: str) -> EventSpec:
    return EventSpec(EventKind.counter, tuple(tags), 1, doc)


def _gauge(doc: str, *tags: str) -> EventSpec:
    return EventSpec(EventKind.gauge, tuple(tags), 1, doc)


def _histogram(doc: str, *tags: str) -> EventSpec:
    """A standalone distribution metric (observed via Tracer.observe,
    unit declared in the doc line) — the third metric kind beside
    counters and gauges; span events get duration histograms for free."""
    return EventSpec(EventKind.histogram, tuple(tags), 1, doc,
                     tuple(tags))


class Event(enum.Enum):
    """The catalog. Member name == Chrome span name == StatsD metric
    name (under the `tb_tpu.` prefix)."""

    # ----------------------------------------------- replica commit stages
    commit_prefetch = _span(
        "journal read of the next committable prepare", "op")
    commit_execute = _span(
        "state-machine execution of one prepare or one aggregated "
        "commit window", "op", "operation", "window")
    commit_compact = _span(
        "durable flush of the committed op + one compaction beat", "op")
    commit_checkpoint = _span(
        "forest checkpoint + superblock flip", "op")
    commits = _counter("prepares committed")
    commit_windows = _counter("aggregated multi-prepare window commits")
    rollbacks = _counter("checkpoint rollbacks on divergence detection")

    # ------------------------------------------------------------- journal
    journal_write = _span("WAL prepare+header pair write (submit)", "op")
    journal_recover = _span("full WAL two-ring recovery scan")

    # ---------------------------------------------------------------- grid
    grid_scrub_tick = _span("one paced scrubber tick of block reads")
    grid_scrub_certify = _span(
        "unpaced full scrub tour (post-rebuild certification)")
    grid_repair_block = _span(
        "peer-provided block validated and installed over a corrupt one",
        slots=4)

    # -------------------------------------------- view change / sync / rebuild
    view_change = _span("view change, start to new-view adoption", "view")
    state_sync = _span("checkpoint state sync, offer to install",
                       "target_op")
    rebuild = _span("rebuild-from-cluster, open_rebuild to voter re-entry")

    # --------------------------------------------------------- message bus
    # `csum` is the frame's header-checksum low bits: the SAME value is
    # tagged on the sender's bus_send and the receiver's bus_recv, which
    # is how trace/merge.py matches send/recv pairs across pids to
    # estimate per-pid clock offsets before causal assembly.
    bus_send = _span("serialize + enqueue one outbound message",
                     "command", "csum")
    bus_recv = _span("deliver one validated inbound message",
                     "command", "csum")
    bus_pool_used = _gauge("outbound message-pool slots in use")
    config_mismatch_peer = _counter(
        "pings rejected for a cluster-config fingerprint mismatch")

    # ------------------------------------------------------------- serving
    serving_dispatch = _span(
        "one supervised device dispatch (includes retries)", "what")
    serving_epoch_verify = _span(
        "epoch verification: quiesce + oracle replay + digest + audit")
    serving_recovery_replay = _span(
        "quarantine + bounded oracle replay + device rebuild", "cause")
    serving_retries = _counter("device dispatch retries")
    serving_recoveries = _counter("serving recoveries", "cause")
    dispatch_route = _counter(
        "window/batch dispatches by kernel route (chain = the default "
        "scan-form whole-window route)", "route")
    window_commit = _span(
        "one serving commit window, submit to resolve, tagged with the "
        "dispatch route it took and its shape tier (scan = the chain "
        "whole-window scan, flat = an unrolled super route, fallback = "
        "per-batch) — the per-class latency distributions the SLO "
        "engine reads", "route", "tier", hist_tags=("route", "tier"))
    window_stage = _span(
        "host-side staging of one commit window's stacked operands "
        "(numpy pack + pytree device transfer): overlapped = packed on "
        "the staging worker while the previous window's dispatch was "
        "in flight (the recorded duration is the WAIT the dispatch "
        "path actually paid, usually ~0), inline = packed "
        "synchronously on the dispatch path (the duration is the full "
        "pack+transfer cost)", "mode", "route", hist_tags=("mode",))
    host_stall_fraction = _gauge(
        "fraction of host window-staging work the dispatch path "
        "actually waited on, cumulative per ledger (stall_ms / total "
        "staging work): 1.0 = fully synchronous staging (every pack "
        "blocks the dispatch), ~0 = the pack/transfer fully hidden "
        "behind in-flight device execution — the overlap gate leg's "
        "ceiling reads this")
    serving_replay_windows = _histogram(
        "windows replayed per recovery (unit: windows; the bounded-"
        "replay objective in perf/slo.json reads this distribution)")
    slo_breach = _counter(
        "SLO objectives observed in breach at evaluation "
        "(trace/slo.py against perf/slo.json)", "objective")

    # ------------------------------------------------------ sharded router
    router_step = _span("one sharded (or degraded single-chip) batch step",
                        "mode", "degraded")
    router_fallback = _counter("host fallbacks off the sharded step",
                               "cause")
    router_reroute = _counter(
        "batches rerouted to the single-chip step under shard loss")
    shard_exchange = _span(
        "partitioned-state batch step: on-device event exchange + "
        "per-shard fixpoint + owner-masked write-back", "mode")
    cross_shard_transfers = _counter(
        "created transfers whose debit and credit accounts live on "
        "different shards (resolved via the exchange join)")
    reshard_stage = _span(
        "one stage of a live resharding migration (parallel/"
        "resharding.py five-stage protocol): stage is snapshot|copy|"
        "double_write|flip|retire, outcome is ok|abort — an abort "
        "freezes a flight artifact and reverts the overlay",
        "stage", "outcome")
    reshard_rows_copied = _counter(
        "account+transfer rows streamed source->target by the copy "
        "stage of a resharding migration (chunked; counted per chunk)")
    reshard_overlay_active = _gauge(
        "overlay entries currently active in the ownership table "
        "(0 = base map only; >0 = a migration is between its first "
        "double-write window and its retire/flip)")

    # ----------------------------------------------------- device telemetry
    # Decoded host-side from the fixed-layout u32 telemetry block the
    # partitioned route harvests with its outputs (parallel/partitioned
    # TEL_LAYOUT): measured ON DEVICE per prepare, never host-side
    # guesswork.
    device_fixpoint_rounds = _histogram(
        "fixpoint rounds the judge actually consumed per prepare "
        "(unit: rounds; 0 = the proof-gated plain tier)")
    device_poison_cause = _counter(
        "prepares poisoned/escalated on device, by decoded cause code",
        "cause")
    device_exchange_occupancy = _histogram(
        "exchange-lane occupancy per psum phase (unit: pct of the "
        "static lane capacity; the headroom-burn early-warning "
        "objective in perf/slo.json reads this distribution)", "phase")
    device_ring_occupancy = _histogram(
        "per-shard event-ring rows after write-back (unit: rows)")
    device_writeback_rows = _counter(
        "owner-masked transfer rows written back across all shards")
    flight_recorder_dump = _counter(
        "flight-recorder artifacts dumped for post-mortem", "reason")

    # ------------------------------------------------------ admission plane
    # Session ingress + SLO-driven load shedding in front of the
    # serving supervisor (admission.py). `decision`
    # is admit|shed; `cls` is the priority class (critical/standard/
    # batch by default); `reason` is the shed cause (no_credit,
    # queue_full, shed_line, deadline, drain) and is omitted on admits.
    # The span duration is the request's QUEUE WAIT (enqueue to window
    # dispatch for admits, enqueue to rejection for sheds) on the
    # plane's clock — the per-class admitted-latency distributions the
    # SLO engine's admission objectives read.
    admission_decision = _span(
        "one admission decision: request enqueue to window dispatch "
        "(admit) or to typed ShedResult (shed); duration = queue wait "
        "on the plane clock", "decision", "cls", "reason",
        hist_tags=("decision", "cls"))
    admission_shed = _counter(
        "requests rejected with a typed ShedResult", "cls", "reason")
    admission_credit_occupancy = _gauge(
        "admission queue occupancy, 0..1 of the plane's bounded queue "
        "capacity (sampled once per pump tick)")

    # -------------------------------------------------- causal tracing
    # Per-request spans.  These carry a propagated trace
    # context (trace_id/span_id/parent_id recorded as span args), so
    # trace/merge.py's assemble_traces() can rebuild one causal tree
    # per client request across client + replica dumps.
    client_request = _span(
        "one client request, submit to reply (the causal root span "
        "every downstream span parents to)", "operation")
    commit_quorum = _span(
        "primary's prepare_ok quorum wait: prepare fan-out to quorum "
        "reached (explicit-timing span recorded at quorum)", "op")
    replica_ack = _span(
        "backup replication of one traced prepare: receipt to the "
        "durable-slot prepare_ok", "op")
    trace_tail_keep = _counter(
        "traces force-kept by tail retention (SLO breach, fallback/"
        "poison cause, supervisor recovery) regardless of the head-"
        "sampling decision", "reason")

    # ------------------------------------------- performance observatory
    # Sampled dispatch profiling, device-memory watermarks,
    # and burn-rate alerting (trace/profiler.py, trace/memwatch.py,
    # trace/alerts.py). `dispatch_device_time` is the profiler's
    # measured device time of one SAMPLED dispatch (block-until-ready
    # timer, or a profiler capture where the backend supports it);
    # the memory gauges are the host-side static-allocation ledger's
    # watermark vs the committed perf/membudget_r*.json; `alert_fired`
    # counts typed alert firings from the multi-window burn-rate engine.
    dispatch_device_time = _histogram(
        "device time of one sampled serving dispatch (unit: us; "
        "sampled 1/N by trace/profiler.py DispatchProfiler, partitioned "
        "by dispatch route and shape tier — the measured side of the "
        "achieved-vs-roofline fraction)", "route", "tier")
    memory_watermark_bytes = _gauge(
        "static-allocation ledger watermark: bytes the serving ledger "
        "holds resident (state pytree + staged packs + telemetry block "
        "+ scratch), summed across components by trace/memwatch.py — "
        "checked against the committed perf/membudget_r*.json")
    memory_budget_headroom_bytes = _gauge(
        "committed memory budget minus the current watermark (negative "
        "= over budget, the memwatch gate leg REDs)")
    alert_fired = _counter(
        "typed alerts fired by the multi-window burn-rate engine "
        "(trace/alerts.py), by rule and severity; a page-severity "
        "firing freezes a flight-recorder artifact and tail-keeps the "
        "breaching traces under reason alert:<rule>", "rule", "severity")

    # ------------------------------------------------------ tracer internal
    trace_dropped_events = _counter(
        "span ring evictions (the trace is truncated at its start)")

    @property
    def kind(self) -> EventKind:
        return self.value.kind

    @property
    def tags(self) -> tuple:
        return self.value.tags

    @property
    def slots(self) -> int:
        return self.value.slots

    @property
    def doc(self) -> str:
        return self.value.doc

    @property
    def hist_tags(self) -> tuple:
        return self.value.hist_tags


CATALOG: dict = {e.name: e for e in Event}

# Stable Chrome lanes: tid 0 is reserved for instant markers/metadata;
# each span event owns [TID_BASE[e], TID_BASE[e] + e.slots).
TID_BASE: dict = {}
_next = 1
for _e in Event:
    TID_BASE[_e] = _next
    if _e.kind == EventKind.span:
        _next += _e.slots

# Hot-path constants, stapled onto each member as a PLAIN instance
# attribute: `ev._hot` is one C-speed attribute read, where `ev.name`
# costs a DynamicClassAttribute descriptor hop, `ev.tags` a property
# into the EventSpec, and any dict keyed by the member a Python-level
# Enum.__hash__ call. The recording tracer's span-close path reads
# several of these per span; the bench ##trace overhead ratios guard
# the sum. Layout: (name, kind, frozenset(tags), slots, hist_tags,
# TID_BASE[member]).
for _e in Event:
    _e._hot = (_e.name, _e.kind, frozenset(_e.tags), _e.slots,
               _e.hist_tags, TID_BASE[_e])
del _next, _e


def lookup(name) -> Event:
    """Resolve an Event member or its string name; KeyError text names
    the offender (the recording tracer's hard-error path)."""
    if isinstance(name, Event):
        return name
    ev = CATALOG.get(name)
    if ev is None:
        raise KeyError(
            f"trace event {name!r} is not in the catalog "
            f"(trace/event.py); free-form names are "
            f"rejected under the recording tracer")
    return ev
