"""Tracing and metrics: the typed catalog, spans, StatsD and the flight
recorder — the subset the serving supervisor, the ledger and the
admission plane use, copied from the JAX reference package so traces
from both packages merge.

- `event.py`  — the typed event catalog (every legal span/counter/gauge/
  histogram, fixed tag schemas, per-event concurrency lanes), equal to
  the JAX package's member for member.
- `tracer.py` — NullTracer (the default, no overhead) and the recording
  Tracer (bounded ring with self-describing eviction, wall-clock
  anchored timestamps, per-event timing aggregates). Spans read the
  host clock only: a span around asynchronous device work measures the
  host's time, not the card's.
- `statsd.py` — DogStatsD UDP emission + interval-flushed aggregates.
- `histogram.py` — log2-bucketed, losslessly mergeable histograms.
- `context.py` — the compact trace-context block, deterministic minting
  and head sampling.
- `flight_recorder.py` — the bounded ring of per-window records dumped
  as a JSON artifact on recovery.
"""

from .context import (TraceContext, fmt_span_id, fmt_trace_id,
                      head_sampled, mint_context, mint_trace_id)
from .event import CATALOG, TID_BASE, Event, EventKind, EventSpec, lookup
from .flight_recorder import FlightRecorder, merge_flight_records
from .histogram import Histogram
from .statsd import StatsD, TimingAggregates
from .tracer import NullTracer, Tracer

__all__ = [
    "CATALOG", "TID_BASE", "Event", "EventKind", "EventSpec", "lookup",
    "TraceContext", "fmt_span_id", "fmt_trace_id", "head_sampled",
    "mint_context", "mint_trace_id",
    "FlightRecorder", "merge_flight_records",
    "Histogram", "StatsD", "TimingAggregates",
    "NullTracer", "Tracer",
]
