"""Tracing and metrics: the typed catalog, spans, StatsD, the flight
recorder and the performance observatory, copied from the JAX reference
package (so traces from both packages merge) where no device is
involved, and ported where one is.

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
- `merge.py`  — cluster-wide trace merge (pid=replica, common timeline),
  exact offline span quantiles, critical paths and causal assembly.
- `slo.py`    — objectives from slo.json, evaluation against live
  histograms, and run-granular burn-rate accounting.
- `alerts.py` — the burn-rate alert rules of slo.json, parsed and
  checked, and the multi-window multi-burn-rate `AlertEngine` the
  serving supervisor ticks once a committed window (typed alerts,
  `alert:<rule>` tail retention, page-severity flight freezes).
- `profiler.py` — the observatory's dispatch side: sampled dispatch
  timing to the ledger's device being idle (`dispatch_device_time`), a
  one-shot torch.profiler capture, and the static FLOPs / device-bytes
  cost model with achieved-vs-roofline fractions per dispatch tier.
- `memwatch.py` — the device-memory watermark plane: the deterministic
  static-allocation ledger (bytes per component from shapes) audited
  against the port's committed `trace/membudget.json`, plus the CUDA
  allocator's stats and the window graphs' pools.
"""

from .alerts import Alert, AlertEngine, AlertRule, load_alert_rules
from .context import (TraceContext, fmt_span_id, fmt_trace_id,
                      head_sampled, mint_context, mint_trace_id)
from .event import CATALOG, TID_BASE, Event, EventKind, EventSpec, lookup
from .flight_recorder import FlightRecorder, merge_flight_records
from .histogram import Histogram
from .memwatch import (MemWatch, check_budget, device_memory_stats,
                       load_budget, measure_ledger, pytree_bytes,
                       static_ledger)
from .merge import (CRITICAL_PATH_STAGES, assemble_traces, causal_edges,
                    critical_path, estimate_clock_offsets,
                    merge_trace_files, merge_traces, span_quantile)
from .profiler import (DispatchProfiler, measured_dispatch_us,
                       profile_probe, roofline_fractions,
                       roofline_seconds, static_cost_model)
from .slo import (Objective, burn_rates, evaluate, evaluate_bench_record,
                  load_objectives)
from .statsd import StatsD, TimingAggregates
from .tracer import NullTracer, Tracer

__all__ = [
    "CATALOG", "TID_BASE", "Event", "EventKind", "EventSpec", "lookup",
    "TraceContext", "fmt_span_id", "fmt_trace_id", "head_sampled",
    "mint_context", "mint_trace_id",
    "FlightRecorder", "merge_flight_records",
    "Histogram", "CRITICAL_PATH_STAGES", "critical_path",
    "assemble_traces", "causal_edges", "estimate_clock_offsets",
    "merge_trace_files", "merge_traces", "span_quantile",
    "Objective", "burn_rates", "evaluate", "evaluate_bench_record",
    "load_objectives", "StatsD", "TimingAggregates",
    "NullTracer", "Tracer",
    "Alert", "AlertEngine", "AlertRule", "load_alert_rules",
    "MemWatch", "check_budget", "device_memory_stats", "load_budget",
    "measure_ledger", "pytree_bytes", "static_ledger",
    "DispatchProfiler", "measured_dispatch_us", "profile_probe",
    "roofline_fractions", "roofline_seconds", "static_cost_model",
]
