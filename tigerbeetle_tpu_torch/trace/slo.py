"""SLO engine: declared latency objectives, evaluation, burn rates.

`slo.json` declares the service-level objectives (the ROADMAP's
"per-class p50/p99 latency SLOs tracked in bench + devhub"). Schema:

    {
      "burn_window_runs": 8,          # sliding window for burn rates
      "burn_budget": 0.25,            # tolerated breach fraction
      "objectives": [
        {"name": "chain_window_p99_ms",
         "event": "window_commit",     # MUST be a catalog member
         "tags": {"route": "chain"},   # histogram series filter
         "quantile": 0.99,
         "threshold": 250.0,           # in `unit`
         "unit": "ms",                 # ms (span durations) | raw
         "doc": "..."}
      ]
    }

Every objective references a trace-catalog event; an off-catalog event
is a hard error at load time (a "dead SLO" — an objective nothing can
ever feed — is RED in the gate's metrics leg). Evaluation reads the
recording tracer's cumulative histograms: an objective with no samples
is `ok: None` (unknown), a breached one emits the `slo_breach` counter.
Burn-rate accounting is run-granular: over the trailing
`burn_window_runs` bench/devhub records, the burn rate is the fraction
of evaluated runs in breach; burn above `burn_budget` (or a breach in
the latest run) raises the devhub panel's badge.

The port's copy of the JAX package's `trace/slo.py`. It reads its own
copy of the JAX package's data file (`perf/slo.json`, equal byte for
byte, held so by tests/test_torch_gate_legs.py): `slo.json` beside this
module, against the port's catalog.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

from .event import Event, EventKind, lookup
from .histogram import Histogram

DEFAULT_SLO_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "slo.json")


@dataclasses.dataclass(frozen=True)
class Objective:
    name: str
    event: str
    quantile: float
    threshold: float
    tags: dict = dataclasses.field(default_factory=dict)
    unit: str = "ms"
    doc: str = ""


def load_objectives(path: Optional[str] = None) -> dict:
    """Parse slo.json -> {"objectives": [Objective...],
    "burn_window_runs": int, "burn_budget": float}. Raises ValueError
    on schema violations or objectives referencing off-catalog events
    (dead SLOs cannot ship — the gate metrics leg runs exactly this)."""
    path = path or DEFAULT_SLO_PATH
    with open(path) as f:
        raw = json.load(f)
    objectives = []
    seen = set()
    for o in raw.get("objectives", []):
        name = o.get("name")
        if not name or name in seen:
            raise ValueError(f"slo.json: missing/duplicate name {name!r}")
        seen.add(name)
        try:
            ev = lookup(o["event"])
        except KeyError as e:
            raise ValueError(
                f"slo.json objective {name!r}: {e.args[0]}") from e
        if ev.kind not in (EventKind.span, EventKind.histogram):
            raise ValueError(
                f"slo.json objective {name!r}: event {ev.name} is a "
                f"{ev.kind.value}; objectives need a distribution "
                f"(span or histogram)")
        tags = o.get("tags") or {}
        if not set(tags) <= set(ev.hist_tags):
            raise ValueError(
                f"slo.json objective {name!r}: tags {sorted(tags)} are "
                f"not histogram dimensions of {ev.name} "
                f"(has {list(ev.hist_tags)})")
        q = float(o.get("quantile", 0.99))
        if not 0.0 < q <= 1.0:
            raise ValueError(f"slo.json objective {name!r}: quantile {q}")
        objectives.append(Objective(
            name=name, event=ev.name, quantile=q,
            threshold=float(o["threshold"]), tags=dict(tags),
            unit=o.get("unit", "ms"), doc=o.get("doc", "")))
    if not objectives:
        raise ValueError(f"slo.json at {path} declares no objectives")
    return {
        "objectives": objectives,
        "burn_window_runs": int(raw.get("burn_window_runs", 8)),
        "burn_budget": float(raw.get("burn_budget", 0.25)),
    }


def _series_for(tracer, objective: Objective) -> Histogram:
    """Merge the tracer histogram series matching the objective's event
    + tag filter (an empty filter aggregates every series of the
    event)."""
    out = Histogram()
    for key, (name, tags) in tracer.histogram_series.items():
        if name != objective.event:
            continue
        if any(tags.get(k) != v for k, v in objective.tags.items()):
            continue
        out.merge(tracer.histograms[key])
    return out


def _exemplar_trace_ids(tracer, objective: Objective) -> list:
    """Trace ids exemplifying the objective's series: the tracer keeps
    one exemplar (latest traced sample) per histogram series; a breach
    tail-keeps exactly these, tying the breached distribution back to
    concrete causal request traces."""
    out = []
    exemplars = getattr(tracer, "exemplars", None)
    if not exemplars:
        return out
    for key, (name, tags) in tracer.histogram_series.items():
        if name != objective.event:
            continue
        if any(tags.get(k) != v for k, v in objective.tags.items()):
            continue
        ex = exemplars.get(key)
        if ex and ex.get("trace_id"):
            out.append(ex["trace_id"])
    return out


def evaluate(tracer, objectives, emit_to=None) -> list:
    """Evaluate objectives against a recording tracer's cumulative
    histograms. Returns one row per objective:
    {name, event, quantile, value, threshold, unit, count, ok} with
    ok=None when the series is empty (unknown, not a breach). With
    `emit_to` (a tracer), each breach counts the `slo_breach` catalog
    event tagged with the objective name, and tail-retains the breached
    series' exemplar traces (keep_trace reason "slo_breach") so a
    1%-head-sampled deployment still keeps every breach's trace."""
    rows = []
    for o in objectives:
        h = _series_for(tracer, o)
        value = h.quantile(o.quantile)
        if value is not None and o.unit == "ms" and Event[o.event].kind \
                is EventKind.span:
            value /= 1000.0  # span histograms accumulate microseconds
        ok = None if value is None else bool(value <= o.threshold)
        if ok is False and emit_to is not None:
            emit_to.count(Event.slo_breach, objective=o.name)
            for tid in _exemplar_trace_ids(tracer, o):
                emit_to.keep_trace(tid, reason="slo_breach")
        rows.append({
            "name": o.name, "event": o.event, "quantile": o.quantile,
            "value": None if value is None else round(value, 3),
            "threshold": o.threshold, "unit": o.unit,
            "count": h.count, "ok": ok,
        })
    return rows


def evaluate_bench_record(record: dict, objectives) -> list:
    """Evaluate objectives against one bench/devhub record (offline —
    the devhub panel's per-run data point). Serving-window objectives
    read the record's per-window latency histogram
    (serving_batch_latency.histogram, milliseconds); anything the
    record does not carry evaluates to ok=None. Device-telemetry
    objectives (device_exchange_occupancy — the exchange-headroom burn
    early warning) read the shard probe's harvested distribution
    (shard_balance.telemetry.exchange_occupancy, already in the
    event's declared unit)."""
    lat = record.get("serving_batch_latency") or {}
    hist = None
    if isinstance(lat.get("histogram"), dict):
        try:
            hist = Histogram.from_dict(lat["histogram"])
        except (AssertionError, ValueError, TypeError):
            hist = None
    tel = (record.get("shard_balance") or {}).get("telemetry") or {}
    tel_hist = None
    if isinstance(tel.get("exchange_occupancy"), dict):
        try:
            tel_hist = Histogram.from_dict(tel["exchange_occupancy"])
        except (AssertionError, ValueError, TypeError):
            tel_hist = None
    rows = []
    for o in objectives:
        value = None
        count = 0
        if o.event == "window_commit":
            if hist is not None:
                value = hist.quantile(o.quantile)  # already ms
                count = hist.count
            elif o.quantile == 0.99 and lat.get("p99_ms") is not None:
                value = float(lat["p99_ms"])
        elif o.event == "device_exchange_occupancy" \
                and tel_hist is not None:
            value = tel_hist.quantile(o.quantile)  # already pct
            count = tel_hist.count
        ok = None if value is None else bool(value <= o.threshold)
        rows.append({
            "name": o.name, "event": o.event, "quantile": o.quantile,
            "value": None if value is None else round(value, 3),
            "threshold": o.threshold, "unit": o.unit,
            "count": count, "ok": ok,
        })
    return rows


def burn_rates(per_run_rows: list, window_runs: int,
               budget: float) -> dict:
    """Run-granular burn accounting: `per_run_rows` is a list (oldest
    first) of evaluate()/evaluate_bench_record() outputs, one per run.
    Returns {objective: {burn_rate, breaches, evaluated, budget,
    breached_now, badge}} over the trailing `window_runs` runs; runs
    where the objective was unknown don't consume error budget."""
    out: dict = {}
    recent = per_run_rows[-window_runs:]
    names = {r["name"] for rows in recent for r in rows}
    for name in sorted(names):
        verdicts = [r["ok"] for rows in recent for r in rows
                    if r["name"] == name and r["ok"] is not None]
        breaches = sum(1 for v in verdicts if v is False)
        burn = round(breaches / len(verdicts), 4) if verdicts else 0.0
        breached_now = bool(verdicts) and verdicts[-1] is False
        out[name] = {
            "burn_rate": burn, "breaches": breaches,
            "evaluated": len(verdicts), "window_runs": window_runs,
            "budget": budget, "breached_now": breached_now,
            "badge": breached_now or burn > budget,
        }
    return out
