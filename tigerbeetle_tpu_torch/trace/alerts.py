"""Burn-rate alert rules over the SLO objectives: slo.json's
``alerts`` section, parsed and checked against its own objectives.

Each rule watches one declared objective and fires SRE-style, when both
a fast and a slow burn window exceed their burn thresholds (Google SRE
workbook ch.5, in commit-window ticks). A rule naming an objective that
slo.json does not declare, an unknown severity, inverted windows or
a missing runbook anchor is a load-time ValueError.

Mechanics per tick (a tick = one committed serving window, decimated
by ``tick_every``): the rule's objective is evaluated over the DELTA of
its histogram series since the previous tick (cumulative histograms
subtract losslessly), so a burn is about what just happened; a tick
with no new samples is UNKNOWN and neither consumes error budget nor
resolves an alert; breach bits land in a ring of ``slow_window`` ticks,
the rule fires when both burns breach (with at least ``fast_window``
known ticks) and resolves after ``hysteresis`` consecutive healthy
known ticks.

A firing is a typed `Alert` (severity, runbook anchor, the breaching
value, both burn rates, the exemplar trace ids of the breaching series,
which it force-keeps through tail retention under ``alert:<rule>``); a
page-severity firing also freezes a flight-recorder artifact
(``alert_<rule>`` cause).

A copy of the JAX package's `trace/alerts.py`: the rules devhub lists
and the `AlertEngine` the serving supervisor ticks once a committed
window (`ServingSupervisor(alert_engine=...)` binds it to the
supervisor's tracer and flight recorder).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

from .event import Event, EventKind
from .histogram import Histogram
from .slo import (DEFAULT_SLO_PATH, Objective, _exemplar_trace_ids,
                  _series_for, load_objectives)

SEVERITIES = ("page", "ticket")


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """One burn-rate rule over a declared SLO objective."""

    name: str
    objective: str           # slo.json objective name
    fast_window: int         # ticks; the cliff detector
    slow_window: int         # ticks; the blip filter (> fast_window)
    fast_burn: float         # breach fraction to trip the fast window
    slow_burn: float         # breach fraction to trip the slow window
    severity: str = "ticket"  # page | ticket
    hysteresis: int = 8      # healthy known ticks to resolve
    runbook: str = ""        # anchor into docs/operating/monitoring.md
    doc: str = ""


@dataclasses.dataclass
class Alert:
    """A typed firing: everything the responder needs, pre-assembled."""

    rule: str
    objective: str
    severity: str
    runbook: str
    fired_tick: int
    value: Optional[float]       # breaching delta quantile (obj. unit)
    threshold: float
    fast_burn_rate: float
    slow_burn_rate: float
    trace_ids: list = dataclasses.field(default_factory=list)
    flight_path: Optional[str] = None
    resolved_tick: Optional[int] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def load_alert_rules(path: Optional[str] = None) -> dict:
    """Parse slo.json's ``alerts`` section against its own
    objectives. Returns {"rules": [AlertRule...], "objectives":
    {name: Objective}}. A rule referencing an undeclared objective, an
    unknown severity, or inverted windows is a ValueError — the
    dead-rule RED the gate's profile leg proves."""
    import json

    path = path or DEFAULT_SLO_PATH
    loaded = load_objectives(path)
    by_name = {o.name: o for o in loaded["objectives"]}
    with open(path) as f:
        raw = json.load(f)
    rules = []
    seen = set()
    for r in raw.get("alerts", []):
        name = r.get("name")
        if not name or name in seen:
            raise ValueError(
                f"slo.json alerts: missing/duplicate rule name {name!r}")
        seen.add(name)
        obj = r.get("objective")
        if obj not in by_name:
            raise ValueError(
                f"slo.json alert {name!r}: objective {obj!r} is not "
                f"declared in {sorted(by_name)} — a dead rule nothing "
                f"can ever evaluate")
        sev = r.get("severity", "ticket")
        if sev not in SEVERITIES:
            raise ValueError(
                f"slo.json alert {name!r}: severity {sev!r} not in "
                f"{SEVERITIES}")
        fast_w = int(r.get("fast_window", 8))
        slow_w = int(r.get("slow_window", 32))
        if not 0 < fast_w < slow_w:
            raise ValueError(
                f"slo.json alert {name!r}: windows must satisfy "
                f"0 < fast ({fast_w}) < slow ({slow_w})")
        fast_b = float(r.get("fast_burn", 0.5))
        slow_b = float(r.get("slow_burn", 0.25))
        for label, b in (("fast_burn", fast_b), ("slow_burn", slow_b)):
            if not 0.0 < b <= 1.0:
                raise ValueError(
                    f"slo.json alert {name!r}: {label} {b} not in (0, 1]")
        if not r.get("runbook"):
            raise ValueError(
                f"slo.json alert {name!r}: a rule must carry a runbook "
                f"anchor (docs/operating/monitoring.md#...)")
        rules.append(AlertRule(
            name=name, objective=obj, fast_window=fast_w,
            slow_window=slow_w, fast_burn=fast_b, slow_burn=slow_b,
            severity=sev, hysteresis=int(r.get("hysteresis", 8)),
            runbook=str(r["runbook"]), doc=r.get("doc", "")))
    return {"rules": rules, "objectives": by_name}


def _delta_histogram(cur: Histogram, prev_buckets: dict,
                     prev_zero: int) -> Histogram:
    """The lossless difference of two cumulative snapshots of the same
    series (integer bucket subtraction). min/max are bucket-mid bounds
    — exact extremes don't subtract, and quantiles only need the
    clip."""
    from .histogram import bucket_mid

    d = Histogram()
    for i, n in cur.buckets.items():
        dn = n - prev_buckets.get(i, 0)
        if dn > 0:
            d.buckets[i] = dn
    d.zero_count = max(0, cur.zero_count - prev_zero)
    d.count = d.zero_count + sum(d.buckets.values())
    if d.buckets:
        d.min = 0.0 if d.zero_count else bucket_mid(min(d.buckets))
        d.max = bucket_mid(max(d.buckets))
    elif d.count:
        d.min = d.max = 0.0
    return d


class AlertEngine:
    """The per-process alert evaluator the serving supervisor ticks
    once per committed window (decimated by ``tick_every`` so rule
    evaluation never shows up in the dispatch overhead budget)."""

    def __init__(self, rules=None, objectives=None, *, tracer=None,
                 flight=None, tick_every: int = 4,
                 path: Optional[str] = None):
        if rules is None:
            loaded = load_alert_rules(path)
            rules = loaded["rules"]
            objectives = loaded["objectives"]
        if objectives is None:
            objectives = {}
        missing = [r.name for r in rules if r.objective not in objectives]
        if missing:
            raise ValueError(f"alert rules without objectives: {missing}")
        self.rules = list(rules)
        self.objectives = dict(objectives)
        self.tracer = tracer
        self.flight = flight
        self.tick_every = max(1, int(tick_every))
        self.windows = 0          # windows seen (tick() calls)
        self.ticks = 0            # evaluations actually run
        self.fired: list = []     # every Alert ever fired, in order
        self.active: dict = {}    # rule name -> Alert
        self._bits: dict = {r.name: deque(maxlen=r.slow_window)
                            for r in self.rules}
        self._healthy: dict = {r.name: 0 for r in self.rules}
        self._snap: dict = {}     # rule name -> (buckets, zero)
        self._last: dict = {}     # rule name -> last evaluation row

    def bind(self, tracer, flight=None) -> None:
        """Late wiring (the supervisor owns tracer + flight recorder)."""
        self.tracer = tracer
        if flight is not None:
            self.flight = flight

    # ----------------------------------------------------------- ticking

    def tick(self) -> list:
        """Advance one committed window; every ``tick_every``-th call
        evaluates all rules. Returns alerts newly fired on this call."""
        self.windows += 1
        if (self.windows - 1) % self.tick_every:
            return []
        if self.tracer is None or not getattr(
                self.tracer, "histogram_series", None):
            return []
        self.ticks += 1
        fired_now = []
        for rule in self.rules:
            alert = self._tick_rule(rule)
            if alert is not None:
                fired_now.append(alert)
        return fired_now

    def _tick_rule(self, rule: AlertRule):
        o = self.objectives[rule.objective]
        cur = _series_for(self.tracer, o)
        prev_buckets, prev_zero = self._snap.get(rule.name, ({}, 0))
        self._snap[rule.name] = (dict(cur.buckets), cur.zero_count)
        delta = _delta_histogram(cur, prev_buckets, prev_zero)
        bits = self._bits[rule.name]
        if delta.count == 0:
            bits.append(None)     # unknown: consumes no error budget
            return None
        value = delta.quantile(o.quantile)
        if value is not None and o.unit == "ms" and \
                Event[o.event].kind is EventKind.span:
            value /= 1000.0       # span histograms carry microseconds
        breach = value is not None and value > o.threshold
        bits.append(bool(breach))
        self._last[rule.name] = {"value": value, "breach": breach,
                                 "tick": self.ticks}
        if rule.name in self.active:
            self._maybe_resolve(rule, breach)
            return None
        return self._maybe_fire(rule, o, value)

    def _burn(self, bits, window: int):
        known = [b for b in list(bits)[-window:] if b is not None]
        if not known:
            return 0.0, 0
        return sum(known) / len(known), len(known)

    def _maybe_fire(self, rule: AlertRule, o: Objective, value):
        bits = self._bits[rule.name]
        fast, fast_n = self._burn(bits, rule.fast_window)
        slow, _ = self._burn(bits, rule.slow_window)
        known_total = sum(1 for b in bits if b is not None)
        if known_total < rule.fast_window:
            return None           # not enough evidence to page anyone
        if fast < rule.fast_burn or slow < rule.slow_burn:
            return None
        alert = Alert(
            rule=rule.name, objective=rule.objective,
            severity=rule.severity, runbook=rule.runbook,
            fired_tick=self.ticks, value=value, threshold=o.threshold,
            fast_burn_rate=round(fast, 4), slow_burn_rate=round(slow, 4))
        if self.tracer is not None:
            self.tracer.count(Event.alert_fired, rule=rule.name,
                              severity=rule.severity)
            for tid in _exemplar_trace_ids(self.tracer, o):
                self.tracer.keep_trace(tid, reason=f"alert:{rule.name}")
                alert.trace_ids.append(tid)
        if rule.severity == "page" and self.flight is not None:
            alert.flight_path = self.flight.dump(f"alert_{rule.name}")
        self.active[rule.name] = alert
        self.fired.append(alert)
        self._healthy[rule.name] = 0
        return alert

    def _maybe_resolve(self, rule: AlertRule, breach: bool) -> None:
        if breach:
            self._healthy[rule.name] = 0
            return
        self._healthy[rule.name] += 1
        if self._healthy[rule.name] >= rule.hysteresis:
            self.active.pop(rule.name).resolved_tick = self.ticks
            self._healthy[rule.name] = 0

    # ------------------------------------------------------------- stats

    def stats(self) -> dict:
        return {
            "rules": len(self.rules),
            "windows": self.windows,
            "ticks": self.ticks,
            "tick_every": self.tick_every,
            "fired_total": len(self.fired),
            "active": sorted(self.active),
            "alerts": [a.to_dict() for a in self.fired],
            "last": {k: dict(v) for k, v in self._last.items()},
        }
