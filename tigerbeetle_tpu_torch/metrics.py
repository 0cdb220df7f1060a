"""Prometheus text exposition of the trace registry + /metrics endpoint.

Renders everything a recording tracer accumulates — counters, gauges,
and the cumulative log2 histograms every span feeds at close — in
Prometheus text exposition format v0.0.4, plus the SLO engine's
evaluation rows when provided. Served by `MetricsServer`, a stdlib
`http.server` thread wired into `main.py start --metrics-port`. No third-party client library: the text format is
lines, and the repo's no-new-deps rule holds.

Naming: counters are `{prefix}_{event}_total`; gauges `{prefix}_{event}`;
span-duration histograms `{prefix}_{event}_us` (explicit microseconds
unit — `_bucket{le=...}` / `_sum` / `_count` with the series' partition
tags as labels); histogram-kind catalog events keep their declared unit
and render as `{prefix}_{event}` histograms. SLO rows render as
`{prefix}_slo_value` / `{prefix}_slo_threshold` / `{prefix}_slo_ok`
gauges labelled by objective.

Exemplars: when a tracer carries per-series exemplars (the
latest traced sample of a histogram series, stamped with its causal
trace id), the series' `_bucket` line containing the exemplar value
gets an OpenMetrics exemplar suffix — `` # {trace_id="..."} <value>`` —
so a dashboard can jump from a p99 bucket straight to one concrete
request trace. `parse_prometheus` understands the suffix and returns
the exemplars under the reserved `__exemplars__` key.

The port's copy of the JAX package's `metrics.py`: the same names and
lines for the same tracer contents.
"""

from __future__ import annotations

import http.server
import re
import threading
from typing import Callable, Optional

from .trace.event import CATALOG, EventKind
from .trace.histogram import Histogram


def _esc(v) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _labels(tags: dict, extra: Optional[dict] = None) -> str:
    items = dict(tags)
    if extra:
        items.update(extra)
    if not items:
        return ""
    body = ",".join(f'{k}="{_esc(v)}"' for k, v in sorted(items.items()))
    return "{" + body + "}"


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def _exemplar_suffix(ex: dict) -> str:
    """OpenMetrics exemplar suffix for one `_bucket` line:
    `` # {trace_id="<hex>"} <value>``."""
    return (f' # {{trace_id="{_esc(ex["trace_id"])}"}} '
            f'{_fmt(ex["value"])}')


def render_prometheus(tracers, slo_rows: Optional[list] = None,
                      burn: Optional[dict] = None,
                      alert_engine=None,
                      prefix: str = "tb_tpu") -> str:
    """Render one or many tracers' registries as Prometheus text.
    Multiple tracers (e.g. an in-process cluster's replicas) merge:
    counters add, gauges keep the last writer, histograms merge
    losslessly per series key.

    With `alert_engine` (a trace.alerts.AlertEngine), the engine's
    firing state renders in Prometheus' own ALERTS idiom —
    `{prefix}_alerts{alertname=...,severity=...} 1` for every ACTIVE
    alert plus a `{prefix}_alerts_fired_total` counter per rule — so
    an Alertmanager-style consumer sees the same shape it would from a
    real Prometheus rule evaluation."""
    if not isinstance(tracers, (list, tuple)):
        tracers = [tracers]
    counters: dict = {}
    gauges: dict = {}
    hists: dict = {}
    series: dict = {}
    exemplars: dict = {}
    for t in tracers:
        for name, v in t.counters.items():
            counters[name] = counters.get(name, 0) + v
        gauges.update(t.gauges)
        for key, h in t.histograms.items():
            if key in hists:
                hists[key].merge(h)
            else:
                hists[key] = Histogram().merge(h)
                series[key] = t.histogram_series[key]
        # One exemplar per series survives the merge: the slowest traced
        # sample wins (the sample an operator chasing a p99 wants).
        for key, ex in getattr(t, "exemplars", {}).items():
            cur = exemplars.get(key)
            if cur is None or ex["value"] >= cur["value"]:
                exemplars[key] = ex
    lines: list = []

    def _doc(name: str) -> str:
        ev = CATALOG.get(name)
        return _esc(ev.doc.replace("\n", " ")) if ev is not None else ""

    for name in sorted(counters):
        metric = f"{prefix}_{name}_total"
        lines.append(f"# HELP {metric} {_doc(name)}")
        lines.append(f"# TYPE {metric} counter")
        lines.append(f"{metric} {_fmt(counters[name])}")
    for name in sorted(gauges):
        metric = f"{prefix}_{name}"
        lines.append(f"# HELP {metric} {_doc(name)}")
        lines.append(f"# TYPE {metric} gauge")
        lines.append(f"{metric} {_fmt(gauges[name])}")
    # Histograms, grouped per event so the TYPE header appears once and
    # every tagged series renders under it with its label set.
    by_event: dict = {}
    for key in sorted(hists):
        name, tags = series[key]
        by_event.setdefault(name, []).append(
            (tags, hists[key], exemplars.get(key)))
    for name in sorted(by_event):
        ev = CATALOG.get(name)
        unit_suffix = ("_us" if ev is not None
                       and ev.kind is EventKind.span else "")
        metric = f"{prefix}_{name}{unit_suffix}"
        lines.append(f"# HELP {metric} {_doc(name)}")
        lines.append(f"# TYPE {metric} histogram")
        for tags, h, ex in by_event[name]:
            # The exemplar rides the first bucket whose upper bound
            # covers its value (OpenMetrics: an exemplar must lie
            # within its bucket), falling back to +Inf.
            for upper, cum_count in h.cumulative():
                line = (f"{metric}_bucket"
                        f"{_labels(tags, {'le': _fmt(upper)})} "
                        f"{cum_count}")
                if ex is not None and ex["value"] <= upper:
                    line += _exemplar_suffix(ex)
                    ex = None
                lines.append(line)
            line = (f"{metric}_bucket{_labels(tags, {'le': '+Inf'})} "
                    f"{h.count}")
            if ex is not None:
                line += _exemplar_suffix(ex)
            lines.append(line)
            lines.append(f"{metric}_sum{_labels(tags)} {_fmt(h.sum)}")
            lines.append(f"{metric}_count{_labels(tags)} {h.count}")
    if slo_rows:
        for stem, doc in (("slo_value", "latest evaluated objective "
                           "value (in the objective's unit)"),
                          ("slo_threshold", "declared objective "
                           "threshold"),
                          ("slo_ok", "1 = objective met, 0 = breached "
                           "(unknown objectives are omitted)")):
            metric = f"{prefix}_{stem}"
            lines.append(f"# HELP {metric} {doc}")
            lines.append(f"# TYPE {metric} gauge")
            for r in slo_rows:
                lab = _labels({"objective": r["name"]})
                if stem == "slo_value" and r["value"] is not None:
                    lines.append(f"{metric}{lab} {_fmt(r['value'])}")
                elif stem == "slo_threshold":
                    lines.append(f"{metric}{lab} {_fmt(r['threshold'])}")
                elif stem == "slo_ok" and r["ok"] is not None:
                    lines.append(f"{metric}{lab} {1 if r['ok'] else 0}")
    if burn:
        metric = f"{prefix}_slo_burn_rate"
        lines.append(f"# HELP {metric} fraction of recent runs in "
                     f"breach over the burn window")
        lines.append(f"# TYPE {metric} gauge")
        for name in sorted(burn):
            lab = _labels({"objective": name})
            lines.append(f"{metric}{lab} {_fmt(burn[name]['burn_rate'])}")
    if alert_engine is not None:
        metric = f"{prefix}_alerts"
        lines.append(f"# HELP {metric} active burn-rate alerts "
                     f"(ALERTS-style: one series per firing rule, "
                     f"value 1)")
        lines.append(f"# TYPE {metric} gauge")
        for name in sorted(alert_engine.active):
            a = alert_engine.active[name]
            lines.append(f"{metric}{_labels({'alertname': name, 'severity': a.severity, 'alertstate': 'firing'})} 1")
        metric = f"{prefix}_alerts_fired_total"
        lines.append(f"# HELP {metric} burn-rate alert firings per "
                     f"rule since process start")
        lines.append(f"# TYPE {metric} counter")
        fired_by_rule: dict = {}
        for a in alert_engine.fired:
            fired_by_rule[a.rule] = fired_by_rule.get(a.rule, 0) + 1
        for name in sorted(fired_by_rule):
            sev = next(a.severity for a in alert_engine.fired
                       if a.rule == name)
            lines.append(f"{metric}{_labels({'alertname': name, 'severity': sev})} "
                         f"{fired_by_rule[name]}")
    return "\n".join(lines) + "\n"


def _parse_labels(body: str) -> dict:
    labels: dict = {}
    for m in re.finditer(r'(\w+)="((?:[^"\\]|\\.)*)"', body):
        labels[m.group(1)] = (m.group(2).replace('\\"', '"')
                              .replace("\\n", "\n")
                              .replace("\\\\", "\\"))
    return labels


def parse_prometheus(text: str) -> dict:
    """Minimal exposition parser for the acceptance tests:
    {metric_name: [(labels_dict, value)]}. Raises ValueError on a line
    that is neither a comment nor `name{labels} value` (with an
    optional OpenMetrics `` # {labels} value`` exemplar suffix) — the
    "Prometheus-parseable" check. Parsed exemplars land under the
    reserved `__exemplars__` key as
    {metric_name: [(labels_dict, exemplar_labels_dict, exemplar_value)]}."""
    out: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        exemplar = None
        if " # " in line:
            line, _, ex_raw = line.partition(" # ")
            ex_head, _, ex_val = ex_raw.rpartition(" ")
            if not (ex_head.startswith("{") and ex_head.endswith("}")):
                raise ValueError(
                    f"unparseable exemplar suffix: {ex_raw!r}")
            try:
                exemplar = (_parse_labels(ex_head[1:-1]), float(ex_val))
            except ValueError as e:
                raise ValueError(
                    f"unparseable exemplar value: {ex_raw!r}") from e
        head, _, val = line.rpartition(" ")
        if not head:
            raise ValueError(f"unparseable exposition line: {line!r}")
        labels: dict = {}
        name = head
        if "{" in head:
            if not head.endswith("}"):
                raise ValueError(f"unparseable exposition line: {line!r}")
            name, _, body = head.partition("{")
            labels = _parse_labels(body[:-1])
        if not name or " " in name:
            raise ValueError(f"unparseable exposition line: {line!r}")
        try:
            fval = float(val)
        except ValueError as e:
            raise ValueError(
                f"unparseable exposition value: {line!r}") from e
        out.setdefault(name, []).append((labels, fval))
        if exemplar is not None:
            out.setdefault("__exemplars__", {}).setdefault(
                name, []).append((labels,) + exemplar)
    return out


class MetricsServer:
    """Tiny stdlib /metrics endpoint: GET /metrics (or /) returns the
    supplier's current exposition text. `port=0` binds an ephemeral
    port (read it back from `.port`); serves on a daemon thread so a
    hung scraper can never block a replica's main loop."""

    def __init__(self, supplier: Callable[[], str], port: int = 0,
                 host: str = "127.0.0.1"):
        self.supplier = supplier

        outer = self

        class _Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API name)
                if self.path not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                try:
                    body = outer.supplier().encode()
                except Exception as e:  # supplier bug: say so, stay up
                    self.send_error(500, explain=str(e))
                    return
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass  # scrapes must not spam the replica's stdout

        self._httpd = http.server.ThreadingHTTPServer((host, port),
                                                      _Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.2},
            daemon=True, name=f"metrics:{self.port}")
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
