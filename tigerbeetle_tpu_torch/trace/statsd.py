"""DogStatsD-format UDP emission + per-event timing aggregation.

reference: src/trace/statsd.zig — the reference does not emit one packet
per span; it AGGREGATES per-event timings (count/sum/min/max) between
emission intervals, flushes them as gauges, and resets the aggregates
after each emit so a quiet interval reads as zero instead of a stale
plateau. Counters and gauges emit immediately (the server aggregates
counts; gauges are last-write-wins anyway). All emission is best-effort:
a dead collector must never take a replica down with it.

Beyond the reference: each aggregate series carries a per-interval
log2 Histogram (trace/histogram.py), and the flush emits derived
p50/p95/p99/p999 as DogStatsD ``|ms`` TIMING lines — tagged with the
series' partition tags (route/tier on window spans) — next to the
count/sum/min/max gauges. The flush-and-reset contract is unchanged:
a quiet interval emits nothing stale.
"""

from __future__ import annotations

import socket

from .histogram import Histogram


class StatsD:
    """DogStatsD-format UDP emitter (reference: src/trace/statsd.zig)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8125,
                 prefix: str = "tb_tpu"):
        self.addr = (host, port)
        self.prefix = prefix
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setblocking(False)

    def _emit(self, metric: str, value, kind: str, tags: dict) -> None:
        line = f"{self.prefix}.{metric}:{value}|{kind}"
        if tags:
            line += "|#" + ",".join(f"{k}:{v}" for k, v in tags.items())
        try:
            self.sock.sendto(line.encode(), self.addr)
        except OSError:
            pass  # metrics are best-effort

    def count(self, metric: str, value: int = 1, **tags) -> None:
        self._emit(metric, value, "c", tags)

    def gauge(self, metric: str, value: float, **tags) -> None:
        self._emit(metric, value, "g", tags)

    def timing(self, metric: str, ms: float, **tags) -> None:
        self._emit(metric, ms, "ms", tags)

    def close(self) -> None:
        self.sock.close()


class TimingAggregates:
    """Per-event span-duration aggregates between StatsD emits:
    count / sum / min / max in microseconds PLUS a per-interval log2
    histogram, reset after each flush (reference statsd.zig behavior:
    gauges reset after emit). Series are partitioned by the event's
    hist_tags values (e.g. window_commit route/tier) so per-class
    distributions survive the aggregation."""

    def __init__(self, with_hist: bool = True):
        # with_hist=False skips the per-interval histogram entirely —
        # it only feeds flush_to()'s percentile TIMING lines, so a
        # tracer with no StatsD attached need not pay a second
        # Histogram.record per span (the tracer's own cumulative
        # histograms are unaffected).
        self._agg: dict[str, list] = {}
        self._hist: dict[str, Histogram] = {}
        self._series: dict[str, tuple] = {}  # key -> (name, tags)
        self._with_hist = with_hist

    def record(self, name: str, dur_us: float, tags: dict = None,
               key: str = None) -> None:
        # `key` lets the tracer's span-close path pass its already-built
        # series key instead of paying the sorted-join twice per span.
        if key is None:
            key = name if not tags else name + "|" + ",".join(
                f"{k}:{v}" for k, v in sorted(tags.items()))
        a = self._agg.get(key)
        if a is None:
            self._agg[key] = [1, dur_us, dur_us, dur_us]
            self._series[key] = (name, dict(tags) if tags else {})
        else:
            a[0] += 1
            a[1] += dur_us
            if dur_us < a[2]:
                a[2] = dur_us
            if dur_us > a[3]:
                a[3] = dur_us
        if self._with_hist:
            h = self._hist.get(key)
            if h is None:
                h = self._hist[key] = Histogram()
            h.record(dur_us)

    def snapshot(self) -> dict:
        """{series: {count, sum_us, min_us, max_us}} without resetting.
        Untagged series key on the bare event name (the bench probe and
        chrome metadata shape); tagged series append |k:v pairs."""
        return {key: {"count": a[0], "sum_us": round(a[1], 3),
                      "min_us": round(a[2], 3), "max_us": round(a[3], 3)}
                for key, a in self._agg.items()}

    def flush_to(self, statsd: StatsD) -> None:
        """Emit every series as four gauges plus histogram-derived
        p50/p95/p99/p999 TIMING (``|ms``) lines carrying the series
        tags, then reset."""
        for key, a in self._agg.items():
            name, tags = self._series[key]
            statsd.gauge(f"trace.{name}.count", a[0], **tags)
            statsd.gauge(f"trace.{name}.sum_us", round(a[1], 3), **tags)
            statsd.gauge(f"trace.{name}.min_us", round(a[2], 3), **tags)
            statsd.gauge(f"trace.{name}.max_us", round(a[3], 3), **tags)
            h = self._hist.get(key)
            summary = h.summary() if h is not None else {}
            for q_name in ("p50", "p95", "p99", "p999"):
                q_us = summary.get(q_name)
                if q_us is not None:
                    statsd.timing(f"trace.{name}.{q_name}",
                                  round(q_us / 1000.0, 4), **tags)
        self._agg.clear()
        self._hist.clear()
        self._series.clear()
