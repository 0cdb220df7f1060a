"""Log2-bucketed mergeable latency histograms (HDR-style, pure numpy).

The reference's timing aggregates (src/trace/statsd.zig) stop at
count/sum/min/max — enough for dashboards, useless for tails. This is
the repo's distribution primitive: a FIXED bucket layout shared by every
histogram ever constructed, so histograms merge LOSSLESSLY across
replicas, processes, and runs by adding bucket counts (associative and
commutative — the property the cluster-wide trace merge and the
Prometheus exposition both lean on).

Layout: each octave [2^k, 2^(k+1)) is split into ``SUB = 2**SUB_BITS``
geometric sub-buckets, i.e. bucket i covers [2^(i/SUB), 2^((i+1)/SUB)).
Reporting a bucket by its geometric midpoint bounds the relative error
of any reconstructed quantile by ``REL_ERROR`` = 2^(1/(2*SUB)) - 1
(~1.09% at SUB_BITS=5) — the "1-2% relative error" HDR contract, at a
cost of SUB buckets per octave actually touched (sparse dict storage).

Values are unit-agnostic floats (span durations feed microseconds;
the replay-length histogram feeds window counts). Zero/negative values
land in a dedicated zero bucket; exact min/max/sum/count ride along so
p0/p100 and means are exact, not bucket-rounded.
"""

from __future__ import annotations

import math

import numpy as np

SUB_BITS = 5                      # sub-buckets per octave = 32
SUB = 1 << SUB_BITS
# Bucket index range: 2^-32 .. 2^48 covers sub-nanosecond (in us) up to
# ~8.9 years (in us); out-of-range values clamp to the edge buckets.
IDX_MIN = -32 * SUB
IDX_MAX = 48 * SUB
# Half-width of one geometric bucket around its midpoint.
REL_ERROR = 2.0 ** (1.0 / (2 * SUB)) - 1.0


def bucket_index(value: float) -> int:
    """Bucket index of a positive value: floor(log2(v) * SUB)."""
    return min(IDX_MAX, max(IDX_MIN, math.floor(math.log2(value) * SUB)))


def bucket_upper(index: int) -> float:
    """Exclusive upper bound of bucket `index` (Prometheus `le`)."""
    return 2.0 ** ((index + 1) / SUB)


def bucket_mid(index: int) -> float:
    """Geometric midpoint — the reported representative value."""
    return 2.0 ** ((index + 0.5) / SUB)


class Histogram:
    """Fixed-layout log2 histogram: sparse bucket counts plus exact
    count/sum/min/max. record() is O(1); record_many() is vectorized
    numpy for bench loops; merge() adds integer bucket counts."""

    __slots__ = ("buckets", "zero_count", "count", "sum", "min", "max")

    def __init__(self):
        self.buckets: dict[int, int] = {}
        self.zero_count = 0
        self.count = 0
        self.sum = 0.0
        self.min: float | None = None
        self.max: float | None = None

    # ---------------------------------------------------------- recording

    def record(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.sum += value
        if self.min is None or value < self.min:
            self.min = value
        if self.max is None or value > self.max:
            self.max = value
        if value <= 0.0:
            self.zero_count += 1
            return
        i = bucket_index(value)
        self.buckets[i] = self.buckets.get(i, 0) + 1

    def record_many(self, values) -> None:
        vals = np.asarray(values, dtype=np.float64).ravel()
        if vals.size == 0:
            return
        self.count += int(vals.size)
        self.sum += float(vals.sum())
        lo = float(vals.min())
        hi = float(vals.max())
        if self.min is None or lo < self.min:
            self.min = lo
        if self.max is None or hi > self.max:
            self.max = hi
        pos = vals[vals > 0.0]
        self.zero_count += int(vals.size - pos.size)
        if pos.size:
            idx = np.clip(np.floor(np.log2(pos) * SUB).astype(np.int64),
                          IDX_MIN, IDX_MAX)
            uniq, counts = np.unique(idx, return_counts=True)
            for i, n in zip(uniq.tolist(), counts.tolist()):
                self.buckets[i] = self.buckets.get(i, 0) + n

    # ------------------------------------------------------------ merging

    def merge(self, other: "Histogram") -> "Histogram":
        """Accumulate `other` into self (lossless: integer bucket adds).
        Returns self for chaining."""
        for i, n in other.buckets.items():
            self.buckets[i] = self.buckets.get(i, 0) + n
        self.zero_count += other.zero_count
        self.count += other.count
        self.sum += other.sum
        if other.min is not None and (self.min is None
                                      or other.min < self.min):
            self.min = other.min
        if other.max is not None and (self.max is None
                                      or other.max > self.max):
            self.max = other.max
        return self

    @classmethod
    def merged(cls, hists) -> "Histogram":
        out = cls()
        for h in hists:
            out.merge(h)
        return out

    # ---------------------------------------------------------- quantiles

    def quantile(self, q: float) -> float | None:
        """Nearest-rank quantile from bucket midpoints, clipped to the
        exact observed [min, max] (so p0/p100 and one-sample histograms
        are exact; interior quantiles carry <= REL_ERROR)."""
        if self.count == 0:
            return None
        target = max(1, math.ceil(q * self.count))
        seen = self.zero_count
        if target <= seen:
            # zero_count > 0 implies min <= 0; the non-positive samples
            # are not sub-bucketed, so report the exact floor.
            return self.min
        for i in sorted(self.buckets):
            seen += self.buckets[i]
            if target <= seen:
                return min(self.max, max(self.min, bucket_mid(i)))
        return self.max

    def summary(self) -> dict:
        """The flushed percentile set (p50/p95/p99/p999) plus exact
        count/sum/min/max — the StatsD + bench record shape."""
        out = {"count": self.count,
               "sum": round(self.sum, 3),
               "min": None if self.min is None else round(self.min, 3),
               "max": None if self.max is None else round(self.max, 3)}
        for name, q in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99),
                        ("p999", 0.999)):
            v = self.quantile(q)
            out[name] = None if v is None else round(v, 3)
        return out

    # --------------------------------------------------------- exposition

    def cumulative(self) -> list:
        """[(upper_bound, cumulative_count), ...] over non-empty buckets
        (zero bucket first when present) — the Prometheus
        `_bucket{le=...}` series; the +Inf bucket is the total count."""
        out = []
        cum = 0
        if self.zero_count:
            cum += self.zero_count
            out.append((0.0, cum))
        for i in sorted(self.buckets):
            cum += self.buckets[i]
            out.append((bucket_upper(i), cum))
        return out

    # ------------------------------------------------------- serialization

    def to_dict(self) -> dict:
        return {
            "sub_bits": SUB_BITS,
            "buckets": {str(i): n for i, n in sorted(self.buckets.items())},
            "zero": self.zero_count,
            "count": self.count,
            "sum": round(self.sum, 6),
            "min": self.min,
            "max": self.max,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Histogram":
        assert d.get("sub_bits", SUB_BITS) == SUB_BITS, \
            "histogram layout mismatch (SUB_BITS changed?)"
        h = cls()
        h.buckets = {int(i): int(n) for i, n in d.get("buckets", {}).items()}
        h.zero_count = int(d.get("zero", 0))
        h.count = int(d.get("count", 0))
        h.sum = float(d.get("sum", 0.0))
        h.min = d.get("min")
        h.max = d.get("max")
        return h
