"""Cluster-synchronized clock: Marzullo interval agreement over peer
clock samples.

reference: src/vsr/clock.zig (+ src/vsr/marzullo.zig). The primary samples
backup clocks via ping/pong round trips; each sample yields an interval
[offset - rtt/2, offset + rtt/2] within which the peer's clock offset must
lie. Marzullo's algorithm finds the point covered by the most intervals —
the cluster-agreed offset bound — so the primary can assert its timestamps
are within tolerance of the cluster majority. Consensus drives time; time
never drives consensus (the reference's doctrine).

A copy of the JAX package's `vsr/clock.py`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Interval:
    lo: int
    hi: int


def marzullo(intervals: list[Interval]) -> Optional[Interval]:
    """The smallest interval consistent with the largest number of sources
    (reference: src/vsr/marzullo.zig:8 smallest_interval)."""
    iv, _ = marzullo_with_count(intervals)
    return iv


def marzullo_with_count(intervals: list[Interval]):
    """(best interval, number of sources covering it). The count is what
    agreement means: sources merely SAMPLED is not sources AGREEING
    (reference clock.zig synchronizes only when the smallest interval is
    consistent with a replica quorum of sources)."""
    if not intervals:
        return None, 0
    edges: list[tuple[int, int]] = []
    for iv in intervals:
        edges.append((iv.lo, -1))  # -1 sorts starts before ends at a tie
        edges.append((iv.hi, +1))
    edges.sort()
    best = 0
    count = 0
    best_lo = best_hi = None
    for i, (value, kind) in enumerate(edges):
        if kind == -1:
            count += 1
            if count > best:
                best = count
                best_lo = value
                best_hi = edges[i + 1][0] if i + 1 < len(edges) else value
        else:
            count -= 1
    if best_lo is None:
        return None, 0
    return Interval(best_lo, best_hi), best


class Clock:
    """Offset estimation against cluster peers.

    Samples are (monotonic_tx, peer_realtime, monotonic_rx) triples from
    ping/pong exchanges; each gives offset = peer_realtime - local_mid with
    uncertainty rtt/2. Samples expire after `window_ns` — a partitioned
    peer's hours-old offset must not keep "synchronizing" the clock
    (reference: epoch expiry in src/vsr/clock.zig)."""

    WINDOW_NS_DEFAULT = 10_000_000_000  # 10s

    def __init__(self, replica_id: int, replica_count: int, time,
                 window_ns: int = WINDOW_NS_DEFAULT):
        self.replica_id = replica_id
        self.replica_count = replica_count
        self.time = time
        self.window_ns = window_ns
        self.samples: dict[int, tuple[int, Interval]] = {}  # peer -> (at, iv)

    def learn(self, peer: int, monotonic_tx: int, peer_realtime: int,
              monotonic_rx: int) -> None:
        assert peer != self.replica_id
        rtt = monotonic_rx - monotonic_tx
        if rtt < 0:
            return
        local_mid = self.time.realtime() - (monotonic_rx - monotonic_tx) // 2
        offset = peer_realtime - local_mid
        self.samples[peer] = (
            monotonic_rx, Interval(offset - rtt // 2, offset + rtt // 2))

    def _fresh(self) -> list[Interval]:
        horizon = self.time.monotonic() - self.window_ns
        return [iv for at, iv in self.samples.values() if at >= horizon]

    def offset(self) -> Optional[Interval]:
        """Agreed offset interval — None unless a QUORUM of sources (our
        own zero-offset interval plus fresh peer samples) actually
        overlap. Peers sampled but wildly disagreeing are not agreement
        (reference clock.zig: the smallest interval must be consistent
        with a replica quorum)."""
        own = [Interval(0, 0)]  # our own clock, zero offset
        intervals = own + self._fresh()
        quorum = self.replica_count // 2 + 1
        if len(intervals) < quorum:
            return None
        iv, covered = marzullo_with_count(intervals)
        if covered < quorum:
            return None
        return iv

    def realtime_synchronized(self) -> Optional[int]:
        iv = self.offset()
        if iv is None:
            return None
        return self.time.realtime() + (iv.lo + iv.hi) // 2
