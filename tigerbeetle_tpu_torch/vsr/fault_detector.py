"""Primary-liveness estimator (sans-io).

reference: src/vsr/fault_detector.zig:1-24 — the "traffic light" analogy:
estimate the primary's health from the inter-arrival rate of its protocol
progress (prepares/commits), not just a hard timeout. An EWMA of observed
inter-arrival intervals sets an adaptive expectation; the detector reports
`suspect` when the time since the last progress exceeds a multiple of that
expectation, and the replica's timeout battery escalates to a view change.

Sans-io: fed observations + queried with timestamps; owns no clock.

A copy of the JAX package's `vsr/fault_detector.py`.
"""

from __future__ import annotations

MS = 1_000_000  # ns


class FaultDetector:
    def __init__(self, *, alpha: float = 0.125,
                 floor_ns: int = 50 * MS, ceil_ns: int = 1000 * MS,
                 suspect_multiplier: float = 8.0):
        self.alpha = alpha
        self.floor_ns = floor_ns
        self.ceil_ns = ceil_ns
        self.suspect_multiplier = suspect_multiplier
        self.ewma_ns: float = float(ceil_ns)
        self.last_progress_ns: int = 0

    def observe_progress(self, now_ns: int) -> None:
        """The primary made protocol progress (prepare/commit heartbeat
        received, view installed)."""
        if self.last_progress_ns:
            interval = now_ns - self.last_progress_ns
            self.ewma_ns += self.alpha * (interval - self.ewma_ns)
            self.ewma_ns = min(max(self.ewma_ns, self.floor_ns),
                               float(self.ceil_ns))
        self.last_progress_ns = now_ns

    def reset(self, now_ns: int) -> None:
        """View change installed a new primary: start fresh."""
        self.ewma_ns = float(self.ceil_ns)
        self.last_progress_ns = now_ns

    def deadline_ns(self) -> int:
        """Time-since-progress beyond which the primary is suspect."""
        return int(self.ewma_ns * self.suspect_multiplier)

    def suspect(self, now_ns: int) -> bool:
        if not self.last_progress_ns:
            return False
        return now_ns - self.last_progress_ns > self.deadline_ns()
