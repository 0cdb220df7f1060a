"""Repair traffic rate limiter.

reference: src/vsr/repair_budget.zig — repair (request_prepare /
request_blocks) must not starve the normal protocol path, so each replica
spends from a refilling budget when requesting repair and stops when
exhausted. Token bucket over nanosecond time, sans-io.

A copy of the JAX package's `vsr/repair_budget.py`.
"""

from __future__ import annotations

MS = 1_000_000  # ns


class RepairBudget:
    def __init__(self, *, capacity: int = 8,
                 refill_interval_ns: int = 50 * MS):
        self.capacity = capacity
        self.refill_interval_ns = refill_interval_ns
        self.tokens = capacity
        self.last_refill_ns = 0

    def refill(self, now_ns: int) -> None:
        if not self.last_refill_ns:
            self.last_refill_ns = now_ns
            return
        elapsed = now_ns - self.last_refill_ns
        earned = int(elapsed // self.refill_interval_ns)
        if earned > 0:
            self.tokens = min(self.capacity, self.tokens + earned)
            self.last_refill_ns += earned * self.refill_interval_ns

    def available(self, now_ns: int) -> int:
        """Tokens spendable right now (after refill) — lets a caller
        size a burst (e.g. the post-rebuild certification's block-repair
        batches) to the budget instead of probing one token at a time."""
        self.refill(now_ns)
        return self.tokens

    def spend(self, now_ns: int, amount: int = 1) -> bool:
        """True (and deducts) if the budget allows `amount` repair sends."""
        self.refill(now_ns)
        if self.tokens < amount:
            return False
        self.tokens -= amount
        return True
