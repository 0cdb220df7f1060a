"""Zipfian-distributed random indices.

reference: src/stdx/zipfian.zig (ZipfianGenerator) — the benchmark's
hot-account workload shape (src/tigerbeetle/benchmark_load.zig:66-77):
item i (0-based) is drawn with probability proportional to 1/(i+1)^theta,
so a small prefix of "hot" items absorbs most of the traffic.

Implementation: inverse-CDF over the exact harmonic weights, vectorized
with numpy (binary search over the cumulative table). Exact for the
n (account counts) the chaos traffic shapes use; the reference uses the
Gray/ YCSB approximation for the same distribution.
"""

from __future__ import annotations

import numpy as np


class ZipfianGenerator:
    def __init__(self, n: int, theta: float = 0.99, seed: int = 0):
        assert n > 0
        self.n = n
        self.theta = theta
        weights = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64),
                                 theta)
        self.cdf = np.cumsum(weights / weights.sum())
        self.rng = np.random.default_rng(seed)

    def draw(self, count: int) -> np.ndarray:
        """`count` item indices in [0, n), hot items most likely."""
        u = self.rng.random(count)
        return np.searchsorted(self.cdf, u, side="left").astype(np.int64)

    def grow(self, n: int) -> "ZipfianGenerator":
        """A generator over a larger item set, preserving the seed stream
        (reference: the generator supports growing item counts as the
        benchmark inserts accounts)."""
        fresh = ZipfianGenerator.__new__(ZipfianGenerator)
        fresh.n = n
        fresh.theta = self.theta
        weights = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64),
                                 self.theta)
        fresh.cdf = np.cumsum(weights / weights.sum())
        fresh.rng = self.rng
        return fresh
