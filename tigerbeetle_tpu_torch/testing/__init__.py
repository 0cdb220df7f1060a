"""Deterministic simulation testing (reference: src/testing/, src/vopr.zig).

Whole clusters — replicas, storage, network, clocks, clients — run in one
process from one seed. Every failure is a replayable seed; all replicas must
converge to byte-identical state (the reference's StateChecker /
StorageChecker discipline, src/testing/cluster/state_checker.zig).

The port's test drivers: the in-process cluster (`cluster.py`), the
workload and its auditor (`workload.py`), the VOPR swarm (`vopr.py`), the
fuzzer registry (`fuzz.py`), the single-chip chaos harness (`chaos.py`),
vortex over real processes (`vortex.py`) and snapshot assertions
(`snap.py`).
"""

from .cluster import Cluster, SimClient

__all__ = ["Cluster", "SimClient"]
