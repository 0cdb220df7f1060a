"""VOPR swarm as a library: one audited cluster-chaos run per seed.

reference: src/vopr.zig:80 — the simulator derives a random cluster
topology + fault configuration from one seed, drives a workload whose
expected outcomes are encoded into the transfer ids (workload/auditor
pair, testing/id.zig IdPermutation), and fails loudly on any divergence.
This module is that loop in callable form so the continuous fuzzing
orchestrator (`cfo`, src/scripts/cfo.zig) can interleave WHOLE-CLUSTER
seeds with the single-component fuzzer registry.

`run_swarm_seed(seed)` raises on any failure (liveness stall, audit
mismatch, checker violation inside the cluster) and returns a summary
dict on success. Deterministic per seed: a failure reproduces with
`python -m tigerbeetle_tpu_torch cfo --kind vopr --seed <seed> --max-runs 1`
(add `--platform cpu` for a run on the CPU).

A copy of the JAX package's `testing/vopr.py`. Its draws from
`random.Random` are that module's call for call: the engine is drawn only
when none is named, so a named engine shifts every later draw there as
here. Every replica's state machine lives on `device` (None: the card);
the device engine's ledger holds 2^10 accounts and 2^13 transfers.
"""

from __future__ import annotations

import random

from .. import multi_batch
from ..state_machine import StateMachine
from ..types import CreateTransferResult, Operation
from .cluster import Cluster, NetworkOptions
from .workload import Auditor, Workload

MS = 1_000_000


def run_swarm_seed(seed: int, engine: str | None = None,
                   steps: int | None = None,
                   tracer_factory=None, device=None) -> dict:
    """One seed-deterministic audited chaos run on a random topology.
    tracer_factory(i) injects a per-replica recording tracer (the
    gate's trace-coverage leg runs a swarm seed this way). `device`
    None means the card."""
    rng = random.Random(seed)
    if engine is None:
        # Device-engine runs cost a jit warmup; keep them a steady
        # minority so a sweep covers all three engines.
        engine = rng.choices(["oracle", "kernel", "device"],
                             weights=[5, 3, 2])[0]
    if steps is None:
        steps = rng.randrange(6, 12)
    replica_count = rng.choice([3, 3, 5])
    standby_count = rng.choice([0, 0, 1])
    if engine == "device":
        def factory():
            return StateMachine(engine="device", a_cap=1 << 10,
                                t_cap=1 << 13, device=device)
    else:
        def factory():
            return StateMachine(engine=engine, device=device)
    net = NetworkOptions(
        loss_probability=rng.choice([0.0, 0.02, 0.05, 0.10]),
        duplicate_probability=rng.choice([0.0, 0.02, 0.05]),
        delay_min_ns=1 * MS,
        delay_max_ns=rng.choice([10 * MS, 30 * MS, 50 * MS]))
    cluster = Cluster(
        seed=seed, replica_count=replica_count,
        standby_count=standby_count,
        state_machine_factory=factory,
        network=net, tracer_factory=tracer_factory)
    client = cluster.client(1)
    workload = Workload(seed, account_ids=list(range(1, 9)))
    auditor = Auditor(workload.permutation)
    max_down = (replica_count - 1) // 2

    def down_count() -> int:
        cut = {e[1] for e in cluster.partitioned if e[0] == "replica"}
        return len(cluster.crashed | cut)

    payload = b"".join(a.pack() for a in workload.accounts())
    client.request(Operation.create_accounts,
                   multi_batch.encode([payload], 128))
    if not cluster.run(20_000, until=lambda: client.idle):
        raise AssertionError(
            f"seed {seed}: account setup stalled: "
            f"{cluster.debug_status()}")

    for step in range(steps):
        roll = rng.random()
        if roll < 0.2 and down_count() < max_down:
            victim = rng.randrange(replica_count)
            if victim not in cluster.crashed:
                cluster.crash(victim)
        elif roll < 0.35 and cluster.crashed:
            cluster.restart(rng.choice(sorted(cluster.crashed)))
        elif roll < 0.45 and down_count() < max_down:
            cluster.partition(("replica", rng.randrange(replica_count)))
        elif roll < 0.55:
            cluster.heal()
        events = workload.batch()
        body = multi_batch.encode(
            [b"".join(t.pack() for t in events)], 128)
        client.request(Operation.create_transfers, body)
        if not cluster.run(60_000, until=lambda: client.idle):
            raise AssertionError(
                f"seed {seed}: step {step} stalled: "
                f"{cluster.debug_status()}")
        (payload,) = multi_batch.decode(client.replies[-1].body, 16)
        results = [CreateTransferResult.unpack(payload[i:i + 16])
                   for i in range(0, len(payload), 16)]
        auditor.check(events, results)

    cluster.heal()
    for r in sorted(cluster.crashed):
        cluster.restart(r)
    cluster.settle(ticks=60_000)
    assert auditor.checked > 0
    # The summary records the network fault configuration ACTUALLY
    # drawn, so a failing seed is triageable straight from the cfo log
    # without re-deriving the rng sequence.
    return dict(seed=seed, engine=engine, replica_count=replica_count,
                standby_count=standby_count, steps=steps,
                audited=auditor.checked,
                network=dict(
                    loss_probability=net.loss_probability,
                    duplicate_probability=net.duplicate_probability,
                    delay_min_ns=net.delay_min_ns,
                    delay_max_ns=net.delay_max_ns))
