"""Catalog-coverage harness: prove every trace event fires, nothing else.

The port's trace-coverage gate (a port of the JAX package's
`testing/trace_coverage.py`; run it with `python -m
tigerbeetle_tpu_torch.testing.trace_coverage`, on the card, or add
`--platform cpu`). The typed catalog
(tigerbeetle_tpu_torch/trace/event.py) promises two invariants the reference
gets from compiling src/trace/event.zig into every hot path:

1. **no free-form names** — the recording Tracer hard-errors on any
   span/counter/gauge outside the catalog, so simply RUNNING the smokes
   under recording tracers proves the suite emits no out-of-catalog
   name;
2. **no dead metrics** — every catalog member must be emitted at least
   once here, or the gate is RED: a metric nobody can produce is a lie
   in the operator docs (docs/operating/monitoring.md mirrors the
   catalog).

The harness runs the existing smokes (rebuild-from-cluster, seeded
serving chaos, a device-engine catch-up that forms commit windows) under
per-replica recording tracers, plus small deterministic scenarios for
the events whose triggers are rare in a healthy run (view change,
checkpoint rollback on divergence, config-fingerprint mismatch, grid
block repair, shard loss/fallback on the sharded router, ring
eviction). Everything is seed-pinned: a red here reproduces exactly.

Every ledger, supervisor, router and state machine a scenario builds
lives on the collector's device (None: the card). The three mesh
scenarios take the port's `parallel/shard_utils.Mesh` of logical shards
of that device, at the counts the JAX package's tests give its host
devices: 8 for the router and partitioned scenarios, 2 for reshard.
"""

from __future__ import annotations

from ..trace import Event, Tracer

CLUSTER = 0xABCD01

# Logical shards of one device (the JAX package's tests run on 8 host
# devices; its reshard scenario takes the first 2).
MESH_SHARDS = 8
RESHARD_SHARDS = 2


class _Collector:
    """Hands out recording tracers and remembers them for the final
    emitted-name union. Small ring capacities are deliberate where
    noted: ring eviction is itself a catalog event to prove."""

    def __init__(self, device=None):
        self.device = device
        self.tracers: list[Tracer] = []

    def make(self, pid: int = 0, capacity: int = 65536) -> Tracer:
        t = Tracer(capacity=capacity, pid=pid)
        self.tracers.append(t)
        return t

    def emitted(self) -> set:
        out: set = set()
        for t in self.tracers:
            out |= t.emitted
        return out

    def state_machine(self, engine: str = "kernel", **kw):
        """A `StateMachine` on the collector's device."""
        from ..state_machine import StateMachine

        return StateMachine(engine=engine, device=self.device, **kw)

    def mesh(self, shards: int):
        """`shards` logical shards of the collector's device."""
        from ..ops.device import resolve_device
        from ..parallel.shard_utils import Mesh

        return Mesh([resolve_device(self.device)] * shards)


# ------------------------------------------------------------- scenarios

def _scenario_rebuild(col: _Collector) -> None:
    """The gate's rebuild smoke under tracers: commit stages incl.
    checkpoint, journal write/recover, scrub ticks, state sync, the
    rebuild phase span, and the certify tour."""
    from .cluster import rebuild_smoke

    rebuild_smoke(tracer_factory=col.make, device=col.device)


def _scenario_view_change(col: _Collector) -> None:
    """Crash the primary; the backups elect — with DELIBERATELY tiny
    rings so the run's span volume also proves self-describing ring
    eviction (trace_dropped_events)."""
    from .. import multi_batch
    from ..types import Account, Operation
    from .cluster import Cluster

    cluster = Cluster(seed=5, replica_count=3,
                      tracer_factory=lambda i: col.make(i, capacity=64),
                      state_machine_factory=col.state_machine)
    client = cluster.client(7)
    client.request(Operation.create_accounts, multi_batch.encode(
        [Account(id=1, ledger=1, code=1).pack()], 128))
    assert cluster.run(4000, until=lambda: client.idle), \
        cluster.debug_status()
    primary = cluster.replicas[0].primary_index()
    cluster.crash(primary)
    live = [r for i, r in enumerate(cluster.replicas) if i != primary]
    assert cluster.run(
        20_000, until=lambda: all(r.view > 0 and r.status == "normal"
                                  for r in live)), cluster.debug_status()
    # Keep ticking: the paced scrub spans overflow the tiny rings, so
    # this scenario also proves the self-describing eviction marker.
    cluster.run(6_000)
    assert any(t.dropped_events for t in
               (cluster.tracers[i] for i in cluster.tracers)), \
        "tiny rings never evicted"


def _scenario_grid_repair(col: _Collector) -> None:
    """Corrupt one grid block on a backup, certify-tour it to surface
    the fault, and let peer repair heal it (grid_repair_block)."""
    from .. import multi_batch
    from ..types import Account, Operation, Transfer
    from .cluster import Cluster

    cluster = Cluster(seed=9, replica_count=3, tracer_factory=col.make,
                      state_machine_factory=col.state_machine)
    client = cluster.client(7)

    def drive(op, body):
        client.request(op, body)
        assert cluster.run(4000, until=lambda: client.idle), \
            cluster.debug_status()

    drive(Operation.create_accounts, multi_batch.encode(
        [b"".join(Account(id=i, ledger=1, code=1).pack()
                  for i in (1, 2))], 128))
    interval = cluster.replicas[0].options.checkpoint_interval
    for k in range(interval):  # cross a checkpoint: the grid holds blocks
        drive(Operation.create_transfers, multi_batch.encode(
            [Transfer(id=100 + k, debit_account_id=1, credit_account_id=2,
                      amount=1, ledger=1, code=1).pack()], 128))
    victim = (cluster.replicas[0].primary_index() + 1) % 3
    r = cluster.replicas[victim]
    blocks = list(r.scrubber._blocks())
    assert blocks, "checkpointed grid has no reachable blocks"
    name, address, size = blocks[0]
    bs = cluster.layout.grid_block_size
    raw = bytearray(cluster.storages[victim].read(
        "grid", address.index * bs, size))
    raw[0] ^= 0xFF
    cluster.storages[victim].write("grid", address.index * bs, bytes(raw))
    faults = r.scrubber.certify()  # immediate full tour finds it
    assert faults, "corrupted block not surfaced by the scrub tour"
    for fname, faddr, fsize in faults:
        r.block_repair[faddr.index] = (fname, faddr, fsize)
    assert cluster.run(8000, until=lambda: not r.block_repair), \
        "peer repair never healed the corrupt block"


def _scenario_rollback_and_config(col: _Collector) -> None:
    """Scripted divergence (a deposed primary's suffix executed under
    reused op numbers) -> checkpoint rollback; then a ping carrying a
    wrong cluster-config fingerprint -> config_mismatch_peer. Mirrors
    tests/test_consensus_scenarios.py's rollback scenario."""
    from ..types import Operation
    from ..vsr.checksum import checksum
    from ..vsr.header import Command, Header, Message
    from ..vsr.replica import Replica
    from ..vsr.storage import TEST_LAYOUT, MemoryStorage

    class _Bus:
        def send_to_replica(self, dst, msg):
            pass

        def send_to_client(self, client_id, msg):
            pass

    class _Time:
        now = 1_700_000_000 * 10**9

        def monotonic(self):
            return self.now

        def realtime(self):
            return self.now

    storage = MemoryStorage(TEST_LAYOUT)
    Replica.format(storage, cluster=CLUSTER, replica_id=1,
                   replica_count=6)
    r = Replica(cluster=CLUSTER, replica_id=1, replica_count=6,
                storage=storage, bus=_Bus(), time=_Time(),
                state_machine_factory=lambda: col.state_machine("oracle"),
                tracer=col.make(1))
    r.open()
    r.status = "normal"

    def pulse_chain(n, start_op=1, parent=None, view=0):
        if parent is None:
            parent = checksum(CLUSTER.to_bytes(16, "little"),
                              domain=b"genesis") if start_op == 1 else 0
        out = []
        for op in range(start_op, start_op + n):
            h = Header(command=Command.prepare, cluster=CLUSTER, view=view,
                       op=op, operation=int(Operation.pulse),
                       parent=parent, timestamp=op * 10**9)
            m = Message(h.finalize())
            parent = m.header.checksum
            out.append(m)
        return out

    def commit_through(msgs, commit):
        for m in msgs:
            r.on_message(m)
        hb = Header(command=Command.commit, cluster=CLUSTER, replica=0,
                    view=r.view, commit=commit)
        r.on_message(Message(hb.finalize()))

    good = pulse_chain(16)
    commit_through(good, 16)
    assert r.superblock.op_checkpoint == 16
    c16 = good[-1].header.checksum
    commit_through(pulse_chain(2, start_op=17, parent=c16), 18)
    a_chain = pulse_chain(4, start_op=17, parent=c16, view=2)
    body = b"".join(m.header.pack() for m in a_chain)
    sv = Header(command=Command.start_view, cluster=CLUSTER, replica=2,
                view=2, op=20, commit=20)
    r.on_message(Message(sv.finalize(body), body=body))
    r.on_message(a_chain[2])  # exposes the divergence -> rollback
    assert r.commit_min == 16, "rollback scenario did not fire"

    bad_ping = Header(command=Command.ping, cluster=CLUSTER, replica=3,
                      view=0, release=1, timestamp=1, context=0xBAD)
    r.on_message(Message(bad_ping.finalize()))
    assert 3 in r._config_mismatch, "config mismatch scenario did not fire"


def _scenario_bus_pair(col: _Collector) -> None:
    """Two real MessageBus endpoints over loopback TCP: send / recv
    spans and the pool gauge on the production transport."""
    from ..vsr.header import Command, Header, Message
    from ..vsr.message_bus import MessageBus

    got: list = []
    b0 = MessageBus(cluster=CLUSTER, on_message=got.append,
                    replica_addresses=[("127.0.0.1", 0)] * 2,
                    replica_id=0, listen=True, listen_port=0,
                    tracer=col.make(0))
    addrs = [b0.listen_address, ("127.0.0.1", 0)]
    b0.replica_addresses = addrs
    b1 = MessageBus(cluster=CLUSTER, on_message=lambda m: None,
                    replica_addresses=addrs, replica_id=1,
                    tracer=col.make(1))
    try:
        ping = Header(command=Command.ping, cluster=CLUSTER, replica=1,
                      view=0, release=1, timestamp=1)
        b1.send_to_replica(0, Message(ping.finalize()))
        for _ in range(200):
            b1.poll(0.01)
            b0.poll(0.01)
            if got:
                break
        assert got, "loopback bus never delivered"
    finally:
        b0.close()
        b1.close()


def _scenario_chaos(col: _Collector) -> None:
    """Seeded serving chaos, kind-pinned so both the retry and the
    recovery catalog events are guaranteed: dispatch faults always
    retry; a state bitflip is corruption, which the harness itself
    asserts ends in >= 1 recovery."""
    from .chaos import run_chaos_seed

    run_chaos_seed(1, windows=4, kinds=("dispatch_fail",),
                   mesh_scenario=False, tracer=col.make(0),
                   device=col.device)
    run_chaos_seed(2, windows=4, kinds=("state_bitflip",),
                   mesh_scenario=False, tracer=col.make(0),
                   device=col.device)


def _scenario_commit_windows(col: _Collector) -> None:
    """A lagging device-engine replica catches up through WINDOWED
    commits (same shape as tests/test_superbatch.py's determinism
    scenario, shrunk): commit_windows plus window-tagged
    commit_execute spans."""
    from .. import multi_batch
    from ..types import Account, Operation, Transfer
    from .cluster import Cluster

    cluster = Cluster(
        seed=31, replica_count=3, tracer_factory=col.make,
        state_machine_factory=lambda: col.state_machine(
            "device", a_cap=1 << 9, t_cap=1 << 12))
    client = cluster.client(77)

    def drive(op, body):
        client.request(op, body)
        assert cluster.run(4000, until=lambda: client.idle), \
            cluster.debug_status()

    drive(Operation.create_accounts, multi_batch.encode(
        [b"".join(Account(id=i, ledger=1, code=1).pack()
                  for i in (1, 2))], 128))
    victim = (cluster.replicas[0].primary_index() + 1) % 3
    cluster.crash(victim)
    for k in range(6):
        drive(Operation.create_transfers, multi_batch.encode(
            [Transfer(id=5000 + k, debit_account_id=1,
                      credit_account_id=2, amount=1 + k,
                      ledger=1, code=1).pack()], 128))
    cluster.restart(victim)
    cluster.settle()
    assert cluster.replicas[victim]._windows_committed >= 1, \
        "catch-up replay never formed a commit window"


def _scenario_router(col: _Collector) -> None:
    """ShardedRouter on 8 logical shards: a clean step, a shard-loss
    reroute, and a guaranteed host fallback (duplicate-id hard-e2
    collision — the same deterministic trigger the JAX package's
    tests/test_closing_native.py pins)."""
    from ..ops.batch import transfers_to_arrays
    from ..ops.ledger import DeviceLedger, pad_transfer_events
    from ..parallel.full_sharded import ShardedRouter, shard_batch
    from ..parallel.shard_utils import replicate
    from ..types import Account, Transfer

    tracer = col.make(0)
    mesh = col.mesh(MESH_SHARDS)
    router = ShardedRouter(mesh, tracer=tracer)
    led = DeviceLedger(a_cap=1 << 8, t_cap=1 << 11, device=mesh.devices[0])
    led.create_accounts([Account(id=i, ledger=1, code=1)
                         for i in (1, 2)], 1_000)
    state = replicate(mesh, led.state)
    led.state = None  # the router's state now

    def batch(evs, ts):
        n = len(evs)
        evp = shard_batch(mesh, pad_transfer_events(
            transfers_to_arrays(evs), 1024))
        return router.step(state, evp, ts, n)

    ts = 10**9
    state, _, fell = batch([Transfer(
        id=10, debit_account_id=1, credit_account_id=2, amount=1,
        ledger=1, code=1)], ts)
    assert not fell
    router.drop_device(mesh.devices[0])
    state, _, fell = batch([Transfer(
        id=11, debit_account_id=1, credit_account_id=2, amount=1,
        ledger=1, code=1)], ts + 100)
    assert not fell and router.shard_loss_reroutes == 1
    router.restore_devices()
    dup = [Transfer(id=20, debit_account_id=1, credit_account_id=2,
                    amount=1, ledger=1, code=1),
           Transfer(id=20, debit_account_id=1, credit_account_id=2,
                    amount=1, ledger=1, code=1)]
    state, _, fell = batch(dup, ts + 200)
    assert fell and router.host_fallbacks == 1, router.stats()


def _scenario_partitioned(col: _Collector) -> None:
    """PartitionedRouter on 8 logical shards: a cross-shard step
    (shard_exchange span + cross_shard_transfers counter + the
    partitioned_* dispatch route + the device-telemetry observations:
    fixpoint rounds, exchange occupancy, ring occupancy, write-back
    rows), a duplicate-id hard collision (the harvested block's poison
    cause -> device_poison_cause), then a shard loss -> resync through
    the shard_resync recovery cause — whose quarantine freezes the
    flight ring (flight_recorder_dump)."""
    from ..oracle import StateMachineOracle
    from ..ops.batch import transfers_to_arrays
    from ..ops.ledger import pad_transfer_events
    from ..parallel.partitioned import PartitionedRouter
    from ..parallel.shard_utils import shard_of_int
    from ..types import Account, Transfer

    tracer = col.make(0)
    mesh = col.mesh(MESH_SHARDS)
    n_dev = int(mesh.size)
    router = PartitionedRouter(mesh, tracer=tracer,
                               a_cap=1 << 9, t_cap=1 << 11)
    oracle = StateMachineOracle()
    accts = [Account(id=i, ledger=1, code=1) for i in range(1, 17)]
    oracle.create_accounts(accts, 1_000)
    state = router.from_oracle(oracle)
    # A debit/credit pair on different shards, so the cross-shard
    # counter is guaranteed to fire (any pair when n_dev == 1).
    dr, cr = 1, 2
    for a in range(2, 17):
        if shard_of_int(a, n_dev) != shard_of_int(1, n_dev):
            cr = a
            break

    def batch(evs, ts):
        n = len(evs)
        evp = pad_transfer_events(transfers_to_arrays(evs), 1024)
        return router.step(state, evp, ts, n)

    ts = 10**9
    state, _, fell = batch([Transfer(
        id=10, debit_account_id=dr, credit_account_id=cr, amount=1,
        ledger=1, code=1)], ts)
    assert not fell
    oracle.create_transfers([Transfer(
        id=10, debit_account_id=dr, credit_account_id=cr, amount=1,
        ledger=1, code=1)], ts)
    if n_dev > 1:
        assert router.cross_shard_transfers >= 1, router.stats()
    # A duplicate-id pair is a hard e2 collision: the harvested block
    # carries a nonzero poison-cause word, so device_poison_cause is
    # guaranteed on-catalog-live even in an otherwise healthy sweep.
    dup = [Transfer(id=20, debit_account_id=dr, credit_account_id=cr,
                    amount=1, ledger=1, code=1),
           Transfer(id=20, debit_account_id=dr, credit_account_id=cr,
                    amount=1, ledger=1, code=1)]
    state, _, fell = batch(dup, ts + 100)
    assert fell and router.device_poison_causes, router.stats()
    router.drop_device(mesh.devices[0])
    state = router.resync(oracle)
    assert router.shard_resyncs == 1
    state, _, fell = batch([Transfer(
        id=11, debit_account_id=cr, credit_account_id=dr, amount=1,
        ledger=1, code=1)], ts + 200)
    assert not fell


def _scenario_overlap(col: _Collector) -> None:
    """The staging plane: a small pipelined ledger run emits
    window_stage in BOTH modes (one window staged ahead on the
    background stager = overlapped, one packed synchronously on the
    dispatch path = inline) and the cumulative host_stall_fraction
    gauge — the events the overlap gate leg's ceiling reads."""
    from ..ops.batch import transfers_to_arrays
    from ..ops.ledger import DeviceLedger
    from ..types import Account, Transfer

    led = DeviceLedger(a_cap=1 << 8, t_cap=1 << 11, device=col.device)
    led.tracer = col.make(60)
    led.create_accounts([Account(id=i, ledger=1, code=1)
                         for i in (1, 2)], 1_000)

    def window(base, ts):
        evs = [transfers_to_arrays(
            [Transfer(id=base + b * 4 + i, debit_account_id=1 + i % 2,
                      credit_account_id=2 - i % 2, amount=1, ledger=1,
                      code=1) for i in range(4)]) for b in range(2)]
        return evs, [ts, ts + 100]

    evs, tss = window(7000, 10 ** 9)
    assert led.stage_window(evs, tss)       # -> mode=overlapped
    assert led.submit_window(evs, tss) is not None
    evs2, tss2 = window(7100, 10 ** 9 + 500)
    assert led.submit_window(evs2, tss2) is not None  # -> mode=inline
    led.resolve_windows()
    st = led.staging_stats
    assert st["staged"] == 1 and st["windows"] == 2, st
    assert led.staging_summary()["host_stall_fraction"] is not None
    led.shutdown_staging()


def _scenario_reshard(col: _Collector) -> None:
    """The elastic-shard plane: one live split migration on a
    2-shard mesh emits the per-stage reshard_stage spans (snapshot,
    copy, flip, retire), the reshard_rows_copied counter, and the
    reshard_overlay_active gauge (raised at double-write activation,
    dropped back at the flip)."""
    import numpy as np

    from ..oracle import StateMachineOracle
    from ..ops.batch import transfers_to_arrays
    from ..parallel.partitioned import PartitionedRouter
    from ..parallel.resharding import ReshardController, ReshardPlan
    from ..types import Account, Transfer

    mesh = col.mesh(RESHARD_SHARDS)
    assert mesh.size >= 2, "reshard scenario needs >= 2 shards"
    tracer = col.make(95)
    router = PartitionedRouter(mesh, a_cap=1 << 9, t_cap=1 << 11)
    oracle = StateMachineOracle()
    oracle.create_accounts([Account(id=i, ledger=1, code=1)
                            for i in range(1, 17)], 1_000)
    state = router.from_oracle(oracle)
    ctl = ReshardController(router, tracer=tracer, chunk_rows=256,
                            min_double_write_windows=1)
    state = ctl.begin(state, ReshardPlan(lo=0, hi=(1 << 63) - 1,
                                         src=0, dst=1, kind="split"))
    rng = np.random.default_rng(19)
    nid, ts = 5000, 10 ** 9
    guard = 0
    while ctl.stage != "done":
        evs, tss = [], []
        for _ in range(2):
            batch = []
            for _i in range(4):
                dr, cr = rng.choice(np.arange(1, 17), 2, replace=False)
                batch.append(Transfer(id=nid, debit_account_id=int(dr),
                                      credit_account_id=int(cr),
                                      amount=1, ledger=1, code=1))
                nid += 1
            ts += 300
            evs.append(transfers_to_arrays(batch))
            tss.append(ts)
        state = ctl.on_window(state, evs)
        state, _ = router.step_window(state, evs, tss)
        guard += 1
        assert guard < 32, ctl.stage
    assert len(ctl.migrations) == 1 and not ctl.aborts, ctl.migrations


def _scenario_admission(col: _Collector) -> None:
    """The admission plane: a tiny seeded overload in front of a
    real supervisor emits the full admission catalog — an
    admission_decision span for BOTH outcomes (admit, and a typed
    ShedResult with a tail-kept ``shed:<reason>`` trace), the
    admission_shed counter, and the per-tick credit-occupancy gauge —
    covering the fast-reject (no_credit) and forced shed-line paths."""
    from ..admission import AdmissionClass, AdmissionPlane, ShedResult, \
        VirtualClock
    from ..serving import ServingSupervisor
    from ..types import Account, Transfer

    tracer = col.make(0)
    clock = VirtualClock()
    sup = ServingSupervisor(a_cap=1 << 8, t_cap=1 << 11,
                            epoch_interval=8, sleep=lambda s: None,
                            seed=7, tracer=tracer, device=col.device)
    classes = (AdmissionClass("critical", 0, slo_ms=100.0,
                              deadline_ms=400.0),
               AdmissionClass("batch", 1, slo_ms=200.0,
                              deadline_ms=800.0))
    plane = AdmissionPlane(sup, classes=classes, prepare_max=8,
                           window_prepares=1, session_credits=2,
                           max_queue=64, clock=clock, seed=7)
    plane.open_accounts([Account(id=i, ledger=1, code=1)
                         for i in (1, 2)], 1_000)
    plane.force_shed_level(1)  # gate the batch class -> shed_line
    nid, reqs = 1, []
    for _round in range(4):
        for sid, cls in ((1, "critical"), (1, "critical"),
                         (1, "critical"), (2, "batch")):
            evs = [Transfer(id=nid + i, debit_account_id=1,
                            credit_account_id=2, amount=1, ledger=1,
                            code=1) for i in range(2)]
            nid += 2
            reqs.append(plane.submit(sid, evs, cls=cls))
        plane.pump()
        clock.advance(0.02)
    plane.drain()
    sup.led.shutdown_staging()
    sheds = [r for r in reqs if r.state == "shed"]
    admits = [r for r in reqs if r.state == "admitted"]
    assert admits and sheds, (len(admits), len(sheds))
    assert all(isinstance(r.shed, ShedResult) for r in sheds)
    assert {r.shed.reason for r in sheds} >= {"no_credit", "shed_line"}
    assert all(tracer.kept_traces.get(r.shed.trace_id, "")
               .startswith("shed:") for r in sheds)
    assert plane.conservation()["ok"], plane.conservation()


def _scenario_slo(col: _Collector) -> None:
    """The SLO engine against the COMMITTED perf/slo.json: objectives
    must load (every referenced event on-catalog — a dead SLO is a red
    right here), evaluate against real samples, and a forced-breach
    pass (thresholds replaced with -1) must emit the slo_breach
    counter deterministically."""
    import dataclasses

    from ..trace import Event as Ev
    from ..trace import evaluate, load_objectives

    tracer = col.make(0)
    cfg = load_objectives()
    # Real samples for every objective's event: a window span per
    # route class and one replay-length observation.
    for route, tier in (("chain", "scan"), ("per_batch", "fallback"),
                        ("super_deep", "flat")):
        with tracer.span(Ev.window_commit) as sp:
            sp.tags["route"] = route
            sp.tags["tier"] = tier
    with tracer.span(Ev.serving_dispatch, what="window"):
        pass
    # Per-class admitted queue-wait samples for the admission
    # objectives (the shed-aware plane's committed p99 budgets).
    for cls_name in ("critical", "standard"):
        with tracer.span(Ev.admission_decision) as sp:
            sp.tags["decision"] = "admit"
            sp.tags["cls"] = cls_name
    tracer.observe(Ev.serving_replay_windows, 2)
    # The exchange-headroom objective reads the device-telemetry plane's
    # occupancy observations (both psum phases of the fused route).
    tracer.observe(Ev.device_exchange_occupancy, 37.5, phase="transfers")
    tracer.observe(Ev.device_exchange_occupancy, 12.5, phase="accounts")
    rows = evaluate(tracer, cfg["objectives"], emit_to=tracer)
    assert all(r["ok"] is not None for r in rows), rows
    forced = [dataclasses.replace(o, threshold=-1.0)
              for o in cfg["objectives"]]
    rows = evaluate(tracer, forced, emit_to=tracer)
    assert all(r["ok"] is False for r in rows), rows
    assert tracer.counters.get("slo_breach", 0) >= len(forced)


def _scenario_observatory(col: _Collector) -> None:
    """The observatory's events, each through its real producer:
    a sampled dispatch feeding the dispatch_device_time histogram, one
    memory-watermark observation against the committed membudget (both
    gauges), and a seeded latency burn firing alert_fired through the
    burn-rate engine — so any of the four going dead REDs this leg."""
    from ..serving import ServingSupervisor
    from ..trace import AlertEngine, DispatchProfiler, MemWatch, \
        mint_context

    from ..ops.device import resolve_device

    tracer = col.make(0)
    prof = DispatchProfiler(tracer=tracer, sample_every=1)
    out = prof.time(lambda: 41 + 1, route="chain", tier="scan",
                    device=resolve_device(col.device))
    assert out == 42 and prof.samples == 1, prof.stats()
    sup = ServingSupervisor(a_cap=1 << 6, t_cap=1 << 8, tracer=tracer,
                            device=col.device)
    mw = MemWatch(tracer=tracer)
    rec = mw.observe(sup.led)
    assert "headroom_bytes" in rec, \
        "no committed membudget — headroom gauge would go dead"
    eng = AlertEngine(tracer=tracer, tick_every=1)
    for i in range(8):
        tracer.record_span(Event.window_commit, tracer.now_ns(),
                           int(600e6), ctx=mint_context(9, i),
                           route="chain", tier="scan")
        eng.tick()
    assert eng.fired, eng.stats()


def _scenario_causal_trace(col: _Collector) -> None:
    """The causal plane end to end in the simulator: a traced
    cluster plus a traced client emits the per-request spans
    (client_request root, the primary's commit_quorum wait, the
    backups' replica_ack), assemble_traces() rebuilds one complete
    orphan-free tree per request, and a forced tail-keep at a 0% head
    rate proves trace_tail_keep + retention."""
    from .. import multi_batch
    from ..trace import assemble_traces
    from ..types import Account, Operation, Transfer
    from .cluster import Cluster

    cluster = Cluster(seed=3, replica_count=3, tracer_factory=col.make,
                      state_machine_factory=col.state_machine)
    client_tracer = col.make(90)
    client = cluster.client(7, tracer=client_tracer)

    def drive(op, body):
        client.request(op, body)
        assert cluster.run(4000, until=lambda: client.idle), \
            cluster.debug_status()

    drive(Operation.create_accounts, multi_batch.encode(
        [b"".join(Account(id=i, ledger=1, code=1).pack()
                  for i in (1, 2))], 128))
    for k in range(3):
        drive(Operation.create_transfers, multi_batch.encode(
            [Transfer(id=900 + k, debit_account_id=1,
                      credit_account_id=2, amount=1 + k,
                      ledger=1, code=1).pack()], 128))
    asm = assemble_traces(cluster.merged_trace())
    assert asm["total"] == 4 and asm["complete"] == 4 \
        and asm["orphan_spans"] == 0, {
            k: asm[k] for k in ("total", "complete", "orphan_spans")}
    # Tail retention: force-keep one trace, then assemble at a 0% head
    # rate — exactly the kept trace survives sampling.
    tid = asm["traces"][0]["trace_id"]
    client_tracer.keep_trace(tid, reason="slo_breach")
    asm2 = assemble_traces(cluster.merged_trace(), head_rate=0.0)
    kept = [t["trace_id"] for t in asm2["traces"] if t["kept"]]
    assert kept == [tid], kept


SCENARIOS = (
    _scenario_rebuild,
    _scenario_view_change,
    _scenario_grid_repair,
    _scenario_rollback_and_config,
    _scenario_bus_pair,
    _scenario_chaos,
    _scenario_commit_windows,
    _scenario_router,
    _scenario_partitioned,
    _scenario_overlap,
    _scenario_reshard,
    _scenario_admission,
    _scenario_slo,
    _scenario_observatory,
    _scenario_causal_trace,
)


def coverage_main(scenarios=SCENARIOS, device=None) -> int:
    """Run every scenario under recording tracers on `device` (None: the
    card); RED when a catalog event was never emitted (dead metric) or —
    belt and braces, the tracer already hard-errors — an emitted name is
    off-catalog."""
    col = _Collector(device)
    failures = 0
    for scenario in scenarios:
        try:
            scenario(col)
            print(f"[trace-cov] {scenario.__name__} ok", flush=True)
        except Exception as e:  # noqa: BLE001 — the gate wants ALL reds
            failures += 1
            print(f"[trace-cov] {scenario.__name__} FAILED: {e!r}",
                  flush=True)
    emitted = col.emitted()
    catalog = {e.name for e in Event}
    dead = sorted(catalog - emitted)
    unknown = sorted(emitted - catalog)
    print(f"[trace-cov] {len(emitted)}/{len(catalog)} catalog events "
          f"emitted across {len(col.tracers)} tracers", flush=True)
    if dead:
        failures += 1
        print(f"[trace-cov] RED: dead catalog events (never emitted by "
              f"the smokes): {dead}", flush=True)
    if unknown:
        failures += 1
        print(f"[trace-cov] RED: off-catalog names emitted: {unknown}",
              flush=True)
    # Histogram coverage (the metrics plane's own dead-metric check):
    # every span/histogram event the smokes emitted must have fed a
    # NON-EMPTY histogram somewhere — an emitted span whose
    # distribution stayed empty means the tracer's span-close
    # accumulation regressed.
    fed: dict = {}
    for t in col.tracers:
        for key, h in t.histograms.items():
            name = t.histogram_series[key][0]
            fed[name] = fed.get(name, 0) + h.count
    starved = sorted(
        e.name for e in Event
        if e.kind.value in ("span", "histogram") and e.name in emitted
        and not fed.get(e.name))
    print(f"[trace-cov] {len(fed)} events fed histograms "
          f"({sum(fed.values())} samples)", flush=True)
    if starved:
        failures += 1
        print(f"[trace-cov] RED: emitted events with EMPTY histograms "
              f"(span-close accumulation broken): {starved}", flush=True)
    return 1 if failures else 0


def metrics_main(device=None) -> int:
    """The metrics leg: the committed perf/slo.json (at the repo's root)
    must
    load with every referenced event on-catalog (a dead SLO is RED),
    and a live /metrics endpoint over a real serving run must produce
    Prometheus-parseable text whose per-route window p99 agrees with
    the tracer's own histograms. The serving run is on `device` (None:
    the card)."""
    import urllib.request

    from ..metrics import MetricsServer, parse_prometheus, \
        render_prometheus
    from ..trace import burn_rates, evaluate, load_objectives
    from .chaos import run_chaos_seed

    failures = 0
    try:
        cfg = load_objectives()
        print(f"[metrics] perf/slo.json: {len(cfg['objectives'])} "
              f"objectives on-catalog, burn window "
              f"{cfg['burn_window_runs']} runs", flush=True)
    except (OSError, ValueError) as e:
        print(f"[metrics] RED: perf/slo.json invalid: {e}", flush=True)
        return 1
    # A real (seeded, tiny) serving run feeds the registry, then the
    # endpoint serves it and the scrape must parse.
    tracer = Tracer(pid=0)
    run_chaos_seed(1, windows=4, kinds=("dispatch_fail",),
                   mesh_scenario=False, tracer=tracer, device=device)
    rows = evaluate(tracer, cfg["objectives"], emit_to=tracer)
    burn = burn_rates([rows], cfg["burn_window_runs"],
                      cfg["burn_budget"])
    srv = MetricsServer(lambda: render_prometheus(
        tracer, slo_rows=rows, burn=burn), port=0)
    try:
        url = f"http://127.0.0.1:{srv.port}/metrics"
        with urllib.request.urlopen(url, timeout=10) as resp:
            text = resp.read().decode()
    finally:
        srv.close()
    try:
        parsed = parse_prometheus(text)
    except ValueError as e:
        print(f"[metrics] RED: exposition not parseable: {e}",
              flush=True)
        return 1
    window_counts = parsed.get("tb_tpu_window_commit_us_count", [])
    routes = {lab.get("route") for lab, _ in window_counts}
    if not window_counts:
        failures += 1
        print("[metrics] RED: no window_commit histogram series on "
              "the endpoint", flush=True)
    if not {lab.get("objective") for lab, _ in
            parsed.get("tb_tpu_slo_threshold", [])}:
        failures += 1
        print("[metrics] RED: no SLO series on the endpoint",
              flush=True)
    print(f"[metrics] endpoint ok: {len(parsed)} metric families, "
          f"window routes {sorted(r for r in routes if r)}", flush=True)
    return 1 if failures else 0


def main(argv=None) -> int:
    """`python -m tigerbeetle_tpu_torch.testing.trace_coverage
    [--platform cpu]`: the catalog gate, on the card unless the CPU is
    asked for."""
    import argparse

    p = argparse.ArgumentParser(prog="trace_coverage")
    p.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    return coverage_main(device=p.parse_args(argv).platform)


# Deterministic seed record for reproduction: every scenario above is
# fixed-seed; re-running coverage_main reproduces a red exactly.
if __name__ == "__main__":  # pragma: no cover - gate entry
    import sys

    sys.exit(main())
