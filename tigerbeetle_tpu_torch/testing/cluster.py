"""In-process deterministic cluster: simulated time, network, and storage.

reference: src/testing/cluster.zig (ClusterType), packet_simulator.zig
(delay/loss/duplication/partitions), time.zig (TimeSim). Replicas are REAL
Replica instances — only their environment is simulated, via constructor
injection. Every message crosses the "network" as serialized bytes, so wire
codecs are exercised and no Python object state leaks between replicas.

A copy of the JAX package's `testing/cluster.py`. The default state
machine factory is the port's `StateMachine()`, on the card; on the CPU
pass one, e.g. `lambda: StateMachine(engine="oracle", device="cpu")`.
"""

from __future__ import annotations

import dataclasses
import heapq
import random
from typing import Callable, Optional

from ..state_machine import StateMachine
from ..trace import Event, NullTracer, mint_context
from ..types import Operation
from ..vsr import snapshot as snapshot_codec
from ..vsr.header import Command, Header, Message
from ..vsr.replica import Replica, ReplicaOptions
from ..vsr.storage import MemoryStorage, StorageLayout, TEST_LAYOUT

MS = 1_000_000


class TimeSim:
    """Deterministic clock shared by the cluster
    (reference: src/testing/time.zig)."""

    def __init__(self, start_ns: int = 1_700_000_000 * 10**9):
        self.now = start_ns

    def monotonic(self) -> int:
        return self.now

    def realtime(self) -> int:
        return self.now

    def advance(self, dt_ns: int) -> None:
        self.now += dt_ns


class DriftedTime:
    """Per-replica view of the shared simulated clock with rate drift and
    a wall-clock offset (reference: TimeSim per-replica drift — the Clock's
    Marzullo agreement exists to survive exactly this)."""

    def __init__(self, base: TimeSim, drift_ppm: int = 0,
                 offset_ns: int = 0):
        self.base = base
        self.drift_ppm = drift_ppm
        self.offset_ns = offset_ns
        self._origin = base.now

    def _scaled(self) -> int:
        elapsed = self.base.now - self._origin
        return self._origin + elapsed + elapsed * self.drift_ppm // 1_000_000

    def monotonic(self) -> int:
        return self._scaled()

    def realtime(self) -> int:
        return self._scaled() + self.offset_ns


@dataclasses.dataclass
class NetworkOptions:
    """reference: src/testing/packet_simulator.zig:13-74"""

    delay_min_ns: int = 1 * MS
    delay_max_ns: int = 5 * MS
    loss_probability: float = 0.0
    duplicate_probability: float = 0.0


class _ReplicaBus:
    """MessageBus facade handed to one replica."""

    def __init__(self, cluster: "Cluster", replica_id: int):
        self.cluster = cluster
        self.replica_id = replica_id

    def send_to_replica(self, dst: int, msg: Message) -> None:
        self.cluster._post(("replica", self.replica_id), ("replica", dst),
                           msg.pack())

    def send_to_client(self, client_id: int, msg: Message) -> None:
        self.cluster._post(("replica", self.replica_id), ("client", client_id),
                           msg.pack())


class SimClient:
    """Harness-side client: request/reply with redundancy against every
    replica (only the primary acts; session request numbers dedupe).
    reference: src/vsr/client.zig (simplified: no hedging, no eviction)."""

    def __init__(self, cluster: "Cluster", client_id: int,
                 tracer=None, trace_head_rate: float = 1.0,
                 trace_seed: int = 0):
        self.cluster = cluster
        self.client_id = client_id
        self.request_number = 0
        self.inflight: Optional[dict] = None
        self.replies: list[Message] = []
        # Causal tracing: with a recording tracer every
        # request mints a deterministic context, opens the causal root
        # span (explicit timing: the reply closes it in on_message),
        # and ships the context on the wire header.
        self.tracer = tracer if tracer is not None else NullTracer()
        self.trace_head_rate = trace_head_rate
        self.trace_seed = trace_seed

    def request(self, operation: Operation, body: bytes,
                callback: Optional[Callable[[Message], None]] = None) -> None:
        assert self.inflight is None, "one request at a time"
        self.request_number += 1
        ctx = mint_context(self.client_id, self.request_number,
                           head_rate=self.trace_head_rate,
                           seed=self.trace_seed)
        root_sid = self.tracer.mint_span_id()
        header = Header(
            command=Command.request, cluster=self.cluster.cluster_id,
            client=self.client_id, request=self.request_number,
            operation=int(operation),
            trace_ctx=ctx.child(root_sid) if root_sid else ctx)
        msg = Message(header.finalize(body), body=body)
        self.inflight = {"message": msg, "sent_at": 0, "callback": callback,
                         "ctx": ctx, "root_sid": root_sid,
                         "t0": self.tracer.now_ns(),
                         "operation": int(operation)}
        self._send()

    def _send(self) -> None:
        msg = self.inflight["message"]
        self.inflight["sent_at"] = self.cluster.time.now
        for r in range(self.cluster.replica_count):
            self.cluster._post(("client", self.client_id), ("replica", r),
                               msg.pack())

    def on_message(self, msg: Message) -> None:
        if msg.header.command != Command.reply:
            return
        if self.inflight is None:
            return
        if msg.header.request != self.request_number:
            return
        inf = self.inflight
        cb = inf["callback"]
        self.inflight = None
        self.replies.append(msg)
        if inf["root_sid"]:
            self.tracer.record_span(
                Event.client_request, inf["t0"],
                self.tracer.now_ns() - inf["t0"], ctx=inf["ctx"],
                span_id=inf["root_sid"], operation=inf["operation"])
        if cb is not None:
            cb(msg)

    def tick(self) -> None:
        if (self.inflight is not None
                and self.cluster.time.now - self.inflight["sent_at"] > 300 * MS):
            self._send()  # resend (view change / loss)

    @property
    def idle(self) -> bool:
        return self.inflight is None


class Cluster:
    def __init__(self, *, seed: int = 0, replica_count: int = 3,
                 standby_count: int = 0,
                 layout: StorageLayout = TEST_LAYOUT,
                 network: NetworkOptions = NetworkOptions(),
                 options: ReplicaOptions = ReplicaOptions(),
                 state_machine_factory=StateMachine,
                 clock_drift_ppm_max: int = 0,
                 clock_offset_ns_max: int = 0,
                 tracer_factory=None):
        # Simulated clusters always run with the extra-check mode on
        # (reference: VOPR builds compile constants.verify in,
        # docs/internals/vopr.md:48-57).
        from .. import constants as _constants

        _constants.set_verify(True)
        self.cluster_id = 0xC1A57E12
        self.rng = random.Random(seed)
        self.time = TimeSim()
        self.network = network
        self.replica_count = replica_count
        self.standby_count = standby_count
        self.node_count = replica_count + standby_count
        self.layout = layout
        self.options = options
        self.state_machine_factory = state_machine_factory
        self.queue: list = []  # heap of (deliver_at, seq, src, dst, raw)
        self._seq = 0
        self.partitioned: set = set()  # endpoints whose links are cut
        self.cut_links: set[frozenset] = set()  # replica-pair partitions
        # Directional (src, dst) endpoint cuts — asymmetric partitions
        # (reference packet_simulator models send-only/receive-only).
        self.cut_directed: set[tuple] = set()
        self.crashed: set[int] = set()
        self.clock_drift_ppm_max = clock_drift_ppm_max
        self.clock_offset_ns_max = clock_offset_ns_max
        # Per-replica tracers (tracer_factory(i) -> tracer, pid=i
        # expected): one tracer per replica id, SHARED across restarts
        # so a replica's trace is continuous over its crashes.
        self.tracer_factory = tracer_factory
        self.tracers: dict[int, object] = {}

        self.storages = [MemoryStorage(layout)
                         for _ in range(self.node_count)]
        self.replicas: list[Replica] = []
        for i in range(self.node_count):
            Replica.format(self.storages[i], cluster=self.cluster_id,
                           replica_id=i, replica_count=replica_count)
            self.replicas.append(self._make_replica(i))
            self.replicas[i].open()
        self.clients: dict[int, SimClient] = {}

    def _make_replica(self, i: int) -> Replica:
        time = self.time
        if self.clock_drift_ppm_max or self.clock_offset_ns_max:
            drift_rng = random.Random((self.rng.getrandbits(32) << 8) | i)
            time = DriftedTime(
                self.time,
                drift_ppm=drift_rng.randint(-self.clock_drift_ppm_max,
                                            self.clock_drift_ppm_max),
                offset_ns=drift_rng.randint(-self.clock_offset_ns_max,
                                            self.clock_offset_ns_max))
        tracer = None
        if self.tracer_factory is not None:
            if i not in self.tracers:
                self.tracers[i] = self.tracer_factory(i)
            tracer = self.tracers[i]
        return Replica(
            cluster=self.cluster_id, replica_id=i,
            replica_count=self.replica_count,
            standby_count=self.standby_count, storage=self.storages[i],
            bus=_ReplicaBus(self, i), time=time,
            state_machine_factory=self.state_machine_factory,
            options=self.options, tracer=tracer)

    def client(self, client_id: int, tracer=None,
               trace_head_rate: float = 1.0,
               trace_seed: int = 0) -> SimClient:
        if client_id not in self.clients:
            self.clients[client_id] = SimClient(
                self, client_id, tracer=tracer,
                trace_head_rate=trace_head_rate, trace_seed=trace_seed)
        return self.clients[client_id]

    # ------------------------------------------------------------- network

    def _post(self, src, dst, raw: bytes) -> None:
        if src in self.partitioned or dst in self.partitioned:
            return
        if (src, dst) in self.cut_directed:
            return
        if src[0] == "replica" and dst[0] == "replica" \
                and frozenset((src[1], dst[1])) in self.cut_links:
            return
        if dst[0] == "replica" and dst[1] in self.crashed:
            return
        if self.rng.random() < self.network.loss_probability:
            return
        copies = 1
        if self.rng.random() < self.network.duplicate_probability:
            copies = 2
        for _ in range(copies):
            delay = self.rng.randrange(
                self.network.delay_min_ns, self.network.delay_max_ns + 1)
            self._seq += 1
            heapq.heappush(
                self.queue, (self.time.now + delay, self._seq, dst, raw))

    # ------------------------------------------------------------- control

    def crash(self, replica_id: int) -> None:
        """Stop a replica (its storage survives)."""
        self.crashed.add(replica_id)

    def restart(self, replica_id: int) -> None:
        assert replica_id in self.crashed
        self.crashed.discard(replica_id)
        self.replicas[replica_id] = self._make_replica(replica_id)
        try:
            self.replicas[replica_id].open()
        except Exception:
            # A refused open (e.g. release gating) leaves the replica
            # down, not half-up: it can be restarted again later.
            self.crashed.add(replica_id)
            raise

    def destroy_data_file(self, replica_id: int) -> None:
        """Total single-replica data loss: stop the replica and zero its
        data file (the vortex destruction fault, in-process)."""
        self.crashed.add(replica_id)
        self.storages[replica_id].erase()

    def begin_rebuild(self, replica_id: int) -> Replica:
        """Bring a destroyed replica back in rebuild-from-cluster mode
        (passive until synced + certified); returns the new Replica."""
        assert replica_id in self.crashed
        self.crashed.discard(replica_id)
        self.replicas[replica_id] = self._make_replica(replica_id)
        self.replicas[replica_id].open_rebuild()
        return self.replicas[replica_id]

    def rebuild(self, replica_id: int, ticks: int = 12000) -> Replica:
        """Run a full rebuild-from-cluster to completion."""
        replica = self.begin_rebuild(replica_id)
        ok = self.run(ticks, until=lambda: replica.rebuild_complete)
        assert ok, f"rebuild stuck: {replica.rebuild_progress()} | " \
            + self.debug_status()
        replica.finish_rebuild()
        return replica

    def partition(self, endpoint) -> None:
        self.partitioned.add(endpoint)

    def cut(self, src, dst) -> None:
        """Drop traffic in ONE direction between two endpoints
        (asymmetric partition; reference packet_simulator's
        send-only/receive-only modes)."""
        self.cut_directed.add((src, dst))

    def partition_mode(self, mode: str) -> None:
        """Link-level partition in one of the reference's modes
        (src/testing/packet_simulator.zig partition_mode): cut replica<->
        replica links; client traffic still flows."""
        self.cut_links.clear()  # REPLACE the previous partition (reference
        # packet_simulator applies one partition at a time)
        nodes = list(range(self.node_count))
        if mode == "isolate_single":
            victim = self.rng.choice(nodes)
            group_a = {victim}
        elif mode == "uniform_size":
            size = self.rng.randrange(1, self.node_count)
            group_a = set(self.rng.sample(nodes, size))
        elif mode == "uniform_partition":
            group_a = {n for n in nodes if self.rng.random() < 0.5}
        else:
            raise ValueError(f"unknown partition mode {mode!r}")
        group_b = set(nodes) - group_a
        for a in group_a:
            for b in group_b:
                self.cut_links.add(frozenset((a, b)))

    def heal(self, endpoint=None) -> None:
        if endpoint is None:
            self.partitioned.clear()
            self.cut_links.clear()
            self.cut_directed.clear()
        else:
            self.partitioned.discard(endpoint)
            self.cut_directed = {
                (s, d) for s, d in self.cut_directed
                if s != endpoint and d != endpoint}
            if endpoint[0] == "replica":
                self.cut_links = {
                    link for link in self.cut_links
                    if endpoint[1] not in link}

    # -------------------------------------------------------------- ticking

    def tick(self, dt_ns: int = 10 * MS) -> None:
        self.time.advance(dt_ns)
        while self.queue and self.queue[0][0] <= self.time.now:
            _, _, dst, raw = heapq.heappop(self.queue)
            try:
                msg = Message.unpack(raw)
            except Exception:
                continue
            if dst[0] == "replica":
                if dst[1] in self.crashed or dst in self.partitioned:
                    continue
                self.replicas[dst[1]].on_message(msg)
            else:
                client = self.clients.get(dst[1])
                if client is not None and dst not in self.partitioned:
                    client.on_message(msg)
        for i, replica in enumerate(self.replicas):
            if i not in self.crashed:
                replica.tick()
        for client in self.clients.values():
            client.tick()

    def run(self, ticks: int, dt_ns: int = 10 * MS,
            until: Optional[Callable[[], bool]] = None) -> bool:
        for _ in range(ticks):
            self.tick(dt_ns)
            if until is not None and until():
                return True
        return until is None

    # ------------------------------------------------------------- checkers

    def settle(self, ticks: int = 2000) -> None:
        """Heal everything and run until all live replicas converge."""
        self.heal()
        self.network.loss_probability = 0.0
        self.network.duplicate_probability = 0.0
        ok = self.run(ticks, until=self._converged)
        assert ok, self.debug_status()
        self.check_convergence()

    def _converged(self) -> bool:
        live = [r for i, r in enumerate(self.replicas) if i not in self.crashed]
        commits = {r.commit_min for r in live}
        ops = [r.op for r in live]
        return (len(commits) == 1 and commits.pop() == max(ops)
                and all(c.idle for c in self.clients.values()))

    def check_convergence(self) -> None:
        """All live replicas hold byte-identical state (the reference's
        StateChecker/StorageChecker invariant)."""
        live = [r for i, r in enumerate(self.replicas) if i not in self.crashed]
        snaps = [snapshot_codec.encode(r.state_machine.state) for r in live]
        assert all(s == snaps[0] for s in snaps[1:]), "state divergence"
        commit = {r.commit_min for r in live}
        assert len(commit) == 1
        self.check_storage()

    def check_storage(self) -> None:
        """Physical determinism (reference: storage_checker.zig:55 —
        byte-identical checkpoints): replicas at the same checkpoint hold
        byte-identical grid zones and checkpoint-root blobs."""
        live = [i for i in range(self.node_count) if i not in self.crashed]
        by_ckpt: dict[tuple, list[int]] = {}
        for i in live:
            r = self.replicas[i]
            if r.superblock is not None:
                # Grid bytes depend on all flushes <= commit_min, so only
                # replicas at the same (checkpoint, commit) must match.
                key = (r.superblock.op_checkpoint, r.commit_min)
                by_ckpt.setdefault(key, []).append(i)
        bs = self.layout.grid_block_size
        for (ckpt, _), members in by_ckpt.items():
            if ckpt == 0 or len(members) < 2:
                continue
            # Compare allocated blocks only: a state-synced replica never
            # receives FREE blocks, whose stale bytes are unreachable and
            # legitimately differ (the reference checker likewise compares
            # checkpointed content, not raw free space).
            frees = [self.replicas[i].durable.grid.free for i in members]
            assert all(f == frees[0] for f in frees[1:]), \
                f"free-set divergence at checkpoint {ckpt}: {members}"
            allocated = [b for b, free in enumerate(frees[0]) if not free]
            grids = [
                tuple(self.storages[i].read("grid", b * bs, bs)
                      for b in allocated)
                for i in members]
            assert all(g == grids[0] for g in grids[1:]), \
                f"grid divergence at checkpoint {ckpt}: replicas {members}"
            roots = []
            for i in members:
                sb = self.replicas[i].superblock
                roots.append(self.storages[i].read(
                    "snapshot",
                    sb.snapshot_slot * self.layout.snapshot_size_max,
                    sb.snapshot_size))
            assert all(r == roots[0] for r in roots[1:]), \
                f"checkpoint root divergence at {ckpt}"

    def merged_trace(self) -> dict:
        """One Chrome/Perfetto document for the whole cluster: every
        replica tracer's events on a common (wall-anchored) timeline,
        pid = replica id (requires tracer_factory)."""
        from ..trace import merge_traces

        assert self.tracers, "Cluster built without tracer_factory"
        docs = [self.tracers[i].chrome_dict()
                for i in sorted(self.tracers)]
        for cid in sorted(self.clients):
            t = self.clients[cid].tracer
            if hasattr(t, "chrome_dict"):
                docs.append(t.chrome_dict())
        return merge_traces(docs)

    def debug_status(self) -> str:
        return " | ".join(
            f"r{r.replica_id}:{r.status} v={r.view} op={r.op} "
            f"cmin={r.commit_min} cmax={r.commit_max}"
            for r in self.replicas)


def rebuild_smoke(seed: int = 11, tracer_factory=None) -> None:
    """The gate's rebuild smoke: 3-replica in-process cluster, traffic
    past a WAL wrap, zero one replica's data file under continued load,
    rebuild it from the cluster, and require the rebuilt replica's
    state-epoch digest to be bit-identical to every healthy peer's (plus
    the storage checker's byte-identical checkpoints). With
    tracer_factory the whole run records (the gate's trace-coverage leg
    reuses this smoke to prove the rebuild/state-sync catalog events)."""
    from .. import multi_batch
    from ..ops.state_epoch import combine, oracle_state_digest
    from ..types import Account, Transfer

    def _transfers_body(specs):
        payload = b"".join(
            Transfer(id=i, debit_account_id=1, credit_account_id=2,
                     amount=amt, ledger=1, code=1).pack()
            for (i, amt) in specs)
        return multi_batch.encode([payload], 128)

    cluster = Cluster(seed=seed, replica_count=3,
                      tracer_factory=tracer_factory)
    client = cluster.client(77)

    def drive(op, body):
        client.request(op, body)
        assert cluster.run(4000, until=lambda: client.idle), \
            cluster.debug_status()

    drive(Operation.create_accounts, multi_batch.encode(
        [b"".join(Account(id=i, ledger=1, code=1).pack()
                  for i in (1, 2))], 128))
    # Past the 32-slot WAL window so the rebuild MUST state-sync.
    for k in range(40):
        drive(Operation.create_transfers, _transfers_body([(100 + k, 1)]))
    victim = (cluster.replicas[0].primary_index() + 1) % 3
    cluster.destroy_data_file(victim)
    for k in range(6):  # live traffic while the replica is gone
        drive(Operation.create_transfers, _transfers_body([(200 + k, 1)]))
    rebuilt = cluster.rebuild(victim)
    assert rebuilt._rebuild_synced, "rebuild never exercised state sync"
    cluster.settle()
    digests = [combine(oracle_state_digest(r.state_machine.state, 1 << 8))
               for r in cluster.replicas]
    assert len(set(digests)) == 1, f"state-epoch digest divergence: {digests}"
